"""Halo-exchange domain decomposition of the site graph, the port of
``devicekmc_tpu/parallel/halo.py``.

Sites are split into contiguous slabs along the (x-sorted) transport axis,
one a rank; each rank holds only its slab of every per-site vector, and a
neighbour read across a slab's edge is served by exchanging fixed-width
halos with the adjacent ranks (``mesh.Communicator.exchange``, the JAX
package's ``ppermute`` pair).  Dot products are summed over the ranks.

Requirements: the site order's graph bandwidth is at most the halo width
(x-sorted structures keep it small; ``site_order = "x"``), and the halo fits
in a slab.  :func:`compute_halo_width` measures the bandwidth.

Here: the width and a distributed Jacobi-CG Dirichlet Laplace solve
(:func:`make_halo_laplace_solver`); the exchange is
``mesh.Communicator.exchange``, and the whole superstep through this layout
is ``halo_superstep``.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh


def compute_halo_width(neigh_idx) -> int:
    """Maximum |i - j| over the graph's edges (the ordering's bandwidth);
    ``neigh_idx`` [N, max_nn] with global indices, pad -1."""
    nb = neigh_idx.cpu().numpy() if torch.is_tensor(neigh_idx) else np.asarray(neigh_idx)
    n, m = nb.shape
    rows = np.repeat(np.arange(n), m)
    cols = nb.reshape(-1)
    ok = cols >= 0
    if not ok.any():
        return 0
    return int(np.abs(rows[ok] - cols[ok]).max())


def make_halo_laplace_solver(mesh: Mesh, halo: int, tol: float = 1e-10,
                             maxiter: int = 50000):
    """A distributed Dirichlet Laplace solver over ``mesh``.

    ``solver(edge_g, neigh_idx, interior, is_left, is_right, x0, v_left,
    v_right) -> (phi, iters)`` takes this rank's slabs (``edge_g`` and
    ``neigh_idx`` [S, max_nn], the latter with GLOBAL indices; the masks and
    ``x0`` [S]) and the contact potentials, and returns this rank's slab of
    the potential and the iteration count, the same on every rank.  Jacobi
    CG with criterion "r" (``ops.cg.cg_solve``), every dot product summed
    over the ranks of the mesh's ``"sites"`` axis."""
    from ..physics.potential import _dirichlet_laplace_solve
    from .halo_superstep import _Shard

    mesh = mesh.axis("sites")

    def solver(edge_g, neigh_idx, interior, is_left, is_right, x0, v_left, v_right):
        phi, res = _dirichlet_laplace_solve(
            None, edge_g, float(v_left), float(v_right), x0, tol, maxiter,
            masks=(is_left, is_right, interior), slab=_Shard(mesh.comm, neigh_idx, halo))
        return phi, res.iters

    return solver
