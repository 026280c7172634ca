"""Electrostatic potential solvers of the headline superstep.

1. **Boundary (resistive-network) potential** — Laplace solve over the site
   conductance graph with Dirichlet contacts at -Vd/2 / +Vd/2, conductance
   high_G for metal-metal or neutral-vacancy-pair edges, else low_G.
   Reference: Device::background_potential (src/potential_solver.cpp:289-410)
   and background_potential_gpu_sparse (src/potential_solver_gpu.cu:696-781).

2. **Gridless Poisson** — superposition of screened-Coulomb solutions from
   every charged site over a compacted charged set.  Reference:
   poisson_gridless (src/potential_solver.cpp:412-432, GPU :907-978).

The Laplace solve is Dirichlet-eliminated CG on the ELL graph, warm-started
from the previous solution, with two exact shortcuts (unchanged network,
incrementally certified residual) — the decisions of
``devicekmc_tpu.physics.potential``.  The ``*_batched`` functions take B
replicas of one geometry (a batched state, ``parallel.batched``) and make
each replica's decisions on the device, as masks, as the JAX package's vmap
turns its conditionals into selects.

3. **Conduction-band edge** — the same Laplace solve on the CB-edge network
   (high_G where either endpoint is metal), contacts at +Vd/2 / -Vd/2, once
   per bias point for the transport solver.  Reference: src/potential_solver.cpp:58-70,
   src/potential_solver_gpu.cu:634-674.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import constants as C
from ..ops.boundary_cg import Workspace, cg_solve_device
from ..ops.cg import cg_solve, cg_solve_batched, invert_coarse, rowdot
from ..ops.compact import nonzero_fixed, nonzero_fixed_batched
from ..ops.ell import safe_index
from ..ops.pairwise import (kernel_scalars, poisson_exact_batched, poisson_pairwise_batched,
                            poisson_pairwise_rows)
from ..state import Geometry, PhysParams, SimState, _as_dtype, replace
from ..structure import Element


def _select(cond: torch.Tensor, a: float, b: float, dtype) -> torch.Tensor:
    """``where(cond, a, b)`` for two scalars, in ``dtype`` (torch.where of
    two Python scalars would give the default float32).  The scalars are
    filled on the device: a tensor made from host data is a copy that waits
    for the card."""
    return torch.where(cond, torch.full((), a, dtype=dtype, device=cond.device),
                       torch.full((), b, dtype=dtype, device=cond.device))


def _edge_conductance_boundary(geom: Geometry, state: SimState, params: PhysParams,
                               rows=None):
    """Per-edge conductance: high_G iff (metal,metal) or (neutral vacancy,
    neutral vacancy); [B, N, max_nn] for a batched state.  ``rows``
    (``parallel.sharding._Rows``): the whole state's conductances at that
    rank's rows only."""
    elem = state.element.long()
    safe = safe_index(geom.neigh_idx) if rows is None else rows.win_safe
    own = slice(None) if rows is None else rows.sl
    metal = geom.metal_mask_table[elem]
    cvac = (state.element == int(Element.VACANCY)) & (state.charge == 0)
    high = ((metal[..., own, None] & metal[..., safe])
            | (cvac[..., own, None] & cvac[..., safe]))
    g = _select(high, params.high_G, params.low_G, params.dtype)
    return torch.where(geom.neigh_valid, g, 0.0)


def _edge_conductance_cb(geom: Geometry, state: SimState, params: PhysParams, slab=None):
    """Per-edge conductance of the CB-edge network: high_G iff either
    endpoint is metal (src/potential_solver.cpp:58-70).  ``slab``: the
    neighbours' metal flags through its halo window."""
    metal = geom.metal_mask_table[state.element.long()]
    if slab is None:
        metal_nb = metal[safe_index(geom.neigh_idx)]
    else:
        metal_nb = slab.gather(metal.to(torch.int32)) > 0
    g = _select(metal[:, None] | metal_nb, params.high_G, params.low_G, params.dtype)
    return torch.where(geom.neigh_valid, g, 0.0)


class _OneDevice:
    """The sums of a solve whose vectors are whole on one device; a slab of a
    mesh (``parallel.halo_superstep._Shard``) gives the same methods summed
    over its ranks."""

    @staticmethod
    def rows(x):
        return x

    @staticmethod
    def psum(t, op="sum"):
        return t

    pdot = staticmethod(torch.dot)


def _dirichlet_system(geom: Geometry, edge_g, v_left: float, v_right: float, masks,
                      nbr=None):
    """The Dirichlet-eliminated interior system of the conductances
    ``edge_g`` ([N, max_nn], or [B, N, max_nn] for B replicas): the
    right-hand side, the operator, its diagonal, the off-diagonal values and
    the Jacobi diagonal (1 on the contacts).  ``nbr(x)``: a per-site
    tensor's values at each row's neighbour slots (any value at pad slots,
    where ``edge_g`` is 0); by default indexed at ``geom.neigh_idx``."""
    is_left, is_right, interior = masks
    dtype = edge_g.dtype
    diag = edge_g.sum(dim=-1)
    if nbr is None:
        safe = safe_index(geom.neigh_idx)
        nbr = lambda x: x[..., safe]  # noqa: E731
    nb_boundary_v = torch.where(
        nbr(is_left), v_left, _select(nbr(is_right), v_right, 0.0, dtype)
    )
    # RHS: b_i = sum_{j in boundary} G_ij * V_j   (Dirichlet elimination)
    b = torch.where(interior, (edge_g * nb_boundary_v).sum(dim=-1), 0.0)
    # interior operator: (L_II x)_i = diag_i x_i - sum_{j interior} G_ij x_j
    neg_vals = -edge_g * nbr(interior)

    def matvec(x):
        xm = torch.where(interior, x, 0.0)
        # ops.ell.ell_matvec's arithmetic
        return torch.where(interior, diag * xm + (neg_vals * nbr(xm)).sum(dim=-1), 0.0)

    return b, matvec, diag, neg_vals, torch.where(interior, diag, 1.0)


def _dirichlet_laplace_solve(
    geom: Geometry,
    edge_g: torch.Tensor,
    v_left: float,
    v_right: float,
    x0: torch.Tensor,
    tol: float,
    maxiter: int,
    masks=None,
    deflate_slabs: int = 0,
    want_residual: bool = False,
    slab=None,
):
    """Graph-Laplacian solve with Dirichlet contacts on ``masks`` = (left,
    right, interior), by default the boundary network's.  Returns the
    full-length potential and the CG result (plus the TRUE residual and the
    right-hand side with ``want_residual``).

    ``slab`` (``parallel.halo_superstep._Shard``): the vectors are one
    rank's slab of a mesh, the neighbours read through its halo window
    (``slab.gather``) and every sum of the solve taken over the ranks
    (``slab.pdot``, ``slab.psum`` of ``slab.rows``)."""
    is_left, is_right, interior = masks or (
        geom.bp_left_mask, geom.bp_right_mask, geom.bp_interior_mask
    )
    red = _OneDevice if slab is None else slab

    dtype = edge_g.dtype
    b, matvec, diag, neg_vals, pre_diag = _dirichlet_system(
        geom, edge_g, v_left, v_right, (is_left, is_right, interior),
        nbr=None if slab is None else slab.gather)
    x0_int = torch.where(interior, x0, 0.0)

    if deflate_slabs > 0:
        # A-DEF2 x-slab deflation in the Jacobi-scaled metric: the slab
        # basis captures the Laplacian's smooth long-range error modes
        # (kappa ~ high_G/low_G = 1e8); criterion "r" on the scaled system
        # is the reference's rule on its symmetric-scaled system
        # (src/iterative_solvers_gpu.cu:309-480).
        K = deflate_slabs
        ax = geom.coords[:, 0].to(dtype)
        big = torch.finfo(dtype).max
        xmin = red.psum(torch.where(interior, ax, big).min(), op="min")
        xmax = red.psum(torch.where(interior, ax, -big).max(), op="max")
        agg_x = torch.clamp(
            ((ax - xmin) / torch.clamp(xmax - xmin, min=1e-30) * K).to(torch.int32),
            0, K - 1,
        )
        agg = torch.where(interior, agg_x, K).long()      # contacts: no aggregate
        Zm = torch.nn.functional.one_hot(agg, K + 1)[:, :K].to(dtype)   # [N, K]

        LZ = pre_diag[:, None] * Zm
        Zm_nb = _slot_rows(Zm, geom, slab)
        for s in range(neg_vals.shape[1]):
            LZ = LZ + neg_vals[:, s:s + 1] * Zm_nb(s)
        LZ = torch.where(interior[:, None], LZ, 0.0)
        rows = red.rows
        E = red.psum(rows(Zm).T @ rows(LZ))
        E_inv = invert_coarse(E)
        ds = torch.sqrt(torch.where(interior & (diag > 0), diag, 1.0))
        dsi = 1.0 / ds
        Zhat = ds[:, None] * Zm
        W = dsi[:, None] * LZ

        def esolve(a):
            c = E_inv @ a
            return c + E_inv @ (a - E @ c)

        b_s = dsi * b
        y0 = ds * x0_int
        y0 = (y0 - Zhat @ esolve(red.psum(rows(W).T @ rows(y0)))
              + Zhat @ esolve(red.psum(rows(Zhat).T @ rows(b_s))))
        res = cg_solve(
            lambda y: dsi * matvec(dsi * y), b_s, x0=y0,
            precond=lambda r: r + Zhat @ esolve(
                red.psum(rows(Zhat).T @ rows(r) - rows(W).T @ rows(r))),
            tol=tol, maxiter=maxiter, criterion="r", dot=red.pdot,
        )
        res = res._replace(x=res.x * dsi)
    else:
        res = cg_solve(matvec, b, x0=x0_int, diag=pre_diag, tol=tol, maxiter=maxiter,
                       dot=red.pdot)

    phi = torch.where(
        is_left, v_left, torch.where(is_right, v_right, res.x)
    ).to(dtype)
    if want_residual:
        # TRUE residual of the returned solution: the anchor the incremental
        # shortcut updates exactly
        r_true = torch.where(interior, b - matvec(res.x), 0.0)
        return phi, res, r_true, b
    return phi, res


def _slot_rows(Z, geom, slab):
    """``s -> Z``'s rows at each row's neighbour slot ``s`` ([N, K]; a slab's
    through one exchange of its halo window)."""
    if slab is None:
        safe = safe_index(geom.neigh_idx)
        return lambda s: Z[safe[:, s]]
    Zw = slab.window(Z)
    return lambda s: Zw[slab.win_safe[:, s]]


def _incremental_boundary_residual(
    geom: Geometry, params: PhysParams, state: SimState, cvac, changed,
    v_left: float, v_right: float,
):
    """Exact O(changed rows) update of the stored boundary residual and RHS.

    Only rows touching a site whose neutral-vacancy membership flipped (the
    changed sites and their neighbours) change; they are recomputed with the
    arithmetic of :func:`_dirichlet_laplace_solve` and the plain-r criterion
    re-evaluated.  Returns ``(r_new, b_new, converged)``; ``converged`` is
    False when the changed set overflows ``boundary_delta_cap``."""
    dtype = params.dtype
    cap = int(params.boundary_delta_cap)
    ch_idx, n_changed_t = nonzero_fixed(changed, cap, fill_value=0)
    n_changed = int(n_changed_t)
    fits = n_changed <= cap
    ch = ch_idx[:min(n_changed, cap)].long()

    # affected rows = changed sites + their neighbours, ascending
    aff = torch.zeros(geom.N, dtype=torch.bool, device=geom.device)
    aff[ch] = True
    nb = geom.neigh_idx[ch]
    aff[nb[nb >= 0].long()] = True
    rows = torch.nonzero(aff).reshape(-1)

    metal = geom.metal_mask_table[state.element.long()]
    interior = geom.bp_interior_mask
    xm = torch.where(interior, state.potential_boundary, 0.0)

    rnb = geom.neigh_idx[rows]
    rvalid = rnb >= 0
    rsafe = rnb.clamp(min=0).long()
    hi = (metal[rows][:, None] & metal[rsafe]) | (cvac[rows][:, None] & cvac[rsafe])
    g = torch.where(rvalid, _select(hi, params.high_G, params.low_G, dtype), 0.0)
    nbv = torch.where(
        geom.bp_left_mask[rsafe], v_left,
        _select(geom.bp_right_mask[rsafe], v_right, 0.0, dtype),
    )
    int_rows = interior[rows]
    b_rows = torch.where(int_rows, (g * nbv).sum(dim=1), 0.0)
    diag_rows = g.sum(dim=1)
    y_rows = diag_rows * xm[rows] - (g * interior[rsafe] * xm[rsafe]).sum(dim=1)
    r_rows = torch.where(int_rows, b_rows - y_rows, 0.0)

    r_new = state.boundary_r.clone()
    b_new = state.boundary_b.clone()
    r_new[rows] = r_rows
    b_new[rows] = b_rows

    rn2 = torch.dot(r_new, r_new)
    ref = torch.sqrt(torch.dot(b_new, b_new))
    thresh = params.solver_tol * torch.where(ref > 0, ref, 1.0)
    return r_new, b_new, fits and bool(rn2 <= thresh * thresh)


def solve_boundary_potential(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, rows=None,
) -> Tuple[SimState, dict]:
    """Update ``potential_boundary``: contacts at -Vd/2 (left) and +Vd/2
    (right) (src/potential_solver.cpp:311-319).

    Two exact shortcuts, decided as the JAX package decides them:
      * neutral-vacancy set and Vd unchanged since the previous solve: the
        previous potential is the solution (no assembly, no CG);
      * with ``boundary_incremental`` and the Jacobi solve: the stored TRUE
        residual is updated on the affected rows only, and if the warm
        solution still meets the tolerance the solve is skipped.

    ``rows`` (``parallel.sharding._Rows``): the state is whole on every rank
    of a mesh (the replicated decomposition).  The shortcuts are decided
    alike on every rank from the whole state; a solve assembles this rank's
    rows and runs over the ranks (see :func:`_dirichlet_laplace_solve`), and
    the potential, the true residual and the right-hand side are made whole
    by one all-gather."""
    dtype = params.dtype
    Vd = float(torch.tensor(Vd, dtype=dtype))
    elem = state.element
    cvac = (elem == int(Element.VACANCY)) & (state.charge == 0)
    changed = cvac != state.cvac_prev
    same_vd = Vd == state.Vd_prev
    vl = float(torch.tensor(-Vd / 2.0, dtype=dtype))
    vr = float(torch.tensor(Vd / 2.0, dtype=dtype))
    inc_on = params.boundary_incremental and params.boundary_precond == "jacobi"

    def solve():
        edge_g = _edge_conductance_boundary(geom, state, params, rows)
        phi, res, r_true, b = _dirichlet_laplace_solve(
            geom if rows is None else rows.geom, edge_g, vl, vr,
            x0=state.potential_boundary if rows is None else state.potential_boundary[rows.sl],
            tol=params.solver_tol, maxiter=params.solver_maxiter,
            deflate_slabs=(params.coarse_slabs
                           if params.boundary_precond == "deflated" else 0),
            want_residual=True, slab=rows,
        )
        if rows is not None:
            phi, r_true, b = rows.whole(phi, r_true, b)
        return phi, res.iters, r_true, b, res.converged

    if same_vd and not bool(changed.any()):
        phi, iters, r, b, conv = (state.potential_boundary, 0,
                                  state.boundary_r, state.boundary_b, True)
    elif inc_on:
        r_inc, b_inc, inc_conv = _incremental_boundary_residual(
            geom, params, state, cvac, changed, vl, vr
        )
        if same_vd and inc_conv:
            phi, iters, r, b, conv = state.potential_boundary, 0, r_inc, b_inc, True
        else:
            phi, iters, r, b, conv = solve()
    else:
        phi, iters, r, b, conv = solve()

    new_state = replace(
        state, potential_boundary=phi, cvac_prev=cvac, Vd_prev=Vd,
        boundary_r=r, boundary_b=b,
    )
    # boundary_converged: the CG's own flag (True on the skip paths), which
    # the engine's chunked cold solve loops on
    return new_state, {"cg_iters_boundary": iters, "boundary_converged": conv}


def _incremental_boundary_residual_batched(
    geom: Geometry, params: PhysParams, states: SimState, cvac, changed,
    v_left: float, v_right: float,
):
    """:func:`_incremental_boundary_residual` of B replicas on the device:
    each replica's changed sites compacted to ``boundary_delta_cap`` slots,
    the rows they touch (a changed site and its neighbours, [B, cap *
    (max_nn + 1)], a row touched twice computed twice alike) recomputed with
    its arithmetic and scattered into the stored residual and RHS, so
    replica b's are its single update's; ``converged`` [B] with the same
    rule (a changed set over the cap never converges).  No host read."""
    dtype = params.dtype
    cap = int(params.boundary_delta_cap)
    B, N = changed.shape
    ch_idx, n_changed = nonzero_fixed_batched(changed, cap, fill_value=0)
    ch = ch_idx.long()
    ch_ok = torch.arange(cap, device=geom.device) < n_changed[:, None]
    rows = torch.cat([ch[..., None], geom.neigh_idx[ch].long()], dim=-1)   # [B, cap, m+1]
    row_ok = (ch_ok[..., None] & (rows >= 0)).reshape(B, -1)
    rows = rows.clamp(min=0).reshape(B, -1)

    def at(x, idx):     # x [B, N] at per-replica indices idx [B, ...]
        return torch.gather(x, 1, idx.reshape(B, -1)).reshape(idx.shape)

    metal = geom.metal_mask_table[states.element.long()]
    interior = geom.bp_interior_mask
    xm = torch.where(interior, states.potential_boundary, 0.0)

    rnb = geom.neigh_idx[rows]
    rvalid = rnb >= 0
    rsafe = rnb.clamp(min=0).long()
    hi = ((at(metal, rows)[..., None] & at(metal, rsafe))
          | (at(cvac, rows)[..., None] & at(cvac, rsafe)))
    g = torch.where(rvalid, _select(hi, params.high_G, params.low_G, dtype), 0.0)
    nbv = torch.where(
        geom.bp_left_mask[rsafe], v_left,
        _select(geom.bp_right_mask[rsafe], v_right, 0.0, dtype),
    )
    int_rows = interior[rows]
    b_rows = torch.where(int_rows, (g * nbv).sum(dim=-1), 0.0)
    diag_rows = g.sum(dim=-1)
    y_rows = diag_rows * at(xm, rows) - (g * interior[rsafe] * at(xm, rsafe)).sum(dim=-1)
    r_rows = torch.where(int_rows, b_rows - y_rows, 0.0)

    # rows not touched go to a dropped column N
    dst = torch.where(row_ok, rows, N)
    pad = states.boundary_r.new_zeros(B, 1)
    r_new = torch.cat([states.boundary_r, pad], 1).scatter_(1, dst, r_rows)[:, :N]
    b_new = torch.cat([states.boundary_b, pad], 1).scatter_(1, dst, b_rows)[:, :N]
    rn2 = rowdot(r_new, r_new)
    ref = torch.sqrt(rowdot(b_new, b_new))
    thresh = params.solver_tol * torch.where(ref > 0, ref, 1.0)
    return r_new, b_new, (n_changed <= cap) & (rn2 <= thresh * thresh)


def solve_boundary_potential_batched(
    geom: Geometry, params: PhysParams, states: SimState, Vd: float,
    cg_ws: Optional[Workspace] = None,
) -> Tuple[SimState, dict]:
    """:func:`solve_boundary_potential` of B replicas.  The exact skip, the
    incremental residual and the solve are chosen per replica on the device
    (masks), and the replicas that need a solve run one batched CG; the
    others keep their field.  Metrics are [B] tensors.

    Without ``cg_ws`` (run eagerly): one read for all replicas says whether
    any solves at all (no assembly and no CG when none does), the CG is
    :func:`cg_solve_batched` (a read a chunk of iterations), and with
    ``boundary_precond = "deflated"`` the replicas that need a solve run the
    single deflated solve one by one (one read of the mask).

    With ``cg_ws`` (the buffers of ``ops.boundary_cg``, made before a graph
    capture) nothing is read: the system is assembled every step and the CG
    is one device loop (``ops.boundary_cg.cg_solve_device``), which runs no
    iteration when no replica solves; the deflated solve raises."""
    dtype = params.dtype
    Vd = _as_dtype(Vd, dtype)   # on the host: a captured body reads nothing
    if cg_ws is not None and params.boundary_precond != "jacobi":
        raise ValueError("a captured superstep runs the Jacobi boundary CG; "
                         f"boundary_precond={params.boundary_precond!r} runs eagerly")
    cvac = (states.element == int(Element.VACANCY)) & (states.charge == 0)
    changed = cvac != states.cvac_prev
    same_vd = states.Vd_prev == Vd
    vl, vr = _as_dtype(-Vd / 2.0, dtype), _as_dtype(Vd / 2.0, dtype)
    skip = same_vd & ~changed.any(dim=-1)
    keep = torch.zeros_like(skip)
    r_keep, b_keep = states.boundary_r, states.boundary_b
    if params.boundary_incremental and params.boundary_precond == "jacobi":
        r_inc, b_inc, inc_conv = _incremental_boundary_residual_batched(
            geom, params, states, cvac, changed, vl, vr)
        keep = ~skip & same_vd & inc_conv
        r_keep = torch.where(skip[:, None], states.boundary_r, r_inc)
        b_keep = torch.where(skip[:, None], states.boundary_b, b_inc)
    solve = ~(skip | keep)
    new_states = replace(
        states, cvac_prev=cvac, Vd_prev=torch.full_like(states.Vd_prev, Vd),
        boundary_r=r_keep, boundary_b=b_keep)
    if cg_ws is None and not bool(solve.any()):
        # one read for all replicas: no assembly and no CG when none solves
        return new_states, {"cg_iters_boundary": torch.zeros_like(solve, dtype=torch.int64),
                            "boundary_converged": torch.ones_like(solve)}

    edge_g = _edge_conductance_boundary(geom, states, params)
    masks = (geom.bp_left_mask, geom.bp_right_mask, geom.bp_interior_mask)
    interior = geom.bp_interior_mask
    if params.boundary_precond == "deflated":
        phi, iters = states.potential_boundary.clone(), torch.zeros_like(states.Vd_prev,
                                                                          dtype=torch.int64)
        r, b = r_keep.clone(), b_keep.clone()
        conv = torch.ones_like(skip)
        for k in torch.nonzero(solve).reshape(-1).tolist():
            phi[k], res, r[k], b[k] = _dirichlet_laplace_solve(
                geom, edge_g[k], vl, vr, x0=states.potential_boundary[k],
                tol=params.solver_tol, maxiter=params.solver_maxiter,
                deflate_slabs=params.coarse_slabs, want_residual=True)
            iters[k], conv[k] = res.iters, res.converged
    else:
        b_sys, matvec, diag, neg_vals, pre_diag = _dirichlet_system(geom, edge_g, vl, vr,
                                                                    masks)
        x0 = torch.where(interior, states.potential_boundary, 0.0)
        if cg_ws is None:
            res = cg_solve_batched(matvec, b_sys, x0, pre_diag, tol=params.solver_tol,
                                   maxiter=params.solver_maxiter, active=solve)
        else:
            res = cg_solve_device((diag, neg_vals, geom.neigh_idx, interior), b_sys, x0,
                                  pre_diag, params.solver_tol, params.solver_maxiter, solve,
                                  cg_ws)
        phi_s = torch.where(geom.bp_left_mask, vl,
                            torch.where(geom.bp_right_mask, vr, res.x)).to(dtype)
        r_true = torch.where(interior, b_sys - matvec(res.x), 0.0)
        s2 = solve[:, None]
        phi = torch.where(s2, phi_s, states.potential_boundary)
        r = torch.where(s2, r_true, r_keep)
        b = torch.where(s2, b_sys, b_keep)
        iters = torch.where(solve, res.iters, 0)
        conv = solve.logical_not() | res.converged

    return (replace(new_states, potential_boundary=phi, boundary_r=r, boundary_b=b),
            {"cg_iters_boundary": iters, "boundary_converged": conv})


def solve_cb_edge(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, slab=None,
) -> Tuple[SimState, dict]:
    """Update ``CB_edge`` [J]: contacts at +q*Vd/2 (left), -q*Vd/2 (right).
    The linear solve runs in volts and the result is scaled by eV_to_J, as
    the reference's GPU path does (src/potential_solver_gpu.cu:634-674).
    ``slab`` (``parallel.halo_superstep._Shard``): the state is one rank's
    slab, solved over the ranks (see :func:`_dirichlet_laplace_solve`)."""
    dtype = params.dtype
    edge_g = _edge_conductance_cb(geom, state, params, slab)
    vl = float(torch.tensor(Vd / 2.0, dtype=dtype))
    vr = float(torch.tensor(-Vd / 2.0, dtype=dtype))
    phi, res = _dirichlet_laplace_solve(
        geom, edge_g, vl, vr,
        x0=state.CB_edge / C.EV_TO_J,
        tol=params.solver_tol, maxiter=params.solver_maxiter,
        masks=(geom.left_mask, geom.right_mask, geom.interior_mask),
        deflate_slabs=(params.coarse_slabs
                       if params.boundary_precond == "deflated" else 0),
        slab=slab,
    )
    return (replace(state, CB_edge=phi * C.EV_TO_J),
            {"cg_iters_cb_edge": res.iters, "cb_edge_converged": res.converged})


# ----------------------------------------------------------------------------
# gridless Poisson (pairwise screened Coulomb), compacted charged set
# ----------------------------------------------------------------------------

def _exact_sweep(geom: Geometry, params: PhysParams, charge, cidx, counts, r0: int,
                 n_rows: int, block: int):
    """The exact-erfc sweep (``poisson_kernel = "jnp"``) in f32 (mixed) or the
    working dtype of the rows ``[r0, r0 + n_rows)`` over each replica's
    compacted charged list ``cidx`` [B, cap] (int32; its true count
    ``counts`` [B] on the device, the fill slots past it unread): [B,
    n_rows].  One launch of the exact kernel on the card, the port's PyTorch
    sweep (its plain version) on the CPU."""
    cdtype = torch.float32 if params.mixed else params.dtype
    coords = geom.coords.to(cdtype)
    ci = cidx.long()
    return poisson_exact_batched(
        coords[r0:r0 + n_rows], r0, coords[ci], cidx,
        torch.gather(charge, 1, ci).to(cdtype), counts,
        [_as_dtype(x, cdtype) for x in geom.lattice_host], _as_dtype(params.sigma, cdtype),
        _as_dtype(params.k, cdtype), geom.pbc, n_sweep=geom.N, block=block)


def poisson_gridless_compact(
    geom: Geometry, params: PhysParams, state: SimState, cap: int,
    block: int = 512, rows=None,
) -> Tuple[SimState, Union[int, torch.Tensor]]:
    """Charged-site-compacted Poisson.  Returns ``(state, n_charged)``; the
    engine checks n_charged <= cap (the exactness condition) and redoes the
    step with a grown cap on overflow.

    ``params.poisson_kernel == "pallas"`` runs the f32 A&S-erfc sweep (the
    pair-sweep kernel on the card, its plain version on the CPU; n_charged
    an int); ``"jnp"`` the exact-erfc sweep in f32 (mixed) or the working
    dtype (the exact kernel on the card, which reads the count there, and
    the port's PyTorch sweep on the CPU; n_charged a 0-d tensor on the
    device).  Either way the sweep runs over the charged sites actually
    present: the fill slots of the fixed-size buffer add exact zeros, so
    dropping them changes no bit of the result.

    ``rows`` (``parallel.sharding._Rows``): the state is whole on every rank
    of a mesh; every rank compacts the whole charged set, sweeps this rank's
    rows against it, and one all-gather makes the potential whole."""
    r0, n_rows = (0, geom.N) if rows is None else (rows.gstart, rows.S)
    if params.poisson_kernel == "pallas":
        cap = -(-cap // 8) * 8
        cidx, n_charged_t = nonzero_fixed(state.charge != 0, cap, fill_value=0)
        n_charged = int(n_charged_t)
        cidx = cidx[:min(n_charged, cap)]
        coords32 = geom.coords.to(torch.float32).contiguous()
        cq = state.charge[cidx.long()].to(torch.float32)
        inv_s, kq, lat_y, lat_z = kernel_scalars(
            params.sigma, params.k, geom.lattice_host, params.dtype)
        v = poisson_pairwise_rows(coords32, r0, n_rows, cidx, cq, inv_s, kq, lat_y, lat_z,
                                  geom.pbc)
    else:
        charge = state.charge[None]
        cidx, counts = nonzero_fixed_batched(charge != 0, cap, fill_value=0)
        v = _exact_sweep(geom, params, charge, cidx, counts, r0, n_rows, block)[0]
        n_charged = counts[0]
    if rows is not None:
        v = rows.whole(v)
    return replace(state, potential_charge=v.to(params.dtype)), n_charged


def poisson_gridless_compact_batched(
    geom: Geometry, params: PhysParams, states: SimState, cap: int, block: int = 512,
) -> Tuple[SimState, torch.Tensor]:
    """:func:`poisson_gridless_compact` of B replicas.  Returns ``(states,
    n_charged)`` with the true counts [B] on the device; a replica that
    overflows ``cap`` sweeps its first ``cap`` charged sites, as the single
    path does.  Either kernel is ONE launch for all replicas that reads the
    counts on the device: the batched pair sweep (``"pallas"``) or the exact
    sweep (``"jnp"``)."""
    if params.poisson_kernel == "pallas":
        cap = -(-cap // 8) * 8
    cidx, n_charged = nonzero_fixed_batched(states.charge != 0, cap, fill_value=0)
    if params.poisson_kernel == "pallas":
        coords32 = geom.coords.to(torch.float32).contiguous()
        cq = torch.gather(states.charge, 1, cidx.long()).to(torch.float32)
        inv_s, kq, lat_y, lat_z = kernel_scalars(
            params.sigma, params.k, geom.lattice_host, params.dtype)
        v = poisson_pairwise_batched(coords32, cidx, cq, n_charged, inv_s, kq, lat_y, lat_z,
                                     geom.pbc)
    else:
        v = _exact_sweep(geom, params, states.charge, cidx, n_charged, 0, geom.N, block)
    return replace(states, potential_charge=v.to(params.dtype)), n_charged
