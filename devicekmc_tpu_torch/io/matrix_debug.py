"""Solver-matrix debug dumps and cross-implementation validation, the
port's copy of ``devicekmc_tpu/io/matrix_debug.py`` (numpy, on the port's
records: the conductances come from ``physics.potential`` as tensors and are
read back to the host).

Mirrors the reference's matrix-validation toolchain so solver matrices can be
compared between this framework, the reference CPU path and the reference GPU
path:

* :func:`save_csr_format` — the 3-line values/columns/row_ptr text format of
  ``save_CSR_format`` (src/utils.cpp:301-352; interior block only),
* :func:`dump_csr_txt` — the 3-file ``csr{Values,RowPtr,ColIndices}_step#K.txt``
  format of ``dump_csr_matrix_txt`` (src/iterative_solvers_gpu.cu:142-169),
* :func:`check_matrix_match` — elementwise ``np.isclose`` comparison
  (postprocessing/check_matrix_match.py, atol 1e-10),
* :func:`boundary_matrix_dense` / :func:`cb_matrix_dense` — dense assembly of
  the two Laplace systems for oracle checks (the reference's
  ``check_sparse_dense_match``, src/iterative_solvers_gpu.cu:113-139).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..state import Geometry, PhysParams, SimState
from ..structure import Element


def ell_to_csr(
    neigh_idx: np.ndarray, vals: np.ndarray, diag: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert an ELL matrix (+diagonal) to CSR with sorted column indices."""
    n, m = neigh_idx.shape
    rows, cols, data = [], [], []
    for i in range(n):
        entries = [(i, diag[i])]
        for s in range(m):
            j = neigh_idx[i, s]
            if j >= 0 and vals[i, s] != 0:
                entries.append((int(j), vals[i, s]))
        entries.sort()
        for j, v in entries:
            rows.append(i)
            cols.append(j)
            data.append(v)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    for r in rows:
        row_ptr[r + 1] += 1
    row_ptr = np.cumsum(row_ptr)
    return np.asarray(data), np.asarray(cols, dtype=np.int64), row_ptr


def _dense_from_edges(geom: Geometry, edge_vals: np.ndarray) -> np.ndarray:
    """Dense symmetric matrix with off-diag -G and diag = row sums of G."""
    n = geom.N
    nb = geom.neigh_idx.cpu().numpy()
    K = np.zeros((n, n))
    for i in range(n):
        for s in range(nb.shape[1]):
            j = nb[i, s]
            if j >= 0:
                K[i, j] = -edge_vals[i, s]
    np.fill_diagonal(K, 0.0)
    K[np.arange(n), np.arange(n)] = -K.sum(axis=1)
    return K


def boundary_matrix_dense(
    geom: Geometry, params: PhysParams, state: SimState
) -> np.ndarray:
    """Dense K of the boundary-potential network (background_potential rule)."""
    from ..physics.potential import _edge_conductance_boundary

    edge_g = _edge_conductance_boundary(geom, state, params).cpu().numpy()
    return _dense_from_edges(geom, edge_g)


def cb_matrix_dense(
    geom: Geometry, params: PhysParams, state: SimState
) -> np.ndarray:
    """Dense K of the CB-edge network (setLaplacePotential rule)."""
    from ..physics.potential import _edge_conductance_cb

    edge_g = _edge_conductance_cb(geom, state, params).cpu().numpy()
    return _dense_from_edges(geom, edge_g)


def save_csr_format(
    K: np.ndarray, n_left: int, n_right: int, filename: str
) -> None:
    """Write the interior block of dense K in the reference's 3-line CSR text
    format (values / column indices / row_ptr)."""
    n = K.shape[0]
    block = K[n_left: n - n_right, n_left: n - n_right]
    vals, cols, row_ptr = [], [], [0]
    for i in range(block.shape[0]):
        for j in range(block.shape[1]):
            if block[i, j] != 0:
                vals.append(block[i, j])
                cols.append(j)
        row_ptr.append(len(vals))
    with open(filename, "w") as f:
        f.write(" ".join(f"{v:.17g}" for v in vals) + " \n")
        f.write(" ".join(str(c) for c in cols) + " \n")
        f.write(" ".join(str(r) for r in row_ptr) + "\n")


def dump_csr_txt(
    row_ptr: np.ndarray,
    col_indices: np.ndarray,
    values: np.ndarray,
    step: int,
    prefix: str = ".",
) -> None:
    """Write csrValues_step#K.txt / csrRowPtr_step#K.txt /
    csrColIndices_step#K.txt (reference GPU dump format)."""
    import os

    def w(name, arr, fmt):
        with open(os.path.join(prefix, f"{name}_step#{step}.txt"), "w") as f:
            f.write(" ".join(fmt(v) for v in arr) + " ")

    w("csrValues", values, lambda v: f"{v:.17g}")
    w("csrRowPtr", row_ptr, str)
    w("csrColIndices", col_indices, str)


def load_csr_txt(step: int, prefix: str = "."):
    import os

    def r(name, dtype):
        with open(os.path.join(prefix, f"{name}_step#{step}.txt")) as f:
            return np.array(f.read().split(), dtype=dtype)

    return (
        r("csrRowPtr", np.int64),
        r("csrColIndices", np.int64),
        r("csrValues", np.float64),
    )


def check_matrix_match(
    a_vals: np.ndarray, b_vals: np.ndarray, atol: float = 1e-10
) -> bool:
    """Elementwise comparison like postprocessing/check_matrix_match.py."""
    a_vals = np.asarray(a_vals, dtype=np.float64)
    b_vals = np.asarray(b_vals, dtype=np.float64)
    if a_vals.shape != b_vals.shape:
        print(f"shape mismatch: {a_vals.shape} vs {b_vals.shape}")
        return False
    close = np.isclose(a_vals, b_vals, atol=atol)
    if not close.all():
        bad = np.nonzero(~close)[0]
        print(f"{len(bad)} mismatched entries; first at {bad[0]}: "
              f"{a_vals[bad[0]]} vs {b_vals[bad[0]]}")
        return False
    return True
