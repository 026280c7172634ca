"""On-the-fly WKB tunnel block products: kernels 4-7 of the port
(``csrc/wkb_fly.cu``).

Replaces the TPU kernels of ``devicekmc_tpu/ops/wkb_pallas.py``:
``wkb_fly_matvec`` (plain and symmetric form), ``wkb_fly_matmat`` and
``wkb_fly_pdisp`` (the forward-current dissipation row sums of the
site-resolved power, run once per transport solve with heating on).  The
metal x metal tunnel block ``T_cc`` of the blocked transport operator is
never stored: every entry is re-derived from the two atoms' positions and
conduction-band edges inside the product (negated WKB transmission,
trapezoidal or triangular barrier; eligible when ``|dE| > ctol`` and the pair
are not neighbours), in f32.

Bound on the card: operations (about 30 FP32 operations a pair, 38 under
PBC, with one exp, two square roots and a division).  See the kernel source
for the design.

:func:`wkb_fly_matvec`, :func:`wkb_fly_matmat` and :func:`wkb_fly_pdisp`
launch the kernels for CUDA tensors and take the plain versions (``*_plain``)
only for CPU tensors.  Each wrapper's ``launches`` counts its kernel launches.  ``env`` is the dict of
``physics.current.wkb_env``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_TILE = 128
#: column-group widths the matmat kernel is built for
_MATMAT_KB = (4, 8, 24)
#: blocks per row tile of the matmat kernel (column tiles dealt round-robin)
_MATMAT_SPLIT = 8


def pair_vals_plain(env, pos_r, cb_r, pos_c, cb_c) -> torch.Tensor:
    """Negated-transmission tile [R, C] between two point sets: the
    arithmetic of the TPU kernels' pair routine (``x**1.5`` as
    ``x*sqrt(x)``), in f32."""
    dx = pos_r[:, None, 0] - pos_c[None, :, 0]
    dy = pos_r[:, None, 1] - pos_c[None, :, 1]
    dz = pos_r[:, None, 2] - pos_c[None, :, 2]
    if env["pbc"]:
        ly, lz = env["lattice"][1], env["lattice"][2]
        dy = dy - torch.round(dy / ly) * ly
        dz = dz - torch.round(dz / lz) * lz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    abs_dE = torch.abs(cb_r[:, None] - cb_c[None, :])
    elig = (abs_dE > env["ctol"]) & ~(dist < env["nn"])
    safe = torch.where(elig, abs_dE, 1.0)
    s = env["prefac"] * (dist * 1e-10) / safe
    qV0 = torch.tensor(env["qV0"], dtype=torch.float32, device=pos_r.device)
    E2 = qV0 - safe
    e15 = qV0 * torch.sqrt(qV0)
    E2p = torch.where(E2 > 0, E2, 0.0)
    T = torch.where(
        E2 > 0,
        torch.exp(s * (e15 - E2p * torch.sqrt(E2p))),
        torch.where(E2 < 0, torch.exp(s * e15), 0.0),
    )
    return torch.where(elig, -T, 0.0)


def _row_chunk(n_cols: int) -> int:
    """Rows per chunk so that a chunk's [rows, n_cols] f32 intermediates stay
    near 64 MB each."""
    return max(8, (1 << 24) // max(n_cols, 1))


def wkb_fly_matmat_plain(pos, cb, X, env) -> torch.Tensor:
    """The plain PyTorch version of :func:`wkb_fly_matmat`, chunked over
    rows."""
    n = pos.shape[0]
    pos32, cb32, X32 = pos.float(), cb.float(), X.float()
    out = torch.empty((n, X.shape[1]), dtype=torch.float32, device=pos.device)
    step = _row_chunk(n)
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        out[r0:r1] = pair_vals_plain(env, pos32[r0:r1], cb32[r0:r1], pos32, cb32) @ X32
    return out


def wkb_fly_matvec_plain(pos, cb, x, env) -> torch.Tensor:
    """The plain PyTorch version of :func:`wkb_fly_matvec` (one function for
    both forms: the symmetric form computes the same sums)."""
    return wkb_fly_matmat_plain(pos, cb, x[:, None], env)[:, 0]


def _scalars(env):
    return (env["prefac"], env["qV0"], env["ctol"], env["nn"],
            env["lattice"][1], env["lattice"][2], int(bool(env["pbc"])))


def _check(name, pos, cb, X, ndim):
    if pos.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pos.device}")
    if pos.dtype != torch.float32 or pos.dim() != 2 or pos.shape[1] != 3 \
            or not pos.is_contiguous():
        raise ValueError(f"{name}: pos must be a contiguous [n,3] float32 tensor")
    n = pos.shape[0]
    if cb.dtype != torch.float32 or cb.shape != (n,) or not cb.is_contiguous():
        raise ValueError(f"{name}: cb must be a contiguous [n] float32 tensor")
    if X.dtype != torch.float32 or X.dim() != ndim or X.shape[0] != n \
            or not X.is_contiguous():
        raise ValueError(f"{name}: the operand must be contiguous float32 with n rows")
    if cb.device != pos.device or X.device != pos.device:
        raise ValueError(f"{name}: all tensors on one device")


def _fn(symbol, argtypes):
    fn = getattr(_build.load("wkb_fly"), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def wkb_fly_matvec(pos: torch.Tensor, cb: torch.Tensor, x: torch.Tensor, env,
                   symmetric: bool = True) -> torch.Tensor:
    """y = T_cc @ x without materialising T_cc.  pos [n,3], cb [n] (J),
    x [n], all f32; returns [n] f32.  ``symmetric=True`` uses every
    upper-triangle entry for its row and its column sum."""
    if pos.device.type == "cpu":
        return wkb_fly_matvec_plain(pos, cb, x, env)
    _check("wkb_fly_matvec", pos, cb, x, 1)
    n = pos.shape[0]
    y = torch.empty(n, dtype=torch.float32, device=pos.device)
    if n == 0:
        return y
    nt = -(-n // _TILE)
    part = torch.empty(nt * nt * _TILE, dtype=torch.float32, device=pos.device)
    fn = _fn("dkmc_wkb_fly_matvec",
             [_P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P])
    err = fn(pos.data_ptr(), cb.data_ptr(), x.data_ptr(), n, *_scalars(env),
             int(bool(symmetric)), part.data_ptr(), y.data_ptr(),
             torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkb_fly_matvec kernel launch failed: cudaError {err}")
    wkb_fly_matvec.launches += 1
    return y


wkb_fly_matvec.launches = 0


def wkb_fly_matmat(pos: torch.Tensor, cb: torch.Tensor, X: torch.Tensor, env,
                   KB: int | None = None) -> torch.Tensor:
    """Y = T_cc @ X for X [n, K] f32 (the deflation basis); the pair value is
    computed once per group of ``KB`` columns and contracted in FP32.  By
    default ``KB`` is the narrowest built width that holds all K columns (one
    sweep over the pairs up to K = 24), else the widest."""
    if pos.device.type == "cpu":
        return wkb_fly_matmat_plain(pos, cb, X, env)
    _check("wkb_fly_matmat", pos, cb, X, 2)
    n, K = X.shape
    if KB is None:
        KB = next((kb for kb in _MATMAT_KB if kb >= K), _MATMAT_KB[-1])
    if KB not in _MATMAT_KB:
        raise ValueError(f"wkb_fly_matmat: KB must be one of {_MATMAT_KB}")
    Y = torch.empty((n, K), dtype=torch.float32, device=pos.device)
    if n == 0 or K == 0:
        return Y
    n_split = min(_MATMAT_SPLIT, -(-n // _TILE))
    part = torch.empty(n_split * n * K, dtype=torch.float32, device=pos.device)
    fn = _fn("dkmc_wkb_fly_matmat",
             [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P])
    err = fn(pos.data_ptr(), cb.data_ptr(), X.data_ptr(), n, K, KB, *_scalars(env),
             n_split, part.data_ptr(), Y.data_ptr(),
             torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkb_fly_matmat kernel launch failed: cudaError {err}")
    wkb_fly_matmat.launches += 1
    return Y


wkb_fly_matmat.launches = 0


def _vsgn(Vd) -> float:
    """The sign of the bias as the kernels take it: -1.0, 0.0 or 1.0."""
    Vd = float(Vd)
    return float((Vd > 0) - (Vd < 0))


def wkb_fly_pdisp_plain(pos, cb, ms, Vd, env) -> torch.Tensor:
    """The plain PyTorch version of :func:`wkb_fly_pdisp`, chunked over rows:
    ``row[i] = sum_j [fwd] (-T_ij dM)(-dM)``, ``dM = ms_i - ms_j``, in f32."""
    n = pos.shape[0]
    pos32, cb32, ms32 = pos.float(), cb.float(), ms.float()
    vs = _vsgn(Vd)
    out = torch.empty(n, dtype=torch.float32, device=pos.device)
    step = _row_chunk(n)
    for r0 in range(0, n, step):
        r1 = min(r0 + step, n)
        vals = pair_vals_plain(env, pos32[r0:r1], cb32[r0:r1], pos32, cb32)
        dM = ms32[r0:r1, None] - ms32[None, :]
        I_cal = vals * dM
        fwd = ((I_cal < 0) & (vs > 0)) | ((I_cal > 0) & (vs < 0))
        out[r0:r1] = (torch.where(fwd, -I_cal, 0.0) * (-dM)).sum(dim=1)
    return out


def wkb_fly_pdisp(pos: torch.Tensor, cb: torch.Tensor, ms: torch.Tensor, Vd,
                  env) -> torch.Tensor:
    """The metal x metal rows of the forward-current dissipation sweep
    (``physics.current._pdisp_rows_cols`` on the on-the-fly block; the block
    is symmetric, so the row sums are all it needs).  pos [n,3], cb [n] (J),
    ms [n] (the atoms' shifted scaled potentials), all f32; only the sign of
    ``Vd`` enters.  Returns [n] f32."""
    if pos.device.type == "cpu":
        return wkb_fly_pdisp_plain(pos, cb, ms, Vd, env)
    _check("wkb_fly_pdisp", pos, cb, ms, 1)
    n = pos.shape[0]
    row = torch.empty(n, dtype=torch.float32, device=pos.device)
    if n == 0:
        return row
    nt = -(-n // _TILE)
    part = torch.empty(nt * nt * _TILE, dtype=torch.float32, device=pos.device)
    fn = _fn("dkmc_wkb_fly_pdisp",
             [_P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _F, _P, _P, _P])
    err = fn(pos.data_ptr(), cb.data_ptr(), ms.data_ptr(), n, *_scalars(env),
             _vsgn(Vd), part.data_ptr(), row.data_ptr(),
             torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkb_fly_pdisp kernel launch failed: cudaError {err}")
    wkb_fly_pdisp.launches += 1
    return row


wkb_fly_pdisp.launches = 0
