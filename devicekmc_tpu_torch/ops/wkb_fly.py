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

Two bounds on the card: the data-sheet bound (about 30 FP32 operations a
pair, 38 under PBC, against 67 TFLOP/s; ``chip_smoke.py`` prints it beside the
times) and the issue bound (the compiled inner loop's instructions and
special-function instructions a pair against the SMs' issue slots;
``tools/fly_sass.py`` works it out from the disassembly).
The design, in the kernel source's header: a short pair value (launch
constants hoisted, approximate square roots and division for the value,
full-accuracy exp; which entries are exact zeros is decided with the plain
version's correctly rounded operations), column chunks of 32 that a warp leaves when their CB-edge range proves
every entry an exact zero (:func:`chunk_skip_plain` is that test in
PyTorch), a symmetric matvec over the upper-triangle tiles whose column sums
travel through the lanes of a warp, a matmat with the X tile read as float4,
and one launch a call: the partial sums of a strip are added in a fixed order
by the block that draws the strip's last integer ticket, so two calls give
the same bits.

:func:`wkb_fly_matvec`, :func:`wkb_fly_matmat` and :func:`wkb_fly_pdisp`
launch the kernels for CUDA tensors and take the plain versions (``*_plain``)
only for CPU tensors.  Each wrapper's ``launches`` counts its calls that
launched (one device launch each).  ``env`` is the dict of
``physics.current.wkb_env``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_TILE = 128
#: columns of a skip chunk (the lanes of a warp)
_CHUNK = 32
#: column-group widths the matmat kernel is built for
_MATMAT_KB = (4, 8, 24)
#: blocks per row tile of the matmat kernel, at most
_MATMAT_SPLIT = 16
#: tiles a streaming multiprocessor that the matvec's grid aims for
_TILES_PER_SM = 8


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


def chunk_skip_plain(cb_r, cb_c, ctol) -> torch.Tensor:
    """The kernels' skip test in PyTorch: [ceil(R/32), ceil(C/32)] bool, True
    where a warp of 32 rows leaves a chunk of 32 columns because every row's
    CB edge lies within ``ctol`` of the chunk's smallest and largest, in f32.
    Every entry of :func:`pair_vals_plain` in a skipped chunk is an exact 0:
    rounding is monotone, so ``|fl(a - b)| <= max(fl(a - min), fl(max - a))``."""
    cr, cc = cb_r.float(), cb_c.float()
    R, C = cr.shape[0], cc.shape[0]
    nr, nc = -(-R // _CHUNK), -(-C // _CHUNK)
    inf = float("inf")
    pad = nc * _CHUNK - C
    cmin = torch.nn.functional.pad(cc, (0, pad), value=inf).reshape(nc, _CHUNK).amin(dim=1)
    cmax = torch.nn.functional.pad(cc, (0, pad), value=-inf).reshape(nc, _CHUNK).amax(dim=1)
    mine = ((cr[:, None] - cmin[None, :]) <= ctol) & ((cmax[None, :] - cr[:, None]) <= ctol)
    mine = torch.nn.functional.pad(mine, (0, 0, 0, nr * _CHUNK - R), value=True)
    return mine.reshape(nr, _CHUNK, nc).all(dim=1)


def matvec_col_split(n: int, n_sm: int = _build.H100_SMS) -> int:
    """Warps-of-4 per tile of the matvec on a card of ``n_sm`` streaming
    multiprocessors: 4 while the upper triangle alone holds too few tiles to
    fill the card with one, else 1."""
    nt = -(-n // _TILE)
    return 4 if nt * (nt + 1) // 2 < 2 * _TILES_PER_SM * n_sm else 1


def matmat_split(n: int) -> int:
    """Blocks per row tile of the matmat (the column tiles are dealt to them
    round-robin): 16 where there are as many column tiles, the fastest on an
    H100 at 3,527 and at 24,768 atoms alike (fewer leave the card empty at
    the first width and balance the skipped chunks worse at the second, more
    lengthen the last block's sum over the slots)."""
    return min(-(-n // _TILE), _MATMAT_SPLIT)


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
    upper-triangle entry for its row and its column sum.  One device launch
    either way."""
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
             [_P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P, _P, _P, _P])
    err = fn(pos.data_ptr(), cb.data_ptr(), x.data_ptr(), n, *_scalars(env),
             int(bool(symmetric)), matvec_col_split(n, _build.sm_count(pos.device)),
             part.data_ptr(),
             _build.tickets(pos.device, nt).data_ptr(), y.data_ptr(),
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
    sweep over the pairs up to K = 24), else the widest; all groups run in
    one device launch."""
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
    nt, groups = -(-n // _TILE), -(-K // KB)
    n_split = matmat_split(n)
    part = torch.empty(n_split * nt * _TILE * groups * KB, dtype=torch.float32,
                       device=pos.device)
    fn = _fn("dkmc_wkb_fly_matmat",
             [_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P])
    err = fn(pos.data_ptr(), cb.data_ptr(), X.data_ptr(), n, K, KB, *_scalars(env),
             n_split, part.data_ptr(), _build.tickets(pos.device, nt * groups).data_ptr(),
             Y.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream)
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
             [_P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _F, _P, _P, _P, _P])
    err = fn(pos.data_ptr(), cb.data_ptr(), ms.data_ptr(), n, *_scalars(env),
             _vsgn(Vd), part.data_ptr(), _build.tickets(pos.device, nt).data_ptr(),
             row.data_ptr(), torch.cuda.current_stream(pos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkb_fly_pdisp kernel launch failed: cudaError {err}")
    wkb_fly_pdisp.launches += 1
    return row


wkb_fly_pdisp.launches = 0
