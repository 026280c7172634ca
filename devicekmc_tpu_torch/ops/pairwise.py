"""Gridless-Poisson pair sweep: kernel 2 of the port (``csrc/pairwise.cu``).

Replaces the TPU kernel ``devicekmc_tpu/ops/pairwise_pallas.py``
(``poisson_pairwise_pallas``).  For every site i, the screened-Coulomb
superposition over a compacted charged set, all in f32:

    V_i = sum_c q_c * erfc(r_ic / (sigma*sqrt2)) * k*e / r_ic

with the y/z minimum image under PBC (round half to even), the self pair and
r <= 0 skipped, and erfc by Abramowitz & Stegun 7.1.26.  The kernel skips a
pair when its squared distance is 0, which is the same rule.

Bound on the card: operations (about 30 FP32 operations a pair, one exp; the
compiled loop's issue bound in ``tools/fly_sass.py``).  See the kernel
source for the design; :func:`poisson_grid` is its grid rule.

:func:`poisson_pairwise` launches the kernel for CUDA tensors and takes the
plain version :func:`poisson_pairwise_plain` only for CPU tensors.
``poisson_pairwise.launches`` counts kernel launches (one device launch a
call).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import constants as C
from . import _build

#: threads a block of the kernel, and charged sites a tile
_THREADS = 128
#: rows a thread
_ROWS = 2
#: blocks a streaming multiprocessor that the grid aims for
_BLOCKS_PER_SM = 24
#: charged sites a split of the charged set takes at least
_MIN_SPLIT = 64

_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_P = 0.3275911


def kernel_scalars(sigma: float, k: float, lattice, dtype: torch.dtype):
    """(inv_s, kq, lat_y, lat_z) as f32 values, computed as the TPU kernel
    computes them: in the parameters' dtype, then rounded to f32."""
    dt = np.float32 if dtype == torch.float32 else np.float64
    inv_s = np.float32(dt(1.0) / (dt(sigma) * dt(np.sqrt(np.float32(2.0)))))
    kq = np.float32(dt(k) * dt(C.Q_C))
    return (float(inv_s), float(kq), float(np.float32(lattice[1])),
            float(np.float32(lattice[2])))


def _erfc_pos(x: torch.Tensor) -> torch.Tensor:
    """erfc for x >= 0 by Abramowitz & Stegun 7.1.26."""
    t = 1.0 / (1.0 + _P * x)
    poly = t * (_A[0] + t * (_A[1] + t * (_A[2] + t * (_A[3] + t * _A[4]))))
    return poly * torch.exp(-x * x)


def poisson_pairwise_plain(coords, charged_idx, charged_q, inv_s, kq, lat_y,
                           lat_z, pbc: bool, block: int = 2048) -> torch.Tensor:
    """The plain PyTorch version, blocked over rows; same arguments as
    :func:`poisson_pairwise`."""
    n = coords.shape[0]
    ci = charged_idx.long()
    cc = coords[ci]                                       # [C, 3]
    out = torch.empty(n, dtype=torch.float32, device=coords.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        xr = coords[r0:r1]
        dx = cc[None, :, 0] - xr[:, None, 0]
        dy = cc[None, :, 1] - xr[:, None, 1]
        dz = cc[None, :, 2] - xr[:, None, 2]
        if pbc:
            dy = dy - torch.round(dy / lat_y) * lat_y
            dz = dz - torch.round(dz / lat_z) * lat_z
        r = torch.sqrt(dx * dx + dy * dy + dz * dz) * 1e-10
        rows = torch.arange(r0, r1, device=coords.device)
        dead = (ci[None, :] == rows[:, None]) | (r <= 0.0)
        r = torch.where(dead, 1.0, r)
        contrib = charged_q[None, :] * _erfc_pos(r * inv_s) * kq / r
        out[r0:r1] = torch.where(dead, 0.0, contrib).sum(dim=1)
    return out


def poisson_grid(n: int, n_c: int, n_sm: int = _build.H100_SMS):
    """(row blocks, splits of the charged set) of the kernel's grid for n
    rows and n_c charged sites on a card of ``n_sm`` streaming
    multiprocessors: 256 rows a block; the charged set is split where the row
    blocks alone leave the card short of 24 blocks an SM (small blocks
    balance the SMs' work), into at most one split a 64 charged sites."""
    blocks = -(-n // (_THREADS * _ROWS))
    want = -(-_BLOCKS_PER_SM * n_sm // max(blocks, 1))
    return blocks, max(1, min(want, -(-n_c // _MIN_SPLIT)))


def _lib():
    lib = _build.load("pairwise")
    fn = lib.dkmc_poisson_pairwise
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, i, f, f, f, f, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def poisson_pairwise(coords: torch.Tensor, charged_idx: torch.Tensor,
                     charged_q: torch.Tensor, inv_s: float, kq: float,
                     lat_y: float, lat_z: float, pbc: bool) -> torch.Tensor:
    """V [N] f32 from f32 ``coords`` [N,3] (contiguous), int32
    ``charged_idx`` [C] and f32 ``charged_q`` [C]; the scalars come from
    :func:`kernel_scalars`."""
    if coords.device.type == "cpu":
        return poisson_pairwise_plain(coords, charged_idx, charged_q, inv_s, kq,
                                      lat_y, lat_z, pbc)
    if coords.device.type != "cuda":
        raise ValueError(f"poisson_pairwise: unsupported device {coords.device}")
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 3 \
            or not coords.is_contiguous():
        raise ValueError("poisson_pairwise: coords must be a contiguous [N,3] float32 tensor")
    if charged_idx.dtype != torch.int32 or charged_q.dtype != torch.float32 \
            or charged_idx.dim() != 1 or charged_q.shape != charged_idx.shape \
            or not (charged_idx.is_contiguous() and charged_q.is_contiguous()):
        raise ValueError("poisson_pairwise: charged_idx int32 [C] and charged_q "
                         "float32 [C], contiguous")
    if charged_idx.device != coords.device or charged_q.device != coords.device:
        raise ValueError("poisson_pairwise: all tensors on one device")
    n = coords.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=coords.device)
    if n == 0:
        return out
    n_c = charged_idx.shape[0]
    blocks, n_split = poisson_grid(n, n_c, _build.sm_count(coords.device))
    part = torch.empty(n_split * blocks * _THREADS * _ROWS, dtype=torch.float32,
                       device=coords.device)
    cnt = _build.tickets(coords.device, blocks)
    fn = _lib()
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = fn(coords.data_ptr(), n, charged_idx.data_ptr(), charged_q.data_ptr(),
             n_c, inv_s, kq, lat_y, lat_z, int(bool(pbc)), n_split, part.data_ptr(),
             cnt.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"poisson_pairwise kernel launch failed: cudaError {err}")
    poisson_pairwise.launches += 1
    return out


poisson_pairwise.launches = 0
