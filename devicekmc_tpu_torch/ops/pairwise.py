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
plain version :func:`poisson_pairwise_plain` only for CPU tensors; it is
every row of :func:`poisson_pairwise_rows`, which sweeps a range of rows of
the same sweep (a rank's rows under the replicated decomposition), each row
bit-equal to the whole sweep's.  ``poisson_pairwise.launches`` counts the
launches of both (one device launch a call).
:func:`poisson_pairwise_batched` sweeps B replicas' charged lists
over the shared coordinates in one launch, each replica's count read on the
device and its charged set split as the single launch splits it, so replica
b's V is the single kernel's bit for bit; its plain version
:func:`poisson_pairwise_batched_plain` is the single plain sweep replica by
replica.

:func:`poisson_exact_batched` is the exact-erfc sweep of ``poisson_kernel =
"jnp"`` (``csrc/pairwise_exact.cu``, f32 or f64): B replicas' source lists
over the rows of a range in one launch, each replica's count read on the
device; its plain version :func:`poisson_exact_batched_plain` is
:func:`poisson_exact_plain`, the port's PyTorch sweep, of each replica's
first ``min(count, cap)`` sources.
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
                           lat_z, pbc: bool, block: int = 2048, row0: int = 0,
                           n_rows=None) -> torch.Tensor:
    """The plain PyTorch version, blocked over rows; same arguments as
    :func:`poisson_pairwise`, and of :func:`poisson_pairwise_rows` the rows
    ``[row0, row0 + n_rows)`` (default: every row)."""
    n = coords.shape[0] - row0 if n_rows is None else n_rows
    ci = charged_idx.long()
    cc = coords[ci]                                       # [C, 3]
    out = torch.empty(n, dtype=torch.float32, device=coords.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        xr = coords[row0 + r0:row0 + r1]
        dx = cc[None, :, 0] - xr[:, None, 0]
        dy = cc[None, :, 1] - xr[:, None, 1]
        dz = cc[None, :, 2] - xr[:, None, 2]
        if pbc:
            dy = dy - torch.round(dy / lat_y) * lat_y
            dz = dz - torch.round(dz / lat_z) * lat_z
        r = torch.sqrt(dx * dx + dy * dy + dz * dz) * 1e-10
        rows = torch.arange(row0 + r0, row0 + r1, device=coords.device)
        dead = (ci[None, :] == rows[:, None]) | (r <= 0.0)
        r = torch.where(dead, 1.0, r)
        contrib = charged_q[None, :] * _erfc_pos(r * inv_s) * kq / r
        out[r0:r1] = torch.where(dead, 0.0, contrib).sum(dim=1)
    return out


def _want_splits(blocks: int, n_sm: int) -> int:
    """The most splits of the charged set for ``blocks`` row blocks: enough
    for 24 blocks an SM."""
    return -(-_BLOCKS_PER_SM * n_sm // max(blocks, 1))


def poisson_grid(n: int, n_c: int, n_sm: int = _build.H100_SMS):
    """(row blocks, splits of the charged set) of the kernel's grid for n
    rows and n_c charged sites on a card of ``n_sm`` streaming
    multiprocessors: 256 rows a block; the charged set is split where the row
    blocks alone leave the card short of 24 blocks an SM (small blocks
    balance the SMs' work), into at most one split a 64 charged sites.  The
    batched kernel applies the same rule to each replica's count."""
    blocks = -(-n // (_THREADS * _ROWS))
    return blocks, max(1, min(_want_splits(blocks, n_sm), -(-n_c // _MIN_SPLIT)))


def batched_tickets(n: int, batch: int) -> int:
    """The int32 tickets the batched kernel draws for ``batch`` replicas of
    ``n`` rows: one a row block of each replica."""
    return batch * poisson_grid(n, 0)[0]


_ARGTYPES = {
    "dkmc_poisson_pairwise": "piiippiffffiipppp",
    "dkmc_poisson_pairwise_batched": "pipppiiffffiiippppp",
    "dkmc_poisson_exact": "piippppiiidddddiiippppp",
}


def _lib(symbol="dkmc_poisson_pairwise"):
    lib = "pairwise_exact" if symbol == "dkmc_poisson_exact" else "pairwise"
    fn = getattr(_build.load(lib), symbol)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
                 "d": ctypes.c_double}
        fn.argtypes = [kinds[c] for c in _ARGTYPES[symbol]]
        fn.restype = ctypes.c_int
    return fn


def poisson_pairwise(coords: torch.Tensor, charged_idx: torch.Tensor,
                     charged_q: torch.Tensor, inv_s: float, kq: float,
                     lat_y: float, lat_z: float, pbc: bool) -> torch.Tensor:
    """V [N] f32 from f32 ``coords`` [N,3] (contiguous), int32
    ``charged_idx`` [C] and f32 ``charged_q`` [C]; the scalars come from
    :func:`kernel_scalars`.  Every row of :func:`poisson_pairwise_rows`."""
    return poisson_pairwise_rows(coords, 0, coords.shape[0], charged_idx, charged_q, inv_s,
                                 kq, lat_y, lat_z, pbc)


def poisson_pairwise_rows(coords: torch.Tensor, row0: int, n_rows: int,
                          charged_idx: torch.Tensor, charged_q: torch.Tensor, inv_s: float,
                          kq: float, lat_y: float, lat_z: float, pbc: bool) -> torch.Tensor:
    """V [n_rows] f32 of the rows ``[row0, row0 + n_rows)`` of the sweep over
    every site of ``coords`` [N,3] (f32, contiguous), the charged sites
    ``charged_idx`` (int32, indices into ``coords``) with charges
    ``charged_q``: one rank's rows under the replicated decomposition
    (``parallel.sharding``), or every row (:func:`poisson_pairwise`).  The
    launch splits the charged set by the grid rule of the sweep over every
    site, so row k is row ``row0 + k`` of the whole sweep bit for bit.  For
    CPU tensors the plain version (:func:`poisson_pairwise_plain` with the
    same range).  Each launch adds one to ``poisson_pairwise.launches``."""
    if coords.device.type == "cpu":
        return poisson_pairwise_plain(coords, charged_idx, charged_q, inv_s, kq, lat_y,
                                      lat_z, pbc, row0=row0, n_rows=n_rows)
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
    if not 0 <= row0 <= n - n_rows:
        raise ValueError(f"poisson_pairwise: rows [{row0}, {row0 + n_rows}) outside the "
                         f"{n} sites")
    out = torch.empty(n_rows, dtype=torch.float32, device=coords.device)
    if n_rows == 0:
        return out
    n_c = charged_idx.shape[0]
    n_split = poisson_grid(n, n_c, _build.sm_count(coords.device))[1]
    blocks = poisson_grid(n_rows, 0)[0]
    part = torch.empty(n_split * blocks * _THREADS * _ROWS, dtype=torch.float32,
                       device=coords.device)
    cnt = _build.tickets(coords.device, blocks)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = _lib()(
        coords.data_ptr(), n, row0, n_rows, charged_idx.data_ptr(), charged_q.data_ptr(),
        n_c, inv_s, kq, lat_y, lat_z, int(bool(pbc)), n_split, part.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"poisson_pairwise kernel launch failed: cudaError {err}")
    poisson_pairwise.launches += 1
    return out


poisson_pairwise.launches = 0


def poisson_pairwise_batched_plain(coords, charged_idx, charged_q, counts, inv_s, kq,
                                   lat_y, lat_z, pbc: bool) -> torch.Tensor:
    """The plain version of :func:`poisson_pairwise_batched`:
    :func:`poisson_pairwise_plain` of each replica's first ``min(count,
    cap)`` charged sites."""
    cap = charged_idx.shape[1]
    return torch.stack([
        poisson_pairwise_plain(coords, charged_idx[b, :n], charged_q[b, :n], inv_s, kq,
                               lat_y, lat_z, pbc)
        for b, n in enumerate(min(int(c), cap) for c in counts.tolist())])


def poisson_pairwise_batched(coords: torch.Tensor, charged_idx: torch.Tensor,
                             charged_q: torch.Tensor, counts: torch.Tensor, inv_s: float,
                             kq: float, lat_y: float, lat_z: float, pbc: bool
                             ) -> torch.Tensor:
    """V [B, N] f32 of B replicas in one launch: f32 ``coords`` [N,3] shared,
    int32 ``charged_idx`` [B, cap] and f32 ``charged_q`` [B, cap] (each
    replica's charged list, filled past its count), int32 ``counts`` [B] on
    the device (the true counts; a replica sweeps its first ``min(count,
    cap)``); the scalars come from :func:`kernel_scalars`.  No count is read
    by the host."""
    if coords.device.type == "cpu":
        return poisson_pairwise_batched_plain(coords, charged_idx, charged_q, counts,
                                              inv_s, kq, lat_y, lat_z, pbc)
    if coords.device.type != "cuda":
        raise ValueError(f"poisson_pairwise_batched: unsupported device {coords.device}")
    if coords.dtype != torch.float32 or coords.dim() != 2 or coords.shape[1] != 3 \
            or not coords.is_contiguous():
        raise ValueError("poisson_pairwise_batched: coords must be a contiguous [N,3] "
                         "float32 tensor")
    B = charged_idx.shape[0]
    if charged_idx.dtype != torch.int32 or charged_q.dtype != torch.float32 \
            or counts.dtype != torch.int32 or charged_idx.dim() != 2 \
            or charged_q.shape != charged_idx.shape or tuple(counts.shape) != (B,) \
            or not (charged_idx.is_contiguous() and charged_q.is_contiguous()
                    and counts.is_contiguous()):
        raise ValueError("poisson_pairwise_batched: charged_idx int32 [B, cap], charged_q "
                         "float32 [B, cap] and counts int32 [B], contiguous")
    if any(t.device != coords.device for t in (charged_idx, charged_q, counts)):
        raise ValueError("poisson_pairwise_batched: all tensors on one device")
    n, cap = coords.shape[0], charged_idx.shape[1]
    out = torch.empty((B, n), dtype=torch.float32, device=coords.device)
    if n == 0 or B == 0:
        return out
    n_sm = _build.sm_count(coords.device)
    blocks, max_split = poisson_grid(n, cap, n_sm)
    part = torch.empty(B * max_split * blocks * _THREADS * _ROWS, dtype=torch.float32,
                       device=coords.device)
    cnt = _build.tickets(coords.device, batched_tickets(n, B))
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = _lib("dkmc_poisson_pairwise_batched")(
        coords.data_ptr(), n, charged_idx.data_ptr(), charged_q.data_ptr(),
        counts.data_ptr(), B, cap, inv_s, kq, lat_y, lat_z, int(bool(pbc)),
        _want_splits(blocks, n_sm), max_split, part.data_ptr(), cnt.data_ptr(),
        out.data_ptr(), _build.launch_counter(coords.device, "poisson_pairwise_batched"),
        stream)
    if err != 0:
        raise RuntimeError(f"poisson_pairwise_batched kernel launch failed: cudaError {err}")
    poisson_pairwise_batched.launches += 1
    return out


poisson_pairwise_batched.launches = 0


# ----------------------------------------------------------------------------
# the exact-erfc sweep (poisson_kernel = "jnp")
# ----------------------------------------------------------------------------

def poisson_exact_plain(coords, c_coords, c_ids, cq, lattice, sigma: float, k: float,
                        pbc: bool, block: int = 512, row0: int = 0):
    """Exact-erfc pair sweep in ``coords.dtype`` of the rows ``coords``
    (site ids ``row0``, ``row0 + 1``, ...) over the charged sites at
    ``c_coords`` (site ids ``c_ids``, charges ``cq``), blocked over rows; a
    pair of one site with itself adds nothing.  ``lattice``, ``sigma`` and
    ``k``: values of the dtype."""
    dtype = coords.dtype
    n = coords.shape[0]
    sig = torch.tensor(sigma, dtype=dtype)
    inv_s = 1.0 / (sig * torch.sqrt(torch.tensor(2.0, dtype=dtype)))
    kk = torch.tensor(k, dtype=dtype, device=coords.device)
    ci = c_ids
    out = torch.empty(n, dtype=dtype, device=coords.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        d = coords[r0:r1, None, :] - c_coords[None, :, :]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        if pbc:
            dy = dy - torch.round(dy / lattice[1]) * lattice[1]
            dz = dz - torch.round(dz / lattice[2]) * lattice[2]
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz) * 1e-10
        rows = torch.arange(row0 + r0, row0 + r1, device=coords.device)
        dead = (rows[:, None] == ci[None, :]) | (dist <= 0.0)
        dist = torch.where(dead, 1.0, dist)
        contrib = cq[None, :] * torch.special.erfc(dist * inv_s.item()) * kk * C.Q_C / dist
        out[r0:r1] = torch.where(dead, 0.0, contrib).sum(dim=1)
    return out


def exact_scalars(lattice, sigma: float, k: float, dtype: torch.dtype):
    """(inv_s, k, Q_C, lat_y, lat_z) as the kernel takes them: the values of
    ``dtype`` that :func:`poisson_exact_plain` computes with."""
    sig = torch.tensor(sigma, dtype=dtype)
    inv_s = 1.0 / (sig * torch.sqrt(torch.tensor(2.0, dtype=dtype)))
    return (float(inv_s), *(float(torch.tensor(x, dtype=dtype))
                            for x in (k, C.Q_C, lattice[1], lattice[2])))


def poisson_exact_batched_plain(rows, row0: int, src_coords, src_ids, src_q, counts,
                                lattice, sigma: float, k: float, pbc: bool,
                                block: int = 512) -> torch.Tensor:
    """The plain version of :func:`poisson_exact_batched`:
    :func:`poisson_exact_plain` of each replica's first ``min(count, cap)``
    sources (the counts read)."""
    cap = src_ids.shape[1]
    return torch.stack([
        poisson_exact_plain(rows, src_coords[b, :n], src_ids[b, :n].long(), src_q[b, :n],
                            lattice, sigma, k, pbc, block, row0)
        for b, n in enumerate(min(int(c), cap) for c in counts.tolist())])


def poisson_exact_batched(rows: torch.Tensor, row0: int, src_coords: torch.Tensor,
                          src_ids: torch.Tensor, src_q: torch.Tensor, counts: torch.Tensor,
                          lattice, sigma: float, k: float, pbc: bool, n_sweep=None,
                          block: int = 512) -> torch.Tensor:
    """V [B, n_rows] of the exact-erfc sweep in the rows' dtype (f32 or
    f64): ``rows`` [n_rows, 3] (contiguous; row j is the site ``row0 + j``)
    under B replicas' sources, the coordinates ``src_coords`` [B, cap, 3]
    and charges ``src_q`` [B, cap] in the rows' dtype and the site ids
    ``src_ids`` [B, cap] (int32), each list filled past its count; ``counts``
    [B] int32 on the device, the true counts (a replica sweeps its first
    ``min(count, cap)``).  ``lattice``, ``sigma`` and ``k`` are values of the
    dtype.  ``n_sweep``: the rows of the whole sweep when ``rows`` is a range
    of it (default: ``n_rows``); the launch splits each source list by that
    sweep's grid rule, so row j is row ``row0 + j`` of the whole sweep bit
    for bit.  No count is read by the host.  For CPU tensors the plain
    version (``block`` rows at a time).  Each launch adds one to
    ``poisson_exact_batched.launches``."""
    if rows.device.type == "cpu":
        return poisson_exact_batched_plain(rows, row0, src_coords, src_ids, src_q, counts,
                                           lattice, sigma, k, pbc, block)
    if rows.device.type != "cuda":
        raise ValueError(f"poisson_exact_batched: unsupported device {rows.device}")
    dt = rows.dtype
    if dt not in (torch.float32, torch.float64) or rows.dim() != 2 or rows.shape[1] != 3 \
            or not rows.is_contiguous():
        raise ValueError("poisson_exact_batched: rows must be a contiguous [n, 3] float32 "
                         "or float64 tensor")
    B, cap = src_ids.shape if src_ids.dim() == 2 else (-1, -1)
    if src_ids.dtype != torch.int32 or counts.dtype != torch.int32 \
            or src_coords.dtype != dt or src_q.dtype != dt \
            or tuple(src_coords.shape) != (B, cap, 3) or tuple(src_q.shape) != (B, cap) \
            or tuple(counts.shape) != (B,) \
            or not all(t.is_contiguous() for t in (src_coords, src_ids, src_q, counts)):
        raise ValueError("poisson_exact_batched: src_coords [B, cap, 3] and src_q [B, cap] "
                         "in the rows' dtype, src_ids int32 [B, cap] and counts int32 [B], "
                         "contiguous")
    if any(t.device != rows.device for t in (src_coords, src_ids, src_q, counts)):
        raise ValueError("poisson_exact_batched: all tensors on one device")
    n = rows.shape[0]
    n_sweep = n if n_sweep is None else n_sweep
    if row0 < 0 or n_sweep < n:
        raise ValueError(f"poisson_exact_batched: {n} rows from {row0} in a sweep of "
                         f"{n_sweep}")
    out = torch.empty((B, n), dtype=dt, device=rows.device)
    if n == 0 or B == 0:
        return out
    n_sm = _build.sm_count(rows.device)
    want = _want_splits(poisson_grid(n_sweep, 0, n_sm)[0], n_sm)
    max_split = max(1, min(want, -(-cap // _MIN_SPLIT)))
    blocks = poisson_grid(n, 0)[0]
    part = torch.empty(B * max_split * blocks * _THREADS * _ROWS, dtype=dt, device=rows.device)
    cnt = _build.tickets(rows.device, batched_tickets(n, B))
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = _lib("dkmc_poisson_exact")(
        rows.data_ptr(), n, row0, src_coords.data_ptr(), src_ids.data_ptr(),
        src_q.data_ptr(), counts.data_ptr(), B, cap, int(dt == torch.float64),
        *exact_scalars(lattice, sigma, k, dt), int(bool(pbc)), want, max_split,
        part.data_ptr(), cnt.data_ptr(), out.data_ptr(),
        _build.launch_counter(rows.device, "poisson_exact_batched"), stream)
    if err != 0:
        raise RuntimeError(f"poisson_exact_batched kernel launch failed: cudaError {err}")
    poisson_exact_batched.launches += 1
    return out


poisson_exact_batched.launches = 0
