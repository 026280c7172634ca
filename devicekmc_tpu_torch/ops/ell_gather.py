"""ELL neighbour gather: kernel 1 of the port (``csrc/ell_gather.cu``).

Replaces the TPU kernel ``devicekmc_tpu/ops/ell_gather_pallas.py``
(``ell_gather_pallas``).  Gathers C per-site 32-bit channels at the
neighbour indices: ``out_c[r, s] = values_c[max(neigh_idx[r, s], 0)]``.  Bits
only: float32 and int32 channels pass unchanged, and pad slots hold site 0's
word, to be masked with ``neigh_valid`` downstream.

Bound on the card: bytes (the index stream in, C output streams out; the
per-site sources stay in L2).  See the kernel source for the design: four
slots a lane in warp tiles of 128 consecutive slots (one slot a lane for
short calls), two tiles in flight, evict-first streams, each block sweeping
one contiguous range of tiles with a grid of a few blocks an SM
(:func:`gather_grid`).

:func:`ell_gather` launches the kernel for CUDA tensors and takes the plain
version :func:`ell_gather_plain` only for CPU tensors.  ``ell_gather.launches``
counts kernel launches.  :func:`ell_gather_batched` gathers the channels of B
replicas of one geometry ([B, N] each) in one launch (its own count), the
index plan shared or one a replica; :func:`ell_gather_batched_plain` is the
single plain gather replica by replica.  :func:`ell_stream_copy` runs the kernel's loop
without the gather: a measurement aid, launched on no path, that gives the
streams' floor beside the gather.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build

MAX_CHANNELS = 2
_WORD_DTYPES = (torch.float32, torch.int32)
_THREADS = 512
_WARPS = _THREADS // 32
#: blocks of the grid a streaming multiprocessor, at most (fewer where the
#: kernel's registers leave room for fewer, :func:`resident_blocks`: 2 for two
#: channels on an H100); more blocks an SM keep more bytes in flight, fewer
#: keep fewer source windows in L1
GATHER_BLOCKS_PER_SM = 4


def gather_grid(n_pairs: int, n_sm: int, per_sm: int = GATHER_BLOCKS_PER_SM
                ) -> Tuple[int, int]:
    """(slots a lane, blocks) of the kernel's launch.  Four slots a lane
    (warp tiles of 128 slots) where the tiles give every warp of one block
    an SM work; one slot a lane below that (short calls, such as the rate
    table's compacted rows, are latency bound: four times the warps).
    ``per_sm`` blocks an SM, each sweeping one contiguous range of tiles, no
    more blocks than give each of their warps a tile, but at least one block
    an SM while there are tiles for them."""
    k = 4 if -(-n_pairs // 128) >= n_sm * _WARPS else 1
    tiles = -(-n_pairs // (32 * k))
    full = -(-tiles // _WARPS)
    return k, max(1, min(n_sm * per_sm, max(full, min(n_sm, tiles))))


def ell_gather_plain(neigh_idx: torch.Tensor, values: Sequence[torch.Tensor]
                     ) -> List[torch.Tensor]:
    """The plain PyTorch version: indexed loads at the clamped indices."""
    safe = neigh_idx.clamp(min=0).long()
    return [v[safe] for v in values]


def _fn(symbol, n_ptrs):
    fn = getattr(_build.load("ell_gather"), symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = ([p, ctypes.c_longlong, ctypes.c_int] + [p] * n_ptrs
                       + [ctypes.c_int, ctypes.c_int, p])
        fn.restype = ctypes.c_int
    return fn


def _check_idx(name, neigh_idx):
    if neigh_idx.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {neigh_idx.device}")
    if neigh_idx.dtype != torch.int32 or neigh_idx.dim() != 2 \
            or not neigh_idx.is_contiguous():
        raise ValueError(f"{name}: neigh_idx must be a contiguous 2-D int32 tensor")


_resident = {}


def resident_blocks(nch: int) -> int:
    """Blocks of the kernel for ``nch`` channels that one SM holds at once
    (the CUDA occupancy calculator: the kernel's registers decide)."""
    if nch not in _resident:
        fn = _build.load("ell_gather").dkmc_ell_gather_blocks_per_sm
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
        per_sm = fn(nch)
        if per_sm <= 0:
            raise RuntimeError(f"ell_gather: occupancy query failed ({per_sm})")
        _resident[nch] = per_sm
    return _resident[nch]


def launch_grid(n_pairs: int, nch: int, device) -> Tuple[int, int]:
    """(slots a lane, blocks) that :func:`ell_gather` launches for
    ``n_pairs`` pairs of ``nch`` channels on the card ``device``."""
    return gather_grid(n_pairs, _build.sm_count(device),
                       min(GATHER_BLOCKS_PER_SM, resident_blocks(nch)))


def _launch(name, fn, neigh_idx, ptrs, nch, grid):
    stream = torch.cuda.current_stream(neigh_idx.device).cuda_stream
    err = fn(neigh_idx.data_ptr(), neigh_idx.numel(), nch, *ptrs, *grid, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _gather(neigh_idx, values, grid):
    """The kernel's launch with ``grid`` = (slots a lane, blocks) (checked
    inputs, at least one pair); :func:`ell_gather` gives it
    :func:`launch_grid`."""
    outs = [torch.empty(neigh_idx.shape, dtype=v.dtype, device=v.device)
            for v in values]
    srcs = [v.data_ptr() for v in values] + [None] * (MAX_CHANNELS - len(values))
    dsts = [o.data_ptr() for o in outs] + [None] * (MAX_CHANNELS - len(outs))
    _launch("ell_gather", _fn("dkmc_ell_gather", 2 * MAX_CHANNELS), neigh_idx,
            srcs + dsts, len(values), grid)
    return outs


def ell_gather(neigh_idx: torch.Tensor, values: Sequence[torch.Tensor]
               ) -> List[torch.Tensor]:
    """Gather each [N] 32-bit tensor of ``values`` at ``neigh_idx`` ([R, M]
    int32, pad -1, entries < N).  Returns a list of [R, M] tensors of the
    input dtypes."""
    values = list(values)
    if neigh_idx.device.type == "cpu":
        return ell_gather_plain(neigh_idx, values)
    _check_idx("ell_gather", neigh_idx)
    if not 1 <= len(values) <= MAX_CHANNELS:
        raise ValueError(f"ell_gather: 1 to {MAX_CHANNELS} channels, got {len(values)}")
    for v in values:
        if v.device != neigh_idx.device or v.dim() != 1 or not v.is_contiguous() \
                or v.dtype not in _WORD_DTYPES:
            raise ValueError(
                "ell_gather: each channel must be a contiguous 1-D float32 or "
                f"int32 tensor on {neigh_idx.device}"
            )
    if neigh_idx.numel() == 0:
        return [torch.empty(neigh_idx.shape, dtype=v.dtype, device=v.device)
                for v in values]
    outs = _gather(neigh_idx, values,
                   launch_grid(neigh_idx.numel(), len(values), neigh_idx.device))
    ell_gather.launches += 1
    return outs


ell_gather.launches = 0


def ell_gather_batched_plain(neigh_idx: torch.Tensor, values: Sequence[torch.Tensor]
                             ) -> List[torch.Tensor]:
    """The plain version of :func:`ell_gather_batched`: :func:`ell_gather_plain`
    replica by replica."""
    values = list(values)
    per = [ell_gather_plain(neigh_idx if neigh_idx.dim() == 2 else neigh_idx[b],
                            [v[b] for v in values])
           for b in range(values[0].shape[0])]
    return [torch.stack([p[c] for p in per]) for c in range(len(values))]


def ell_gather_batched(neigh_idx: torch.Tensor, values: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """Gather each [B, N] 32-bit tensor of ``values`` (B replicas of a
    channel) at ``neigh_idx``: [R, M] int32 shared by the replicas, or [B, R,
    M] one plan a replica (pad -1, entries < N).  Returns a list of [B, R, M]
    tensors of the input dtypes; replica b is ``ell_gather`` of replica b's
    channels at its plan, bit for bit."""
    values = list(values)
    if neigh_idx.device.type == "cpu":
        return ell_gather_batched_plain(neigh_idx, values)
    if not 1 <= len(values) <= MAX_CHANNELS:
        raise ValueError(f"ell_gather_batched: 1 to {MAX_CHANNELS} channels, "
                         f"got {len(values)}")
    B, n_src = values[0].shape if values[0].dim() == 2 else (0, 0)
    shared = neigh_idx.dim() == 2
    if neigh_idx.device.type != "cuda" or neigh_idx.dtype != torch.int32 \
            or neigh_idx.dim() not in (2, 3) or not neigh_idx.is_contiguous() \
            or (not shared and neigh_idx.shape[0] != B):
        raise ValueError("ell_gather_batched: neigh_idx must be a contiguous int32 "
                         "[R, M] or [B, R, M] tensor on a CUDA device")
    for v in values:
        if v.device != neigh_idx.device or v.dim() != 2 or not v.is_contiguous() \
                or v.dtype not in _WORD_DTYPES or tuple(v.shape) != (B, n_src):
            raise ValueError(
                "ell_gather_batched: each channel must be a contiguous [B, N] float32 "
                f"or int32 tensor on {neigh_idx.device}, all of one shape")
    out_shape = (B,) + tuple(neigh_idx.shape[-2:])
    outs = [torch.empty(out_shape, dtype=v.dtype, device=v.device) for v in values]
    n_pairs = neigh_idx.shape[-2] * neigh_idx.shape[-1]
    if B == 0 or n_pairs == 0:
        return outs
    srcs = [v.data_ptr() for v in values] + [None] * (MAX_CHANNELS - len(values))
    dsts = [o.data_ptr() for o in outs] + [None] * (MAX_CHANNELS - len(outs))
    fn = _build.load("ell_gather").dkmc_ell_gather_batched
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, ll, i, p, p, p, p, i, i, i, ll, i, p, p]
        fn.restype = ctypes.c_int
    k, blocks = launch_grid(n_pairs, len(values), neigh_idx.device)
    err = fn(neigh_idx.data_ptr(), n_pairs, len(values), *srcs, *dsts, k, blocks, B, n_src,
             int(not shared), _build.launch_counter(neigh_idx.device, "ell_gather_batched"),
             torch.cuda.current_stream(neigh_idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_gather_batched kernel launch failed: cudaError {err}")
    ell_gather_batched.launches += 1
    return outs


ell_gather_batched.launches = 0


def ell_stream_copy(neigh_idx: torch.Tensor, nch: int) -> List[torch.Tensor]:
    """The gather kernel's loop with the gather left out: ``nch`` int32
    copies of ``neigh_idx`` (CUDA only, on :func:`ell_gather`'s grid).  It
    moves the index and output bytes that :func:`ell_gather` moves and
    reads no source: a measurement of the streams alone, launched on no
    path."""
    _check_idx("ell_stream_copy", neigh_idx)
    if not 1 <= nch <= MAX_CHANNELS:
        raise ValueError(f"ell_stream_copy: 1 to {MAX_CHANNELS} channels, got {nch}")
    outs = [torch.empty_like(neigh_idx) for _ in range(nch)]
    if neigh_idx.numel():
        dsts = [o.data_ptr() for o in outs] + [None] * (MAX_CHANNELS - nch)
        _launch("ell_stream_copy", _fn("dkmc_ell_stream_copy", MAX_CHANNELS), neigh_idx,
                dsts, nch, launch_grid(neigh_idx.numel(), nch, neigh_idx.device))
    return outs
