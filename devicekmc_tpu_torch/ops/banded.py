"""Static band product from the band's nonzeros: kernel 3 of the port
(``csrc/banded.cu``).

Replaces the TPU kernel ``devicekmc_tpu/ops/banded_pallas.py``
(``banded_matvec_pallas``):

    y[r*B + b] = sum_{k, j} C4[r, k, b, j] * xw[(r + k)*B + j]

``C4`` [R, m_pad, B, B], the JAX package's dense band blocks, holds the
static neighbour conductances of the blocked transport operator over
x-sorted atoms (``physics.current.build_banded_nb``).  The port stores only
its nonzeros (:class:`BandSlots`): each row ``i = r*B + b`` has slots, a
window offset ``k*B + j`` (uint16) and a value (f32, or bf16 under
``transport_bf16_inner``), in ascending offset order, laid out as a sliced
ELL (slices of 32 rows, each padded to its longest row rounded up to
``GROUP`` slots with offset 0 and value 0, slot-group-major; see the kernel
source).  ``xw`` [(R + m_pad - 1)*B] is the padded, permuted vector (f32);
the sums are f32, each row's in ascending slot order, a rounded multiply
then a rounded add: the kernel and :func:`banded_matvec_plain` are
bit-equal.

:func:`band_slots` makes the storage from a dense ``C4`` (the JAX package's
band, for the parity tests), :func:`band_dense` the dense blocks back;
``physics.current.build_banded_nb`` makes it from the atom graph with
:func:`slots_from_entries`, never holding ``C4``.

Bound on the card: bytes (the slots, the window once, the output).
:func:`banded_matvec` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors.  ``banded_matvec.launches`` counts
kernel launches.  :func:`banded_matvec_out` writes into a buffer of the
caller's on a given stream and counts its launches on the card too
(``_build.launch_counts``): the form the transport solve's device loop
captures into a WHILE body, where nothing may allocate.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build

_STORAGE = (torch.float32, torch.bfloat16)
#: rows a slice (a warp on the card, a lane a row) and slots a lane loads at
#: once (csrc/banded.cu kSlice, kGroup)
SLICE = 32
GROUP = 4
#: window offsets are uint16
MAX_WINDOW = 1 << 16


class BandSlots(NamedTuple):
    """The band's nonzeros as a sliced ELL: ``off`` int16 [E] (the bits of
    the uint16 window offsets), ``val`` [E] f32 or bf16, ``start`` int32
    [R*B/32 + 1] (the first element of each slice of 32 rows; slice s holds
    ``(start[s+1] - start[s]) / 32`` slots a row), ``shape`` (R, m_pad, B).
    Row ``i``'s slot ``j`` is element ``start[i // 32] + (j // GROUP) * 32 *
    GROUP + (i % 32) * GROUP + j % GROUP``."""
    off: torch.Tensor
    val: torch.Tensor
    start: torch.Tensor
    shape: tuple

    def to(self, device) -> "BandSlots":
        return BandSlots(self.off.to(device), self.val.to(device), self.start.to(device),
                         self.shape)


def slots_from_entries(row: torch.Tensor, off: torch.Tensor, val: torch.Tensor,
                       shape: tuple) -> BandSlots:
    """The :class:`BandSlots` of the entries ``val`` (in the storage type) at
    rows ``row`` and window offsets ``off`` (int64, any order; an entry
    repeated keeps its first value, an entry of value 0 is no slot), on
    their device."""
    R, m_pad, B = shape
    width = m_pad * B
    if B % SLICE != 0 or width > MAX_WINDOW:
        raise ValueError(f"band slots: B must be a multiple of {SLICE} and m_pad * B at most "
                         f"{MAX_WINDOW} (uint16 window offsets), got B={B}, m_pad={m_pad}")
    dev = row.device
    n_rows = R * B
    keep = val != 0
    key = row[keep] * width + off[keep]
    key, order = torch.sort(key, stable=True)
    val = val[keep][order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key, val = key[first], val[first]
    row, off = key // width, key % width
    counts = torch.bincount(row, minlength=n_rows)
    slots = counts.view(-1, SLICE).amax(dim=1)
    slots = (slots + GROUP - 1) // GROUP * GROUP
    start = torch.zeros(n_rows // SLICE + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(slots * SLICE, 0)
    j = torch.arange(key.numel(), device=dev) - (torch.cumsum(counts, 0) - counts)[row]
    pos = (start[row // SLICE] + (j // GROUP) * (SLICE * GROUP) + (row % SLICE) * GROUP
           + j % GROUP)
    n = int(start[-1])
    if n >= 1 << 31:
        raise ValueError(f"band slots: {n} elements exceed int32 indices")
    off16 = torch.zeros(n, dtype=torch.int16, device=dev)
    off16[pos] = torch.where(off >= 1 << 15, off - (1 << 16), off).to(torch.int16)
    vals = torch.zeros(n, dtype=val.dtype, device=dev)
    vals[pos] = val
    return BandSlots(off16, vals, start.to(torch.int32), (R, m_pad, B))


def band_slots(C4) -> BandSlots:
    """The :class:`BandSlots` of a dense band ``C4`` [R, m_pad, B, B] (a
    numpy array, bf16 ones of JAX included, or a tensor; f32 or bf16): its
    nonzeros, in ascending offset order a row, on C4's device."""
    if isinstance(C4, np.ndarray):
        # a copy: JAX hands out read-only arrays
        if C4.dtype.name == "bfloat16":
            C4 = torch.from_numpy(np.array(C4).view(np.int16)).view(torch.bfloat16)
        else:
            C4 = torch.from_numpy(np.array(C4))
    if C4.dim() != 4 or C4.shape[2] != C4.shape[3] or C4.dtype not in _STORAGE:
        raise ValueError("band_slots: C4 must be an [R, m_pad, B, B] float32 or bfloat16 "
                         "array")
    R, m_pad, B, _ = C4.shape
    r, k, b, j = torch.nonzero(C4, as_tuple=True)
    return slots_from_entries(r * B + b, k * B + j, C4[r, k, b, j], (R, m_pad, B))


def _rows(slots: BandSlots):
    """Each row's slots as [R*B, W] element positions (W: the longest
    slice's slots a row) and whether the row's slice holds slot ``s``."""
    R, m_pad, B = slots.shape
    n_rows = R * B
    start = slots.start.long()
    per_row = ((start[1:] - start[:-1]) // SLICE).repeat_interleave(SLICE)
    W = int(per_row.max()) if n_rows else 0
    i = torch.arange(n_rows, device=start.device)[:, None]
    s = torch.arange(W, device=start.device)[None, :]
    pos = (start[i // SLICE] + (s // GROUP) * (SLICE * GROUP) + (i % SLICE) * GROUP
           + s % GROUP)
    held = s < per_row[:, None]
    return torch.where(held, pos, 0), held


def band_dense(slots: BandSlots) -> torch.Tensor:
    """The dense band ``C4`` [R, m_pad, B, B] of ``slots``, in their storage
    type: the layout the JAX package reads."""
    R, m_pad, B = slots.shape
    pos, held = _rows(slots)
    i = torch.arange(R * B, device=pos.device)[:, None].expand_as(pos)[held]
    pos = pos[held]
    off = slots.off[pos].long() & 0xFFFF
    val = slots.val[pos]
    C4 = torch.zeros((R, m_pad, B, B), dtype=slots.val.dtype, device=pos.device)
    nz = val != 0
    i, off, val = i[nz], off[nz], val[nz]
    C4[i // B, off // B, i % B, off % B] = val
    return C4


def banded_matvec_plain(slots: BandSlots, xw: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a loop over slot columns, ``acc = acc +
    v[:, s] * xw[r*B + off[:, s]]`` in f32 for the rows whose slice holds
    slot ``s`` (pads: value 0); the kernel's arithmetic in its order."""
    R, m_pad, B = slots.shape
    pos, held = _rows(slots)
    x = xw.reshape(-1).float()
    base = (torch.arange(R * B, device=x.device) // B) * B
    off = slots.off.long() & 0xFFFF
    acc = torch.zeros(R * B, dtype=torch.float32, device=x.device)
    for s in range(pos.shape[1]):
        p = pos[:, s]
        term = slots.val[p].float() * x[base + off[p]]
        acc = torch.where(held[:, s], acc + term, acc)
    return acc


def _lib(symbol="dkmc_banded_matvec"):
    fn = getattr(_build.load("banded"), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p] * 4 + [i] * 4 + [p] * (2 if symbol == "dkmc_banded_matvec" else 3))
        fn.restype = ctypes.c_int
    return fn


def _check(slots: BandSlots, xw: torch.Tensor) -> None:
    if xw.device.type != "cuda":
        raise ValueError(f"banded_matvec: unsupported device {xw.device}")
    R, m_pad, B = slots.shape
    if B % SLICE != 0 or m_pad * B > MAX_WINDOW or R <= 0:
        raise ValueError(f"banded_matvec: B must be a multiple of {SLICE} and m_pad * B at "
                         f"most {MAX_WINDOW}")
    if slots.val.dtype not in _STORAGE or slots.off.dtype != torch.int16 \
            or slots.start.dtype != torch.int32 \
            or slots.off.shape != slots.val.shape or slots.start.numel() != R * B // SLICE + 1:
        raise ValueError("banded_matvec: slots must hold int16 offsets, f32 or bf16 values "
                         "of the same length and int32 slice starts [R*B/32 + 1]")
    for t in (slots.off, slots.val, slots.start):
        if t.device != xw.device or not t.is_contiguous() or t.data_ptr() % 16 != 0:
            raise ValueError("banded_matvec: the slots must be contiguous and 16-byte "
                             "aligned on xw's device")
    if xw.dtype != torch.float32 or xw.numel() != (R + m_pad - 1) * B \
            or not xw.is_contiguous():
        raise ValueError("banded_matvec: xw must be a contiguous f32 window of "
                         "(R + m_pad - 1) * B entries")


def _launch(slots: BandSlots, xw: torch.Tensor, out: torch.Tensor, counter, stream) -> None:
    R, m_pad, B = slots.shape
    args = (slots.off.data_ptr(), slots.val.data_ptr(), slots.start.data_ptr(), xw.data_ptr(),
            R, m_pad, B, int(slots.val.dtype == torch.bfloat16), out.data_ptr())
    if counter is None:
        err = _lib()(*args, stream)
    else:
        err = _lib("dkmc_banded_matvec_out")(*args, counter, stream)
    if err != 0:
        raise RuntimeError(f"banded_matvec kernel launch failed: cudaError {err}")


def banded_matvec(slots: BandSlots, xw: torch.Tensor) -> torch.Tensor:
    """y [R*B] f32 from the band's ``slots`` and the window ``xw`` [(R +
    m_pad - 1)*B] (f32 on the card)."""
    if xw.device.type == "cpu":
        return banded_matvec_plain(slots, xw)
    _check(slots, xw)
    R, m_pad, B = slots.shape
    y = torch.empty(R * B, dtype=torch.float32, device=xw.device)
    _launch(slots, xw, y, None, torch.cuda.current_stream(xw.device).cuda_stream)
    banded_matvec.launches += 1
    return y


banded_matvec.launches = 0


def banded_matvec_out(slots: BandSlots, xw: torch.Tensor, out: torch.Tensor,
                      stream=None) -> torch.Tensor:
    """:func:`banded_matvec` into ``out`` (contiguous [R*B] f32) on
    ``stream`` (a raw stream handle; None: the current stream), its launches
    also counted on the card; allocates nothing.  For CPU tensors the plain
    version, copied into ``out``."""
    if xw.device.type == "cpu":
        return out.copy_(banded_matvec_plain(slots, xw))
    _check(slots, xw)
    R, m_pad, B = slots.shape
    if out.dtype != torch.float32 or out.numel() != R * B or not out.is_contiguous() \
            or out.device != xw.device:
        raise ValueError("banded_matvec_out: out must be a contiguous [R*B] f32 tensor on "
                         "xw's device")
    if stream is None:
        stream = torch.cuda.current_stream(xw.device).cuda_stream
    _launch(slots, xw, out, _build.launch_counter(xw.device, "banded_matvec_out"), stream)
    banded_matvec_out.launches += 1
    return out


banded_matvec_out.launches = 0
