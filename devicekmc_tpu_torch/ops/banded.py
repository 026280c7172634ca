"""Static banded-dense matvec: kernel 3 of the port (``csrc/banded.cu``).

Replaces the TPU kernel ``devicekmc_tpu/ops/banded_pallas.py``
(``banded_matvec_pallas``):

    y[r, b] = sum_{k, j} C4[r, k, b, j] * xp2[r + k, j]

``C4`` [R, m_pad, B, B] holds the static neighbour conductances of the
blocked transport operator as zero-padded band blocks over x-sorted atoms
(``physics.current.build_banded_nb``), stored f32 or bf16; ``xp2``
[R + m_pad - 1, B] is the padded, permuted vector, f32 or in C4's type (the
transport path passes f32 with either band); the sum is taken in f32.

Bound on the card: bytes (``C4`` is read once).  See the kernel source for
the design.

:func:`banded_matvec` launches the kernel for CUDA tensors and takes the
plain version :func:`banded_matvec_plain` only for CPU tensors.
``banded_matvec.launches`` counts kernel launches.  :func:`banded_matvec_out`
writes into a buffer of the caller's on a given stream and counts its
launches on the card too (``_build.launch_counts``): the form the transport
solve's device loop captures into a WHILE body, where nothing may allocate.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_STORAGE = (torch.float32, torch.bfloat16)


def window_stack(xp2: torch.Tensor, R: int, m_pad: int) -> torch.Tensor:
    """[R, m_pad, B]: the m_pad shifted windows of ``xp2`` every row block
    multiplies with."""
    return torch.stack([xp2[k:k + R] for k in range(m_pad)], dim=1)


def banded_matvec_plain(C4: torch.Tensor, xp2: torch.Tensor,
                        max_bytes: int = 1 << 30) -> torch.Tensor:
    """The plain PyTorch version: an einsum over the window stack, chunked
    over row blocks so that an f32 copy of a bf16 band stays below
    ``max_bytes``."""
    R, m_pad, B, _ = C4.shape
    xst = window_stack(xp2.float(), R, m_pad)
    out = torch.empty((R, B), dtype=torch.float32, device=C4.device)
    step = max(1, max_bytes // max(m_pad * B * B * 4, 1))
    for r0 in range(0, R, step):
        r1 = min(r0 + step, R)
        out[r0:r1] = torch.einsum("rkbj,rkj->rb", C4[r0:r1].float(), xst[r0:r1])
    return out


def _lib(symbol="dkmc_banded_matvec"):
    fn = getattr(_build.load("banded"), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, p, i, i, i, i, i, p, p] if symbol == "dkmc_banded_matvec"
                       else [p, p, i, i, i, i, i, p, p, p])
        fn.restype = ctypes.c_int
    return fn


def _check(C4: torch.Tensor, xp2: torch.Tensor) -> None:
    if C4.device.type != "cuda":
        raise ValueError(f"banded_matvec: unsupported device {C4.device}")
    if C4.dim() != 4 or C4.shape[2] != C4.shape[3] or C4.dtype not in _STORAGE \
            or not C4.is_contiguous():
        raise ValueError("banded_matvec: C4 must be a contiguous [R, m_pad, B, B] "
                         "float32 or bfloat16 tensor")
    R, m_pad, B, _ = C4.shape
    if xp2.dtype not in (C4.dtype, torch.float32) \
            or tuple(xp2.shape) != (R + m_pad - 1, B) \
            or not xp2.is_contiguous() or xp2.device != C4.device:
        raise ValueError("banded_matvec: xp2 must be a contiguous "
                         "[R + m_pad - 1, B] f32 tensor, or of C4's type, on C4's device")
    if B % 128 != 0:
        raise ValueError("banded_matvec: B must be a multiple of 128")
    if m_pad * B * 4 > 227 * 1024:
        raise ValueError("banded_matvec: the window (m_pad * B floats) exceeds "
                         "the shared memory of a block")


def banded_matvec(C4: torch.Tensor, xp2: torch.Tensor) -> torch.Tensor:
    """y [R, B] f32 from contiguous ``C4`` [R, m_pad, B, B] (f32 or bf16)
    and ``xp2`` [R + m_pad - 1, B] (f32, or C4's type); B a multiple of 128
    on the card."""
    if C4.device.type == "cpu":
        return banded_matvec_plain(C4, xp2)
    _check(C4, xp2)
    R, m_pad, B, _ = C4.shape
    y = torch.empty((R, B), dtype=torch.float32, device=C4.device)
    if R == 0:
        return y
    err = _lib()(C4.data_ptr(), xp2.data_ptr(), R, m_pad, B,
                 int(C4.dtype == torch.bfloat16), int(xp2.dtype == torch.bfloat16),
                 y.data_ptr(),
                 torch.cuda.current_stream(C4.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"banded_matvec kernel launch failed: cudaError {err}")
    banded_matvec.launches += 1
    return y


banded_matvec.launches = 0


def banded_matvec_out(C4: torch.Tensor, xp2: torch.Tensor, out: torch.Tensor,
                      stream=None) -> torch.Tensor:
    """:func:`banded_matvec` into ``out`` (contiguous [R, B] f32) on
    ``stream`` (a raw stream handle; None: the current stream), its launches
    also counted on the card; allocates nothing.  For CPU tensors the plain
    version, copied into ``out``."""
    if C4.device.type == "cpu":
        return out.copy_(banded_matvec_plain(C4, xp2))
    _check(C4, xp2)
    R, m_pad, B, _ = C4.shape
    if out.dtype != torch.float32 or tuple(out.shape) != (R, B) or not out.is_contiguous() \
            or out.device != C4.device:
        raise ValueError("banded_matvec_out: out must be a contiguous [R, B] f32 tensor on "
                         "C4's device")
    if stream is None:
        stream = torch.cuda.current_stream(C4.device).cuda_stream
    err = _lib("dkmc_banded_matvec_out")(
        C4.data_ptr(), xp2.data_ptr(), R, m_pad, B, int(C4.dtype == torch.bfloat16),
        int(xp2.dtype == torch.bfloat16), out.data_ptr(),
        _build.launch_counter(C4.device, "banded_matvec_out"), stream)
    if err != 0:
        raise RuntimeError(f"banded_matvec kernel launch failed: cudaError {err}")
    banded_matvec_out.launches += 1
    return out


banded_matvec_out.launches = 0
