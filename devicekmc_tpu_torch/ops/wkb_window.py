"""Contact->trap window-integral tunnel block: kernel 8 of the port
(``csrc/wkb_window.cu``).

Replaces the TPU kernel ``devicekmc_tpu/ops/wkb_pallas.py``
(``wkb_window_block``).  Assembles the [n_vac, n_mp] vacancy x metal block of
the blocked transport operator: per eligible pair, ``n_int_steps`` single-shot
WKB terms summed over the occupied energy window (terms whose energy offset
reaches ``|dE|`` add exact zeros), negated, in f32.  Rows with ``v_ok`` False
hold exact zeros.

Bound on the card: operations (about 13 FP32 operations with one exp and two
square roots per energy step and pair).  See the kernel source for the
design.

:func:`wkb_window_block` launches the kernel for CUDA tensors and takes the
plain version :func:`wkb_window_block_plain` only for CPU tensors.
``wkb_window_block.launches`` counts kernel launches.  ``env`` is the dict of
``physics.current.wkb_env``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build


def _window_rows_plain(env, vpos, vcb, v_ok, pos, cb) -> torch.Tensor:
    dev = vpos.device
    dx = vpos[:, None, 0] - pos[None, :, 0]
    dy = vpos[:, None, 1] - pos[None, :, 1]
    dz = vpos[:, None, 2] - pos[None, :, 2]
    if env["pbc"]:
        ly, lz = env["lattice"][1], env["lattice"][2]
        dy = dy - torch.round(dy / ly) * ly
        dz = dz - torch.round(dz / lz) * lz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    abs_dE = torch.abs(vcb[:, None] - cb[None, :])
    elig = v_ok[:, None] & (abs_dE > env["ctol"]) & ~(dist < env["nn"])
    safe = torch.where(elig, abs_dE, 1.0)
    s = env["prefac"] * (dist * 1e-10) / safe
    qV0 = torch.tensor(env["qV0"], dtype=torch.float32, device=dev)
    dE_step = torch.tensor(env["dE_step"], dtype=torch.float32, device=dev)
    # steps past the widest eligible window add exact zeros: leave them out
    widest = float(torch.where(elig, abs_dE, 0.0).max()) if elig.numel() else 0.0
    n_steps = min(int(env["n_int_steps"]), int(math.ceil(widest / env["dE_step"])) + 1)
    T = torch.zeros_like(s)
    for k in range(n_steps):
        iv = torch.tensor(float(k), dtype=torch.float32, device=dev) * dE_step
        e1 = qV0 + iv
        e2 = e1 - safe
        e15 = e1 * torch.sqrt(e1)
        e2p = torch.where(e2 > 0, e2, 0.0)
        term = torch.where(
            e2 > 0,
            torch.exp(s * (e15 - e2p * torch.sqrt(e2p))),
            torch.where(e2 < 0, torch.exp(s * e15), 0.0),
        )
        T = T + torch.where(iv < safe, term, 0.0)
    return torch.where(elig, -T, 0.0)


def wkb_window_block_plain(vpos, vcb, v_ok, pos, cb, env) -> torch.Tensor:
    """The plain PyTorch version, chunked over rows; same arguments as
    :func:`wkb_window_block`."""
    nv, n = vpos.shape[0], pos.shape[0]
    vpos32, vcb32 = vpos.float(), vcb.float()
    pos32, cb32 = pos.float(), cb.float()
    out = torch.empty((nv, n), dtype=torch.float32, device=vpos.device)
    step = max(8, (1 << 23) // max(n, 1))
    for r0 in range(0, nv, step):
        r1 = min(r0 + step, nv)
        out[r0:r1] = _window_rows_plain(env, vpos32[r0:r1], vcb32[r0:r1],
                                        v_ok[r0:r1], pos32, cb32)
    return out


def _lib():
    fn = _build.load("wkb_window").dkmc_wkb_window_block
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, i, p, p, i, f, f, f, f, f, f, f, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def wkb_window_block(vpos: torch.Tensor, vcb: torch.Tensor, v_ok: torch.Tensor,
                     pos: torch.Tensor, cb: torch.Tensor, env) -> torch.Tensor:
    """The [n_vac, n_mp] f32 block from vpos [n_vac,3], vcb [n_vac], bool
    v_ok [n_vac], pos [n_mp,3], cb [n_mp] (f32, contiguous)."""
    if vpos.device.type == "cpu":
        return wkb_window_block_plain(vpos, vcb, v_ok, pos, cb, env)
    if vpos.device.type != "cuda":
        raise ValueError(f"wkb_window_block: unsupported device {vpos.device}")
    nv, n = vpos.shape[0], pos.shape[0]
    for name, t, shape in (("vpos", vpos, (nv, 3)), ("vcb", vcb, (nv,)),
                           ("pos", pos, (n, 3)), ("cb", cb, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"wkb_window_block: {name} must be a contiguous "
                             f"float32 tensor of shape {shape}")
    if v_ok.dtype != torch.bool or tuple(v_ok.shape) != (nv,) or not v_ok.is_contiguous():
        raise ValueError("wkb_window_block: v_ok must be a contiguous [n_vac] bool tensor")
    if any(t.device != vpos.device for t in (vcb, v_ok, pos, cb)):
        raise ValueError("wkb_window_block: all tensors on one device")
    out = torch.empty((nv, n), dtype=torch.float32, device=vpos.device)
    if nv == 0 or n == 0:
        return out
    err = _lib()(vpos.data_ptr(), vcb.data_ptr(), v_ok.data_ptr(), nv,
                 pos.data_ptr(), cb.data_ptr(), n, env["prefac"], env["qV0"],
                 env["ctol"], env["nn"], env["lattice"][1], env["lattice"][2],
                 env["dE_step"], int(bool(env["pbc"])), int(env["n_int_steps"]),
                 out.data_ptr(), torch.cuda.current_stream(vpos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkb_window_block kernel launch failed: cudaError {err}")
    wkb_window_block.launches += 1
    return out


wkb_window_block.launches = 0
