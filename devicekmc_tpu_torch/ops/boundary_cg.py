"""The warm boundary CG of a captured superstep: B replicas' Jacobi CG as one
device loop (``ops.graph.device_while``) whose body is two hand-written
kernels (``csrc/boundary_cg.cu``).

Replaces the JAX package's device loop of the boundary solve, the
``lax.while_loop`` of ``devicekmc_tpu/ops/cg.py:95-115`` (criterion "r",
Jacobi) inside its jitted superstep.  :func:`cg_solve_device` computes what
``ops.cg.cg_solve_batched`` computes, with the same stop rule and counts,
and reads nothing back: the setup is PyTorch operations on the device, the
loop a WHILE node entered on its predicate, each iteration
:func:`cg_matvec_dot` and :func:`cg_update_direction` (which sets the
predicate) on the buffers of a :class:`Workspace` made before the capture, so
nothing allocates inside the loop.  For CPU tensors the loop is
the plain ``while`` of ``device_while`` and each kernel wrapper runs its
plain version, the arithmetic of ``cg_solve_batched`` in its order, so the
CPU result is ``cg_solve_batched``'s bit for bit.  On the card the kernels
reduce in another, fixed order.

Launches: each iteration launches each kernel once, counted on the device in
``Workspace.total`` (:func:`device_iterations`, written by
cg_update_direction) and, for cg_matvec_dot, in ``_build.launch_counts``; the
wrappers' ``launches`` count their host calls, one a capture of the loop's
body.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Tuple

import torch

from . import _build
from .cg import BatchedCGResult, rowdot
from .ell import ell_matvec, safe_index
from .graph import device_while

#: threads a block of the two kernels
THREADS = 256
#: rows a tile of cg_update_direction (two a thread), whose partial sums have
#: a slot of their own: a replica's reduction order depends on N alone
TILE = 2 * THREADS
#: rows a group of cg_matvec_dot, what a block takes at a time: 16 lanes a
#: row, two rows a warp
MATVEC_ROWS = 16
#: blocks a replica of cg_matvec_dot at most, each taking every
#: MATVEC_GRID-th group: four a streaming multiprocessor of an H100
MATVEC_GRID = 4 * _build.H100_SMS


def n_tiles(n: int) -> int:
    """Tiles of cg_update_direction for ``n`` rows."""
    return -(-n // TILE)


def matvec_grid_size(n: int) -> int:
    """Blocks a replica of cg_matvec_dot for ``n`` rows."""
    return max(1, min(-(-n // MATVEC_ROWS), MATVEC_GRID))


@dataclass
class Workspace:
    """The buffers of one batched solve, made before a capture.  [B, N]: the
    iterate ``x``, residual ``r``, direction ``p``, its product ``ap``, the
    inverse Jacobi diagonal ``minv``; [B]:
    ``rz`` (r.z), ``rr`` (r.r), ``thresh2``, ``alpha``, ``beta``, the
    replicas asked to solve ``act0`` and iterating ``act``, the counts
    ``iters``; ``ctl`` int32 [iterations run, replicas iterating], ``cond``
    the loop's int32 [1] predicate, ``total`` the iterations run since it
    was last set to 0 (int64 [1]); ``part`` the partial sums of
    cg_matvec_dot's blocks and of cg_update_direction's tiles, ``tickets``
    cg_matvec_dot's int32 tickets (zero between launches), ``bar``
    cg_update_direction's grid barrier (int32 [1], whose top bit flips at
    each barrier); ``row_len`` the operator's valid
    prefix a row, -1 on contact rows (int32 [N], :func:`row_lengths`: the
    structure cg_matvec_dot reads on the card); ``grid_mv`` the blocks a
    replica of cg_matvec_dot."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    ap: torch.Tensor
    minv: torch.Tensor
    rz: torch.Tensor
    rr: torch.Tensor
    thresh2: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    act0: torch.Tensor
    act: torch.Tensor
    iters: torch.Tensor
    ctl: torch.Tensor
    cond: torch.Tensor
    total: torch.Tensor
    part: torch.Tensor
    tickets: torch.Tensor
    bar: torch.Tensor
    row_len: torch.Tensor
    grid_mv: int


def row_lengths(neigh_idx: torch.Tensor, interior: torch.Tensor) -> torch.Tensor:
    """The valid prefix of each row of the operator's neighbour list
    ``neigh_idx`` [N, M] (pad -1), its count of valid slots on interior rows
    and -1 on contact rows (int32 [N]): what cg_matvec_dot reads of a row.
    Raises unless every row is left-packed (its valid slots first, as the
    neighbour list is built)."""
    valid = neigh_idx >= 0
    if bool((valid[:, 1:] & ~valid[:, :-1]).any()):
        raise ValueError("row_lengths: a row of the neighbour list is not left-packed")
    return torch.where(interior, valid.sum(-1), -1).to(torch.int32)


def workspace(batch: int, neigh_idx: torch.Tensor, interior: torch.Tensor, dtype,
              device) -> Workspace:
    """The buffers of a solve of ``batch`` systems over the operator whose
    structure is ``neigh_idx`` [N, M] and ``interior`` [N] (the last two of
    :func:`apply_operator`'s ``op``), with its :func:`row_lengths`."""
    dev = torch.device(device)
    n = interior.shape[0]
    grid_mv = matvec_grid_size(n)

    def vec(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return Workspace(
        x=vec(batch, n), r=vec(batch, n), p=vec(batch, n),
        ap=vec(batch, n), minv=vec(batch, n), rz=vec(batch), rr=vec(batch),
        thresh2=vec(batch), alpha=vec(batch), beta=vec(batch),
        act0=torch.zeros(batch, dtype=torch.bool, device=dev),
        act=torch.zeros(batch, dtype=torch.bool, device=dev),
        iters=torch.zeros(batch, dtype=torch.int64, device=dev),
        ctl=torch.zeros(2, dtype=torch.int32, device=dev),
        cond=torch.zeros(1, dtype=torch.int32, device=dev),
        total=torch.zeros(1, dtype=torch.int64, device=dev),
        part=vec(batch * max(2 * n_tiles(n), grid_mv)),
        tickets=torch.zeros(batch, dtype=torch.int32, device=dev),
        bar=torch.zeros(1, dtype=torch.int32, device=dev),
        row_len=row_lengths(neigh_idx, interior).to(dev).contiguous(), grid_mv=grid_mv)


def device_iterations(ws: Workspace) -> int:
    """Iterations run on ``ws`` since ``ws.total`` was last set to 0 (a read):
    the launches of each of the two kernels."""
    return int(ws.total)


# ----------------------------------------------------------------------------
# the two kernels (CUDA tensors only)
# ----------------------------------------------------------------------------

def _fn(symbol):
    fn = getattr(_build.load("boundary_cg"), symbol)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {
            "dkmc_cg_matvec_dot": [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p, p],
            "dkmc_cg_update_direction": [i] + [p] * 18 + [ctypes.c_ulonglong, i, i, i, p],
            "dkmc_cg_update_direction_grid": [i, i, i, ctypes.POINTER(i),
                                              ctypes.POINTER(i)],
        }[symbol]
        fn.restype = ctypes.c_int
    return fn


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _check_ws(name: str, ws: Workspace, op=None) -> Tuple[int, int]:
    B, n = ws.x.shape
    if ws.x.device.type != "cuda" or ws.x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: the workspace must hold f32 or f64 CUDA tensors")
    if op is not None:
        diag, vals, neigh_idx, interior = op
        m = neigh_idx.shape[1]
        for what, t, dtype, shape in (("diag", diag, ws.x.dtype, (B, n)),
                                      ("vals", vals, ws.x.dtype, (B, n, m)),
                                      ("neigh_idx", neigh_idx, torch.int32, (n, m)),
                                      ("interior", interior, torch.bool, (n,))):
            if t.device != ws.x.device or t.dtype != dtype or tuple(t.shape) != shape \
                    or not t.is_contiguous():
                raise ValueError(f"{name}: {what} must be a contiguous {dtype} tensor of "
                                 f"shape {shape} on {ws.x.device}")
    return B, n


def apply_operator(op, x: torch.Tensor) -> torch.Tensor:
    """``A x`` of ``op = (diag [B, N], vals [B, N, M], neigh_idx [N, M] int32,
    interior [N] bool)``: the interior operator of
    ``physics.potential._dirichlet_system`` in its arithmetic."""
    diag, vals, neigh_idx, interior = op
    xm = torch.where(interior, x, 0.0)
    return torch.where(interior, ell_matvec(diag, vals, safe_index(neigh_idx), xm), 0.0)


def cg_matvec_dot_plain(ws: Workspace, op) -> None:
    """The plain version of :func:`cg_matvec_dot` (every replica)."""
    ws.ap.copy_(apply_operator(op, ws.p))
    denom = rowdot(ws.p, ws.ap)
    ws.alpha.copy_(torch.where(denom != 0, ws.rz / denom, 0.0))


def cg_matvec_dot(ws: Workspace, op, stream=None) -> None:
    """``ws.ap = A ws.p`` and ``ws.alpha = ws.rz / (p.ap)`` of each iterating
    replica (:func:`apply_operator`'s ``op``; on the card the interior rows
    and their prefixes are ``ws.row_len``'s, made by :func:`workspace` from
    ``op``'s structure), on ``stream``."""
    if ws.x.device.type == "cpu":
        return cg_matvec_dot_plain(ws, op)
    B, n = _check_ws("cg_matvec_dot", ws, op)
    diag, vals, neigh_idx, _ = op
    _launched("cg_matvec_dot", _fn("dkmc_cg_matvec_dot")(
        int(ws.x.dtype == torch.float64), diag.data_ptr(), vals.data_ptr(),
        neigh_idx.data_ptr(), ws.row_len.data_ptr(), ws.p.data_ptr(), ws.ap.data_ptr(),
        ws.act.data_ptr(), ws.rz.data_ptr(), ws.alpha.data_ptr(), ws.part.data_ptr(),
        ws.tickets.data_ptr(), n, neigh_idx.shape[1], B, ws.grid_mv,
        _build.launch_counter(ws.x.device, "cg_matvec_dot"), _stream(ws, stream)))
    cg_matvec_dot.launches += 1


cg_matvec_dot.launches = 0


def cg_update_direction_plain(ws: Workspace, maxiter: int) -> None:
    """The plain version of :func:`cg_update_direction` (``beta`` and ``p``
    of every replica, the rest where it iterates), in ``cg_solve_batched``'s
    arithmetic; the preconditioned residual ``z`` is a local."""
    act = ws.act
    alpha = ws.alpha[:, None]
    x_n = ws.x + alpha * ws.p
    r_n = ws.r - alpha * ws.ap
    z = ws.minv * r_n
    rz_n = rowdot(r_n, z)
    ws.beta.copy_(torch.where(ws.rz != 0, rz_n / ws.rz, 0.0))
    a2 = act[:, None]
    ws.x.copy_(torch.where(a2, x_n, ws.x))
    ws.r.copy_(torch.where(a2, r_n, ws.r))
    ws.rz.copy_(torch.where(act, rz_n, ws.rz))
    ws.iters.add_(act)
    ws.ctl[0] += 1
    ws.total += 1
    _decide(ws, maxiter)
    ws.p.copy_(z + ws.beta[:, None] * ws.p)


def update_direction_grid(ws: Workspace) -> Tuple[int, int]:
    """``(blocks, tiles a block)`` of :func:`cg_update_direction` on ``ws``'s
    card: as few tiles a block as the blocks the card holds at once allow.
    Raises when no grid of resident blocks can take the solve."""
    B, n = _check_ws("cg_update_direction", ws)
    grid, per = ctypes.c_int(0), ctypes.c_int(0)
    err = _fn("dkmc_cg_update_direction_grid")(int(ws.x.dtype == torch.float64), n, B,
                                               ctypes.byref(grid), ctypes.byref(per))
    if err != 0:
        raise RuntimeError(f"cg_update_direction: no grid of resident blocks takes {B} "
                           f"replicas of {n} rows: cudaError {err}")
    return grid.value, per.value


def cg_update_direction(ws: Workspace, maxiter: int, handle: int = 0, stream=None) -> None:
    """The iterate, residual and direction of each iterating replica, its
    r.z, r.r, beta and count; then the stop flags, the iterations run and the
    predicate ``ws.cond``, also set as the condition of the WHILE node
    ``handle`` (0: none).  On the card one cooperative launch whose grid the
    card holds at once (:func:`update_direction_grid`; raises when none
    can)."""
    if ws.x.device.type == "cpu":
        return cg_update_direction_plain(ws, maxiter)
    B, n = _check_ws("cg_update_direction", ws)
    _launched("cg_update_direction", _fn("dkmc_cg_update_direction")(
        int(ws.x.dtype == torch.float64), ws.x.data_ptr(), ws.r.data_ptr(), ws.p.data_ptr(),
        ws.ap.data_ptr(), ws.minv.data_ptr(), ws.act.data_ptr(), ws.act0.data_ptr(),
        ws.alpha.data_ptr(), ws.beta.data_ptr(), ws.rz.data_ptr(), ws.rr.data_ptr(),
        ws.thresh2.data_ptr(), ws.iters.data_ptr(), ws.part.data_ptr(), ws.bar.data_ptr(),
        ws.ctl.data_ptr(), ws.cond.data_ptr(), ws.total.data_ptr(), handle, n, B,
        int(maxiter), _stream(ws, stream)))
    cg_update_direction.launches += 1


cg_update_direction.launches = 0


# ----------------------------------------------------------------------------
# the solve
# ----------------------------------------------------------------------------

def _stream(ws: Workspace, stream):
    return torch.cuda.current_stream(ws.x.device).cuda_stream if stream is None else stream


def _decide(ws: Workspace, maxiter: int) -> None:
    """r.r, the stop flags and the predicate from the residual, on the device."""
    ws.rr.copy_(rowdot(ws.r, ws.r))
    ws.act.copy_(ws.act0 & (ws.rr > ws.thresh2))
    n_act = ws.act.sum(dtype=torch.int32)
    ws.ctl[1] = n_act
    ws.cond.copy_(((n_act > 0) & (ws.ctl[0] < maxiter)).to(torch.int32).reshape(1))


def cg_setup(op, b: torch.Tensor, x0: torch.Tensor, diag: torch.Tensor, tol: float,
             maxiter: int, active: torch.Tensor, ws: Workspace) -> None:
    """The state of ``cg_solve_batched`` before its first iteration, written
    into ``ws`` by operations on the device: r = b - A x0, z = p = r / diag,
    r.z, r.r, the threshold, the stop flags, the predicate."""
    if tuple(ws.x.shape) != tuple(b.shape) or ws.x.dtype != b.dtype \
            or ws.x.device != b.device:
        raise ValueError(f"cg_setup: a workspace of {tuple(ws.x.shape)} {ws.x.dtype} "
                         f"on {ws.x.device} for systems {tuple(b.shape)} {b.dtype}")
    ws.minv.copy_(torch.where(diag != 0, 1.0 / diag, 1.0))
    ref = torch.sqrt(rowdot(b, b))
    thresh = tol * torch.where(ref > 0, ref, 1.0)
    ws.thresh2.copy_(thresh * thresh)
    ws.act0.copy_(active)
    ws.x.copy_(x0)
    ws.r.copy_(b - apply_operator(op, x0))
    ws.p.copy_(ws.minv * ws.r)
    ws.rz.copy_(rowdot(ws.r, ws.p))
    ws.iters.zero_()
    ws.ctl.zero_()
    _decide(ws, maxiter)


def cg_iteration(ws: Workspace, op, maxiter: int, handle: int = 0, stream=None) -> None:
    """One iteration: the two kernels (their plain versions for CPU
    tensors)."""
    cg_matvec_dot(ws, op, stream)
    cg_update_direction(ws, maxiter, handle, stream)


def cg_solve_device(op, b: torch.Tensor, x0: torch.Tensor, diag: torch.Tensor, tol: float,
                    maxiter: int, active: torch.Tensor, ws: Workspace) -> BatchedCGResult:
    """``cg_solve_batched`` of the operator ``op`` (:func:`apply_operator`)
    as one device loop on ``ws``, with no read: ``b`` and ``x0`` [B, N],
    ``diag`` the Jacobi diagonal, criterion "r" at ``tol``, at most
    ``maxiter`` iterations.  A replica not ``active`` keeps ``x0`` and counts
    0; when none is, the loop runs no iteration.  Returns the iterate, the
    counts, ||r|| and the criterion (new tensors)."""
    cg_setup(op, b, x0, diag, tol, maxiter, active, ws)
    device_while(ws.cond, lambda handle, stream: cg_iteration(ws, op, maxiter, handle, stream))
    return BatchedCGResult(x=ws.x.clone(), iters=ws.iters.clone(),
                           residual=torch.sqrt(torch.abs(ws.rr)).to(torch.float64),
                           converged=ws.rr <= ws.thresh2)
