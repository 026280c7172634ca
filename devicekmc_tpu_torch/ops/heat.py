"""The local heat model's device loops: the transient substeps and the steady
branch as device loops (``ops.graph.device_while``) whose bodies are
hand-written kernels (``csrc/heat.cu``, and for the matrix-free model
``csrc/boundary_cg.cu``'s CG iteration nested in the substep loop).

Replaces the JAX package's ``lax.while_loop`` over the transient substeps
(``devicekmc_tpu/physics/heat.py:271``, dense; ``:351``, matrix-free) and its
``lax.cond`` between the steady and transient branches (``:280``, ``:415``)
inside ``jit(superstep_impl)``.  The branch is no mask: each branch is a loop
of its own whose trip count is set on the device (:func:`prepare`), the
transient loop ``n_sub`` substeps and the steady loop one pass, the branch
not taken 0, so the steady CG's up to 1000 iterations never run beside the
transient ones.

* dense model (:func:`run_dense`): a substep is :func:`dense_substep`, one
  launch that multiplies the propagator into the right-hand side, writes the
  interface temperatures and the next right-hand side, advances the substep
  counter and sets the predicate;
* matrix-free model (:func:`run_cg`): a substep is :func:`cg_begin` (the
  solve's set-up, warm from the field), the CG of ``ops.boundary_cg`` on
  the operator's ELL form (criterion "r", no preconditioner: ``minv = 1``;
  a WHILE node nested in the substep's, as the transport CG's inner loop is
  in its rounds) and :func:`cg_end` (the field written back, the counter,
  the predicate).  The ELL forms of the transient operator ``I - s L`` and
  of the steady one ``-L`` are made once with the model (:func:`workspace`).

Every buffer lives in a :class:`Workspace` made with the heat model, before
any capture, so nothing allocates inside a body.  For CPU tensors each
kernel wrapper runs its plain version and the loops are the plain ``while``
of ``device_while``; on the card, outside a capture, the same kernels run
from a host loop (one read of the trip counts, and for the CG one a chunk of
iterations, ``ops.cg.CHUNKS``), so that its result is the captured loops'
bit for bit.

Launches: each wrapper's ``launches`` counts its host calls (one a capture
of a loop's body); the card counts every launch of the three heat kernels
(``_build.launch_counts``), and ``Workspace.log[2]`` the CG iterations.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import _build, boundary_cg
from . import cg as cg_mod
from .boundary_cg import Workspace as CGWorkspace
from .graph import device_while

#: threads a block of the three kernels
THREADS = 256
#: warps a block
WARPS = THREADS // 32
#: heat_dense_substep's cluster form takes ni up to this (one cluster of at
#: most DENSE_CLUSTER blocks); the grid form the rest, DENSE_BLOCKS_PER_SM
#: blocks an SM, the right-hand side's tile of at most DENSE_TILE_BYTES in
#: shared memory
DENSE_SMALL_MAX_NI = 256
DENSE_CLUSTER = 16
DENSE_BLOCKS_PER_SM = 2
DENSE_TILE_BYTES = 96 * 1024
#: the grid form takes a row a block from this ni (sets of rows below it)
DENSE_ROWS_MIN_NI = 4096
#: rows of a chunk of heat_cg_begin (4 passes of its 8 warps, 2 rows a warp)
BEGIN_CHUNK = 64


#: heat_dense_substep's forms, by the number the kernel's entry takes
DENSE_FORMS = ("sets", "cluster", "rows")


@dataclass(frozen=True)
class DensePlan:
    """How heat_dense_substep covers an [ni, ni] propagator (``csrc/heat.cu``),
    ``form`` one of DENSE_FORMS: "cluster", one cluster of ``grid`` blocks;
    "sets", ``grid`` blocks over tiles of ``tile`` columns of the right-hand
    side in shared memory; either in sets of ``WARPS * rows`` rows (set s,
    s + grid, ... a block); "rows", ``grid`` blocks, the whole right-hand
    side one tile (``tile`` ni), a block a row at a time (its first row its
    index, the next ones drawn from a counter; ``rows`` 1); ``vec`` entries a
    load (16 bytes' worth, or 1)."""
    form: str
    rows: int
    vec: int
    tile: int
    grid: int


def dense_plan(ni: int, itemsize: int, aligned: bool = True,
               sms: int = _build.H100_SMS) -> DensePlan:
    """The form of heat_dense_substep for ``ni`` rows of ``itemsize``-byte
    entries on a card of ``sms`` SMs (``aligned``: the propagator's and the
    right-hand side's data start on 16 bytes).  Up to DENSE_SMALL_MAX_NI one
    cluster of at most DENSE_CLUSTER blocks with the fewest rows a warp that
    covers ni in one pass (4 where none does); above, at most
    DENSE_BLOCKS_PER_SM blocks an SM: a row a block from DENSE_ROWS_MIN_NI
    where the right-hand side fits one tile, else sets of the most rows a
    warp (of 4, 2, 1) that still give every block a set."""
    natural = 16 // itemsize
    vec = natural if aligned and ni % natural == 0 else 1
    if ni <= DENSE_SMALL_MAX_NI:
        rows = next((r for r in (1, 2, 4) if DENSE_CLUSTER * WARPS * r >= ni), 4)
        return DensePlan("cluster", rows, vec, ni,
                         min(-(-ni // (WARPS * rows)), DENSE_CLUSTER))
    cap = sms * DENSE_BLOCKS_PER_SM
    tile = min(ni, DENSE_TILE_BYTES // itemsize // vec * vec)
    if tile == ni and ni >= DENSE_ROWS_MIN_NI:
        return DensePlan("rows", 1, vec, ni, cap)
    rows = next((r for r in (4, 2) if -(-ni // (WARPS * r)) >= cap), 1)
    return DensePlan("sets", rows, vec, tile, min(-(-ni // (WARPS * rows)), cap))


def cg_begin_grid(n: int) -> int:
    """heat_cg_begin's blocks for ``n`` rows at most: a chunk of BEGIN_CHUNK
    rows each (the launch takes as many of them as the card holds at once;
    its partial sums take ``2 * cg_begin_grid(n)`` entries)."""
    return -(-n // BEGIN_CHUNK)


@dataclass
class Workspace:
    """The buffers of the local model's loops, made with the model.

    ``k`` the substeps run (int32 [1]); ``n`` the trip counts of the
    transient and the steady loop (int32 [2]); ``cond`` their predicates
    (int32 [2]); ``log`` the branch (1: steady), the substeps and the CG
    iterations summed (int64 [3], what ``physics.heat.last_local`` reports);
    ``src`` the source term; ``host_n``: the trip counts when the host set
    them (:func:`prepare`), else None.

    Dense: ``u`` the right-hand side, double-buffered [2, ni]; ``iidx`` the
    interface sites (int32 [ni]); ``ticket`` the substep kernel's ticket and
    row counter (int32 [2], zero between launches).  Matrix-free: ``cg`` the
    CG's (``boundary_cg.Workspace`` at B = 1, ``minv = 1``; its ``bar`` also
    cg_begin's grid barrier), ``op_t`` and ``op_s`` the ELL forms of the
    transient and steady operators (``boundary_cg.apply_operator``'s
    ``op``), ``part`` and ``ticket[0]`` cg_begin's partial sums and ticket."""
    method: str
    k: torch.Tensor
    n: torch.Tensor
    cond: torch.Tensor
    log: torch.Tensor
    src: torch.Tensor
    ticket: torch.Tensor
    u: Optional[torch.Tensor] = None
    iidx: Optional[torch.Tensor] = None
    cg: Optional[CGWorkspace] = None
    op_t: Optional[tuple] = None
    op_s: Optional[tuple] = None
    part: Optional[torch.Tensor] = None
    host_n: Optional[Tuple[int, int]] = None


def workspace(method: str, dtype, device, interface_idx: torch.Tensor,
              neigh_idx: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
              diag_base: Optional[torch.Tensor] = None, nb_int: Optional[torch.Tensor] = None,
              n_int_nb: Optional[torch.Tensor] = None, step_scale: float = 0.0) -> Workspace:
    """The buffers of a local model (``method`` "dense" or "cg") in ``dtype``
    on ``device``.  For "cg" also the ELL forms of its two operators from
    the neighbour list ``neigh_idx`` [N, M] (left-packed, pad -1), the
    interface ``mask`` [N], the bath term ``diag_base`` [N], the interface
    neighbours ``nb_int`` [N, M] and their count ``n_int_nb`` [N], and the
    step ``s = step_scale``: on the interface rows the transient operator
    ``I - s L`` has the diagonal ``1 - s d`` and ``-s`` on each interface
    neighbour, the steady ``-L`` the diagonal ``-d`` and ``-1``, where ``d =
    diag_base - n_int_nb`` (``physics.heat._laplacian_apply``'s L); the
    rows off the interface are outside the operator."""
    dev = torch.device(device)
    i32 = dict(dtype=torch.int32, device=dev)
    common = dict(method=method, k=torch.zeros(1, **i32), n=torch.zeros(2, **i32),
                  cond=torch.zeros(2, **i32),
                  log=torch.zeros(3, dtype=torch.int64, device=dev),
                  ticket=torch.zeros(2, **i32))
    if method == "dense":
        ni = interface_idx.shape[0]
        return Workspace(src=torch.zeros(ni, dtype=dtype, device=dev),
                         u=torch.zeros(2, ni, dtype=dtype, device=dev),
                         iidx=interface_idx.to(**i32).contiguous(), **common)
    n = mask.shape[0]
    nb = neigh_idx.to(**i32).contiguous()
    d = diag_base.to(dtype) - n_int_nb.to(dtype)
    s = float(step_scale)
    one = torch.ones((), dtype=dtype, device=dev)

    def form(diag, off):
        vals = torch.where(nb_int, off * one, 0.0 * one)
        return (torch.where(mask, diag, 0.0)[None].contiguous(), vals[None].contiguous(), nb,
                mask.contiguous())

    cg = boundary_cg.workspace(1, nb, mask, dtype, dev)
    cg.minv.fill_(1.0)
    cg.act0.fill_(True)
    return Workspace(src=torch.zeros(n, dtype=dtype, device=dev), cg=cg,
                     op_t=form(1.0 - s * d, -s), op_s=form(-d, -1.0),
                     part=torch.zeros(2 * cg_begin_grid(n), dtype=dtype, device=dev),
                     **common)


def prepare(ws: Workspace, steady, n_sub) -> None:
    """The trip counts and predicates of both loops, the substep counter and
    the log, before a run: ``steady`` the branch and ``n_sub`` the transient
    substeps (0-d device tensors: set on the device; or host values, which
    the host loop then knows without a read).  The loop of the branch not
    taken runs 0 times."""
    if torch.is_tensor(steady):
        n = torch.stack([torch.where(steady, 0, n_sub.to(torch.int32)),
                         steady.to(torch.int32)])
        ws.n.copy_(n)
        ws.log.copy_(torch.stack([steady.to(torch.int64), n[0].to(torch.int64),
                                  torch.zeros((), dtype=torch.int64, device=ws.n.device)]))
        ws.host_n = None
    else:
        host = (0 if steady else int(n_sub), int(bool(steady)))
        ws.n.copy_(torch.tensor(host, dtype=torch.int32))
        ws.log.copy_(torch.tensor([host[1], host[0], 0], dtype=torch.int64))
        ws.host_n = host
    ws.k.zero_()
    ws.cond.copy_((ws.n > 0).to(torch.int32))


# ----------------------------------------------------------------------------
# the kernels (CUDA tensors) and their plain versions (CPU tensors)
# ----------------------------------------------------------------------------

def _fn(symbol):
    fn = getattr(_build.load("heat"), symbol)
    if fn.argtypes is None:
        p, i, d, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_ulonglong
        fn.argtypes = {
            "dkmc_heat_dense_substep": [i, p, p, p, p, p, i, d, d, i, p, p, p, p, u, p, p,
                                        i, i, i, i, i],
            "dkmc_heat_cg_begin": [i] + [p] * 20 + [d, d, d, i, i, i, i, p, p, i, p],
            "dkmc_heat_cg_end": [i, p, p, p, i, d, d, i, p, p, p, p, p, u, p, p],
        }[symbol]
        fn.restype = ctypes.c_int
    return fn


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor, stream):
    return torch.cuda.current_stream(t.device).cuda_stream if stream is None else stream


def _is_f64(t: torch.Tensor) -> int:
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the local heat model's loops run in f32 or f64, not {t.dtype}")
    return int(t.dtype == torch.float64)


def dense_substep_plain(ws: Workspace, M: torch.Tensor, temp: torch.Tensor, T0: float,
                        scale: float, negate: bool, which: int) -> None:
    """The plain version of :func:`dense_substep` (``torch.matmul`` of the
    propagator)."""
    par = ws.k[0] % 2
    u_in = torch.where(par == 0, ws.u[0], ws.u[1])
    acc = M @ u_in
    tn = (-acc if negate else acc) * scale + T0
    temp[ws.iidx.long()] = tn
    nxt = (tn - T0) / scale + ws.src
    ws.u.copy_(torch.stack([torch.where(par == 1, nxt, ws.u[0]),
                            torch.where(par == 0, nxt, ws.u[1])]))
    ws.k += 1
    ws.cond[which] = (ws.k[0] < ws.n[which]).to(torch.int32)


def dense_substep(ws: Workspace, M: torch.Tensor, temp: torch.Tensor, T0: float, scale: float,
                  negate: bool, which: int, handle: int = 0, stream=None,
                  plan: Optional[DensePlan] = None) -> None:
    """One pass of the dense model's loop ``which`` (0: transient, M =
    L_inv; 1: steady, M = L_ss_inv, ``negate``): t = (-)M u_in with u_in
    the half of ``ws.u`` the counter's parity picks, ``temp[iidx] = t scale
    + T0`` and into the other half ``(T - T0) / scale + src``; the counter
    advanced and the predicate ``ws.cond[which]`` (and the WHILE node
    ``handle``'s condition, 0: none) set to ``k < n[which]``.  ``plan``: the
    kernel's form (default :func:`dense_plan` of the shapes and the card)."""
    if temp.device.type == "cpu":
        return dense_substep_plain(ws, M, temp, T0, scale, negate, which)
    ni = ws.u.shape[1]
    if M.dtype != temp.dtype or ws.u.dtype != temp.dtype or tuple(M.shape) != (ni, ni) \
            or not M.is_contiguous() or not temp.is_contiguous():
        raise ValueError("dense_substep: a contiguous [ni, ni] propagator and field of the "
                         "workspace's dtype")
    if plan is None:
        plan = dense_plan(ni, M.element_size(),
                          M.data_ptr() % 16 == 0 and ws.u.data_ptr() % 16 == 0,
                          _build.sm_count(temp.device))
    _launched("heat_dense_substep", _fn("dkmc_heat_dense_substep")(
        _is_f64(temp), M.data_ptr(), ws.u.data_ptr(), ws.src.data_ptr(), ws.iidx.data_ptr(),
        temp.data_ptr(), ni, float(T0), float(scale), int(negate), ws.k.data_ptr(),
        ws.n[which:].data_ptr(), ws.cond[which:].data_ptr(), ws.ticket.data_ptr(), handle,
        _build.launch_counter(temp.device, "heat_dense_substep"), _stream(temp, stream),
        DENSE_FORMS.index(plan.form), plan.rows, plan.vec, plan.tile, plan.grid))
    dense_substep.launches += 1


dense_substep.launches = 0


def cg_begin_plain(ws: Workspace, op: tuple, warm: bool, temp: torch.Tensor, T0: float,
                   scale: float, tol: float, maxiter: int) -> None:
    """The plain version of :func:`cg_begin`: ``boundary_cg.cg_setup`` of
    ``b = x0 + src`` on the interface from x0."""
    mask = op[3]
    x0 = torch.where(mask, (temp - T0) / scale, 0.0) if warm else torch.zeros_like(temp)
    b = torch.where(mask, x0 + ws.src, 0.0)
    c = ws.cg
    boundary_cg.cg_setup(op, b[None], x0[None], c.minv, tol, maxiter, c.act0, c)


def cg_begin(ws: Workspace, op: tuple, warm: bool, temp: torch.Tensor, T0: float,
             scale: float, tol: float, maxiter: int, stream=None) -> None:
    """The set-up of one CG solve of ``op`` (``ws.op_t`` or ``ws.op_s``) in
    ``ws.cg``: x0 = (T - T0) / scale on the interface (``warm``; else 0),
    b = x0 + src there, r = p = b - A x0, r.r, the threshold ``tol ||b||``,
    the stop flag, the count 0 and the inner predicate."""
    if temp.device.type == "cpu":
        return cg_begin_plain(ws, op, warm, temp, T0, scale, tol, maxiter)
    diag, vals, nb, mask = op
    c = ws.cg
    n, m = nb.shape
    grid = cg_begin_grid(n)
    if ws.part.numel() < 2 * grid or ws.part.data_ptr() % 16 != 0:
        raise ValueError(f"cg_begin: the partial sums hold {ws.part.numel()} entries, the "
                         f"grid of {grid} blocks needs {2 * grid}, 16-byte aligned")
    _launched("heat_cg_begin", _fn("dkmc_heat_cg_begin")(
        _is_f64(temp), temp.data_ptr(), mask.data_ptr(), ws.src.data_ptr(), diag.data_ptr(),
        vals.data_ptr(), nb.data_ptr(), c.row_len.data_ptr(), c.x.data_ptr(), c.r.data_ptr(),
        c.p.data_ptr(), c.rz.data_ptr(), c.rr.data_ptr(), c.thresh2.data_ptr(),
        c.act0.data_ptr(), c.act.data_ptr(), c.iters.data_ptr(), c.ctl.data_ptr(),
        c.cond.data_ptr(), ws.part.data_ptr(), ws.ticket.data_ptr(), float(T0), float(scale),
        float(tol), int(warm), n, m, int(maxiter),
        _build.launch_counter(temp.device, "heat_cg_begin"), _stream(temp, stream), grid,
        c.bar.data_ptr()))
    cg_begin.launches += 1


cg_begin.launches = 0


def cg_end_plain(ws: Workspace, temp: torch.Tensor, T0: float, scale: float, negate: bool,
                 which: int) -> None:
    """The plain version of :func:`cg_end`."""
    x = ws.cg.x[0]
    temp.copy_(torch.where(ws.op_t[3], (-x if negate else x) * scale + T0, temp))
    ws.log[2] += ws.cg.iters[0]
    ws.k += 1
    ws.cond[which] = (ws.k[0] < ws.n[which]).to(torch.int32)


def cg_end(ws: Workspace, temp: torch.Tensor, T0: float, scale: float, negate: bool,
           which: int, handle: int = 0, stream=None) -> None:
    """The end of one solve of loop ``which`` (0: transient; 1: steady,
    ``negate``): ``T = (-)x scale + T0`` on the interface, the solve's
    iterations added to ``ws.log[2]``, the counter advanced and the predicate
    ``ws.cond[which]`` (and the WHILE node ``handle``'s condition) set."""
    if temp.device.type == "cpu":
        return cg_end_plain(ws, temp, T0, scale, negate, which)
    c = ws.cg
    _launched("heat_cg_end", _fn("dkmc_heat_cg_end")(
        _is_f64(temp), c.x.data_ptr(), ws.op_t[3].data_ptr(), temp.data_ptr(),
        temp.shape[0], float(T0), float(scale), int(negate), c.iters.data_ptr(),
        ws.log[2:].data_ptr(), ws.k.data_ptr(), ws.n[which:].data_ptr(),
        ws.cond[which:].data_ptr(), handle, _build.launch_counter(temp.device, "heat_cg_end"),
        _stream(temp, stream)))
    cg_end.launches += 1


cg_end.launches = 0


# ----------------------------------------------------------------------------
# the loops
# ----------------------------------------------------------------------------

def _looped(t: torch.Tensor) -> bool:
    """The loops run as device loops: on CPU tensors (their plain ``while``)
    and under a capture on the card; else from the host loop."""
    return t.device.type == "cpu" or torch.cuda.is_current_stream_capturing()


def _trip_counts(ws: Workspace) -> Tuple[int, int]:
    """The host loop's trip counts: known from :func:`prepare`, else one
    read."""
    if ws.host_n is not None:
        return ws.host_n
    cg_mod.readbacks += 1
    return tuple(ws.n.tolist())


def run_dense(ws: Workspace, L_inv: torch.Tensor, L_ss_inv: torch.Tensor, temp: torch.Tensor,
              T0: float, scale: float) -> None:
    """The dense model's two loops on ``temp`` after :func:`prepare` (and
    ``ws.u[0]``, ``ws.src`` set): the transient substeps of L_inv, then the
    steady pass of L_ss_inv."""
    loops = ((L_inv, False, 0), (L_ss_inv, True, 1))
    if _looped(temp):
        for M, negate, which in loops:
            device_while(ws.cond[which:which + 1], lambda h, s, M=M, negate=negate,
                         which=which: dense_substep(ws, M, temp, T0, scale, negate, which,
                                                    h, s))
        return
    for (M, negate, which), trips in zip(loops, _trip_counts(ws)):
        for _ in range(trips):
            dense_substep(ws, M, temp, T0, scale, negate, which)


def _cg_host(ws: Workspace, op: tuple, maxiter: int) -> None:
    """One CG solve on the card outside a capture, after :func:`cg_begin`:
    the boundary CG's iterations in chunks while a read of the predicate
    says go, one read before the first chunk and one after each
    (iterations past the stop leave the iterate and the count as they are;
    no chunk passes the cap)."""
    chunk = ran = 0
    cg_mod.readbacks += 1
    go = bool(int(ws.cg.cond[0]))
    while go:
        n = min(cg_mod.CHUNKS[min(chunk, len(cg_mod.CHUNKS) - 1)], maxiter - ran)
        for _ in range(n):
            boundary_cg.cg_iteration(ws.cg, op, maxiter)
        chunk += 1
        ran += n
        cg_mod.readbacks += 1
        go = bool(int(ws.cg.cond[0])) and ran < maxiter


def run_cg(ws: Workspace, temp: torch.Tensor, T0: float, scale: float, tol: float,
           maxiter: int) -> None:
    """The matrix-free model's two loops on ``temp`` after :func:`prepare`
    (and ``ws.src`` set): the transient substeps, each a CG solve of ``I -
    s L`` warm from the field, then the steady solve of ``-L`` from 0; each
    solve at ``tol`` (criterion "r") and at most ``maxiter`` iterations."""
    loops = ((ws.op_t, True, False, 0), (ws.op_s, False, True, 1))
    if _looped(temp):
        for op, warm, negate, which in loops:
            def substep(handle, stream, op=op, warm=warm, negate=negate, which=which):
                cg_begin(ws, op, warm, temp, T0, scale, tol, maxiter, stream)
                device_while(ws.cg.cond, lambda h, s: boundary_cg.cg_iteration(
                    ws.cg, op, maxiter, h, s), stream=stream)
                cg_end(ws, temp, T0, scale, negate, which, handle, stream)

            device_while(ws.cond[which:which + 1], substep)
        return
    for (op, warm, negate, which), trips in zip(loops, _trip_counts(ws)):
        for _ in range(trips):
            cg_begin(ws, op, warm, temp, T0, scale, tol, maxiter)
            _cg_host(ws, op, maxiter)
            cg_end(ws, temp, T0, scale, negate, which)
