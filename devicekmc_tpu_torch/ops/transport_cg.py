"""The warm transport solve of a captured superstep: the mixed-precision CG
with iterative refinement as two nested device loops (``ops.graph.device_while``)
whose bodies are hand-written kernels (``csrc/transport_cg.cu``, the band's
and the on-the-fly metal block's ``out=`` entries, and the transport build of
boundary_cg's ``cg_update_direction``).

Replaces the JAX package's refinement loop and inner CG of the transport
solve, the ``lax.while_loop``s of ``devicekmc_tpu/ops/cg.py:225`` and ``:112``
inside its jitted superstep.  :func:`solve` computes what
``ops.cg.cg_solve_mixed`` computes for the Jacobi-scaled blocked operator
(``physics.current``, the warm re-solve with the Jacobi preconditioner) with
the same stop rules and counts:

* the set-up: ``thresh = tol ||b||``, the f64 residual of the warm start and
  its norm (:func:`round_end` with ``first``);
* the refinement rounds while ``||r|| > thresh``, fewer than ``max_outer``
  rounds and fewer than ``maxiter`` inner iterations ran: a WHILE node whose
  body is the inner CG (a WHILE node nested in it) and :func:`round_end`
  (the correction ``x += f64(inner x) scale``, the f64 residual, its norm,
  the next round's scale, tolerance and inner set-up with its direction
  packed, the outer predicate);
* the inner CG (f32, criterion "r", no diagonal: the system is already
  scaled) at the round's tolerance, at most ``INNER_MAXITER`` iterations:
  :func:`inner_iteration`, the band beside two branches, the fly matvec and
  transport_blocks (:func:`products`), then transport_rows, then the update
  and direction that also packs the next direction (:func:`update_pack`).

Every buffer lives in a :class:`Workspace` made before the capture, so
nothing allocates inside a body.  For CPU tensors each kernel wrapper runs
its plain version, the arithmetic of ``cg_solve_mixed`` and
``physics.current._apply_X_blocks`` in their order (sums through
``torch.dot``), so the CPU result is theirs bit for bit; on the card the
kernels reduce in another, fixed order.  Outside a capture on the card the
same kernels run from a host loop that reads the predicates once a round and
once a chunk of inner iterations (``ops.cg.CHUNKS``): its result is the
captured loop's bit for bit, iteration counts included.

Launches: each wrapper's ``launches`` counts its host calls (one a capture
of a loop's body); the card counts every launch of the pack, blocks, rows,
refine and update-and-pack kernels, the band and the fly matvec
(``_build.launch_counts``), and ``Workspace.cg.total`` the inner iterations
run.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from . import _build, boundary_cg, cg as cg_mod
from .banded import BandSlots, banded_matvec_out
from .boundary_cg import Workspace as CGWorkspace
from .boundary_cg import cg_update_direction_plain, n_tiles
from .cg import rowdot
from .graph import device_while, fork, join
from .wkb_fly import matvec_scratch, wkb_fly_matvec_out

#: the inner CG's tolerance floor and iteration cap, and the refinement
#: rounds at most (``physics.current.update_power_blocked``'s and
#: ``cg_solve_mixed``'s values)
INNER_TOL = 1e-5
INNER_MAXITER = 400
MAX_OUTER = 40
#: rows a tile of transport_rows (one a thread) and of transport_refine (two
#: a thread), whose partial sums have a slot of their own
ROW_TILE = 256
TILE = 512
#: the tiles of T_vm that transport_blocks reads: rows x columns
BLOCK_ROWS = 32
BLOCK_COLS = 128


def row_tiles(n: int, tile: int = ROW_TILE) -> int:
    return -(-n // tile)


@dataclass
class Workspace:
    """The buffers of one transport solve, made before a capture.

    ``cg``: the inner CG's (``boundary_cg.Workspace`` at B = 1, f32, Nsub
    rows, ``minv = 1``).  The products: ``xs32`` / ``xs64`` the scaled full
    vector [Na + 2], ``xw`` the band's zero-padded window, ``xm`` the metal
    vector [n_mp] (f32), ``band_y`` the band's output, ``y_cc`` the metal
    block's, ``fly`` its scratch; transport_blocks': ``mv`` the columns
    T_vm^T x_v [n_mp], ``y_vm`` / ``y_vv`` / ``y_bump`` [vcap], ``dots32`` /
    ``dots64`` the virtual nodes', its scratch ``col_part`` [row tiles,
    n_mp], ``row_part`` [column tiles, vcap] and ``tickets`` [column tiles +
    row tiles]; ``part32`` / ``part64`` transport_rows' tiles' partial sums
    and ``ticket`` its last ticket; ``part_b`` and ``bar`` transport_refine's
    partial sums and grid barrier.  The refinement (f64): the iterate ``x``,
    residual ``r`` and its r.r ``rsum`` [Nsub], the threshold ``thresh``, the
    go flag ``go`` (False: a skipped solve, no round), the rounds ``it_out``
    and inner iterations ``it_in``, ``rnorm``, ``scale``, ``rnorm0`` (||r||
    of the warm start), the outer predicate ``cond``.  ``inv32`` the band's
    window slot of each atom, ``front`` its leading zeros, ``shape`` (R,
    m_pad, B)."""
    cg: CGWorkspace
    xs32: torch.Tensor
    xs64: torch.Tensor
    xw: torch.Tensor
    xm: torch.Tensor
    band_y: torch.Tensor
    y_cc: torch.Tensor
    fly: tuple
    mv: torch.Tensor
    y_vm: torch.Tensor
    y_vv: torch.Tensor
    y_bump: torch.Tensor
    dots32: torch.Tensor
    dots64: torch.Tensor
    col_part: torch.Tensor
    row_part: torch.Tensor
    tickets: torch.Tensor
    part32: torch.Tensor
    part64: torch.Tensor
    ticket: torch.Tensor
    part_b: torch.Tensor
    bar: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    rsum: torch.Tensor
    thresh: torch.Tensor
    go: torch.Tensor
    it_out: torch.Tensor
    it_in: torch.Tensor
    rnorm: torch.Tensor
    scale: torch.Tensor
    rnorm0: torch.Tensor
    cond: torch.Tensor
    inv32: torch.Tensor
    pi: torch.Tensor
    front: int
    shape: tuple


def workspace(n_atoms: int, vcap: int, n_mp: int, band, device) -> Workspace:
    """The buffers of a solve of the grounded system of ``n_atoms`` atoms
    (Nsub = n_atoms + 1 rows) with a vacancy bucket of ``vcap``, ``n_mp``
    interior-metal atoms and the static ``band`` (``build_banded_nb``)."""
    dev = torch.device(device)
    nsub, n_full = n_atoms + 1, n_atoms + 2
    R, m_pad, B = band["slots"].shape
    tiles = row_tiles(nsub)
    n_ct, n_rt = -(-n_mp // BLOCK_COLS), -(-vcap // BLOCK_ROWS)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    inner = CGWorkspace(
        x=z(1, nsub), r=z(1, nsub), p=z(1, nsub), ap=z(1, nsub),
        minv=torch.ones(1, nsub, dtype=torch.float32, device=dev),
        rz=z(1), rr=z(1), thresh2=z(1), alpha=z(1), beta=z(1),
        act0=z(1, dtype=torch.bool), act=z(1, dtype=torch.bool), iters=z(1, dtype=i64),
        ctl=z(2, dtype=i32), cond=z(1, dtype=i32), total=z(1, dtype=i64),
        part=z(2 * n_tiles(nsub)), tickets=z(1, dtype=i32),
        bar=z(1, dtype=i32), row_len=z(0, dtype=i32), grid_mv=1)
    return Workspace(
        cg=inner, xs32=z(n_full), xs64=z(n_full, dtype=f64),
        xw=z((R + m_pad - 1) * B), xm=z(n_mp), band_y=z(R * B), y_cc=z(n_mp),
        fly=matvec_scratch(n_mp, dev), mv=z(n_mp), y_vm=z(vcap), y_vv=z(vcap),
        y_bump=z(vcap), dots32=z(2), dots64=z(2, dtype=f64), col_part=z(n_rt * n_mp),
        row_part=z(n_ct * vcap), tickets=z(n_ct + n_rt, dtype=i32), part32=z(tiles),
        part64=z(tiles, dtype=f64), ticket=z(1, dtype=i32),
        part_b=z(row_tiles(nsub, TILE)), bar=z(1, dtype=i32), x=z(nsub, dtype=f64),
        r=z(nsub, dtype=f64), rsum=z(1, dtype=f64), thresh=z(1, dtype=f64),
        go=z(1, dtype=torch.bool), it_out=z(1, dtype=i64), it_in=z(1, dtype=i64),
        rnorm=z(1, dtype=f64), scale=z(1, dtype=f64), rnorm0=z(1, dtype=f64),
        cond=z(1, dtype=i32), inv32=band["inv"].to(device=dev, dtype=i32).contiguous(),
        pi=band["pi"].to(dev), front=int(band["front"]), shape=(R, m_pad, B))


class Operator(NamedTuple):
    """One solve's operator, as the kernels read it (assembled by
    ``physics.current``): the Jacobi scaling ``dsi`` / ``dsi32`` [Nsub] and
    the scaled right-hand side ``b`` (f64); the diagonal ``diag`` / ``diag32``
    [Na + 2]; the virtual rows ``gnd`` / ``gnd32`` / ``src`` / ``src32`` [Na],
    nonzero on atoms ``gnd_lo`` .. Na - 1 and 0 .. ``nsi`` - 1, and
    ``loop_G``; the band's ``slots`` (``ops.banded.BandSlots``); the bump
    ``dyn`` [vcap, max_nn] (f32); the ELL conductances ``nbv`` [Na, max_nn]
    (f64) over the atom graph ``anb`` (int32, pad -1); the vacancy blocks
    ``T_vm`` [vcap, n_mp] and ``T_vv`` [vcap, vcap] (f32), the bucket
    ``vidx`` [vcap] (int32), each atom's bucket slot ``vslot`` (int32, -1
    none), the live count ``n_vac`` (int32 [1]); the metal atoms' slots
    ``mp_inv`` [Na] (int32, -1 none) and indices ``mp``; the fly kernel's
    ``mpos``, ``mcb``, ``env``; the plain versions of the product's two
    parts, ``plain_blocks(x, wd)`` and ``plain_rows(x, wd, band_y, y_cc,
    parts)`` (``physics.current``'s ``apply_blocks`` and ``apply_rows`` of
    the solve's blocks)."""
    dsi: torch.Tensor
    dsi32: torch.Tensor
    b: torch.Tensor
    diag: torch.Tensor
    diag32: torch.Tensor
    gnd: torch.Tensor
    gnd32: torch.Tensor
    src: torch.Tensor
    src32: torch.Tensor
    gnd_lo: int
    nsi: int
    loop_G: float
    slots: BandSlots
    dyn: torch.Tensor
    nbv: torch.Tensor
    anb: torch.Tensor
    T_vm: torch.Tensor
    T_vv: torch.Tensor
    vidx: torch.Tensor
    vslot: torch.Tensor
    n_vac: torch.Tensor
    mp_inv: torch.Tensor
    mp: torch.Tensor
    mpos: torch.Tensor
    mcb: torch.Tensor
    env: dict
    plain_blocks: Callable
    plain_rows: Callable


class Result(NamedTuple):
    """The solve's outcome, device tensors: the iterate [Nsub] (f64, the
    workspace's), the inner iterations summed, ||r|| of the last residual
    and of the warm start, the threshold."""
    x: torch.Tensor
    iters: torch.Tensor
    residual: torch.Tensor
    rnorm0: torch.Tensor
    thresh: torch.Tensor


# ----------------------------------------------------------------------------
# the kernels (CUDA tensors) and their plain versions (CPU tensors)
# ----------------------------------------------------------------------------

def _fn(symbol):
    fn = getattr(_build.load("transport_cg"), symbol)
    if fn.argtypes is None:
        p, i, d, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_ulonglong
        fn.argtypes = {
            "dkmc_transport_pack": [p, p, p, p, i, p, i, p, p, p, p],
            "dkmc_transport_blocks": [i] + [p] * 10 + [i] * 6 + [p] * 10,
            "dkmc_transport_rows": [i] + [p] * 17 + [d, i, i] + [p] * 12,
            "dkmc_transport_refine": [p] * 27 + [i, p, p, d, i, i, i, i, u, p, p],
        }[symbol]
        fn.restype = ctypes.c_int
    return fn


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(t: torch.Tensor, stream):
    return torch.cuda.current_stream(t.device).cuda_stream if stream is None else stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def pack_plain(tw: Workspace, op: Operator, hi: bool, first: bool = False) -> None:
    """The plain version of :func:`pack` (``hi``) and of the direction's
    packing by :func:`update_pack` and :func:`refine` (the full f32 vector,
    the band's window and the metal vector of the inner direction)."""
    na = op.mp_inv.shape[0]
    zero = torch.zeros(1, dtype=torch.float64 if hi else torch.float32, device=tw.x.device)
    if hi:
        if not first:
            tw.x.copy_(tw.x + tw.cg.x[0].to(torch.float64) * tw.scale[0])
        tw.xs64.copy_(torch.cat([op.dsi * tw.x, zero]))
        tw.xm.copy_(tw.xs64[2:][op.mp].to(torch.float32))
        return
    tw.xs32.copy_(torch.cat([op.dsi32 * tw.cg.p[0], zero]))
    xa = tw.xs32[2:]
    tw.xw[tw.front:tw.front + na] = xa[tw.pi]
    tw.xm.copy_(xa[op.mp])


def pack(tw: Workspace, op: Operator, first: bool = False, stream=None) -> None:
    """The refinement's iterate after adding the finished round's correction
    ``f64(inner x) * scale`` (unless ``first``): the full f64 vector and the
    metal vector."""
    if tw.x.device.type == "cpu":
        return pack_plain(tw, op, True, first)
    _launched("transport_pack", _fn("dkmc_transport_pack")(
        _ptr(op.dsi), _ptr(tw.x), _ptr(tw.cg.x), _ptr(tw.scale), int(first), _ptr(op.mp_inv),
        op.mp_inv.shape[0] + 1, _ptr(tw.xs64), _ptr(tw.xm),
        _build.launch_counter(tw.x.device, "transport_pack"), _stream(tw.x, stream)))
    pack.launches += 1


pack.launches = 0


def band(tw: Workspace, op: Operator, stream=None) -> None:
    """The band's product of the window (``banded_matvec_out``)."""
    banded_matvec_out(op.slots, tw.xw, tw.band_y, stream)


def fly(tw: Workspace, op: Operator, stream=None) -> None:
    """The on-the-fly metal block's product of the metal vector
    (``wkb_fly_matvec_out``)."""
    wkb_fly_matvec_out(op.mpos, op.mcb, tw.xm, op.env, tw.y_cc, tw.fly, stream)


def blocks_plain(tw: Workspace, op: Operator, hi: bool) -> None:
    """The plain version of :func:`blocks`."""
    xs, wd = (tw.xs64, torch.float64) if hi else (tw.xs32, torch.float32)
    y_mv, y_vv, y_vm, d_gnd, d_src, bump = op.plain_blocks(xs, wd)
    tw.mv.copy_(y_mv)
    tw.y_vv.copy_(y_vv)
    tw.y_vm.copy_(y_vm)
    if bump is not None:
        tw.y_bump.copy_(bump)
    (tw.dots64 if hi else tw.dots32).copy_(torch.stack([d_gnd, d_src]))


def blocks(tw: Workspace, op: Operator, hi: bool, stream=None) -> None:
    """The parts of the product that read the packed vector alone (of the
    inner direction, or ``hi`` of the refinement's iterate): the columns
    T_vm^T x_v, T_vm x_m, T_vv x_v, the bump (not ``hi``: the band's) and the
    two virtual-node dots."""
    if tw.x.device.type == "cpu":
        return blocks_plain(tw, op, hi)
    na, max_nn = op.anb.shape
    vcap, n_mp = op.T_vm.shape
    _launched("transport_blocks", _fn("dkmc_transport_blocks")(
        int(hi), _ptr(tw.xs64 if hi else tw.xs32), _ptr(tw.xm), _ptr(op.T_vm), _ptr(op.T_vv),
        _ptr(op.vidx), _ptr(op.n_vac), None if hi else _ptr(op.dyn), _ptr(op.anb),
        _ptr(op.gnd if hi else op.gnd32), _ptr(op.src if hi else op.src32), op.gnd_lo, op.nsi,
        na, max_nn, vcap, n_mp, _ptr(tw.mv), _ptr(tw.y_vm), _ptr(tw.y_vv), _ptr(tw.y_bump),
        _ptr(tw.dots64 if hi else tw.dots32), _ptr(tw.col_part), _ptr(tw.row_part),
        _ptr(tw.tickets), _build.launch_counter(tw.x.device, "transport_blocks"),
        _stream(tw.x, stream)))
    blocks.launches += 1


blocks.launches = 0


def rows_plain(tw: Workspace, op: Operator, hi: bool) -> None:
    """The plain version of :func:`rows`."""
    nsub = op.dsi.shape[0]
    wd = torch.float64 if hi else torch.float32
    dots = tw.dots64 if hi else tw.dots32
    parts = (tw.mv.to(wd), tw.y_vv.to(wd), tw.y_vm.to(wd), dots[0], dots[1],
             None if hi else tw.y_bump)
    if hi:
        ap = op.dsi * op.plain_rows(tw.xs64, wd, None, tw.y_cc, parts)[:nsub]
        r = op.b - ap
        tw.r.copy_(r)
        tw.rsum.copy_(torch.dot(r, r).reshape(1))
        return
    ap = op.dsi32 * op.plain_rows(tw.xs32, wd, tw.band_y, tw.y_cc, parts)[:nsub]
    c = tw.cg
    c.ap[0].copy_(ap)
    denom = rowdot(c.p, c.ap)
    c.alpha.copy_(torch.where(denom != 0, c.rz / denom, 0.0))


def rows(tw: Workspace, op: Operator, hi: bool, stream=None) -> None:
    """Every row of the product from the packed vector and the outputs of
    the band (not ``hi``: else the ELL part), the metal block and
    :func:`blocks`: the inner CG's ``ap = A p`` and its step ``alpha = r.z /
    p.ap`` (f32), or the refinement's residual ``r = b - A x`` and its r.r
    (``hi``, f64)."""
    if tw.x.device.type == "cpu":
        return rows_plain(tw, op, hi)
    c = tw.cg
    na, max_nn = op.anb.shape
    _launched("transport_rows", _fn("dkmc_transport_rows")(
        int(hi), _ptr(tw.xs64 if hi else tw.xs32), None if hi else _ptr(tw.band_y),
        _ptr(tw.inv32), None if hi else _ptr(tw.y_bump), _ptr(op.nbv) if hi else None,
        _ptr(op.anb), _ptr(op.vslot), _ptr(op.mp_inv), _ptr(tw.y_cc), _ptr(tw.mv),
        _ptr(tw.y_vm), _ptr(tw.y_vv), _ptr(tw.dots64 if hi else tw.dots32),
        _ptr(op.gnd if hi else op.gnd32), _ptr(op.src if hi else op.src32),
        _ptr(op.diag if hi else op.diag32), _ptr(op.dsi if hi else op.dsi32),
        float(op.loop_G), na, max_nn, _ptr(c.p), _ptr(c.ap), _ptr(c.rz), _ptr(c.alpha),
        _ptr(c.act), _ptr(op.b), _ptr(tw.r), _ptr(tw.rsum),
        _ptr(tw.part64 if hi else tw.part32), _ptr(tw.ticket),
        _build.launch_counter(tw.x.device, "transport_rows"), _stream(tw.x, stream)))
    rows.launches += 1


rows.launches = 0


def update_pack_plain(tw: Workspace, op: Operator) -> None:
    """The plain version of :func:`update_pack`."""
    cg_update_direction_plain(tw.cg, INNER_MAXITER)
    pack_plain(tw, op, False)


def update_pack(tw: Workspace, op: Operator, handle: int = 0, stream=None) -> None:
    """The inner CG's update and direction (boundary_cg's
    ``cg_update_direction`` with ``minv = 1``, which sets the inner
    predicate and the WHILE node ``handle``'s condition), the new direction
    packed as :func:`pack_plain` packs it: one launch of the kernel's
    transport build."""
    if tw.x.device.type == "cpu":
        return update_pack_plain(tw, op)
    c = tw.cg
    _launched("cg_update_direction_pack", boundary_cg._fn("dkmc_cg_update_direction_pack")(
        _ptr(c.x), _ptr(c.r), _ptr(c.p), _ptr(c.ap), _ptr(c.minv), _ptr(c.act), _ptr(c.act0),
        _ptr(c.alpha), _ptr(c.beta), _ptr(c.rz), _ptr(c.rr), _ptr(c.thresh2), _ptr(c.iters),
        _ptr(c.part), _ptr(c.bar), _ptr(c.ctl), _ptr(c.cond), _ptr(c.total), handle,
        c.x.shape[1], INNER_MAXITER, _ptr(op.dsi32), _ptr(tw.xs32), _ptr(tw.xw), _ptr(tw.xm),
        _ptr(tw.inv32), _ptr(op.mp_inv), tw.front,
        _build.launch_counter(tw.x.device, "cg_update_direction_pack"), _stream(tw.x, stream)))
    update_pack.launches += 1


update_pack.launches = 0


def refine_plain(tw: Workspace, op: Operator, first: bool, max_outer: int,
                 maxiter: int) -> None:
    """The plain version of :func:`refine`."""
    c = tw.cg
    rn = torch.sqrt(tw.rsum[0])
    if not first:
        tw.it_out += 1
        tw.it_in += c.iters
    go = tw.go[0] & (rn > tw.thresh[0]) & (tw.it_out[0] < max_outer) & (tw.it_in[0] < maxiter)
    scale = torch.where(rn > 0, rn, 1.0)
    b_in = (tw.r / scale).to(torch.float32)
    needed = tw.thresh[0] / torch.clamp(rn, min=1e-300)
    tol = torch.clamp(torch.clamp(0.1 * needed, min=INNER_TOL), max=0.05).to(torch.float32)
    c.x.zero_()
    c.r[0].copy_(b_in)
    c.p[0].copy_(b_in)
    pack_plain(tw, op, False)
    rz = rowdot(c.r, c.p)
    ref = torch.sqrt(rz)
    th = tol * torch.where(ref > 0, ref, 1.0)
    th2 = th * th
    act = go & (rz > th2)
    c.rz.copy_(rz)
    c.rr.copy_(rz)
    c.thresh2.copy_(th2)
    c.act0.copy_(go)
    c.act.copy_(act)
    c.iters.zero_()
    c.ctl[0] = 0
    c.ctl[1] = act.to(torch.int32)[0]
    c.cond.copy_(act.to(torch.int32))
    tw.rnorm.copy_(rn)
    tw.scale.copy_(scale)
    if first:
        tw.rnorm0.copy_(rn)
    tw.cond.copy_(go.to(torch.int32))


def refine(tw: Workspace, op: Operator, first: bool, max_outer: int, maxiter: int,
           handle: int = 0, stream=None) -> None:
    """The end of a round (and, ``first``, of the set-up) from the f64
    residual: ||r||, the rounds and inner iterations counted, the outer
    predicate ``tw.cond`` (also set as the condition of the WHILE node
    ``handle``, 0: none), the scale, and the next round's inner CG: ``b_in =
    f32(r / scale)``, the round's tolerance, x = 0, r = p = b_in (p packed as
    :func:`pack_plain` packs it), r.r, the threshold and the inner
    predicate."""
    if tw.x.device.type == "cpu":
        return refine_plain(tw, op, first, max_outer, maxiter)
    c = tw.cg
    _launched("transport_refine", _fn("dkmc_transport_refine")(
        _ptr(tw.r), _ptr(tw.rsum), _ptr(tw.thresh), _ptr(tw.go), _ptr(tw.it_out),
        _ptr(tw.it_in), _ptr(tw.rnorm), _ptr(tw.scale), _ptr(tw.rnorm0), _ptr(tw.cond),
        _ptr(c.x), _ptr(c.r), _ptr(c.p), _ptr(c.rz), _ptr(c.rr), _ptr(c.thresh2),
        _ptr(c.act0), _ptr(c.act), _ptr(c.iters), _ptr(c.ctl), _ptr(c.cond), _ptr(op.dsi32),
        _ptr(tw.xs32), _ptr(tw.xw), _ptr(tw.xm), _ptr(tw.inv32), _ptr(op.mp_inv), tw.front,
        _ptr(tw.part_b), _ptr(tw.bar), INNER_TOL, int(first), int(max_outer), int(maxiter),
        tw.x.shape[0], handle, _build.launch_counter(tw.x.device, "transport_refine"),
        _stream(tw.x, stream)))
    refine.launches += 1


refine.launches = 0


# ----------------------------------------------------------------------------
# the loops
# ----------------------------------------------------------------------------

def products(tw: Workspace, op: Operator, stream=None) -> None:
    """The products of the inner direction that :func:`rows` reads: the band
    on ``stream``, and beside it the fly matvec and :func:`blocks`, each on a
    branch of its own (``ops.graph.fork``), joined before the return.  The
    fastest of the WHILE body's forms on an H100 (``tools/probe_cg_events.py
    --parts transport``, the crossbar's warm solve, 345 inner iterations, two
    runs): the band captured first, then a branch each, 0.0393-0.0408 ms an
    inner iteration; the band captured after the two branches 0.0440-0.0441;
    one branch of the fly matvec then blocks, the band captured first
    0.0456, last 0.0472; every kernel in series 0.0505.  The fly matvec
    (0.0195 ms) is the longest of the three, the band (0.0055) the
    shortest: inside a WHILE body the nodes start in capture order, and the
    band captured first is done before the branches need the card.  Outside
    a capture (the host loop, and on the CPU) the same kernels run in order
    on one stream: the same bits."""
    dev = tw.x.device
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    side1 = fork(dev, stream, 1) if capturing else stream
    side2 = fork(dev, stream, 2) if capturing else stream
    band(tw, op, stream)
    fly(tw, op, side1)
    blocks(tw, op, False, side2)
    if capturing:
        join(dev, stream, 1)
        join(dev, stream, 2)


def inner_iteration(tw: Workspace, op: Operator, handle: int = 0, stream=None) -> None:
    """One iteration of the inner CG: A p (:func:`products`, :func:`rows`)
    and the update and direction with the next direction packed, which sets
    the inner predicate (and the WHILE node ``handle``'s condition)."""
    products(tw, op, stream)
    rows(tw, op, False, stream)
    update_pack(tw, op, handle, stream)


def round_end(tw: Workspace, op: Operator, max_outer: int, maxiter: int, first: bool = False,
              handle: int = 0, stream=None) -> None:
    """The f64 residual of the corrected iterate and the next round's set-up
    (:func:`refine`), in series."""
    pack(tw, op, first, stream)
    fly(tw, op, stream)
    blocks(tw, op, True, stream)
    rows(tw, op, True, stream)
    refine(tw, op, first, max_outer, maxiter, handle, stream)


def _read(*flags) -> list:
    """The host loop's read of its predicates (one transfer)."""
    cg_mod.readbacks += 1
    return torch.cat(flags).tolist()


def solve(tw: Workspace, op: Operator, x0: torch.Tensor, go: torch.Tensor, tol: float,
          maxiter: int, max_outer: int = MAX_OUTER) -> Result:
    """``cg_solve_mixed`` of the scaled system (``op``, right-hand side
    ``op.b``) from ``x0`` [Nsub] (f64) at ``tol``, on ``tw``; ``go`` a bool
    [1] tensor (False: no round, the iterate stays ``x0``).  Under a capture
    on the card (and on CPU tensors, through their plain versions) the two
    nested device loops; outside one on the card the same kernels from a
    host loop that reads the predicates once a round and once a chunk of
    inner iterations."""
    bnorm = torch.sqrt(torch.dot(op.b, op.b))
    tw.thresh.copy_((tol * torch.where(bnorm > 0, bnorm, 1.0)).reshape(1))
    tw.go.copy_(go.reshape(1))
    tw.x.copy_(x0)
    tw.it_out.zero_()
    tw.it_in.zero_()
    round_end(tw, op, max_outer, maxiter, first=True)
    dev = tw.x.device
    if dev.type == "cpu" or torch.cuda.is_current_stream_capturing():
        def outer(handle, stream):
            device_while(tw.cg.cond,
                         lambda h, s: inner_iteration(tw, op, h, s), stream=stream)
            round_end(tw, op, max_outer, maxiter, handle=handle, stream=stream)

        device_while(tw.cond, outer)
    else:
        while True:
            go_out, go_in = _read(tw.cond, tw.cg.cond)
            if not go_out:
                break
            chunk = ran = 0
            while go_in:
                # no chunk past the inner cap: the cap stops the loop, not
                # the iterate's flag, so an iteration past it would count
                n = min(cg_mod.CHUNKS[min(chunk, len(cg_mod.CHUNKS) - 1)], INNER_MAXITER - ran)
                for _ in range(n):
                    inner_iteration(tw, op)
                chunk += 1
                ran += n
                go_in = _read(tw.cg.cond)[0]
            round_end(tw, op, max_outer, maxiter)
    return Result(x=tw.x, iters=tw.it_in[0], residual=tw.rnorm[0], rnorm0=tw.rnorm0[0],
                  thresh=tw.thresh[0])
