"""The warm transport solve of a captured superstep: the mixed-precision CG
with iterative refinement as two nested device loops (``ops.graph.device_while``)
whose bodies are hand-written kernels (``csrc/transport_cg.cu`` and the
band's and the on-the-fly metal block's ``out=`` entries).

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
  transport_blocks (:func:`products`), then one cooperative launch of the
  rows, the update and the direction that also packs the next direction
  (:func:`rows_update`).

The metal block's product is the on-the-fly kernel's (``transport_cc =
"fly"``) or, with the block stored (``"stored"``, what ``"auto"`` picks on
every structure of the repo), :func:`stored_matvec_out`'s kernel
(``csrc/transport_cg.cu`` ``stored_matvec_kernel``).

In f64 precision :func:`solve_f64` computes what ``ops.cg.cg_solve`` with
the Jacobi ``diag`` and criterion "pre" computes for the unscaled blocked
operator (``physics.current``'s f64 warm re-solve), the counterpart of the
JAX package's ``lax.while_loop`` of ``devicekmc_tpu/ops/cg.py:112``: one
WHILE node whose body is the stored block's product beside transport_blocks
(f64 build), then one cooperative launch of the f64 rows of ``A p`` with
``p.ap`` and alpha, the update, the Jacobi direction and its packing
(:func:`tail_f64`).

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
refine and rows-and-update kernels, the stored block's product, the f64
tail, the band and the fly matvec (``_build.launch_counts``), and
``Workspace.cg.total`` (in f64 ``Workspace.c64.total``) the iterations run.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from . import _build, cg as cg_mod
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
#: a thread), whose partial sums have a slot of their own; a tile of
#: transport_rows_update holds RU_MIN_TILE rows or more (``kRuTile``)
ROW_TILE = 256
TILE = 512
RU_MIN_TILE = 128
#: rows a tile of the f64 solve's tail (a row a thread, ``kUpThreads``)
UPDATE_TILE = 512
#: the tiles of T_vm that transport_blocks reads: rows x columns
BLOCK_ROWS = 32
BLOCK_COLS = 128
#: rows a slice of transport_rows' atom graph (a warp's rows; csrc kSlice)
ATOM_SLICE = 32

def row_tiles(n: int, tile: int = ROW_TILE) -> int:
    return -(-n // tile)


def atom_slices(anb: torch.Tensor):
    """The atom graph ``anb`` [Na, max_nn] (int32, pad -1) as the f64 rows
    kernel reads it, a sliced ELL over the rows of the grounded system (row
    i the atom i - 2, Nsub = Na + 1 rows; rows 0 and 1, the virtual nodes,
    have no slots): slices of ATOM_SLICE rows (a warp's), each row's valid
    neighbours in ``anb``'s order, slot-major inside a slice and padded
    with -1 to the slice's longest row (row i's slot k at ``start[i //
    ATOM_SLICE] + k ATOM_SLICE + i % ATOM_SLICE``).  Returns (indices int32
    [E], the slices' first elements int32 [n_slices + 1]).  Static for a
    structure; one read of the device (E), so it is made before a capture."""
    na = anb.shape[0]
    nsub = na + 1
    dev = anb.device
    valid = anb[:na - 1] >= 0
    n_sl = -(-nsub // ATOM_SLICE)
    count = torch.zeros(n_sl * ATOM_SLICE, dtype=torch.int64, device=dev)
    count[2:nsub] = valid.sum(dim=1)
    start = torch.zeros(n_sl + 1, dtype=torch.int64, device=dev)
    start[1:] = torch.cumsum(count.view(n_sl, ATOM_SLICE).amax(dim=1) * ATOM_SLICE, 0)
    i = torch.arange(2, nsub, device=dev)[:, None]
    j = torch.cumsum(valid.to(torch.int64), dim=1) - 1
    pos = start[i // ATOM_SLICE] + j * ATOM_SLICE + i % ATOM_SLICE
    n = int(start[-1])
    if n >= 1 << 31:
        raise ValueError(f"atom slices: {n} elements exceed int32 indices")
    idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    idx[pos[valid]] = anb[:na - 1][valid]
    return idx, start.to(torch.int32)


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
    row tiles]; ``part_ru`` transport_rows_update's tiles' partial sums of
    p.ap and r.r (two slots for every RU_MIN_TILE rows and four more: the
    r.r slots start 16-byte aligned; its barrier is ``cg.bar``); ``part64``
    transport_rows' tiles' partial sums (the f64 tail's of p.ap, a 256-row
    tile each) and ``ticket`` its last ticket;
    ``part_b`` and ``ticket_b`` transport_refine's.  The refinement (f64): the iterate ``x``,
    residual ``r`` and its r.r ``rsum`` [Nsub], the threshold ``thresh``, the
    go flag ``go`` (False: a skipped solve, no round), the rounds ``it_out``
    and inner iterations ``it_in``, ``rnorm``, ``scale``, ``rnorm0`` (||r||
    of the warm start), the outer predicate ``cond``.  ``inv32`` the band's
    window slot of each atom, ``front`` its leading zeros, ``shape`` (R,
    m_pad, B) (empty, 0 and zeros without a band).

    In f64 precision (``c64`` set, ``cg`` None) the metal vector, the
    products and the tile sums of transport_blocks are f64, ``xs64`` holds
    the CG's direction p, ``x`` and ``r`` its iterate and residual, and
    ``c64`` the rest of its state (:class:`CG64`)."""
    cg: Optional[CGWorkspace]
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
    part_ru: torch.Tensor
    part64: torch.Tensor
    ticket: torch.Tensor
    part_b: torch.Tensor
    ticket_b: torch.Tensor
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
    c64: Optional["CG64"] = None


@dataclass
class CG64:
    """The f64 solve's state beside the workspace's ``x``, ``r`` and ``xs64``
    (iterate, residual, direction): ``ap`` [Nsub], the scalars ``rz``,
    ``alpha``, ``beta`` and the threshold ``thresh2`` of the criterion "pre"
    (f64 [1]), the flag ``act``, the iterations ``iters``, the predicate
    ``cond``, the tail's launches ``total``, its tiles' partial sums of r.z
    ``part`` (those of p.ap: the workspace's ``part64``) and grid barrier
    ``bar``."""
    ap: torch.Tensor
    rz: torch.Tensor
    alpha: torch.Tensor
    beta: torch.Tensor
    thresh2: torch.Tensor
    act: torch.Tensor
    iters: torch.Tensor
    cond: torch.Tensor
    total: torch.Tensor
    part: torch.Tensor
    bar: torch.Tensor


def workspace(n_atoms: int, vcap: int, n_mp: int, band, device,
              f64_solve: bool = False) -> Workspace:
    """The buffers of a solve of the grounded system of ``n_atoms`` atoms
    (Nsub = n_atoms + 1 rows) with a vacancy bucket of ``vcap``, ``n_mp``
    interior-metal atoms and the static ``band`` (``build_banded_nb``; None:
    none, the f64 solve reads the ELL rows); ``f64_solve``: the buffers of
    :func:`solve_f64`, else of the mixed :func:`solve`."""
    dev = torch.device(device)
    nsub, n_full = n_atoms + 1, n_atoms + 2
    R, m_pad, B = band["slots"].shape if band is not None else (0, 0, 0)
    tiles = row_tiles(nsub)
    n_ct, n_rt = -(-n_mp // BLOCK_COLS), -(-vcap // BLOCK_ROWS)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    pd = f64 if f64_solve else torch.float32
    inner = c64 = None
    if f64_solve:
        c64 = CG64(ap=z(nsub, dtype=f64), rz=z(1, dtype=f64), alpha=z(1, dtype=f64),
                   beta=z(1, dtype=f64), thresh2=z(1, dtype=f64), act=z(1, dtype=torch.bool),
                   iters=z(1, dtype=i64), cond=z(1, dtype=i32), total=z(1, dtype=i64),
                   part=z(row_tiles(nsub, UPDATE_TILE), dtype=f64), bar=z(1, dtype=i32))
    else:
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
        xw=z((R + m_pad - 1) * B if R else 0), xm=z(n_mp, dtype=pd), band_y=z(R * B),
        y_cc=z(n_mp, dtype=pd), fly=matvec_scratch(n_mp, dev), mv=z(n_mp, dtype=pd),
        y_vm=z(vcap, dtype=pd), y_vv=z(vcap, dtype=pd), y_bump=z(vcap), dots32=z(2),
        dots64=z(2, dtype=f64), col_part=z(n_rt * n_mp, dtype=pd),
        row_part=z(n_ct * vcap, dtype=pd), tickets=z(n_ct + n_rt, dtype=i32),
        part_ru=z(2 * row_tiles(nsub, RU_MIN_TILE) + 4),
        part64=z(tiles, dtype=f64), ticket=z(1, dtype=i32),
        part_b=z(row_tiles(nsub, TILE)), ticket_b=z(1, dtype=i32), x=z(nsub, dtype=f64),
        r=z(nsub, dtype=f64), rsum=z(1, dtype=f64), thresh=z(1, dtype=f64),
        go=z(1, dtype=torch.bool), it_out=z(1, dtype=i64), it_in=z(1, dtype=i64),
        rnorm=z(1, dtype=f64), scale=z(1, dtype=f64), rnorm0=z(1, dtype=f64),
        cond=z(1, dtype=i32),
        inv32=(band["inv"].to(device=dev, dtype=i32).contiguous() if band is not None
               else z(0, dtype=i32)),
        pi=band["pi"].to(dev) if band is not None else z(0, dtype=i64),
        front=int(band["front"]) if band is not None else 0, shape=(R, m_pad, B), c64=c64)


class Operator(NamedTuple):
    """One solve's operator, as the kernels read it (assembled by
    ``physics.current``): the Jacobi scaling ``dsi`` / ``dsi32`` [Nsub] and
    the scaled right-hand side ``b`` (f64); the diagonal ``diag`` / ``diag32``
    [Na + 2]; the virtual rows ``gnd`` / ``gnd32`` / ``src`` / ``src32`` [Na],
    nonzero on atoms ``gnd_lo`` .. Na - 1 and 0 .. ``nsi`` - 1, and
    ``loop_G``; the band's ``slots`` (``ops.banded.BandSlots``, f32 or bf16)
    and with bf16 slots its ``row_fix`` [Na] (f32, each row's rounding put
    back on the diagonal of the inner product; None: none); the bump
    ``dyn`` [vcap, max_nn] (f32); the atom graph ``anb`` [Na, max_nn]
    (int32, pad -1) and the same graph as the f64 rows kernel reads it,
    ``nb_idx`` and ``nb_start`` (:func:`atom_slices`, static for a
    structure), each atom's class ``cls`` [Na] (uint8: bit 0 metal, bit 1
    neutral vacancy) and the conductances ``g_hi`` (-high_G, of a pair
    whose atoms share a class bit) and ``g_lo`` (-low_G), from which that
    kernel makes each slot's ELL conductance as the assembly's ``nb_vals``
    holds it; the vacancy blocks
    ``T_vm`` [vcap, n_mp] and ``T_vv`` [vcap, vcap] (f32), the bucket
    ``vidx`` [vcap] (int32), each atom's bucket slot ``vslot`` (int32, -1
    none), the live count ``n_vac`` (int32 [1]); the metal atoms' slots
    ``mp_inv`` [Na] (int32, -1 none) and indices ``mp``; the fly kernel's
    ``mpos``, ``mcb``, ``env``; the plain versions of the product's two
    parts, ``plain_blocks(x, wd)`` and ``plain_rows(x, wd, band_y, y_cc,
    parts)`` (``physics.current``'s ``apply_blocks`` and ``apply_rows`` of
    the solve's blocks).  ``T_cc`` the stored metal block [n_mp, n_mp] (f32
    in mixed precision, f64 in f64; None: on the fly); ``minv`` [Nsub] the
    f64 solve's Jacobi 1 / diag (None in mixed precision, where ``dsi``
    scales the system and ``b`` is the scaled right-hand side; in f64
    ``dsi`` and the f32 twins are None, ``b`` the unscaled right-hand
    side)."""
    dsi: Optional[torch.Tensor]
    dsi32: Optional[torch.Tensor]
    b: torch.Tensor
    diag: torch.Tensor
    diag32: Optional[torch.Tensor]
    gnd: torch.Tensor
    gnd32: Optional[torch.Tensor]
    src: torch.Tensor
    src32: Optional[torch.Tensor]
    gnd_lo: int
    nsi: int
    loop_G: float
    slots: Optional[BandSlots]
    row_fix: Optional[torch.Tensor]
    dyn: Optional[torch.Tensor]
    anb: torch.Tensor
    nb_idx: torch.Tensor
    nb_start: torch.Tensor
    cls: torch.Tensor
    g_hi: float
    g_lo: float
    T_vm: torch.Tensor
    T_vv: torch.Tensor
    vidx: torch.Tensor
    vslot: torch.Tensor
    n_vac: torch.Tensor
    mp_inv: torch.Tensor
    mp: torch.Tensor
    mpos: Optional[torch.Tensor]
    mcb: Optional[torch.Tensor]
    env: Optional[dict]
    plain_blocks: Callable
    plain_rows: Callable
    T_cc: Optional[torch.Tensor] = None
    minv: Optional[torch.Tensor] = None


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
            "dkmc_transport_rows": [i] + [p] * 4 + [d, d] + [p] * 11 + [d, i] + [p] * 7,
            "dkmc_transport_stored": [i, p, p, p, i, p, p],
            "dkmc_transport_tail64": [p] * 4 + [d, d] + [p] * 10 + [d, i] + [p] * 14 + [u, i]
                                     + [p] * 4,
            "dkmc_transport_rows_update": [p] * 15 + [d, i] + [p] * 15 + [u, i] + [p] * 3
                                          + [i] + [p] * 4,
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
    packing by :func:`rows_update` and :func:`refine` (the full f32 vector,
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


def stored_matvec_plain(T_cc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`stored_matvec_out`: ``T_cc @ x`` in the
    block's dtype (``physics.current._apply_X_blocks``' product of a stored
    block)."""
    return T_cc.matmul(x)


def stored_matvec_out(T_cc: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      stream=None) -> None:
    """``y = T_cc @ x`` of the stored metal block [n, n] (row-major, f32 or
    f64 storage and sums in its dtype) into the caller's ``y`` [n] on
    ``stream``: a warp a row, the block's loads past L1 where it is at most
    a few of the card's L2s and through L1 where it is larger, one fixed
    order of each row's sum (``csrc/transport_cg.cu``
    ``stored_matvec_kernel``), so that a
    captured loop and a host loop get the same bits.  No TF32 and no
    library call: the product sits in the body of a WHILE node, which cannot
    allocate.  CPU tensors take :func:`stored_matvec_plain`; on the card the
    build or launch raises on failure.  ``launches`` counts the launches;
    the card counts them too."""
    if y.device.type == "cpu":
        y.copy_(stored_matvec_plain(T_cc, x))
        return
    n = T_cc.shape[0]
    if (T_cc.shape != (n, n) or not T_cc.is_contiguous() or x.shape != (n,)
            or y.shape != (n,) or not (T_cc.dtype == x.dtype == y.dtype)
            or T_cc.dtype not in (torch.float32, torch.float64)):
        raise ValueError("stored_matvec_out: a contiguous [n, n] block and [n] vectors of one "
                         "dtype, f32 or f64")
    _launched("stored_matvec", _fn("dkmc_transport_stored")(
        int(T_cc.dtype == torch.float64), _ptr(T_cc), _ptr(x), _ptr(y), n,
        _build.launch_counter(y.device, "stored_matvec"), _stream(y, stream)))
    stored_matvec_out.launches += 1


stored_matvec_out.launches = 0


def metal(tw: Workspace, op: Operator, stream=None) -> None:
    """The metal block's product ``y_cc`` of the metal vector: the stored
    block's (:func:`stored_matvec_out`) or, on the fly, :func:`fly`."""
    if op.T_cc is not None:
        stored_matvec_out(op.T_cc, tw.xm, tw.y_cc, stream)
    else:
        fly(tw, op, stream)


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
    mode = 0 if not hi else 2 if tw.c64 is not None else 1
    _launched("transport_blocks", _fn("dkmc_transport_blocks")(
        mode, _ptr(tw.xs64 if hi else tw.xs32), _ptr(tw.xm), _ptr(op.T_vm), _ptr(op.T_vv),
        _ptr(op.vidx), _ptr(op.n_vac), None if hi else _ptr(op.dyn), _ptr(op.anb),
        _ptr(op.gnd if hi else op.gnd32), _ptr(op.src if hi else op.src32), op.gnd_lo, op.nsi,
        na, max_nn, vcap, n_mp, _ptr(tw.mv), _ptr(tw.y_vm), _ptr(tw.y_vv), _ptr(tw.y_bump),
        _ptr(tw.dots64 if hi else tw.dots32), _ptr(tw.col_part), _ptr(tw.row_part),
        _ptr(tw.tickets), _build.launch_counter(tw.x.device, "transport_blocks"),
        _stream(tw.x, stream)))
    blocks.launches += 1


blocks.launches = 0


def _parts(tw: Workspace, hi: bool) -> tuple:
    """:func:`blocks`' products as ``physics.current.apply_rows`` takes them
    (in the working dtype of ``hi``)."""
    wd = torch.float64 if hi else torch.float32
    dots = tw.dots64 if hi else tw.dots32
    return (tw.mv.to(wd), tw.y_vv.to(wd), tw.y_vm.to(wd), dots[0], dots[1],
            None if hi else tw.y_bump)


def rows_plain(tw: Workspace, op: Operator, hi: bool) -> None:
    """The plain version of :func:`rows` (``hi``) and of the rows of
    :func:`rows_update`: every row of the product from the packed vector
    and the outputs of the band (not ``hi``: else the ELL part; with a bf16
    band its ``row_fix`` times the row's entry added to the band's value, a
    product and a sum each rounded, as ``physics.current._band_unpermute``
    adds it), the metal block and :func:`blocks`: the inner CG's ``ap = A p``
    and its step ``alpha = r.z / p.ap`` (f32), or the refinement's residual
    ``r = b - A x`` and its r.r (``hi``, f64; in the f64 solve, where
    ``dsi`` is None, of the unscaled system)."""
    nsub = op.b.shape[0]
    wd = torch.float64 if hi else torch.float32
    if hi:
        y = op.plain_rows(tw.xs64, wd, None, tw.y_cc, _parts(tw, True))[:nsub]
        r = op.b - (y if op.dsi is None else op.dsi * y)
        tw.r.copy_(r)
        tw.rsum.copy_(torch.dot(r, r).reshape(1))
        return
    parts = _parts(tw, False)
    ap = op.dsi32 * op.plain_rows(tw.xs32, wd, tw.band_y, tw.y_cc, parts)[:nsub]
    c = tw.cg
    c.ap[0].copy_(ap)
    denom = rowdot(c.p, c.ap)
    c.alpha.copy_(torch.where(denom != 0, c.rz / denom, 0.0))


def rows(tw: Workspace, op: Operator, stream=None) -> None:
    """The refinement's residual ``r = b - A x`` of the packed iterate and
    its r.r (f64; in the f64 solve, where ``dsi`` is None, of the unscaled
    system): every row from the ELL part (the operator's atom slices, each
    slot's conductance from the atoms' classes), the metal block and
    :func:`blocks`."""
    if tw.x.device.type == "cpu":
        return rows_plain(tw, op, True)
    _launched("transport_rows", _fn("dkmc_transport_rows")(
        int(tw.c64 is not None), _ptr(tw.xs64), _ptr(op.nb_idx), _ptr(op.nb_start),
        _ptr(op.cls), float(op.g_hi), float(op.g_lo), _ptr(op.vslot),
        _ptr(op.mp_inv), _ptr(tw.y_cc), _ptr(tw.mv), _ptr(tw.y_vm), _ptr(tw.y_vv),
        _ptr(tw.dots64), _ptr(op.gnd), _ptr(op.src), _ptr(op.diag), _ptr(op.dsi),
        float(op.loop_G), op.anb.shape[0], _ptr(op.b), _ptr(tw.r), _ptr(tw.rsum),
        _ptr(tw.part64), _ptr(tw.ticket), _build.launch_counter(tw.x.device, "transport_rows"),
        _stream(tw.x, stream)))
    rows.launches += 1


rows.launches = 0


def update_pack_plain(tw: Workspace, op: Operator) -> None:
    """The inner CG's update and direction (boundary_cg's
    ``cg_update_direction_plain`` with ``minv = 1``, which sets the inner
    predicate), the new direction packed as :func:`pack_plain` packs it: the
    second half of :func:`rows_update_plain`."""
    cg_update_direction_plain(tw.cg, INNER_MAXITER)
    pack_plain(tw, op, False)


def rows_update_plain(tw: Workspace, op: Operator) -> None:
    """The plain version of :func:`rows_update`: :func:`rows_plain` (f32),
    then :func:`update_pack_plain`."""
    rows_plain(tw, op, False)
    update_pack_plain(tw, op)


def rows_update(tw: Workspace, op: Operator, handle: int = 0, stream=None) -> None:
    """The inner iteration's tail after :func:`products`, one cooperative
    launch: every row of ``ap = A p`` (as :func:`rows_plain` computes it,
    a bf16 band's ``row_fix`` included) and ``alpha = r.z / p.ap``; the
    update ``x += alpha p``, ``r -= alpha ap`` (``minv = 1``: z = r), r.z,
    r.r and beta; the direction ``p = z + beta p`` packed as
    :func:`pack_plain` packs it; the stop flag, the counts and the inner
    predicate, also set as the condition of the WHILE node ``handle`` (0:
    none).  A stopped iterate keeps its iterate, residual, direction, r.z
    and count.  On the card the grid is capped at the blocks it holds at
    once; the build or launch raises on failure."""
    if tw.x.device.type == "cpu":
        return rows_update_plain(tw, op)
    c = tw.cg
    _launched("transport_rows_update", _fn("dkmc_transport_rows_update")(
        _ptr(tw.band_y), _ptr(tw.inv32), _ptr(op.row_fix), _ptr(tw.y_bump), _ptr(op.vslot),
        _ptr(op.mp_inv), _ptr(tw.y_cc), _ptr(tw.mv), _ptr(tw.y_vm), _ptr(tw.y_vv),
        _ptr(tw.dots32), _ptr(op.gnd32), _ptr(op.src32), _ptr(op.diag32), _ptr(op.dsi32),
        float(op.loop_G), op.anb.shape[0], _ptr(c.x), _ptr(c.r), _ptr(c.p), _ptr(c.ap),
        _ptr(c.act), _ptr(c.act0), _ptr(c.alpha), _ptr(c.beta), _ptr(c.rz), _ptr(c.rr),
        _ptr(c.thresh2), _ptr(c.iters), _ptr(c.ctl), _ptr(c.cond), _ptr(c.total), handle,
        INNER_MAXITER, _ptr(tw.xs32), _ptr(tw.xw), _ptr(tw.xm), tw.front, _ptr(tw.part_ru),
        _ptr(c.bar), _build.launch_counter(tw.x.device, "transport_rows_update"),
        _stream(tw.x, stream)))
    rows_update.launches += 1


rows_update.launches = 0


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
        _ptr(tw.part_b), _ptr(tw.ticket_b), INNER_TOL, int(first), int(max_outer), int(maxiter),
        tw.x.shape[0], handle, _build.launch_counter(tw.x.device, "transport_refine"),
        _stream(tw.x, stream)))
    refine.launches += 1


refine.launches = 0


# ----------------------------------------------------------------------------
# the loops
# ----------------------------------------------------------------------------

def products(tw: Workspace, op: Operator, stream=None) -> None:
    """The products of the inner direction that :func:`rows_update` reads:
    the band on ``stream``, and beside it the fly matvec and :func:`blocks`,
    each on a branch of its own (``ops.graph.fork``), joined before the
    return.  The fastest of the WHILE body's forms on an H100
    (``tools/probe_cg_events.py --parts transport``, the crossbar's warm
    solve, 345 inner iterations, two runs, with the tail in two kernels
    then): the band captured first, then a branch each, 0.0393-0.0408 ms an
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
    metal(tw, op, side1)
    blocks(tw, op, False, side2)
    if capturing:
        join(dev, stream, 1)
        join(dev, stream, 2)


def inner_iteration(tw: Workspace, op: Operator, handle: int = 0, stream=None) -> None:
    """One iteration of the inner CG: the products of the direction
    (:func:`products`), then its rows, the update and the direction with
    the next direction packed (:func:`rows_update`), which sets the inner
    predicate (and the WHILE node ``handle``'s condition)."""
    products(tw, op, stream)
    rows_update(tw, op, handle, stream)


def round_end(tw: Workspace, op: Operator, max_outer: int, maxiter: int, first: bool = False,
              handle: int = 0, stream=None) -> None:
    """The f64 residual of the corrected iterate and the next round's set-up
    (:func:`refine`), in series."""
    pack(tw, op, first, stream)
    metal(tw, op, stream)
    blocks(tw, op, True, stream)
    rows(tw, op, stream)
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


# ----------------------------------------------------------------------------
# the f64 solve: Jacobi CG, criterion "pre", on the unscaled system
# ----------------------------------------------------------------------------

class ResultF64(NamedTuple):
    """The f64 solve's outcome, device tensors: the iterate [Nsub] (the
    workspace's), the iterations, sqrt(|r'M^-1 r|) of the last residual, and
    whether it met the criterion (``ops.cg.cg_solve``'s ``residual`` and
    ``converged``)."""
    x: torch.Tensor
    iters: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor


def rows_ap_plain(tw: Workspace, op: Operator) -> None:
    """The plain version of :func:`tail_f64`'s rows: while the flag is up,
    ``ap = A p`` of the direction in ``xs64`` (``physics.current.apply_rows``
    of the products, f64) and ``alpha = r.z / p.ap`` (``ops.cg.cg_solve``'s
    operations), else nothing."""
    c = tw.c64
    nsub = op.b.shape[0]
    ap = op.plain_rows(tw.xs64, torch.float64, None, tw.y_cc, _parts(tw, True))[:nsub]
    denom = torch.dot(tw.xs64[:nsub], ap)
    on = c.act
    c.ap.copy_(torch.where(on, ap, c.ap))
    c.alpha.copy_(torch.where(on, torch.where(denom != 0, c.rz / denom, 0.0), c.alpha))


def update_f64_plain(tw: Workspace, op: Operator, maxiter: int) -> None:
    """The plain version of :func:`tail_f64`'s update: ``ops.cg.cg_solve``'s
    update and direction (Jacobi ``minv``) where the flag is up, the
    direction packed into ``xs64`` and the metal vector, the flag from the
    criterion "pre" (r.z above the threshold), the count and the
    predicate."""
    c = tw.c64
    nsub = op.b.shape[0]
    on = c.act
    p = tw.xs64[:nsub]
    x_n = tw.x + c.alpha * p
    r_n = tw.r - c.alpha * c.ap
    z = op.minv * r_n
    rz_n = torch.dot(r_n, z)
    beta = torch.where(c.rz != 0, rz_n / c.rz, 0.0)
    p_n = torch.where(on, z + beta * p, p)
    tw.x.copy_(torch.where(on, x_n, tw.x))
    tw.r.copy_(torch.where(on, r_n, tw.r))
    tw.xs64[:nsub] = p_n
    tw.xm.copy_(tw.xs64[2:][op.mp])
    c.beta.copy_(torch.where(on, beta, c.beta))
    c.rz.copy_(torch.where(on, rz_n, c.rz))
    c.iters.add_(on.to(c.iters.dtype))
    act = on & (c.rz > c.thresh2)
    c.act.copy_(act)
    c.cond.copy_((act & (c.iters < maxiter)).to(torch.int32))
    c.total.add_(1)


def tail_f64(tw: Workspace, op: Operator, maxiter: int, handle: int = 0,
             stream=None) -> None:
    """The f64 solve's tail after the products, one cooperative launch: every
    row of ``ap = A p`` of the direction packed in ``xs64`` (the ELL part,
    the metal block, :func:`blocks`, the virtual rows and the diagonal),
    ``p.ap`` and ``alpha = r.z / p.ap``; a barrier of the grid; ``x += alpha
    p``, ``r -= alpha ap``, ``z = minv r`` and r.z; a barrier; beta and ``p
    = z + beta p`` packed into ``xs64`` and the metal vector; the flag
    (criterion "pre"), the count and the predicate, also set as the
    condition of the WHILE node ``handle`` (0: none).  A stopped solve's
    launch changes nothing but the loop's count, flag and predicate.  CPU
    tensors take :func:`rows_ap_plain` then :func:`update_f64_plain`; on the
    card the grid is capped at the blocks it holds at once, and the build or
    launch raises on failure."""
    if tw.x.device.type == "cpu":
        rows_ap_plain(tw, op)
        return update_f64_plain(tw, op, maxiter)
    c = tw.c64
    _launched("transport_tail64", _fn("dkmc_transport_tail64")(
        _ptr(tw.xs64), _ptr(op.nb_idx), _ptr(op.nb_start), _ptr(op.cls), float(op.g_hi),
        float(op.g_lo), _ptr(op.vslot), _ptr(op.mp_inv), _ptr(tw.y_cc), _ptr(tw.mv),
        _ptr(tw.y_vm), _ptr(tw.y_vv), _ptr(tw.dots64), _ptr(op.gnd), _ptr(op.src),
        _ptr(op.diag), float(op.loop_G), op.anb.shape[0], _ptr(c.ap), _ptr(tw.part64),
        _ptr(tw.x), _ptr(tw.r), _ptr(op.minv), _ptr(tw.xm), _ptr(c.act), _ptr(c.alpha),
        _ptr(c.beta), _ptr(c.rz), _ptr(c.thresh2), _ptr(c.iters), _ptr(c.cond), _ptr(c.total),
        handle, maxiter, _ptr(c.part), _ptr(c.bar),
        _build.launch_counter(tw.x.device, "transport_tail64"), _stream(tw.x, stream)))
    tail_f64.launches += 1


tail_f64.launches = 0


def iteration_f64(tw: Workspace, op: Operator, maxiter: int, handle: int = 0,
                  stream=None) -> None:
    """One iteration of the f64 solve: the stored block's product and, on a
    branch beside it under a capture, :func:`blocks` (f64 build); then
    :func:`tail_f64`, which sets the predicate (and the WHILE node
    ``handle``'s condition).  Outside a capture the same kernels in order on
    one stream: the same bits."""
    dev = tw.x.device
    capturing = dev.type == "cuda" and torch.cuda.is_current_stream_capturing()
    side = fork(dev, stream, 1) if capturing else stream
    metal(tw, op, stream)
    blocks(tw, op, True, side)
    if capturing:
        join(dev, stream, 1)
    tail_f64(tw, op, maxiter, handle, stream)


def _load_vector(tw: Workspace, op: Operator, v: torch.Tensor) -> None:
    """``v`` [Nsub] as the products read it: ``xs64`` (0 on the grounded
    last atom) and the metal vector."""
    nsub = v.shape[0]
    tw.xs64[:nsub] = v
    tw.xs64[nsub:] = 0.0
    tw.xm.copy_(tw.xs64[2:][op.mp].to(tw.xm.dtype))


def solve_f64(tw: Workspace, op: Operator, x0: torch.Tensor, go: torch.Tensor, tol: float,
              maxiter: int) -> ResultF64:
    """``ops.cg.cg_solve(A, op.b, x0, diag, tol, maxiter, criterion="pre")``
    of the unscaled f64 operator ``op`` (Jacobi ``op.minv``) on ``tw``; ``go``
    a bool [1] tensor (False: no iteration, the iterate stays ``x0``).  The
    set-up (threshold, ``r0 = b - A x0`` through the kernels' residual form,
    z0, r0.z0, p0 = z0) in PyTorch; then under a capture on the card (and on
    CPU tensors, through the plain versions, whose arithmetic is
    ``cg_solve``'s bit for bit) one WHILE node of :func:`iteration_f64`;
    outside one on the card the same kernels from a host loop that reads the
    predicate once a chunk of iterations (``ops.cg.CHUNKS``)."""
    c = tw.c64
    ref = torch.sqrt(torch.dot(op.b, op.minv * op.b))
    th = tol * torch.where(ref > 0, ref, 1.0)
    c.thresh2.copy_((th * th).reshape(1))
    tw.x.copy_(x0)
    _load_vector(tw, op, x0)
    metal(tw, op)
    blocks(tw, op, True)
    rows(tw, op)
    z = op.minv * tw.r
    rz = torch.dot(tw.r, z)
    _load_vector(tw, op, z)
    act = go.reshape(1) & (rz > c.thresh2)
    c.rz.copy_(rz.reshape(1))
    c.act.copy_(act)
    c.iters.zero_()
    c.cond.copy_((act & (maxiter > 0)).to(torch.int32))
    dev = tw.x.device
    if dev.type == "cpu" or torch.cuda.is_current_stream_capturing():
        device_while(c.cond, lambda h, s: iteration_f64(tw, op, maxiter, h, s))
    else:
        chunk = ran = 0
        while _read(c.cond)[0]:
            # no chunk past maxiter: the cap stops the loop, not the flag
            n = min(cg_mod.CHUNKS[min(chunk, len(cg_mod.CHUNKS) - 1)], maxiter - ran)
            for _ in range(n):
                iteration_f64(tw, op, maxiter)
            chunk += 1
            ran += n
    m2 = c.rz[0]
    return ResultF64(x=tw.x, iters=c.iters[0], residual=torch.sqrt(torch.abs(m2)),
                     converged=m2 <= c.thresh2[0])
