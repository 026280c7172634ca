"""Charge-transport (current and dissipated power) solver: the blocked
matrix-free path and the dense path.

Builds the transmission/conductance operator X over the *atom* sub-graph
plus two virtual nodes (ground/extraction = node 0, source/injection =
node 1), solves for the virtual potentials and extracts the macroscopic
current and, with a heating solver on, the site-resolved dissipated power.
Reference: Device::updatePower (src/current_solver.cpp:4-385) and
update_power_gpu_sparse (src/current_solver_gpu.cu:854-1136).

Matrix entries (atoms i, j at indices i+2, j+2):
  * neighbour pairs (dist < nn_dist): -high_G' for metal-metal or neutral
    vacancy pairs, else -low_G;
  * non-neighbour pairs that are trap<->trap, contact<->trap or
    contact<->contact with |dE_CB| > tol: -T(WKB), with a trapezoidal
    (low-field) or triangular (high-field) barrier, and an energy-window
    integration for contact->trap (src/current_solver.cpp:99-154);
  * node 1 -- the first ``num_source_inj`` atoms and node 0 -- atoms with
    index > N_atom - num_ground_ext at -high_G' (the reference's strict
    comparison attaches one atom fewer to ground; reproduced);
  * node 0 -- node 1 at -loop_G;
  * diagonal = negated row sum of the off-diagonals.

The tunnel-eligible pairs involve only vacancies and interior-metal atoms
(the reference's own comment, src/current_solver_gpu.cu:32: X "separates
into a sparse neighbor matrix and a dense tunnel matrix"), so instead of
the dense [N_atom+2]^2 matrix the operator is kept as

  * an ELL neighbour-conductance part over the static atom graph
    (``geom.atom_neigh_idx``), with a static band twin (its nonzeros over
    x-sorted atoms) for the f32 inner iterations (:func:`build_banded_nb`),
  * three tunnel blocks over the active subset:
      - metal_p x metal_p  (c2c, single-shot WKB): stored, or re-derived
        inside every product (``transport_cc="fly"``, ``ops/wkb_fly.py``),
      - vac x metal_p      (c2t, energy-window integral, ``ops/wkb_window.py``),
      - vac x vac          (t2t, single-shot WKB),
  * the two virtual-node rows and the exact f64 diagonal.

The linear system is the Nsub = N_atom+1 leading principal block (the last
atom is the ground reference), solved warm-started from the previous
solution: in mixed precision as Jacobi-scaled f32 CG with f64 refinement
(``ops.cg.cg_solve_mixed``), optionally A-DEF2-deflated.  Entries are
assembled in f32 in mixed mode (about 1e-7 relative error each; the solve
refines in f64).

Site-resolved dissipated power is computed only when a heating solver is on
(the reference guards it the same way, src/current_solver.cpp:279-371): the
forward-current rule P_disp[i] = sum_j I_neg(i,j) (Ms_j - Ms_i) is swept
block by block, the metal x metal part by the on-the-fly kernel
(``ops.wkb_fly.wkb_fly_pdisp``) under ``transport_cc="fly"``.

The dense path (``transport="dense"``, :func:`assemble_X` and
:func:`_update_power_dense`) materialises the [N_atom+2]^2 matrix: the
reference's own formulation, for tests and small devices (45 GB in f64 at
the 75k-atom crossbar).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..ops.banded import banded_matvec, slots_from_entries
from ..ops.cg import cg_solve, cg_solve_mixed, invert_coarse
from ..ops import transport_cg
from ..ops.compact import nonzero_fixed, nonzero_fixed_batched
from ..ops.wkb_fly import wkb_fly_matmat, wkb_fly_matvec, wkb_fly_pdisp
from ..ops.wkb_window import wkb_window_block
from ..state import Geometry, PhysParams, SimState, replace
from ..structure import Element

#: conductance-quantum prefactor: G = G0 * T_ij
#: (reference: src/current_solver.cpp:13, G0 = 2 * 3.8612e-5 * 1e-5)
G0 = 2.0 * 3.8612e-5 * 1e-5

#: relative-residual threshold above which a refinement round engages the
#: A-DEF2 deflation; 0.0 = always on (kept as a tunable)
DEFLATION_GATE_REL = 0.0

#: energy spacing of the contact->trap integration [V]
#: (src/current_solver.cpp:111)
DV_INT = 0.01

#: row-chunking threshold (elements) of the tunnel-block assembly; larger
#: blocks are built chunk by chunk over rows
TUNNEL_CHUNK_ELEMS = 1 << 25

#: transport_cc="auto": largest stored metal_p tunnel block [bytes f32].
#: Below it the block is materialised once per bias point; above it the
#: on-the-fly kernels are the only option on one card.  Kept at the JAX
#: package's value so that "auto" decides alike in both.
CC_STORED_MAX_BYTES = 3 << 30

#: transport_incremental="auto": largest persistent (T_vm + T_vv) footprint
#: [bytes] for which the blocks are kept in SimState (the JAX package's value).
TT_INCR_MAX_BYTES = 512 << 20


def resolve_transport_cc(mode: str, n_mp: int, f32_entries: bool) -> str:
    """Resolve transport_cc='auto' to 'stored' or 'fly'.  ``f32_entries``:
    the pairwise dtype is f32 (mixed or f32 precision); the fly kernels
    compute f32 entries, so pure-f64 runs always store."""
    if mode != "auto":
        return mode
    if not f32_entries:
        return "stored"
    return "stored" if n_mp * n_mp * 4 <= CC_STORED_MAX_BYTES else "fly"


def require_ieee_f32(what: str) -> None:
    """f32 products that go to ``torch.matmul`` must not run as TF32."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{what} need IEEE f32: "
            "torch.backends.cuda.matmul.allow_tf32 must be False"
        )


def bf16_inner(params: PhysParams) -> bool:
    """``transport_bf16_inner`` in effect: bf16 twins of the tunnel blocks
    and a bf16 band for the f32 inner iterations.  Mixed mode only: without
    the f64 refinement the whole solve would run on the bf16-perturbed
    operator."""
    return bool(params.mixed and params.transport_bf16_inner)


def twin_matmul_plain(a: torch.Tensor, b: torch.Tensor,
                      max_bytes: int = 1 << 28) -> torch.Tensor:
    """The plain version of :func:`twin_matmul`: both operands upcast to f32
    in row chunks (a bf16 product is exact in f32), so that no f32 copy of a
    whole block is made."""
    if a.dim() == 2:
        step = max(1, max_bytes // max(a.shape[1] * 4, 1))
        out = torch.empty((a.shape[0],) + tuple(b.shape[1:]), dtype=torch.float32,
                          device=a.device)
        bf = b.float()
        for r0 in range(0, a.shape[0], step):
            out[r0:r0 + step] = a[r0:r0 + step].float() @ bf
        return out
    # a vector times a matrix: chunks of the matrix's rows, summed
    step = max(1, max_bytes // max(b.shape[1] * 4, 1))
    out = torch.zeros(b.shape[1:], dtype=torch.float32, device=a.device)
    for r0 in range(0, b.shape[0], step):
        out = out + a[r0:r0 + step].float() @ b[r0:r0 + step].float()
    return out


def twin_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two bf16 operands (a matrix and a vector on either side,
    or two matrices) with f32 products and sums and an f32 result: the JAX
    package's ``jnp.matmul(..., preferred_element_type=float32)``.  A bf16
    result (``torch.matmul`` of two bf16 tensors) would round the product to
    8 mantissa bits.  On the card one library call (``aten::mm.dtype``);
    on CPU tensors the plain version."""
    if a.device.type == "cpu":
        return twin_matmul_plain(a, b)
    a2 = a[None] if a.dim() == 1 else a
    b2 = b[:, None] if b.dim() == 1 else b
    y = torch.mm(a2, b2, out_dtype=torch.float32)
    if a.dim() == 1:
        return y[0]
    return y[:, 0] if b.dim() == 1 else y


def _cdtype(params: PhysParams) -> torch.dtype:
    """The pairwise working dtype: f32 in mixed mode."""
    return torch.float32 if params.mixed else params.dtype


def _dist_blocks(pa, pb, lattice, pbc: bool):
    """Pairwise distances between two point sets with y/z minimum image."""
    dx = pa[:, None, 0] - pb[None, :, 0]
    dy = pa[:, None, 1] - pb[None, :, 1]
    dz = pa[:, None, 2] - pb[None, :, 2]
    if pbc:
        dy = dy - torch.round(dy / lattice[1]) * lattice[1]
        dz = dz - torch.round(dz / lattice[2]) * lattice[2]
    return torch.sqrt(dx * dx + dy * dy + dz * dz)


# --- WKB tunnelling physics ----------------------------------------------

def wkb_env(geom: Geometry, params: PhysParams) -> dict:
    """Scalars of the WKB transmission model as Python floats holding the
    pairwise working dtype's values (f32 in mixed mode).
    Reference: src/current_solver.cpp:99-154."""
    cdtype = _cdtype(params)
    dt = np.float32 if params.dtype == torch.float32 else np.float64
    cd = np.float32 if cdtype == torch.float32 else np.float64
    prefac = -(np.sqrt(dt(2.0) * dt(params.m_e)) / dt(C.H_BAR)) * dt(2.0 / 3.0)
    return dict(
        cdtype=cdtype,
        prefac=float(cd(prefac)),
        qV0=float(cd(dt(C.Q_C) * dt(params.V0))),
        dE_step=float(cd(C.Q_C * DV_INT)),
        ctol=float(cd(C.Q_C * 0.01)),
        nn=float(cd(params.nn_dist)),
        lattice=tuple(float(cd(x)) for x in geom.lattice_host),
        pbc=geom.pbc,
        n_int_steps=params.tunnel_int_steps,
    )


def wkb_single_T(env, s, abs_dE):
    """Single-shot trapezoidal/triangular barrier (trap<->trap,
    contact<->contact; src/current_solver.cpp:135-154)."""
    E1 = torch.full((), env["qV0"], dtype=s.dtype, device=s.device)
    E2 = E1 - abs_dE
    return torch.where(
        E2 > 0,
        torch.exp(s * (E1 ** 1.5 - torch.where(E2 > 0, E2, 0.0) ** 1.5)),
        torch.where(E2 < 0, torch.exp(s * E1 ** 1.5), 0.0),
    )


def wkb_window_T(env, s, abs_dE):
    """contact->trap occupied-energy-window integration
    (src/current_solver.cpp:99-134): ``n_int_steps`` single-shot terms;
    exact while n_int_steps >= ceil(max |dE| / dE_step), which
    :func:`assemble_X_blocks` reports as a metric."""
    qV0 = torch.full((), env["qV0"], dtype=s.dtype, device=s.device)
    dE_step = torch.full((), env["dE_step"], dtype=s.dtype, device=s.device)
    acc = torch.zeros_like(s)
    for kk in range(int(env["n_int_steps"])):
        iv = torch.full((), kk, dtype=s.dtype, device=s.device) * dE_step
        e1 = qV0 + iv
        e2 = e1 - abs_dE
        term = torch.where(
            e2 > 0,
            torch.exp(s * (e1 ** 1.5 - torch.where(e2 > 0, e2, 0.0) ** 1.5)),
            torch.where(e2 < 0, torch.exp(s * e1 ** 1.5), 0.0),
        )
        acc = acc + torch.where(iv < abs_dE, term, 0.0)
    return acc


def tunnel_block(env, pa, cba, oka, pb, cbb, okb, kernel):
    """Negated tunnel-transmission block between two point sets (rows a,
    cols b), built chunk by chunk over rows when big so that the elementwise
    intermediates stay bounded (~128 MB).  ``kernel``: wkb_single_T or
    wkb_window_T."""
    prefac, nn, ctol = env["prefac"], env["nn"], env["ctol"]
    lattice, pbc = env["lattice"], env["pbc"]
    n_cols = pb.shape[0]

    def rows(pa_c, cba_c, oka_c):
        dist = _dist_blocks(pa_c, pb, lattice, pbc)
        abs_dE = torch.abs(cba_c[:, None] - cbb[None, :])
        # dist(i,i)=0 < nn_dist, so self pairs are excluded by ~neighbour
        elig = oka_c[:, None] & okb[None, :] & (abs_dE > ctol) & ~(dist < nn)
        safe_abs = torch.where(elig, abs_dE, 1.0)
        s = prefac * (dist * 1e-10) / safe_abs
        return torch.where(elig, -kernel(env, s, safe_abs), 0.0)

    n_rows = pa.shape[0]
    if n_rows * n_cols <= TUNNEL_CHUNK_ELEMS:
        return rows(pa, cba, oka)
    chunk = max(8, (TUNNEL_CHUNK_ELEMS // n_cols) // 8 * 8)
    out = torch.empty((n_rows, n_cols), dtype=env["cdtype"], device=pa.device)
    for r0 in range(0, n_rows, chunk):
        r1 = min(r0 + chunk, n_rows)
        out[r0:r1] = rows(pa[r0:r1], cba[r0:r1], oka[r0:r1])
    return out


def resolve_transport_incremental(mode: str, params: PhysParams, n_mp: int) -> bool:
    """Resolve config transport_incremental ('auto'|'on'|'off') to a bool
    once the final tunnel_vac_cap and n_mp are known (see
    state.attach_tunnel_state)."""
    if mode == "off":
        return False
    vcap = params.tunnel_vac_cap
    eligible = (params.solve_current and params.transport == "blocked"
                and vcap > 0 and n_mp > 0)
    if not eligible:
        if mode == "on":
            raise ValueError(
                "transport_incremental='on' requires solve_current with "
                "transport='blocked' and tunnel_vac_cap > 0"
            )
        return False
    if mode == "on":
        return True
    itemsize = 4 if _cdtype(params) == torch.float32 else 8
    return vcap * (n_mp + vcap) * itemsize <= TT_INCR_MAX_BYTES


def _vm_block(env, vpos, vcb, v_ok, mpos, mcb):
    """The vacancy x metal_p window-integral block.  f32 entries go through
    the window kernel's wrapper (``ops/wkb_window.py``), f64 entries (pure
    f64 precision) through :func:`tunnel_block`.  Shared by the full and the
    incremental assembly so that their entries are bit-identical."""
    if env["cdtype"] == torch.float32:
        return wkb_window_block(vpos.contiguous(), vcb.contiguous(), v_ok,
                                mpos, mcb, env)
    ones_m = torch.ones(mpos.shape[0], dtype=torch.bool, device=mpos.device)
    return tunnel_block(env, vpos, vcb, v_ok, mpos, mcb, ones_m, wkb_window_T)


def _slot_map(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """int32 [size]: the position in ``idx`` of each index that ``ok``
    marks (positions of distinct indices), -1 elsewhere; fixed shapes, no
    read."""
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=idx.device)
    pos = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    return out.scatter_(0, torch.where(ok, idx, size).long(), pos)[:size]


def _incremental_vacancy_blocks(
    geom, params, state, vidx, v_ok, vpos, vcb, apos, acb, mpos, mcb, env,
):
    """Persistent-tunnel-block update (params.transport_incremental).

    Row content of T_vm/T_vv depends only on (atom identity, the bias-start
    CB edge): the ascending vacancy bucket is reproduced exactly, rows of
    atoms already present in the previous bucket are GATHERED from the
    stored blocks through the atom -> old-slot map, and only atoms that
    ENTERED the bucket since the last solve (<= 1 per KMC event; charge
    flips change nothing here) are recomputed, through the same functions
    the full assembly uses, so the assembled blocks are BIT-IDENTICAL to the
    from-scratch path.  More than transport_delta_cap new atoms, or an
    invalid store (first solve of a bias point, cap growth), takes the full
    re-assembly, exact either way.

    No read, as the JAX package's ``lax.cond`` makes the choice: both
    branches run at their fixed sizes (the full assembly, and the rows of at
    most transport_delta_cap new atoms placed into the gathered store) and
    are selected on the device by ``tt_valid`` and the count of new atoms.
    Returns (T_vm, T_vv, slot_atom_new, partial: 0-d bool tensor)."""
    vcap = params.tunnel_vac_cap
    ccap = params.transport_delta_cap
    Na = geom.N_atom
    dev = vidx.device
    slot_atom_new = torch.where(v_ok, vidx, -1)
    T_vm_f = _vm_block(env, vpos, vcb, v_ok, mpos, mcb)
    T_vv_f = tunnel_block(env, vpos, vcb, v_ok, vpos, vcb, v_ok, wkb_single_T)

    prev = state.tt_slot_atom                      # [vcap] atom ids, -1 free
    amap = _slot_map(prev, prev >= 0, Na)
    src_slot = torch.where(v_ok, amap[vidx.long()], -1)
    have = v_ok & (src_slot >= 0)
    need_idx, n_need = nonzero_fixed_batched((v_ok & ~have)[None], ccap, fill_value=0)
    need_idx, n_need = need_idx[0], n_need[0]
    valid = state.tt_valid if torch.is_tensor(state.tt_valid) else torch.full(
        (), bool(state.tt_valid), device=dev)
    partial = valid & (n_need <= ccap)

    sg = src_slot.clamp(0, max(vcap - 1, 0)).long()
    T_vm = torch.where(have[:, None], state.tt_vm[sg], 0.0)
    T_vv = torch.where(have[:, None] & have[None, :], state.tt_vv[sg][:, sg], 0.0)
    if ccap > 0:
        # the new atoms' rows, then their columns (the need x need entries
        # are bit-equal either way: dist and |dE| are exactly symmetric)
        t_live = torch.arange(ccap, device=dev) < n_need
        atoms_t = torch.where(t_live, vidx[need_idx.long()], 0).long()
        pos_t, cb_t = apos[atoms_t], acb[atoms_t]
        rows_vm = _vm_block(env, pos_t, cb_t, t_live, mpos, mcb)
        rows_vv = tunnel_block(env, pos_t, cb_t, t_live, vpos, vcb, v_ok, wkb_single_T)
        new_of = _slot_map(need_idx, t_live, vcap)
        is_new = new_of >= 0
        new_vv = rows_vv[new_of.clamp(min=0).long()]
        T_vm = torch.where(is_new[:, None], rows_vm[new_of.clamp(min=0).long()], T_vm)
        T_vv = torch.where(is_new[:, None], new_vv, T_vv)
        T_vv = torch.where(is_new[None, :], new_vv.T, T_vv)
    # row-major, as the full assembly's blocks are (a product of a
    # transposed layout sums in another order)
    return (torch.where(partial, T_vm, T_vm_f).contiguous(),
            torch.where(partial, T_vv, T_vv_f).contiguous(), slot_atom_new, partial)


def assemble_cc_block(geom: Geometry, params: PhysParams, state: SimState):
    """The metal_p x metal_p (c2c) tunnel block alone.

    Within a bias point the CB edges, and therefore this (largest) block,
    are constant: the engine assembles it once per bias point and hands it
    to the superstep.  Under ``transport_cc='fly'`` there is nothing to
    cache (entries are re-derived in the kernel): returns None."""
    if params.transport_cc == "fly":
        return None
    return assemble_X_blocks(geom, params, state, _cc_only=True)["T_cc"]


def assemble_transport_cache(geom: Geometry, params: PhysParams, state: SimState):
    """Per-bias-point cache of the blocked transport solver: the metal_p x
    metal_p tunnel block.  The deflation operators are NOT cached: they are
    rebuilt per solve from the current operator, because deflation quality
    degrades with a stale basis while a stale ``cc`` block is exact within a
    bias point."""
    return {"cc": assemble_cc_block(geom, params, state)}


def _coarse_restriction(geom: Geometry, params: PhysParams):
    """0/1 aggregation matrix R [K_tot, Nsub] over the atoms of the grounded
    subsystem: the deflation basis of the A-DEF2 transport preconditioner.
    Aggregates are ``coarse_slabs`` x-slabs, optionally refined
    ``coarse_yz``-ways in each transverse direction (K_tot = slabs * yz^2).
    The two virtual nodes belong to NO aggregate (a zero column): their
    loop_G ~ 1e15 rows would put kappa(E) near 1e20, and Jacobi already
    handles them."""
    K = params.coarse_slabs
    Q = max(1, params.coarse_yz)
    Na = geom.N_atom
    apos = geom.coords[geom.atom_ind.long()][: Na - 1].to(params.dtype)

    def bins(c, nb):
        lo, hi = c.min(), c.max()
        return torch.clamp(
            ((c - lo) / torch.clamp(hi - lo, min=1e-30) * nb).to(torch.int32),
            0, nb - 1,
        )

    agg = bins(apos[:, 0], K)
    K_tot = K
    if Q > 1:
        agg = (agg * Q + bins(apos[:, 1], Q)) * Q + bins(apos[:, 2], Q)
        K_tot = K * Q * Q
    agg = torch.cat([torch.full((2,), K_tot, dtype=torch.int32, device=agg.device), agg])
    return torch.nn.functional.one_hot(agg.long(), K_tot + 1)[:, :K_tot].to(params.dtype).T


def assemble_X_blocks(
    geom: Geometry, params: PhysParams, state: SimState,
    cc=None, _cc_only: bool = False, band=None,
):
    """Assemble the blocked transport operator (see the module docstring).

    Returns a dict with all pieces :func:`_apply_X_blocks` needs: negated
    off-diagonal values (the dense convention) and the exact f64 diagonal.
    ``cc``: the precomputed metal_p x metal_p block of
    :func:`assemble_cc_block` (valid within one bias point); ``band``: the
    static banded operator of :func:`build_banded_nb`.  No read of the
    device: the live vacancy count is a mask, the incremental choice is made
    on the device, ``int_steps_needed`` and ``tt_partial`` are 0-d tensors.
    Also the int32 bucket ``vidx32``, its live count ``n_vac`` [1] and each
    atom's bucket slot ``vslot`` [Na] that the transport CG's kernels
    read."""
    require_ieee_f32("the transport operator's f32 tunnel-block products")
    dtype = params.dtype
    cdtype = _cdtype(params)
    dev = geom.device
    ai = geom.atom_ind.long()
    Na = geom.N_atom
    apos = geom.coords[ai].to(cdtype)
    aelem = state.element[ai]
    acharge = state.charge[ai]
    acb = state.CB_edge[ai].to(cdtype)

    high_G = params.high_G * 1e5             # src/current_solver.cpp:9
    low_G = params.low_G
    loop_G = params.high_G * 1e7             # src/current_solver.cpp:8

    metal = geom.metal_mask_table[aelem.long()]
    anyvac = aelem == int(Element.VACANCY)
    cvac = anyvac & (acharge == 0)

    # --- ELL neighbour conductances (exact dtype: they set the diagonal) ---
    anb = geom.atom_neigh_idx
    valid = anb >= 0
    safe = anb.clamp(min=0).long()
    hi = (metal[:, None] & metal[safe]) | (cvac[:, None] & cvac[safe])
    g_hi = torch.full((), -high_G, dtype=dtype, device=dev)
    g_lo = torch.full((), -low_G, dtype=dtype, device=dev)
    nb_vals = torch.where(valid, torch.where(hi, g_hi, g_lo), 0.0)

    # --- active subset ---
    mp = geom.atom_metalp_idx.long()              # [n_mp] static
    vcap = params.tunnel_vac_cap
    if vcap <= 0:
        raise ValueError("transport='blocked' requires tunnel_vac_cap > 0")
    vidx, n_vac = nonzero_fixed_batched(anyvac[None], vcap, fill_value=0)
    vidx, n_vac = vidx[0], n_vac[0]
    v_ok = torch.arange(vcap, device=dev) < n_vac.clamp(max=vcap)
    vlong = vidx.long()

    mpos, mcb = apos[mp].contiguous(), acb[mp].contiguous()
    vpos, vcb = apos[vlong], acb[vlong]

    env = wkb_env(geom, params)

    cc_fly = params.transport_cc == "fly"
    if cc_fly and cdtype != torch.float32:
        raise ValueError(
            "transport_cc='fly' computes f32 entries (the on-the-fly kernels "
            "are f32); it requires precision 'mixed' or 'f32'"
        )
    ones_m = torch.ones(mp.shape[0], dtype=torch.bool, device=dev)
    if cc_fly:
        T_cc = None
    elif cc is not None:
        T_cc = cc.to(cdtype)
    else:
        T_cc = tunnel_block(env, mpos, mcb, ones_m, mpos, mcb, ones_m, wkb_single_T)
    if _cc_only:
        return dict(T_cc=T_cc)
    tt_slot_new = None
    partial = torch.zeros((), dtype=torch.bool, device=dev)
    if params.transport_incremental:
        T_vm, T_vv, tt_slot_new, partial = _incremental_vacancy_blocks(
            geom, params, state, vidx, v_ok, vpos, vcb, apos, acb, mpos, mcb, env,
        )
    else:
        T_vv = tunnel_block(env, vpos, vcb, v_ok, vpos, vcb, v_ok, wkb_single_T)
        T_vm = _vm_block(env, vpos, vcb, v_ok, mpos, mcb)

    # exactness check of the integration trip count: the number of dE_step
    # windows the widest eligible (vac, metal_p) pair needs
    dist_vm = _dist_blocks(vpos, mpos, env["lattice"], geom.pbc)
    abs_vm = torch.abs(vcb[:, None] - mcb[None, :])
    elig_vm = v_ok[:, None] & (abs_vm > env["ctol"]) & ~(dist_vm < env["nn"])
    widest = torch.where(elig_vm, abs_vm, 0.0).max() if elig_vm.numel() else \
        torch.zeros((), dtype=cdtype, device=dev)
    int_steps_needed = torch.ceil(widest / env["dE_step"])

    # --- virtual-node rows ---
    idx = torch.arange(Na, device=dev)
    nsi, nge = params.num_source_inj, params.num_ground_ext
    src_vals = torch.where(idx < nsi, g_hi, 0.0)
    # strict ">" keeps the reference's off-by-one (src/current_solver.cpp:187)
    gnd_vals = torch.where(idx > (Na - nge), g_hi, 0.0)

    # --- exact diagonal = -(off-diagonal row sums) ---
    row_atoms = nb_vals.sum(dim=1) + gnd_vals + src_vals
    # block row sums in the storage dtype, cast after (no f64 copy of the
    # multi-GB cc block)
    if cc_fly:
        cc_row = wkb_fly_matvec(
            mpos, mcb, torch.ones(mp.shape[0], dtype=torch.float32, device=dev), env,
        ).to(dtype)
    else:
        cc_row = T_cc.sum(dim=1).to(dtype)
    mv_row = T_vm.sum(dim=0).to(dtype)             # metal rows, vac cols
    vv_row = T_vv.sum(dim=1).to(dtype)
    vm_row = T_vm.sum(dim=1).to(dtype)
    # index_add_: the pad slots of vidx all point at atom 0 (with value 0)
    row_atoms.index_add_(0, mp, cc_row + mv_row)
    row_atoms.index_add_(0, vlong, torch.where(v_ok, vv_row + vm_row, 0.0))
    row0 = gnd_vals.sum() - loop_G
    row1 = src_vals.sum() - loop_G
    diag = -torch.cat([torch.stack([row0, row1]), row_atoms])

    out = dict(
        nb_vals=nb_vals, nb_safe=safe,
        T_cc=T_cc, T_vv=T_vv, T_vm=T_vm,
        mp=mp, mp_inv=geom.atom_metalp_inv, vidx=vlong, v_ok=v_ok,
        src_vals=src_vals, gnd_vals=gnd_vals,
        loop_G=loop_G, diag=diag,
        int_steps_needed=int_steps_needed,
        tt_slot_atom=tt_slot_new, tt_partial=partial,
        vidx32=vidx, n_vac=n_vac.reshape(1).to(torch.int32), vslot=_slot_map(vidx, v_ok, Na),
    )
    if cc_fly:
        # everything the on-the-fly kernels need to re-derive cc entries
        out["fly"] = dict(mpos=mpos, mcb=mcb, env=env)
    if band is not None:
        # dynamic complement of the static banded operator: the
        # (high_G - low_G) bump on uncharged-vacancy pairs, supported
        # entirely on the vacancy bucket (see build_banded_nb)
        vnb = anb[vlong]                      # [vcap, max_nn]
        vvalid = vnb >= 0
        vsafe = vnb.clamp(min=0).long()
        hi_dyn = vvalid & v_ok[:, None] & cvac[vlong][:, None] & cvac[vsafe]
        bump = torch.full((), -(high_G - low_G), dtype=dtype, device=dev).to(torch.float32)
        out["band"] = band
        out["band_dyn_vals"] = torch.where(hi_dyn, bump, 0.0)
        out["band_vnb_safe"] = vsafe
    if bf16_inner(params):
        # bf16 twins of the tunnel blocks for the f32 inner iterations only;
        # the f64 refinement keeps the f32 blocks, so the converged answer is
        # unchanged.  Under transport_cc="fly" the metal block has no stored
        # form: only the vacancy blocks get twins (and _apply_X_blocks then
        # reads none of them, as the JAX package does)
        if not cc_fly:
            out["T_cc16"] = T_cc.to(torch.bfloat16)
        out["T_vv16"] = T_vv.to(torch.bfloat16)
        out["T_vm16"] = T_vm.to(torch.bfloat16)
    return out


def _place_tunnel(blk, ya, y_mp, y_v):
    """Add the metal_p part (through the static inverse map, a gather) and
    the vacancy part (a small scatter-add) of a tunnel product to ``ya``."""
    pad = torch.zeros((1,) + y_mp.shape[1:], dtype=y_mp.dtype, device=y_mp.device)
    inv = blk["mp_inv"].long()
    n_mp = blk["mp"].shape[0]
    ya = ya + torch.cat([y_mp, pad])[torch.where(inv >= 0, inv, n_mp)]
    v_ok = blk["v_ok"] if y_v.dim() == 1 else blk["v_ok"][:, None]
    # index_add_, not ya[vidx] += ...: the pad slots of vidx repeat atom 0
    return ya.index_add_(0, blk["vidx"], torch.where(v_ok, y_v, 0.0))


def _apply_X_blocks(blk, x, wd):
    """y = X @ x for the blocked operator; x is the full [Na+2] vector.

    ``wd`` is the working dtype of the gather/reduction path; the tunnel
    blocks multiply in their storage dtype (f32 in mixed mode: promoting to
    f64 would materialise multi-GB converted copies) and the products are
    cast to ``wd``."""
    x = x.to(wd)
    xa = x[2:]
    if blk.get("band") is not None and wd == torch.float32:
        # gather-free static banded matvec + the small dynamic vacancy-pair
        # correction (f32 inner iterations only; the f64 refinement matvec
        # keeps the exact ELL path)
        ya = _band_bump(blk, xa, _banded_nb_matvec(blk["band"], xa))
    else:
        ya = _ell_nb(blk, xa, wd)

    # the f32 inner iterations read the bf16 twins when the metal block has
    # one (transport_bf16_inner with a stored block: the JAX package's test);
    # the f64 refinement always reads the f32 blocks
    if wd == torch.float32 and blk.get("T_cc16") is not None:
        T_cc, T_vv, T_vm = blk["T_cc16"], blk["T_vv16"], blk["T_vm16"]
        mm = twin_matmul
    else:
        T_cc, T_vv, T_vm = blk["T_cc"], blk["T_vv"], blk["T_vm"]
        mm = torch.matmul
    cd = T_vv.dtype
    xm = xa[blk["mp"]].to(cd)
    if blk.get("fly") is not None:
        f = blk["fly"]
        y_cc = wkb_fly_matvec(f["mpos"], f["mcb"], xm.float().contiguous(), f["env"]).to(wd)
    else:
        y_cc = mm(T_cc, xm).to(wd)
    return _apply_tail(blk, x, wd, ya, y_cc, xm, T_vv, T_vm, mm)


def _ell_nb(blk, xa, wd):
    """The neighbour part of X x through the ELL conductances."""
    return (blk["nb_vals"].to(wd) * xa[blk["nb_safe"]]).sum(dim=1)


def _bump_values(blk, xa):
    """The dynamic (high_G - low_G) bump on the neutral-vacancy pairs of the
    bucket, one value a bucket slot."""
    return (blk["band_dyn_vals"] * xa[blk["band_vnb_safe"]]).sum(dim=1)


def _place_bump(blk, ya, yv):
    """``ya`` plus the bump ``yv`` at the bucket's live atoms."""
    return ya.index_add_(0, blk["vidx"], torch.where(blk["v_ok"], yv, 0.0))


def _band_bump(blk, xa, ya):
    """The band's product plus the dynamic (high_G - low_G) bump on the
    neutral-vacancy pairs of the bucket."""
    return _place_bump(blk, ya, _bump_values(blk, xa))


def _tail_products(blk, x, wd, xm, T_vv, T_vm, mm):
    """The parts of X x's rest that read x alone: the vacancy blocks'
    products T_vm^T x_v, T_vv x_v, T_vm x_m (in ``wd``) and the virtual
    nodes' dots gnd . xa, src . xa."""
    xa = x[2:]
    cd = T_vv.dtype
    xv = torch.where(blk["v_ok"], xa[blk["vidx"]], 0.0).to(cd)
    y_mv = mm(xv, T_vm).to(wd)
    y_vv = mm(T_vv, xv).to(wd)
    y_vm = mm(T_vm, xm).to(wd)
    gnd = blk["gnd_vals"].to(wd)
    src = blk["src_vals"].to(wd)
    return y_mv, y_vv, y_vm, torch.dot(gnd, xa), torch.dot(src, xa)


def _tail_rows(blk, x, wd, ya, y_cc, products):
    """X x's rows from the neighbour part ``ya``, the metal block's product
    ``y_cc`` and :func:`_tail_products`: the vacancy blocks' placement, the
    virtual rows and the diagonal."""
    y_mv, y_vv, y_vm, d_gnd, d_src = products
    ya = _place_tunnel(blk, ya, y_cc + y_mv, y_vv + y_vm)

    src = blk["src_vals"].to(wd)
    gnd = blk["gnd_vals"].to(wd)
    loop_G = blk["loop_G"]
    x0, x1 = x[0], x[1]
    ya = ya + gnd * x0 + src * x1
    y0 = d_gnd - loop_G * x1
    y1 = d_src - loop_G * x0
    return torch.cat([torch.stack([y0, y1]), ya]) + blk["diag"].to(wd) * x


def _apply_tail(blk, x, wd, ya, y_cc, xm, T_vv, T_vm, mm):
    """The rest of X x after the neighbour part ``ya`` and the metal block's
    product ``y_cc``: the vacancy blocks, their placement, the virtual rows
    and the diagonal."""
    return _tail_rows(blk, x, wd, ya, y_cc, _tail_products(blk, x, wd, xm, T_vv, T_vm, mm))


def apply_blocks(blk, x, wd):
    """The parts of :func:`_apply_X_blocks` of the full vector ``x`` (already
    in ``wd``) that read ``x`` alone, in its operations: the vacancy blocks'
    products and the virtual nodes' dots (:func:`_tail_products`), and with
    the band in the f32 iterations the bump, else None.  The plain version of
    the transport CG's transport_blocks kernel (``ops.transport_cg``)."""
    xa = x[2:]
    xm = xa[blk["mp"]].to(blk["T_vv"].dtype)
    bump = (_bump_values(blk, xa)
            if blk.get("band") is not None and wd == torch.float32 else None)
    return _tail_products(blk, x, wd, xm, blk["T_vv"], blk["T_vm"], torch.matmul) + (bump,)


def apply_rows(blk, x, wd, band_y, y_cc, parts):
    """:func:`_apply_X_blocks` of ``x`` from the products its kernels made:
    ``band_y`` the band's output in its permuted layout (f32 with a band;
    None: the ELL part), ``y_cc`` the on-the-fly metal block's [n_mp] f32
    and ``parts`` :func:`apply_blocks`' (in ``wd``).  The plain version of
    the transport CG's transport_rows kernel, the same operations as
    :func:`_apply_X_blocks`."""
    xa = x[2:]
    *products, bump = parts
    if band_y is not None:
        ya = _place_bump(blk, _band_unpermute(blk["band"], band_y, xa), bump)
    else:
        ya = _ell_nb(blk, xa, wd)
    return _tail_rows(blk, x, wd, ya, y_cc.to(wd), products)


def _apply_X_blocks_mat(blk, X, wd):
    """Y = X_op @ X for a matrix of column vectors X [Na+2, K]: the
    multi-RHS twin of :func:`_apply_X_blocks`, used to build the deflation
    basis W = A Z in one pass (the tunnel blocks are read once for all K
    columns; the ELL part runs as max_nn row gathers of [Na, K] panels)."""
    X = X.to(wd)
    x0, x1, Xa = X[0], X[1], X[2:]
    nb_vals = blk["nb_vals"].to(wd)
    nb_safe = blk["nb_safe"]
    Ya = torch.zeros_like(Xa)
    for s in range(nb_vals.shape[1]):
        Ya = Ya + nb_vals[:, s:s + 1] * Xa[nb_safe[:, s]]

    T_vv, T_vm = blk["T_vv"], blk["T_vm"]
    cd = T_vv.dtype
    Xm = Xa[blk["mp"]].to(cd)
    Xv = torch.where(blk["v_ok"][:, None], Xa[blk["vidx"]], 0.0).to(cd)
    if blk.get("fly") is not None:
        f = blk["fly"]
        Y_cc = wkb_fly_matmat(f["mpos"], f["mcb"], Xm.float().contiguous(), f["env"]).to(wd)
    else:
        Y_cc = torch.matmul(blk["T_cc"], Xm).to(wd)
    Y_mv = torch.matmul(T_vm.T, Xv).to(wd)
    Y_vv = torch.matmul(T_vv, Xv).to(wd)
    Y_vm = torch.matmul(T_vm, Xm).to(wd)
    Ya = _place_tunnel(blk, Ya, Y_cc + Y_mv, Y_vv + Y_vm)

    src = blk["src_vals"].to(wd)
    gnd = blk["gnd_vals"].to(wd)
    loop_G = blk["loop_G"]
    Ya = Ya + gnd[:, None] * x0[None, :] + src[:, None] * x1[None, :]
    y0 = gnd @ Xa - loop_G * x1
    y1 = src @ Xa - loop_G * x0
    return torch.cat([torch.stack([y0, y1]), Ya]) + blk["diag"].to(wd)[:, None] * X


def build_banded_nb(
    geom: Geometry, params: PhysParams, state: SimState,
    block: int = 128, max_bytes: int = 3 << 30,
):
    """Static band of the neighbour-conductance operator (built ONCE per
    simulation, on the device; the gather-free inner-CG matvec).

    The neighbour matrix decomposes exactly as

        nb = -low_G * ADJ  - (high_G-low_G) * MM  - (high_G-low_G) * CVAC2

    where ADJ (atom adjacency) and MM (metal-metal pairs) are STATIC (no
    KMC event touches a metal site) and CVAC2 (uncharged-vacancy pairs,
    src/current_solver.cpp:86-99) lives entirely on the vacancy bucket.
    The static part couples x-sorted atoms within a band: the JAX package
    lays it out dense, ``C4[r, k, b, j]`` the coupling of permuted atom
    r*B+b to permuted atom (r-p+k)*B+j, k zero-padded to a multiple of 8;
    the port keeps the same layout's nonzeros only (``ops.banded``
    ``BandSlots``: each row's window offsets k*B+j and values, f32), made
    from the atom graph without ever holding ``C4``, so the matvec needs no
    gather beyond the two [Na] permutation reads.  The permutation is
    internal to this operator.  Under ``transport_bf16_inner`` the values
    are stored bf16: they feed only the f32 inner matvec (the f64
    refinement keeps the exact ELL path), as the tunnel blocks' twins do,
    with ``row_fix`` [Na] f32, each row's rounding, which the matvec adds
    back on the diagonal.

    Returns dict(slots, front=p*B, pi, inv[, row_fix]), or None where the
    JAX package's dense layout would exceed ``max_bytes`` (extreme aspect
    ratios); callers then keep the ELL gather."""
    dev = geom.device
    anb = geom.atom_neigh_idx
    Na = int(geom.N_atom)
    ai = geom.atom_ind.long()
    ax = geom.coords[ai][:, 0]
    pi = torch.sort(ax, stable=True).indices
    inv = torch.empty_like(pi)
    inv[pi] = torch.arange(Na, device=dev)
    rows = torch.arange(Na, device=dev)[:, None].expand_as(anb)
    msk = anb >= 0
    rows, cols = rows[msk], anb[msk].long()
    bw = int((inv[rows] - inv[cols]).abs().max()) if rows.numel() else 1
    B = block
    p = -(-bw // B)
    m = 2 * p + 1
    m_pad = m if m < 8 else -(-m // 8) * 8
    R = -(-Na // B)
    if R * B * m_pad * B * 4 > max_bytes:
        return None
    metal = geom.metal_mask_table[state.element[ai].long()]
    high_G = params.high_G * 1e5
    vals64 = torch.where(
        metal[rows] & metal[cols],
        torch.tensor(-high_G, dtype=torch.float64, device=dev),
        torch.tensor(-params.low_G, dtype=torch.float64, device=dev),
    )
    vals = vals64.to(torch.float32)
    ri, ci = inv[rows], inv[cols]
    off = ci - (ri // B - p) * B
    bf16 = bf16_inner(params)
    band = dict(slots=slots_from_entries(ri, off, vals.to(torch.bfloat16) if bf16 else vals,
                                         (R, m_pad, B)),
                front=p * B, pi=pi, inv=inv)
    if bf16:
        # the rows of the rounded band no longer sum to what the exact f64
        # diagonal cancels (-1e5 rounds to a bf16 160 away, 18 times in a
        # metal row): the inner operator would lose the Laplacian's
        # near-null space and its CG stall (with the vector rounded too, as
        # the JAX package has it: 16,000 iterations unconverged on a
        # 5,000-site crossbar).  Each row's rounding is put back on the
        # diagonal (_banded_nb_matvec), so that the rounded operator stays a
        # conductance Laplacian whose entries are within bf16 of the exact
        band["row_fix"] = torch.zeros(Na, dtype=torch.float64, device=dev).index_add_(
            0, rows, vals64 - vals.to(torch.bfloat16).double()).to(torch.float32)
    return band


def _band_window(band, xa):
    """The permuted vector laid into the band's zero-padded window layout
    [(R + m_pad - 1) * B] f32."""
    R, m_pad, B = band["slots"].shape
    Na = band["pi"].shape[0]
    xp = torch.zeros((R + m_pad - 1) * B, dtype=torch.float32, device=xa.device)
    front = band["front"]                  # p*B leading zeros
    xp[front:front + Na] = xa[band["pi"]].float()
    return xp


def _band_unpermute(band, y, xa):
    """The band kernel's output ``y`` (its permuted layout) back in atom
    order, plus the ``row_fix`` diagonal of a bf16 band."""
    Na = band["pi"].shape[0]
    y = y.reshape(-1)[:Na][band["inv"]]
    if band.get("row_fix") is not None:
        y = y + band["row_fix"] * xa
    return y


def _banded_nb_matvec(band, xa):
    """y = C_static @ x through the band kernel's wrapper (``ops/banded.py``):
    the permuted vector is laid into the zero-padded window layout, and the
    result permuted back.  The vector stays f32 with a bf16 band too (the
    JAX package rounds it to bf16, which makes the inner operator nonlinear
    noise of 2^-9 of the 1e5 metal conductances), and a bf16 band adds its
    ``row_fix`` diagonal."""
    return _band_unpermute(band, banded_matvec(band["slots"], _band_window(band, xa)), xa)


def _deflation_ops(geom: Geometry, params: PhysParams, blk, d):
    """A-DEF2 deflation operators of the blocked transport CG, built in the
    Jacobi-SCALED metric (transport_precond="deflated").

    A coarse correction formulated in the UNSCALED metric is optimal in the
    A-energy norm but worsens the Jacobi-scaled residual norm the stopping
    criterion uses (the reference's rule on the symmetric-scaled system,
    src/iterative_solvers_gpu.cu:309-480).  So the scaled system
    A^ = D^-1/2 A D^-1/2 is deflated with the scaled basis Z^ = D^1/2 Z: the
    Galerkin matrix E = Z^T A Z is unchanged and warm-started easy solves
    cannot be hurt (the A-DEF2 operator is a projection, not an additive
    term).

    Returns (Zhat [Nsub,K], W = A^ Z^ [Nsub,K], coarse_solve).  The
    preconditioner application is  M^-1 r = r + Z^ E^-1 (Z^^T r - W^T r)
    with the start vector  x0 = Z^ E^-1 Z^^T b  (Tang/Nabben/Vuik/Erlangga's
    A-DEF2, the variant robust to inexact coarse solves, which matters here
    because E is assembled through f32 blocks)."""
    dtype = params.dtype
    Nsub = geom.N_atom + 1
    Zm = _coarse_restriction(geom, params).T            # [Nsub, K] 0/1
    # AZ in FULL precision even in mixed mode: E's dominant entries come from
    # the exact high_G neighbour couplings, and with kappa(E) ~ 1e10 an
    # f32-assembled E makes E^-1 worthless.  The tunnel blocks stay f32
    # inside _apply_X_blocks_mat: their contributions are far below E's floor.
    Xfull = torch.cat([Zm, torch.zeros((1, Zm.shape[1]), dtype=dtype, device=Zm.device)])
    AZ = _apply_X_blocks_mat(blk, Xfull, dtype)[:Nsub]
    E = Zm.T @ AZ                                       # = Z^T A Z
    E_inv = invert_coarse(E)

    def coarse_solve(a):
        # one refinement step on the K x K solve: kappa(E) ~ 1e10 leaves the
        # raw Cholesky inverse ~1e-6 accurate, and the residual drift that
        # induces in the inner CG stalls warm solves
        c = E_inv @ a
        return c + E_inv @ (a - E @ c)

    ds = torch.sqrt(torch.where(d > 0, d, 1.0))
    return ds[:, None] * Zm, AZ / ds[:, None], coarse_solve


def _forward_masks(I_cal, Vd: float):
    """(fwd, fwd_t): the forward-current pairs of the stored orientation and
    of its transpose (whose I_cal has the other sign).  Vd == 0 selects
    nothing."""
    if Vd > 0:
        return I_cal < 0, I_cal > 0
    if Vd < 0:
        return I_cal > 0, I_cal < 0
    none = torch.zeros_like(I_cal, dtype=torch.bool)
    return none, none


def _pdisp_rows_cols(E, ms_r, ms_c, Vd: float, chunk: int = 2048):
    """Forward-current dissipation sums of one stored tunnel block.

    Returns (row_contrib [R], col_contrib [C]): the dense rule
    P_disp[i] += I_neg(i,j) * (Ms_j - Ms_i) for the stored orientation AND
    its transpose in one sweep (the transpose flips the sign of I_cal,
    src/current_solver.cpp:319-337), chunk by chunk over rows so that no
    second block-sized array is made.  The stored rows are multiplied in the
    dtype of ``ms_c`` (f64 in mixed mode)."""
    R = E.shape[0]
    row = torch.empty(R, dtype=ms_c.dtype, device=E.device)
    col = torch.zeros(E.shape[1], dtype=ms_c.dtype, device=E.device)
    for b0 in range(0, R, chunk):
        b1 = min(b0 + chunk, R)
        dM = ms_r[b0:b1, None] - ms_c[None, :]
        I_cal = E[b0:b1].to(ms_c.dtype) * dM
        fwd, fwd_t = _forward_masks(I_cal, Vd)
        row[b0:b1] = (torch.where(fwd, -I_cal, 0.0) * (-dM)).sum(dim=1)
        # transpose orientation: I_cal' = -I_cal, displacement = +dM
        col = col + (torch.where(fwd_t, I_cal, 0.0) * dM).sum(dim=0)
    return row, col


def _site_power(geom: Geometry, params: PhysParams, state: SimState, P_disp,
                read: bool = True):
    """Per-site power [N] and its sum from the per-atom dissipation sums:
    metal atoms dissipate nothing (alpha = 0), the injection and extraction
    layers are left out (src/current_solver.cpp:339-371).  ``read`` False:
    the sum stays a 0-d tensor."""
    Na, nsi = geom.N_atom, params.num_source_inj
    ai = geom.atom_ind.long()
    idx = torch.arange(Na, device=P_disp.device)
    metal = geom.metal_mask_table[state.element[ai].long()]
    in_range = (idx >= nsi) & (idx < Na - nsi)
    atom_power = torch.where(in_range & ~metal, -P_disp, 0.0).to(params.dtype)
    power = torch.zeros(geom.N, dtype=params.dtype, device=P_disp.device)
    power[ai] = atom_power
    return power, (float(power.sum()) if read else power.sum())


def _pdisp_blocked(blk, Matoms, Vd: float):
    """Per-atom forward-current dissipation sums over the blocked operator:
    the ELL neighbour part, then the three tunnel blocks placed as in
    :func:`_place_tunnel`.  Under ``transport_cc="fly"`` the metal x metal
    rows come from the on-the-fly kernel, f32 throughout; the stored blocks
    multiply in the dtype of ``Matoms``."""
    Ms = Matoms + torch.abs(Matoms.min())
    dM_nb = Ms[:, None] - Ms[blk["nb_safe"]]
    I_cal = blk["nb_vals"] * dM_nb
    fwd, _ = _forward_masks(I_cal, Vd)
    P_disp = (torch.where(fwd, -I_cal, 0.0) * (-dM_nb)).sum(dim=1)

    ms_m = Ms[blk["mp"]]
    ms_v = torch.where(blk["v_ok"], Ms[blk["vidx"]], 0.0)
    if blk.get("fly") is not None:
        f = blk["fly"]
        cc_r = wkb_fly_pdisp(f["mpos"], f["mcb"], ms_m.float().contiguous(), Vd,
                             f["env"]).to(Ms.dtype)
    else:
        cc_r, _ = _pdisp_rows_cols(blk["T_cc"], ms_m, ms_m, Vd)
    vv_r, _ = _pdisp_rows_cols(blk["T_vv"], ms_v, ms_v, Vd)
    vm_r, vm_c = _pdisp_rows_cols(blk["T_vm"], ms_v, ms_m, Vd)
    return _place_tunnel(blk, P_disp, cc_r + vm_c, vv_r + vm_r)


def update_power_blocked(
    geom: Geometry,
    params: PhysParams,
    state: SimState,
    Vd: float,
    cg_tol: Optional[float] = None,
    cg_maxiter: int = 20000,
    cc=None,
    precond: Optional[str] = None,
) -> Tuple[SimState, Dict]:
    """The transport solve with the blocked matrix-free operator
    (transport="blocked"): same physics and outputs as Device::updatePower
    (src/current_solver.cpp:4-385) at a size where the dense matrix cannot
    be materialised.  ``cc``: the per-bias-point cache dict of
    :func:`assemble_transport_cache` (plus ``band``), or the raw metal
    block."""
    dtype = params.dtype
    dev = geom.device
    Na = geom.N_atom
    Nsub = Na + 1
    nsi = params.num_source_inj
    if cg_tol is None:
        cg_tol = params.transport_tol
    if bf16_inner(params):
        # the bf16-perturbed inner operator leaves a larger error that the
        # criterion does not see at a given outer tolerance: two more digits
        # (the JAX package's rule)
        cg_tol = cg_tol * 1e-2

    band = None
    if isinstance(cc, dict):
        band = cc.get("band")
        cc = cc.get("cc")
    blk = assemble_X_blocks(geom, params, state, cc=cc, band=band)
    loop_G = blk["loop_G"]
    diag = blk["diag"]

    rhs = torch.zeros(Nsub, dtype=dtype, device=dev)
    rhs[0] = -loop_G * Vd
    rhs[1] = loop_G * Vd

    def apply_sub(x_sub, wd):
        x_full = torch.cat([x_sub, torch.zeros(1, dtype=x_sub.dtype, device=dev)])
        return _apply_X_blocks(blk, x_full, wd)[:Nsub]

    d = diag[:Nsub]
    x_init = state.virtual_potentials[:Nsub]
    deflate = (precond or params.transport_precond) == "deflated"
    if deflate:
        Zhat, W, esolve = _deflation_ops(geom, params, blk, d)
    if params.mixed:
        # Jacobi-scaled f32 CG + f64 iterative refinement
        dsi = 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0))
        dsi32 = dsi.to(torch.float32)
        b_s = rhs * dsi
        y0 = x_init / dsi
        inner_precond = inner_start = None
        if deflate:
            Zh32 = Zhat.to(torch.float32)
            W32 = W.to(torch.float32)

            def _coarse_f32(coeff):
                # the coarse solve stays f64 (kappa(E) ~ 1e10 makes an f32
                # solve garbage); cast at the boundary only
                return esolve(coeff.to(dtype)).to(torch.float32)

            # per-round gate (see DEFLATION_GATE_REL; always on as shipped)
            def inner_precond(r, gate):
                if not gate:
                    return r
                return r + Zh32 @ _coarse_f32(Zh32.T @ r - W32.T @ r)

            def inner_start(b, gate):
                if not gate:
                    return torch.zeros_like(b)
                return Zh32 @ _coarse_f32(Zh32.T @ b)

        res = cg_solve_mixed(
            lambda y: dsi * apply_sub(dsi * y, dtype),
            lambda y: dsi32 * apply_sub(dsi32 * y, torch.float32),
            b_s, x0=y0,
            tol=cg_tol, inner_tol=1e-5, inner_maxiter=400,
            maxiter=cg_maxiter,
            inner_precond=inner_precond, inner_start=inner_start,
            inner_gate_rel=DEFLATION_GATE_REL if deflate else None,
        )
        v = res.x * dsi
    elif deflate:
        # f64 deflated solve on the scaled system.  criterion "r" on the
        # scaled system IS the Jacobi-preconditioned criterion on the
        # unscaled one: ||D^-1/2 (b - A x)|| = sqrt(r' M^-1 r).
        ds = torch.sqrt(torch.where(d > 0, d, 1.0))
        dsi = 1.0 / ds
        b_s = rhs * dsi
        y0 = x_init * ds
        y0 = (
            y0
            - Zhat @ esolve(W.T @ y0)           # P^T y0
            + Zhat @ esolve(Zhat.T @ b_s)       # + Z^ E^-1 Z^^T b
        )
        res = cg_solve(
            lambda y: dsi * apply_sub(dsi * y, dtype), b_s,
            x0=y0,
            precond=lambda r: r + Zhat @ esolve(Zhat.T @ r - W.T @ r),
            tol=cg_tol, maxiter=cg_maxiter, criterion="r",
        )
        v = res.x * dsi
    else:
        res = cg_solve(
            lambda x: apply_sub(x, dtype), rhs,
            x0=x_init,
            diag=d, tol=cg_tol, maxiter=cg_maxiter, criterion="pre",
        )
        v = res.x

    M = torch.cat([v * G0, torch.zeros(1, dtype=dtype, device=dev)])  # [Na+2]
    # one read: the current, the contact drop and the assembly's metrics
    I_macro, contact_drop, n_vac, int_steps, partial = torch.stack([
        t.to(torch.float64) for t in (
            torch.sum(blk["gnd_vals"] * (M[0] - M[2:])), torch.abs(v[nsi] - Vd),
            _n_vac_atoms_t(geom, state), blk["int_steps_needed"], blk["tt_partial"])]).tolist()

    # dissipated power, block by block: only when a heating solver is on
    # (the reference guards the whole extraction, src/current_solver.cpp:279-371)
    solve_heat = params.solve_heating_global or params.solve_heating_local
    if solve_heat:
        power, P_tot = _site_power(geom, params, state, _pdisp_blocked(blk, M[2:], Vd))
    else:
        power, P_tot = torch.zeros(geom.N, dtype=dtype, device=dev), 0.0

    new_state = replace(
        state,
        power=power,
        I_macro=I_macro,
        P_tot=P_tot,
        virtual_potentials=torch.cat([v, torch.zeros(1, dtype=dtype, device=dev)]),
    )
    if blk["tt_slot_atom"] is not None:
        # persist the (bit-exact) incremental tunnel blocks for the next solve
        new_state = replace(
            new_state, tt_slot_atom=blk["tt_slot_atom"],
            tt_vm=blk["T_vm"], tt_vv=blk["T_vv"], tt_valid=True,
        )
    metrics = {
        "n_vac_atoms": int(n_vac),
        "Current [uA]": I_macro * 1e6,
        "Conductance [uS]": abs(I_macro / (Vd if Vd != 0 else 1.0)) * 1e6,
        "cg_iters_power": res.iters,
        "transport_rel0": res.rel0,
        # the explicit convergence signal the chunked cold solves loop on
        "transport_converged": res.converged,
        "contact_potential_drop": contact_drop,
        "tunnel_int_steps_needed": int(int_steps),
        # 1: stored tunnel rows reused and only new ones computed, 0: full
        # assembly, -1: solve skipped (kept out of output.txt by the engine)
        "transport_partial_assembly": int(partial),
    }
    if solve_heat:
        # logged only when a heating solver is on (reference schema)
        metrics["Total dissipated power [mW]"] = P_tot * 1e3
    return new_state, metrics


def device_form_reason(params: PhysParams) -> Optional[str]:
    """Why the in-superstep transport solve of ``params`` does not run as the
    transport CG's device loops (``ops.transport_cg``); None when it does:
    blocked, mixed precision, the on-the-fly metal block, the Jacobi warm
    preconditioner, no bf16 inner operator (and, at the call, the static
    band: :func:`warm_device_form`)."""
    if params.transport != "blocked":
        return f"transport={params.transport!r}: the dense transport solve runs eagerly"
    if not params.mixed:
        return "a precision other than 'mixed': the f64 blocked solve runs eagerly"
    if params.transport_cc != "fly":
        return (f"transport_cc={params.transport_cc!r}: the stored metal block runs "
                "eagerly")
    if params.transport_warm_precond != "jacobi":
        return (f"transport_warm_precond={params.transport_warm_precond!r}: the deflated "
                "warm re-solve runs eagerly")
    if params.transport_bf16_inner:
        return "transport_bf16_inner: the bf16 inner operator runs eagerly"
    return None


def warm_device_form(params: PhysParams, cc, precond: Optional[str]) -> bool:
    """The in-superstep blocked solve runs as the transport CG's device loops
    (no read inside the solve): :func:`device_form_reason` None, the warm
    preconditioner ``precond`` Jacobi, and the static band in ``cc``."""
    return (device_form_reason(params) is None and precond == "jacobi"
            and isinstance(cc, dict) and cc.get("band") is not None)


def transport_workspace(geom: Geometry, params: PhysParams, cc) -> transport_cg.Workspace:
    """The transport CG's workspace of this bias point's cache ``cc`` (made
    at the first solve, kept in ``cc`` under "tws" for the next)."""
    n_mp = int(geom.atom_metalp_idx.shape[0])
    key = (geom.N_atom, params.tunnel_vac_cap, n_mp)
    tws = cc.get("tws")
    if tws is None or cc.get("tws_key") != key:
        tws = cc["tws"] = transport_cg.workspace(geom.N_atom, params.tunnel_vac_cap, n_mp,
                                                 cc["band"], geom.device)
        cc["tws_key"] = key
    return tws


def _update_power_warm_device(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, cg_tol: float,
    cg_maxiter: int, cc, go: torch.Tensor,
) -> Tuple[Dict, Dict]:
    """The warm blocked re-solve with no read of the device
    (:func:`warm_device_form`): the assembly, the mixed CG as the
    transport CG's device loops (``ops.transport_cg.solve``, under a capture
    two nested WHILE nodes), the current, and with heating the site power.
    ``go`` [1] bool: False runs no refinement round.  Returns the new state
    fields and the metrics, 0-d tensors where they are scalars (the
    arithmetic of :func:`update_power_blocked`'s mixed branch)."""
    dtype = params.dtype
    dev = geom.device
    Na = geom.N_atom
    Nsub = Na + 1
    nsi = params.num_source_inj
    band = cc["band"]
    blk = assemble_X_blocks(geom, params, state, band=band)
    loop_G = blk["loop_G"]
    diag = blk["diag"]
    rhs = torch.zeros(Nsub, dtype=dtype, device=dev)
    # fills, not item assignments (a copy from the host under a capture)
    rhs.select(0, 0).fill_(-loop_G * Vd)
    rhs.select(0, 1).fill_(loop_G * Vd)
    d = diag[:Nsub]
    dsi = 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0))
    b_s = rhs * dsi
    y0 = state.virtual_potentials[:Nsub] / dsi
    f = blk["fly"]
    gnd, src = blk["gnd_vals"], blk["src_vals"]
    op = transport_cg.Operator(
        dsi=dsi, dsi32=dsi.to(torch.float32), b=b_s, diag=diag,
        diag32=diag.to(torch.float32), gnd=gnd, gnd32=gnd.to(torch.float32), src=src,
        src32=src.to(torch.float32), gnd_lo=max(0, min(Na, Na - params.num_ground_ext + 1)),
        nsi=max(0, min(Na, nsi)), loop_G=loop_G, slots=band["slots"],
        dyn=blk["band_dyn_vals"].contiguous(), nbv=blk["nb_vals"].contiguous(),
        anb=geom.atom_neigh_idx, T_vm=blk["T_vm"].contiguous(), T_vv=blk["T_vv"].contiguous(),
        vidx=blk["vidx32"], vslot=blk["vslot"], n_vac=blk["n_vac"],
        mp_inv=geom.atom_metalp_inv, mp=blk["mp"], mpos=f["mpos"], mcb=f["mcb"], env=f["env"],
        plain_blocks=lambda x, wd: apply_blocks(blk, x, wd),
        plain_rows=lambda x, wd, band_y, y_cc, parts: apply_rows(blk, x, wd, band_y, y_cc,
                                                                  parts))
    tws = transport_workspace(geom, params, cc)
    res = transport_cg.solve(tws, op, y0, go, cg_tol, cg_maxiter)
    v = res.x * dsi

    contact_drop = torch.abs(v[nsi] - Vd)
    M = torch.cat([v * G0, torch.zeros(1, dtype=dtype, device=dev)])  # [Na+2]
    I_macro = torch.sum(blk["gnd_vals"] * (M[0] - M[2:]))
    solve_heat = params.solve_heating_global or params.solve_heating_local
    if solve_heat:
        power, P_tot = _site_power(geom, params, state, _pdisp_blocked(blk, M[2:], Vd),
                                   read=False)
    else:
        power = torch.zeros(geom.N, dtype=dtype, device=dev)
        P_tot = torch.zeros((), dtype=dtype, device=dev)
    fields = dict(power=power, I_macro=I_macro, P_tot=P_tot,
                  virtual_potentials=torch.cat([v, torch.zeros(1, dtype=dtype, device=dev)]))
    if blk["tt_slot_atom"] is not None:
        fields.update(tt_slot_atom=blk["tt_slot_atom"], tt_vm=blk["T_vm"], tt_vv=blk["T_vv"],
                      tt_valid=torch.ones((), dtype=torch.bool, device=dev))
    bref = torch.sqrt(torch.dot(b_s, b_s))
    bref = torch.where(bref > 0, bref, 1.0)
    metrics = {
        "n_vac_atoms": _n_vac_atoms_t(geom, state),
        "Current [uA]": I_macro * 1e6,
        "Conductance [uS]": torch.abs(I_macro / (Vd if Vd != 0 else 1.0)) * 1e6,
        "cg_iters_power": res.iters.clone(),
        "transport_rel0": res.rnorm0 / bref,
        "transport_converged": res.residual <= res.thresh,
        "contact_potential_drop": contact_drop,
        "tunnel_int_steps_needed": blk["int_steps_needed"],
        "transport_partial_assembly": blk["tt_partial"].to(torch.int64),
    }
    if solve_heat:
        metrics["Total dissipated power [mW]"] = P_tot * 1e3
    return fields, metrics


#: the Python types of the metrics of the blocked solve, as the eager solve
#: returns them
_METRIC_TYPES = {"n_vac_atoms": int, "cg_iters_power": int, "transport_converged": bool,
                 "tunnel_int_steps_needed": int, "transport_partial_assembly": int}


def _to_host(fields: Dict, metrics: Dict) -> Tuple[Dict, Dict]:
    """The scalar fields and the metrics of :func:`_update_power_warm_device`
    as host numbers, in one read."""
    keys = [k for k in ("I_macro", "P_tot", "tt_valid") if k in fields] + sorted(metrics)
    vals = torch.stack([(fields[k] if k in fields else metrics[k]).reshape(())
                        .to(torch.float64) for k in keys]).tolist()
    out = dict(zip(keys, vals))
    fields = dict(fields, **{k: out[k] for k in ("I_macro", "P_tot") if k in fields})
    if "tt_valid" in fields:
        fields["tt_valid"] = bool(out["tt_valid"])
    metrics = {k: _METRIC_TYPES.get(k, float)(out[k]) for k in metrics}
    return fields, metrics


def _n_vac_atoms_t(geom: Geometry, state: SimState) -> torch.Tensor:
    return (state.element[geom.atom_ind.long()] == int(Element.VACANCY)).sum()


def _n_vac_atoms(geom: Geometry, state: SimState) -> int:
    return int(_n_vac_atoms_t(geom, state))


def _f64(v, dev) -> torch.Tensor:
    """A host number or a 0-d tensor as a 0-d f64 tensor on ``dev`` (a
    fill: no copy from the host, which a capture cannot hold)."""
    if torch.is_tensor(v):
        return v.to(torch.float64)
    return torch.full((), v, dtype=torch.float64, device=dev)


def _reuse_transport_metrics(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, blocked: bool
) -> Dict:
    """Metrics of an unchanged-network transport skip, reconstructed from
    the stored converged solution, as 0-d tensors (:func:`_to_host` reads
    them): the keys of the matching solve branch; on the blocked path -1
    sentinels tell "skipped" from "converged at once" in the logs.  With
    heating on, ``power`` and ``P_tot`` of the last solve stay in the state
    and are reported again."""
    dev = geom.device
    f64 = lambda v: _f64(v, dev)
    I_macro = f64(state.I_macro)
    metrics = {
        "n_vac_atoms": _n_vac_atoms_t(geom, state),
        "Current [uA]": I_macro * 1e6,
        "Conductance [uS]": torch.abs(I_macro / (Vd if Vd != 0 else 1.0)) * 1e6,
        "cg_iters_power": torch.zeros((), dtype=torch.int64, device=dev),
        "transport_converged": torch.ones((), dtype=torch.bool, device=dev),
        "contact_potential_drop": torch.abs(
            state.virtual_potentials[params.num_source_inj] - Vd),
    }
    if blocked:
        metrics["transport_rel0"] = f64(-1.0)
        metrics["tunnel_int_steps_needed"] = f64(-1.0)
        metrics["transport_partial_assembly"] = f64(-1.0)
    if params.solve_heating_global or params.solve_heating_local:
        metrics["Total dissipated power [mW]"] = f64(state.P_tot) * 1e3
    return metrics


def update_power(
    geom: Geometry,
    params: PhysParams,
    state: SimState,
    Vd: float,
    method: str = "cg",
    cg_tol: Optional[float] = None,
    cg_maxiter: int = 20000,
    cc=None,
    allow_skip: bool = False,
    precond: Optional[str] = None,
) -> Tuple[SimState, Dict]:
    """Transport dispatcher.  ``transport="blocked"`` takes the matrix-free
    operator unless ``method="direct"`` asks for the dense direct solve (the
    oracle of the tests); ``transport="dense"`` materialises X and solves by
    ``method`` ("cg", "direct", "cg_f32scaled").

    ``allow_skip=True`` (the superstep path) enables the exact
    unchanged-network fast path: X is a function of (element, charge) at atom
    sites, the bias-start CB edge and Vd only; when all are unchanged since
    the last converged solve, that solution IS the solution and assembly,
    set-up and solve are skipped (never with ``method="direct"``).  The
    superstep path is also the WARM path: its blocked re-solves use
    transport_warm_precond, cold pre-solves (the default, always solve) keep
    transport_precond; ``precond`` names the blocked solve's preconditioner
    outright (the modular driver's bounded warm segments)."""
    if cg_tol is None:
        cg_tol = params.transport_tol
    Vd = float(torch.tensor(Vd, dtype=params.dtype))
    blocked = params.transport == "blocked" and method != "direct"
    if precond is None and allow_skip:
        precond = params.transport_warm_precond

    device = blocked and allow_skip and warm_device_form(params, cc, precond)
    if device and torch.is_tensor(state.I_macro):
        return _update_power_device_state(geom, params, state, Vd, cg_tol, cg_maxiter, cc)

    def solve(st):
        if device:
            go = torch.ones(1, dtype=torch.bool, device=geom.device)
            fields, m = _to_host(*_update_power_warm_device(
                geom, params, st, Vd, cg_tol, cg_maxiter, cc, go))
            return replace(st, **fields), m
        if blocked:
            return update_power_blocked(
                geom, params, st, Vd, cg_tol=cg_tol, cg_maxiter=cg_maxiter, cc=cc,
                precond=precond,
            )
        return _update_power_dense(geom, params, st, Vd, method, cg_tol, cg_maxiter)

    if not (allow_skip and params.transport_skip_unchanged and method != "direct"):
        return solve(state)

    if transport_unchanged(geom, params, state, Vd):
        return state, _to_host({}, _reuse_transport_metrics(geom, params, state, Vd, blocked))[1]
    new_state, m = solve(state)
    ai = geom.atom_ind.long()
    return replace(new_state, trans_elem_prev=state.element[ai],
                   trans_charge_prev=state.charge[ai], transport_Vd_prev=Vd), m


def _update_power_device_state(geom: Geometry, params: PhysParams, state: SimState,
                               Vd: float, cg_tol: float, cg_maxiter: int, cc):
    """:func:`update_power`'s in-superstep path on a state whose scalars are
    0-d device tensors (a captured superstep's): the unchanged-network test
    on the device; a skipped step enters the solve's loops with a false
    predicate and keeps the old state's fields and the skip's metrics,
    selected on the device."""
    dev = geom.device
    ai = geom.atom_ind.long()
    elem, charge = state.element[ai], state.charge[ai]
    Vd_t = torch.full((), Vd, dtype=torch.float64, device=dev)
    if params.transport_skip_unchanged:
        same = transport_unchanged(geom, params, state, Vd)
    else:
        same = torch.zeros((), dtype=torch.bool, device=dev)
    fields, m = _update_power_warm_device(geom, params, state, Vd, cg_tol, cg_maxiter, cc,
                                          (~same).reshape(1))
    kw = {k: torch.where(same, getattr(state, k).to(v.dtype), v) for k, v in fields.items()}
    if params.transport_skip_unchanged:
        kw.update(trans_elem_prev=elem, trans_charge_prev=charge,
                  transport_Vd_prev=Vd_t.to(state.transport_Vd_prev.dtype))
    reuse = _reuse_transport_metrics(geom, params, state, Vd, True)
    metrics = {k: torch.where(same, reuse[k].to(v.dtype), v) for k, v in m.items()}
    return replace(state, **kw), metrics


def transport_unchanged(geom: Geometry, params: PhysParams, state: SimState,
                        Vd: float) -> torch.Tensor:
    """0-d bool, True when X is the one of the last converged solve: (element,
    charge) at atom sites and Vd unchanged (the bias-start CB edge is
    constant within a bias point).  Then that solution IS the solution.  No
    read: the state's scalars may be host numbers or 0-d device tensors."""
    dev = geom.device
    Vd = float(torch.tensor(Vd, dtype=params.dtype))
    ai = geom.atom_ind.long()
    return ((_f64(state.transport_Vd_prev, dev) == _f64(Vd, dev))
            & (state.element[ai] == state.trans_elem_prev).all()
            & (state.charge[ai] == state.trans_charge_prev).all())


# ----------------------------------------------------------------------------
# dense path
# ----------------------------------------------------------------------------

def assemble_X(geom: Geometry, params: PhysParams, state: SimState, Vd=None):
    """Dense X matrix [N_atom+2, N_atom+2] (symmetric, diagonal folded) and
    loop_G.

    In mixed precision the pairwise assembly (distances, WKB exponentials)
    runs in f32: every entry is an independent elementwise computation with
    about 1e-7 relative error; the matrix itself is cast to f64 for the
    solve.  With a vacancy bucket (``tunnel_vac_cap > 0``) the contact->trap
    window integral runs over the compacted vacancy x interior-metal pairs
    only and is scattered back symmetrically; without one it runs over all
    pairs."""
    dtype = params.dtype
    cdtype = _cdtype(params)
    dev = geom.device
    ai = geom.atom_ind.long()
    Na = geom.N_atom
    apos = geom.coords[ai].to(cdtype)
    aelem = state.element[ai]
    acharge = state.charge[ai]
    acb = state.CB_edge[ai].to(cdtype)          # [J]
    env = wkb_env(geom, params)

    high_G = params.high_G * 1e5                # src/current_solver.cpp:9
    low_G = params.low_G
    loop_G = params.high_G * 1e7                # src/current_solver.cpp:8

    idx = torch.arange(Na, device=dev)
    eye = idx[:, None] == idx[None, :]
    dist = _dist_blocks(apos, apos, env["lattice"], geom.pbc)
    neighbor = (dist < env["nn"]) & ~eye

    metal = geom.metal_mask_table[aelem.long()]
    anyvac = aelem == int(Element.VACANCY)
    cvac = anyvac & (acharge == 0)

    # --- neighbour conductances ---
    hi_pair = (metal[:, None] & metal[None, :]) | (cvac[:, None] & cvac[None, :])
    G_nb = torch.where(
        hi_pair, torch.tensor(high_G, dtype=torch.float64, device=dev),
        torch.tensor(low_G, dtype=torch.float64, device=dev)).to(cdtype)

    # --- tunnelling ---
    nlc, nsi, nge = params.num_layers_contact, params.num_source_inj, params.num_ground_ext
    metal_p = metal & (idx > (nlc - 1) * nsi) & (idx < Na - (nlc - 1) * nge)
    t2t = anyvac[:, None] & anyvac[None, :]
    c2t = (anyvac[:, None] & metal_p[None, :]) | (anyvac[None, :] & metal_p[:, None])
    c2c = metal_p[:, None] & metal_p[None, :]

    abs_dE = torch.abs(acb[:, None] - acb[None, :])
    eligible = (t2t | c2t | c2c) & (abs_dE > env["ctol"]) & ~neighbor & ~eye
    safe_abs_dE = torch.where(eligible, abs_dE, 1.0)
    s = env["prefac"] * (dist * 1e-10) / safe_abs_dE     # common exponent scale
    T_single = wkb_single_T(env, s, safe_abs_dE)

    vcap = params.tunnel_vac_cap
    mp = geom.atom_metalp_idx.long()
    if vcap > 0 and mp.shape[0] > 0:
        # compacted: c2t pairs live on (vacancy x interior-metal) only; exact
        # while n_vac <= vcap (the n_vac_atoms metric lets the engine redo)
        vidx, n_vac = nonzero_fixed(anyvac, vcap, fill_value=0)
        v_ok = torch.arange(vcap, device=dev) < min(int(n_vac), vcap)
        vlong = vidx.long()
        elig_cv = eligible[vlong][:, mp] & v_ok[:, None]
        s_cv, abs_cv = s[vlong][:, mp], safe_abs_dE[vlong][:, mp]
        T_cv = torch.where(elig_cv, wkb_window_T(env, s_cv, abs_cv), 0.0)
        X_atoms = torch.where(
            neighbor, -G_nb, torch.where(eligible & ~c2t, -T_single, 0.0)
        ).to(dtype)
        # scatter the compact c2t entries symmetrically; fill slots carry 0
        # and the eligibility mask keeps neighbour entries untouched (the
        # repeated pad slots rewrite atom 0's row with its own values)
        upd = torch.where(elig_cv, -T_cv, 0.0).to(dtype)
        keep_vm = torch.where(elig_cv, 0.0, X_atoms[vlong][:, mp])
        X_atoms[vlong[:, None], mp[None, :]] = keep_vm + upd
        X_atoms[mp[None, :], vlong[:, None]] = keep_vm + upd
    else:
        T = torch.where(c2t, wkb_window_T(env, s, safe_abs_dE), T_single)
        X_atoms = torch.where(
            neighbor, -G_nb, torch.where(eligible, -T, 0.0)).to(dtype)

    # --- the full (Na+2) x (Na+2) matrix ---
    X = torch.zeros((Na + 2, Na + 2), dtype=dtype, device=dev)
    X[2:, 2:] = X_atoms
    g_hi = torch.tensor(-high_G, dtype=dtype, device=dev)
    src_row = torch.where(idx < nsi, g_hi, 0.0)
    # strict ">" keeps the reference's off-by-one (src/current_solver.cpp:187):
    # one atom fewer is attached to ground
    gnd_row = torch.where(idx > (Na - nge), g_hi, 0.0)
    X[1, 2:] = src_row
    X[2:, 1] = src_row
    X[0, 2:] = gnd_row
    X[2:, 0] = gnd_row
    X[0, 1] = -loop_G
    X[1, 0] = -loop_G

    # diagonal = negated off-diagonal row sums over the FULL matrix
    diag = -X.sum(dim=1)
    X = X + torch.diag(diag)
    return X, loop_G


def _dense_system(geom, params, state, Vd: float):
    """X, its grounded leading block and the right-hand side."""
    Nsub = geom.N_atom + 1
    X, loop_G = assemble_X(geom, params, state, Vd)
    rhs = torch.zeros(Nsub, dtype=params.dtype, device=geom.device)
    rhs[0] = -loop_G * Vd
    rhs[1] = loop_G * Vd
    return X, X[:Nsub, :Nsub], rhs


def _update_power_dense(
    geom: Geometry,
    params: PhysParams,
    state: SimState,
    Vd: float,
    method: str,
    cg_tol: float,
    cg_maxiter: int,
) -> Tuple[SimState, Dict]:
    """The transport solve on the dense matrix: ``direct`` (LU), Jacobi CG
    with the preconditioned criterion, or, in mixed precision (and for
    ``cg_f32scaled``), f32 CG on the symmetrically Jacobi-scaled matrix with
    f64 refinement."""
    require_ieee_f32("the dense transport solve's f32 products")
    dtype = params.dtype
    dev = geom.device
    Na = geom.N_atom
    Nsub = Na + 1
    nsi = params.num_source_inj

    X, Dsub, rhs = _dense_system(geom, params, state, Vd)
    cg_iters, cg_converged = 0, True
    if method == "direct":
        v = torch.linalg.solve(Dsub, rhs)
    elif method == "cg_f32scaled" or (method == "cg" and params.mixed):
        # D^-1/2 X D^-1/2 has a unit diagonal and |off-diagonal| <= 1, all
        # f32-representable, and a moderate condition number
        d = torch.diagonal(Dsub)
        dsi = 1.0 / torch.sqrt(torch.where(d > 0, d, 1.0))
        A64 = Dsub * dsi[:, None] * dsi[None, :]
        A32 = A64.to(torch.float32)
        res = cg_solve_mixed(
            lambda y: A64 @ y, lambda y: A32 @ y,
            rhs * dsi, x0=state.virtual_potentials[:Nsub] / dsi,
            tol=cg_tol, inner_tol=1e-5, inner_maxiter=400, maxiter=cg_maxiter,
        )
        v = res.x * dsi
        cg_iters, cg_converged = res.iters, res.converged
    else:
        # "pre" criterion: the rows span ~21 decades (the loop_G penalty
        # against tunnelling), so the plain residual norm means nothing
        res = cg_solve(
            lambda x: Dsub @ x, rhs, x0=state.virtual_potentials[:Nsub],
            diag=torch.diagonal(Dsub), tol=cg_tol, maxiter=cg_maxiter,
            criterion="pre",
        )
        v = res.x
        cg_iters, cg_converged = res.iters, res.converged

    # potential-drop sanity check (src/current_solver.cpp:239-243)
    contact_drop = float(torch.abs(v[nsi] - Vd))
    # scale by the conductance quantum; the grounded last atom stays at 0
    M = torch.cat([v * G0, torch.zeros(1, dtype=dtype, device=dev)])  # [Na+2]
    # macroscopic current through the ground/extraction node
    I_macro = float(torch.sum(X[0, 2:] * (M[0] - M[2:])))

    solve_heat = params.solve_heating_global or params.solve_heating_local
    if solve_heat:
        Matoms = M[2:]
        Ms = Matoms + torch.abs(Matoms.min())
        # P_disp[i] = sum_j I_neg[i,j] * (Ms[j] - Ms[i]) with
        # I_neg(i,j) = -X(i,j)(Ms_i - Ms_j) on forward-current pairs off the
        # diagonal (src/current_solver.cpp:319-337), in row blocks so that no
        # second N_atom^2 array stands beside X
        BLK = 1024
        idx = torch.arange(Na, device=dev)
        P_disp = torch.empty(Na, dtype=dtype, device=dev)
        for b0 in range(0, Na, BLK):
            b1 = min(b0 + BLK, Na)
            dMb = Ms[b0:b1, None] - Ms[None, :]
            I_cal = X[2 + b0:2 + b1, 2:] * dMb
            fwd, _ = _forward_masks(I_cal, Vd)
            offd = idx[b0:b1, None] != idx[None, :]
            P_disp[b0:b1] = (torch.where(fwd & offd, -I_cal, 0.0) * (-dMb)).sum(dim=1)
        power, P_tot = _site_power(geom, params, state, P_disp)
    else:
        power, P_tot = torch.zeros(geom.N, dtype=dtype, device=dev), 0.0

    new_state = replace(
        state,
        power=power,
        I_macro=I_macro,
        P_tot=P_tot,
        virtual_potentials=torch.cat([v, torch.zeros(1, dtype=dtype, device=dev)]),
    )
    metrics = {
        "n_vac_atoms": _n_vac_atoms(geom, state),
        "Current [uA]": I_macro * 1e6,
        "Conductance [uS]": abs(I_macro / (Vd if Vd != 0 else 1.0)) * 1e6,
        "cg_iters_power": cg_iters,
        "transport_converged": cg_converged,
        "contact_potential_drop": contact_drop,
    }
    if solve_heat:
        metrics["Total dissipated power [mW]"] = P_tot * 1e3
    return new_state, metrics


def compute_bond_currents(
    geom: Geometry,
    params: PhysParams,
    state: SimState,
    Vd: float,
    method: str = "cg",
    cg_tol: float = 1e-10,
):
    """Per-atom bond-current flow field (analysis tool; reference:
    postprocessing/plot_bond_current.py over a dumped X matrix).

    Returns (I_vec [N_atom,3], I_out [N_atom]): the displacement-weighted sum
    of the outgoing bond currents at each atom and the total outgoing
    (positive) current."""
    Na = geom.N_atom
    Nsub = Na + 1
    dtype = params.dtype
    Vd = float(torch.tensor(Vd, dtype=dtype))
    X, Dsub, rhs = _dense_system(geom, params, state, Vd)
    if method == "direct":
        v = torch.linalg.solve(Dsub, rhs)
    else:
        v = cg_solve(
            lambda x: Dsub @ x, rhs, x0=state.virtual_potentials[:Nsub],
            diag=torch.diagonal(X)[:Nsub], tol=cg_tol, maxiter=50000,
        ).x
    Matoms = torch.cat([v * G0, torch.zeros(1, dtype=dtype, device=v.device)])[2:]

    apos = geom.coords[geom.atom_ind.long()]
    dM = Matoms[:, None] - Matoms[None, :]
    idx = torch.arange(Na, device=v.device)
    # current from i to j (off the diagonal)
    I_bond = torch.where(idx[:, None] != idx[None, :], -X[2:, 2:] * dM, 0.0)

    disp = apos[:, None, :] - apos[None, :, :]
    norm = torch.sqrt((disp * disp).sum(dim=-1))
    unit = disp / torch.where(norm > 0, norm, 1.0)[..., None]
    I_vec = (I_bond[..., None] * (-unit)).sum(dim=1)
    I_out = torch.where(I_bond > 0, I_bond, 0.0).sum(dim=1)
    return I_vec, I_out
