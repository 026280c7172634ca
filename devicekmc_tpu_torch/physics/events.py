"""KMC event engine: rate table + rejection-free residence-time superstep.

Four event types over (site i, neighbour j) pairs (reference:
KMCProcess::update_events_and_rates, src/KMCProcess.cpp:67-164), with rate
``P = freq * exp(-EA / (kB * T_bg))``, ``EA = E_zero_field - E``:

  0 VACANCY_GENERATION    (d, O):   E = 2*(phi_i - phi_j),           barrier E_gen_0[layer_j]
  1 VACANCY_RECOMBINATION (Od, V):  E = cs*(dphi + (cs/2)*v2),       barrier E_rec_1[layer_j]
  2 VACANCY_DIFFUSION     (V, O):   E = (qi-qj)*(dphi + qi*v1),      barrier E_diff_2[layer_i]
  3 ION_DIFFUSION         (Od, d):  E = (qi-qj)*(dphi - 2*v1),       barrier E_diff_3[layer_j]

Superstep semantics (reference: KMCProcess::executeKMCStep,
src/KMCProcess.cpp:259-373): the rate table is built once; the loop then
selects an event with probability proportional to its rate, executes it,
zeroes every pair whose row or neighbour site is i or j, and draws
event_time = -ln(u)/Psum from the shrunken Psum, until event_time >= 1/freq.

The random stream is the JAX package's (threefry, ``rng.py``): per event
``key, k_sel, k_time = split(key, 3)``, the selection draw in f64 and the
time draw in the table's dtype, so trajectories compare event by event.

The table lives on the device.  On the card the incremental event loop of a
superstep is ONE kernel launch (``ops/kmc_events.py``): no read-back per
event, and one small result (time, count, key) read per superstep.  The
host loop that reads ten scalars an event is its plain version and runs for
CPU tensors; ``event_mode = "scan"`` and the flat selection stay host loops,
the equivalence checks of the incremental loop.

:func:`execute_superstep_incremental_batched` runs the incremental superstep
of B replicas (a batched state): the tables [B, n_rows, m] with their sums,
one launch of the batched event loop, and nothing read back.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from .. import rng
from ..ops import kmc_events
from ..ops.compact import nonzero_fixed, nonzero_fixed_batched
from ..ops.ell_gather import ell_gather, ell_gather_batched
from ..ops.kmc_events import execute_event, event_type, time_draw
from ..state import Geometry, PhysParams, SimState, replace
from ..structure import Element

_D = int(Element.DEFECT)
_OD = int(Element.OXYGEN_DEFECT)
_V = int(Element.VACANCY)
_O = int(Element.O)

_BLOCK = kmc_events.BLOCK  # rows per block in the hierarchical rate sum

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def pack_site_code(elem, charge, site_layer) -> torch.Tensor:
    """(element, charge, layer) packed into one int32 per site, so the
    neighbour side of the rate table is one 32-bit gather."""
    return ((elem << 8) | ((charge + 8) << 4) | site_layer).to(torch.int32)


def rates_from_pairs(
    params: PhysParams,
    layer_E,        # [n_layers, 4]
    T_bg,           # float, or [B] tensor for B replicas
    row_elem,       # [R]
    row_charge,     # [R]
    row_phi,        # [R]
    row_layer,      # [R]
    phi_j,          # [R, m]  gathered neighbour potential
    code_j,         # [R, m]  gathered neighbour pack_site_code
    v1,             # [R, m]  v_solve(r, 1) per pair
    neigh_valid,    # [R, m]
) -> torch.Tensor:
    """The four-event-type Arrhenius rate law on pre-gathered pair data, in
    ``phi_j.dtype``, with the JAX package's arithmetic order.  With a leading
    replica axis (row data [B, R], pair data [B, R, m], ``T_bg`` [B]) each
    replica's table is its single table, bit for bit."""
    dtype = phi_j.dtype
    e_j = code_j >> 8
    q_j = (((code_j >> 4) & 15) - 8).to(dtype)
    lay_j = code_j & 15

    e_i = row_elem[..., None]
    q_i = row_charge.to(dtype)[..., None]
    dphi = row_phi[..., None] - phi_j

    v1 = v1.to(dtype)
    v2 = v1 * 2.0
    lay_i = row_layer[..., None]
    layer_E = layer_E.to(dtype)

    def _table(col, lay):
        out = layer_E[0, col] * torch.ones_like(lay, dtype=dtype)
        for k in range(1, layer_E.shape[0]):
            out = torch.where(lay == k, layer_E[k, col], out)
        return out

    E_gen_j = _table(0, lay_j)
    E_rec_j = _table(1, lay_j)
    E_diff_i = _table(2, lay_i)
    E_diff_j = _table(3, lay_j)

    m_gen = (e_i == _D) & (e_j == _O)
    EA_gen = E_gen_j - 2.0 * dphi

    m_rec = (e_i == _OD) & (e_j == _V)
    cs = q_i - q_j
    EA_rec = E_rec_j - cs * (dphi + torch.trunc(cs / 2.0) * v2)

    m_vdf = (e_i == _V) & (e_j == _O)
    self_v = torch.where(q_i != 0, q_i * v1, 0.0)
    EA_vdf = E_diff_i - (q_i - q_j) * (dphi + self_v)

    m_idf = (e_i == _OD) & (e_j == _D)
    self_i = torch.where(q_i != 0, v2, 0.0)
    EA_idf = E_diff_j - (q_i - q_j) * (dphi - self_i)

    EA = torch.where(
        m_gen, EA_gen,
        torch.where(m_rec, EA_rec, torch.where(m_vdf, EA_vdf, EA_idf)),
    )
    any_event = (m_gen | m_rec | m_vdf | m_idf) & neigh_valid

    npd, wd = _NP_DTYPE[dtype], _NP_DTYPE[params.dtype]
    if torch.is_tensor(T_bg):
        # kT of each replica, rounded as the single path rounds it on the host
        kT = (T_bg.to(params.dtype) * float(wd(C.KB_EV))).to(dtype)[:, None, None]
        # PyTorch divides by a host scalar on the card as a product with its
        # reciprocal, on the CPU by true division: the same here
        x = -EA * torch.reciprocal(kT) if EA.device.type == "cuda" else -EA / kT
    else:
        x = -EA / float(npd(wd(C.KB_EV) * wd(T_bg)))
    # clamp the Arrhenius exponent and the rate so Psum stays finite: an
    # exp(+80) f32 rate already fires "instantly"
    exp_cap = 80.0 if dtype == torch.float32 else 600.0
    p_cap = 1e30 if dtype == torch.float32 else 1e290
    freq = float(npd(params.freq))
    P = freq * torch.exp(torch.clamp(x, max=exp_cap))
    P = torch.clamp(P, max=p_cap)
    return torch.where(any_event, P, 0.0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [N] at the indices idx (any shape), or x [B, N] at idx [R, m]
    (shared by the replicas) or [B, R, m] (one per replica) -> [B, R, m]."""
    if x.dim() == 1:
        return x[idx]
    if idx.dim() == 2:
        return x[:, idx]
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def build_rate_table(
    geom: Geometry, params: PhysParams, state: SimState, active_idx=None
) -> torch.Tensor:
    """Rates for every (site, neighbour-slot) pair -> [N, max_nn], or
    [cap, max_nn] for the rows ``active_idx`` (only {d, Od, V} sites can
    source an event, so that compaction is exact).

    In mixed precision the table is f32, and the neighbour gather of
    (phi, code) goes through the ELL-gather kernel; it moves 32-bit words, so
    the int32 codes pass unchanged.  An f64 table gathers with plain
    indexing, as the JAX package does.

    A batched state (a leading replica axis [B]) gives [B, N, max_nn], or
    [B, cap, max_nn] for each replica's rows ``active_idx`` [B, cap]; an f32
    table gathers (phi, code) of all replicas in one launch of the batched
    gather, and each replica's table is its single table, bit for bit."""
    dtype = torch.float32 if params.mixed else params.dtype
    elem = state.element
    phi = (state.potential_boundary + state.potential_charge).to(dtype)
    code = pack_site_code(elem, state.charge, geom.site_layer)

    if active_idx is not None:
        a = active_idx.long()
        neigh_idx = geom.neigh_idx[a].contiguous()
        neigh_valid = geom.neigh_valid[a]
        v_pair = geom.v2_pair[a]
        row_elem, row_charge = torch.gather(elem, -1, a), torch.gather(state.charge, -1, a)
        row_phi, row_layer = torch.gather(phi, -1, a), geom.site_layer[a]
    else:
        neigh_idx, neigh_valid, v_pair = geom.neigh_idx, geom.neigh_valid, geom.v2_pair
        row_elem, row_charge = elem, state.charge
        row_phi, row_layer = phi, geom.site_layer

    if dtype == torch.float32:
        gather = ell_gather_batched if elem.dim() == 2 else ell_gather
        phi_j, code_j = gather(neigh_idx, [phi.contiguous(), code.contiguous()])
    else:
        safe = neigh_idx.clamp(min=0).long()
        phi_j, code_j = _take(phi, safe), _take(code, safe)

    return rates_from_pairs(
        params, geom.layer_E, state.T_bg,
        row_elem, row_charge, row_phi, row_layer,
        phi_j, code_j, v_pair, neigh_valid,
    )


class SuperstepResult(NamedTuple):
    state: SimState
    step_time: float
    n_events: int
    n_active: int = 0


def execute_superstep(geom: Geometry, params: PhysParams, state: SimState,
                      rate_table=None) -> SuperstepResult:
    """One KMC superstep (dispatch on params.event_mode).  ``rate_table``:
    :func:`build_rate_table`'s signature, by default that function (the
    replicated decomposition gives the table its ranks made by rows)."""
    if params.event_mode == "incremental":
        return execute_superstep_incremental(geom, params, state, rate_table=rate_table)
    return execute_superstep_scan(geom, params, state, rate_table=rate_table)


def _select_flat(prob: torch.Tensor, u: float):
    """Literal flat cumsum + upper_bound (reference semantics)."""
    flat = prob.reshape(-1)
    cum = torch.cumsum(flat, dim=0)
    psum = cum[-1]
    target = (u * psum).reshape(1)
    idx = torch.searchsorted(cum, target, right=True)[0]
    return psum, torch.clamp(idx, max=flat.shape[0] - 1)


def _select_two_level(prob: torch.Tensor, u: float):
    """Row sums -> row -> slot, the row-level accumulation in f64."""
    n, m = prob.shape
    acc = torch.float64 if prob.dtype == torch.float32 else prob.dtype
    row_cum = torch.cumsum(prob.to(acc).sum(dim=1), dim=0)
    psum = row_cum[-1]
    target = (u * psum).reshape(1)
    row = torch.clamp(torch.searchsorted(row_cum, target, right=True)[0], max=n - 1)
    base = torch.where(row > 0, row_cum[(row - 1).clamp(min=0)], 0.0)
    slot_cum = torch.cumsum(prob[row].to(acc), dim=0)
    slot = torch.searchsorted(slot_cum, (target - base), right=True)[0]
    return psum, row * m + torch.clamp(slot, max=m - 1)


def execute_superstep_scan(geom: Geometry, params: PhysParams, state: SimState,
                           rate_table=None) -> SuperstepResult:
    """Literal formulation: every event rescans the full [N, max_nn] table
    (the reference's Thrust scan, src/kmc_events.cu:210-349).  Kept as the
    equivalence check of :func:`execute_superstep_incremental`."""
    prob = (rate_table or build_rate_table)(geom, params, state).clone()
    n, m = prob.shape
    t_window = 1.0 / params.freq
    select = _select_flat if params.selection == "flat" else _select_two_level
    npd = _NP_DTYPE[prob.dtype]
    element = state.element.clone()
    charge = state.charge.clone()
    nb_flat = geom.neigh_idx.reshape(-1)
    key = state.key
    event_time, count = 0.0, 0
    while event_time < t_window and count < params.max_events_per_superstep:
        key, k_sel, k_time = rng.split(key, 3)
        u_sel = rng.uniform(k_sel, npd)
        psum, idx = select(prob, u_sel)
        p_sel = prob.reshape(-1)[idx]
        psum_h, p_h, idx_h = torch.stack(
            [psum.to(torch.float64), p_sel.to(torch.float64), idx.to(torch.float64)]
        ).tolist()
        idx_h = int(idx_h)
        if not (psum_h > 0 and p_h > 0):
            event_time = float("inf")
            break
        i, j = idx_h // m, int(nb_flat[idx_h])
        e_i, e_j, q_i, q_j = torch.stack(
            [element[i], element[j], charge[i], charge[j]]).tolist()
        execute_event(element, charge, i, j, e_i, e_j, q_i, q_j, event_type(e_i, e_j))
        # conflict zeroing: any pair whose row or neighbour is i or j
        rows = torch.arange(n, device=prob.device)[:, None]
        nb = geom.neigh_idx
        conflict = (rows == i) | (rows == j) | (nb == i) | (nb == j)
        prob = torch.where(conflict, 0.0, prob)
        u_t = rng.uniform(k_time, npd)
        event_time = time_draw(params.dtype, prob.dtype, u_t, psum_h)
        count += 1
    return SuperstepResult(
        state=replace(state, element=element, charge=charge, key=key,
                      kmc_time=state.kmc_time + event_time),
        step_time=event_time, n_events=count,
    )


def incremental_tables(geom: Geometry, params: PhysParams, state: SimState,
                       rate_table=None):
    """The inputs of the incremental event loop: the rate table (all rows,
    or with ``params.active_rows_cap > 0`` the candidate source rows {d, Od,
    V}, fill rows zero), its f64 row sums (zero-padded to whole blocks) and
    block sums, the site of each row and the row of each site (int32, -1
    where a site has none), and the count of candidate rows as a 0-d device
    tensor (None for the full table).  Returns ``(prob, row_sums,
    block_sums, aidx, inv, n_active)``.

    A batched state gives each of these with a leading replica axis
    (``prob`` [B, n_rows, m], counts [B]), each replica compacting its own
    rows on the device; the full table's ``aidx = inv = arange(N)`` stays
    shared.  ``rate_table``: :func:`build_rate_table` by default."""
    table = rate_table or build_rate_table
    N = geom.N
    cap = params.active_rows_cap
    dev = geom.device
    lead = state.element.shape[:-1]     # () for one state, (B,) for a batch
    if cap > 0:
        elem = state.element
        active = (elem == _D) | (elem == _OD) | (elem == _V)
        compact = nonzero_fixed_batched if lead else nonzero_fixed
        aidx, n_active = compact(active, cap, fill_value=0)
        slot_ok = torch.arange(cap, device=dev) < n_active[..., None]
        inv = torch.full((*lead, N + 1), -1, dtype=torch.int32, device=dev)
        inv.scatter_(-1, torch.where(slot_ok, aidx.long(), N),
                     torch.arange(cap, dtype=torch.int32, device=dev).expand(*lead, cap))
        inv = inv[..., :N].contiguous()
        prob = table(geom, params, state, active_idx=aidx)
        prob = torch.where(slot_ok[..., None], prob, 0.0)
        n_rows = cap
    else:
        aidx = torch.arange(N, dtype=torch.int32, device=dev)
        inv = aidx
        n_active = None
        prob = table(geom, params, state)
        n_rows = N
    nb_pad = (-n_rows) % _BLOCK
    n_blocks = (n_rows + nb_pad) // _BLOCK
    acc = torch.float64 if prob.dtype == torch.float32 else prob.dtype
    row_sums = torch.nn.functional.pad(prob.to(acc).sum(dim=-1), (0, nb_pad))
    block_sums = row_sums.reshape(*lead, n_blocks, _BLOCK).sum(dim=-1)
    return prob.contiguous(), row_sums, block_sums, aidx, inv, n_active


def execute_superstep_incremental(geom: Geometry, params: PhysParams,
                                  state: SimState, event_loop=None,
                                  rate_table=None) -> SuperstepResult:
    """The same superstep at O(max_nn + N/BLOCK) work per event:

      * a three-level sum hierarchy (block sums -> row sums -> slots) in f64
        is kept up to date incrementally — an event invalidates only the
        rows of i and j and one reverse-edge slot (geom.rev_slot) in each
        neighbouring row;
      * touched row and block sums are recomputed exactly from the zeroed
        table, never by subtraction (removing an exp(+70) rate would leave
        ulp noise larger than the surviving rates).

    The table and its sums come from :func:`incremental_tables`; the loop
    over events is ``ops.kmc_events.kmc_event_loop`` (one launch on the
    card, the plain host loop for CPU tensors), or ``event_loop`` with its
    signature.  The loop's result and ``n_active`` are read back together,
    once.

    With ``params.active_rows_cap > 0`` the table holds only the candidate
    source rows (elements in {d, Od, V}); ``n_active`` lets the engine grow
    the bucket when it overflows.
    """
    prob, row_sums, block_sums, aidx, inv, n_active_t = incremental_tables(
        geom, params, state, rate_table)
    loop = event_loop or kmc_events.kmc_event_loop
    element, charge, res = loop(
        prob, row_sums, block_sums, aidx, inv, geom.neigh_idx, geom.rev_slot,
        state.element, state.charge, state.key, 1.0 / params.freq,
        params.max_events_per_superstep, params.dtype)
    if n_active_t is not None:
        res = torch.cat([res, n_active_t.reshape(1).to(res.dtype)])
    event_time, count, k0, k1, *n_active = res.tolist()
    n_active = int(n_active[0]) if n_active else geom.N
    return SuperstepResult(
        state=replace(state, element=element, charge=charge, key=(int(k0), int(k1)),
                      kmc_time=state.kmc_time + event_time),
        step_time=event_time, n_events=int(count), n_active=n_active,
    )


class BatchedSuperstepResult(NamedTuple):
    state: SimState
    step_time: torch.Tensor   # [B] float64
    n_events: torch.Tensor    # [B] int64
    n_active: torch.Tensor    # [B] int64


def execute_superstep_incremental_batched(geom: Geometry, params: PhysParams,
                                          states: SimState) -> BatchedSuperstepResult:
    """:func:`execute_superstep_incremental` of B replicas: the tables of
    all replicas, then ONE launch of the batched event loop
    (``ops.kmc_events.kmc_event_loop_batched``; its plain version for CPU
    tensors), each replica from its own key on the device.  Nothing is read
    back: the step times, event counts and keys stay on the device."""
    prob, row_sums, block_sums, aidx, inv, n_active = incremental_tables(
        geom, params, states)
    element, charge, keys, res = kmc_events.kmc_event_loop_batched(
        prob, row_sums, block_sums, aidx, inv, geom.neigh_idx, geom.rev_slot,
        states.element, states.charge, states.key, 1.0 / params.freq,
        params.max_events_per_superstep, params.dtype)
    event_time = res[:, 0]
    if n_active is None:
        n_active = torch.full_like(event_time, geom.N, dtype=torch.int64)
    return BatchedSuperstepResult(
        state=replace(states, element=element, charge=charge, key=keys,
                      kmc_time=states.kmc_time + event_time),
        step_time=event_time, n_events=res[:, 1].to(torch.int64),
        n_active=n_active.to(torch.int64))
