"""The KMC superstep body, a batch of supersteps with the driver's stop
conditions between them (``batch_steps > 1``), and the superstep of B
replicas of one device (:func:`superstep_batched`, the body of
``parallel.batched``).  Phase order mirrors the reference main loop
(src/kmc_main.cpp:175-234): charge -> boundary potential -> gridless Poisson
-> KMC events -> transport / dissipated power -> heat."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .ops import boundary_cg, kmc_events
from .ops import graph as ops_graph
from .ops.ell_gather import ell_gather_batched
from .ops.pairwise import batched_tickets, poisson_exact_batched, poisson_pairwise_batched
from .ops.wkb_fly import wkb_fly_matvec, wkb_fly_pdisp
from .ops.wkb_window import wkb_window_block
from .physics import charge as charge_mod
from .physics import current as current_mod
from .physics import events as events_mod
from .physics import heat as heat_mod
from .physics import potential as potential_mod
from .state import (HOST_COLS, Geometry, PhysParams, SimState, _unbatch, batch_size, host_block,
                    host_row, host_values, replace, set_host, stack_states, unbatch_all)


# ----------------------------------------------------------------------------
# phases: the units of the superstep, of the modular driver's timing and of
# the engine's cold solves (named as the JAX package's engine names them)
# ----------------------------------------------------------------------------

def _phase_charge(geom, params, state):
    return charge_mod.update_charge(geom, params, state)


def _phase_boundary(geom, params, state, Vd, rows=None):
    """``rows``: a rank's rows under the replicated decomposition
    (``parallel.sharding``), as in the next phase."""
    return potential_mod.solve_boundary_potential(geom, params, state, Vd, rows=rows)


def _phase_poisson(geom, params, state, rows=None):
    if params.poisson_compact_cap > 0:
        state, n = potential_mod.poisson_gridless_compact(
            geom, params, state, cap=params.poisson_compact_cap, rows=rows)
        return state, {"n_charged_sites": n}
    # dense sweep: every site is a candidate, so the compaction bucket is the
    # whole site axis and can never overflow
    state, _ = potential_mod.poisson_gridless_compact(
        geom, replace(params, poisson_kernel="jnp"), state, cap=geom.N, rows=rows)
    return state, {}


def _phase_cb_edge(geom, params, state, Vd):
    return potential_mod.solve_cb_edge(geom, params, state, Vd)


def _phase_events(geom, params, state):
    return events_mod.execute_superstep(geom, params, state)


def _phase_power(geom, params, state, Vd, cc=None, cg_maxiter=20000):
    """The in-superstep transport solve: the exact unchanged-network skip and
    transport_warm_precond (cold pre-solves call update_power directly and
    always solve)."""
    return current_mod.update_power(geom, params, state, Vd, cc=cc,
                                    cg_maxiter=cg_maxiter, allow_skip=True)


def _phase_transport_cache(geom, params, state):
    return current_mod.assemble_transport_cache(geom, params, state)


def _phase_power_chunk(geom, params, state, Vd, cc=None, cg_maxiter=20000,
                       precond=None):
    """One bounded transport solve (no skip); ``precond`` None keeps
    transport_precond (the cold solves)."""
    return current_mod.update_power(geom, params, state, Vd, cc=cc,
                                    cg_maxiter=cg_maxiter, precond=precond)


def _phase_heat(geom, params, heat, state, step_time):
    return heat_mod.update_temperature(geom, params, heat, state, step_time)


def _phase_heat_window(geom, params, heat, state, temp, n_sub):
    return heat_mod.local_cg_transient_window(geom, params, heat, state, temp, n_sub)


def _phase_heat_steady(geom, params, heat, state, temp):
    return heat_mod.local_cg_steady(geom, params, heat, state, temp)


def _phase_heat_finish(geom, params, state, temp):
    return heat_mod.finish_local_temperature(geom, params, state, temp)


# ----------------------------------------------------------------------------
# bounded segments (solver_chunk_iters > 0)
# ----------------------------------------------------------------------------

#: transient local-heat substeps a segment in the chunked modular driver
HEAT_SUBSTEPS_PER_DISPATCH = 64


def segments(step, state, iters_key: str, converged_key: str, what: str):
    """``step(state) -> (state, metrics)`` repeated, each segment
    warm-started from the last, until the solver reports convergence: the
    loop ends on its ``converged_key`` flag, never on the iteration count (a
    segment can converge in exactly its cap, and the mixed-precision solver
    can leave unconverged with fewer).  Returns the state, the last
    segment's metrics and the iterations summed over the segments."""
    total = 0
    for _ in range(1000):
        state, m = step(state)
        total += int(m[iters_key])
        if m[converged_key]:
            return state, m, total
    raise RuntimeError(f"chunked {what} failed to converge")


def chunked_boundary_resolve(geom, params, state, Vd, chunk: int, boundary=_phase_boundary):
    """The boundary solve in segments of ``chunk`` iterations; the metrics
    with the iterations summed.  ``boundary``: :func:`_phase_boundary`'s
    signature (the replicated decomposition's solve over its ranks)."""
    pchunk = replace(params, solver_maxiter=chunk)

    def step(st):
        st, m = boundary(geom, pchunk, st, Vd)
        if not m["boundary_converged"]:
            # defeat the exact skip for the next segment (it would see an
            # unchanged network and keep the unconverged field)
            st = replace(st, Vd_prev=float("nan"))
        return st, m

    state, m, total = segments(step, state, "cg_iters_boundary", "boundary_converged",
                               "boundary solve")
    return state, dict(m, cg_iters_boundary=total)


def chunked_power_resolve(geom, params, state, Vd, cc, chunk: int):
    """The in-superstep transport solve in segments of ``chunk`` iterations:
    an unchanged network takes the exact skip; otherwise warm segments
    (transport_warm_precond) commit only the warm start and the persistent
    tunnel rows until one converges, and a last call from that start does
    the extraction and records the network for the skip.  Its
    ``transport_converged`` is the step's; ``cg_iters_power`` sums all
    segments."""
    if params.transport_skip_unchanged and current_mod.transport_unchanged(
            geom, params, state, Vd):
        return _phase_power(geom, params, state, Vd, cc)

    def step(st):
        new, m = _phase_power_chunk(geom, params, st, Vd, cc=cc, cg_maxiter=chunk,
                                    precond=params.transport_warm_precond)
        rep = {"virtual_potentials": new.virtual_potentials}
        if params.transport_incremental:
            rep.update(tt_slot_atom=new.tt_slot_atom, tt_vm=new.tt_vm, tt_vv=new.tt_vv,
                       tt_valid=new.tt_valid)
        return replace(st, **rep), m

    state, _, total = segments(step, state, "cg_iters_power", "transport_converged",
                               "transport re-solve")
    state, m = _phase_power(geom, params, state, Vd, cc, cg_maxiter=chunk)
    return state, dict(m, cg_iters_power=total + int(m["cg_iters_power"]))


def run_heat_phase_chunked(geom, params, heat, state, step_time):
    """The local cg heat phase as segments of at most
    HEAT_SUBSTEPS_PER_DISPATCH transient substeps; the same substeps in the
    same order as the single call, so the same field.  The global and dense
    models take the single call.  Returns (state, metrics)."""
    if not (params.solve_heating_local and not params.solve_heating_global
            and heat is not None and heat.method == "cg" and heat.n_interface):
        return _phase_heat(geom, params, heat, state, step_time)
    temp = state.temperature
    if heat_mod.is_steady(params, step_time):
        heat_mod.last_local.update(branch="steady", substeps=0, cg_iters=0)
        temp = _phase_heat_steady(geom, params, heat, state, temp)
    else:
        n_sub = heat_mod.n_substeps(params, step_time)
        heat_mod.last_local.update(branch="transient", substeps=n_sub, cg_iters=0)
        W = HEAT_SUBSTEPS_PER_DISPATCH
        for k0 in range(0, n_sub, W):
            temp = _phase_heat_window(geom, params, heat, state, temp,
                                      min(W, n_sub - k0))
    return _phase_heat_finish(geom, params, state, temp)


# ----------------------------------------------------------------------------
# the superstep
# ----------------------------------------------------------------------------

def _untimed(key, fn, *args, **kw):
    return fn(*args, **kw)


def superstep_impl(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, cc=None,
    heat=None, chunk_iters: int = 0, phase=_untimed,
) -> Tuple[SimState, float, Dict]:
    """One superstep.  Returns ``(state, step_time, metrics)``; metric
    values are Python numbers or 0-d tensors.  ``cc``: the per-bias-point
    cache of the blocked transport operator
    (``current.assemble_transport_cache``, plus the static band); ``heat``:
    the local heat model (``heat.build_heat_model``), needed only with
    ``solve_heating_local``.

    ``phase(key, fn, *args, **kw)`` runs each module under the reference's
    timing key (charge, potential from boundaries, potential from charges,
    kmc events, dissipated power, temperature); the default just calls it.
    ``chunk_iters > 0`` runs the boundary and transport re-solves in segments
    of that many iterations and the local cg heat model in segments of
    HEAT_SUBSTEPS_PER_DISPATCH substeps."""
    metrics: Dict = {}
    if params.solve_potential:
        state, m = phase("charge", _phase_charge, geom, params, state)
        metrics.update(m)
        if chunk_iters > 0:
            state, m = phase("potential from boundaries", chunked_boundary_resolve,
                             geom, params, state, Vd, chunk_iters)
        else:
            state, m = phase("potential from boundaries", _phase_boundary,
                             geom, params, state, Vd)
        metrics.update(m)
        state, m = phase("potential from charges", _phase_poisson, geom, params, state)
        metrics.update(m)

    step_time = 0.0
    if params.perturb_structure:
        res = phase("kmc events", _phase_events, geom, params, state)
        state, step_time = res.state, res.step_time
        metrics["n_events"] = res.n_events
        metrics["n_active_rows"] = res.n_active

    if params.solve_current:
        if chunk_iters > 0:
            state, m = phase("dissipated power", chunked_power_resolve,
                             geom, params, state, Vd, cc, chunk_iters)
        else:
            state, m = phase("dissipated power", _phase_power, geom, params, state, Vd, cc)
        metrics.update(m)
        # heat runs on the power of the last transport solve, also after a
        # skipped one (power and P_tot then stay in the state)
        if params.solve_heating_global or params.solve_heating_local:
            heat_fn = run_heat_phase_chunked if chunk_iters > 0 else _phase_heat
            state, m = phase("temperature", heat_fn, geom, params, heat, state, step_time)
            metrics.update(m)
    return state, step_time, metrics


def multi_superstep_impl(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, Icc_A: float,
    t_end: float, n_steps: int, cc=None, heat=None, limit=None,
):
    """Up to ``n_steps`` supersteps with the driver's stop conditions
    applied between them, as the JAX package's ``multi_superstep_impl``
    (``devicekmc_tpu/superstep.py:63-107``): a step after the KMC clock
    reached ``t_end`` or the current passed the compliance ``Icc_A`` [A] is
    a no-op (``step_time`` 0, ``active`` False), and so is every step from
    ``limit`` on.  Returns ``(state, step_times, metrics)``: ``step_times``
    an f64 array [n_steps], ``metrics`` a dict of f64 arrays [n_steps] of the
    superstep's metrics plus the bool array ``active``; a no-op step's row
    holds 0.

    The batch is a host loop over supersteps: each still reads a few
    scalars, so the loop leaves once a step is a no-op.  The state and the
    step times are those of the JAX package; a no-op step's metric row is
    0, where the JAX package's holds the metrics of the superstep it
    computed from the frozen state and selected away (its ``n_events`` may
    be nonzero), as the per-step driver would have no such step.  All the
    batch's tensor metrics are read back in one transfer at the end."""
    step_times = np.zeros(n_steps)
    active = np.zeros(n_steps, dtype=bool)
    rows = []
    for k in range(n_steps):
        if limit is not None and k >= limit:
            break
        state, step_times[k], m = superstep_impl(geom, params, state, Vd, cc=cc,
                                                 heat=heat)
        active[k] = True
        rows.append(m)
        if state.kmc_time >= t_end or state.I_macro > Icc_A:
            break
    keys = sorted({key for m in rows for key in m})
    metrics = {key: np.zeros(n_steps) for key in keys}
    lazy = [(k, key, v) for k, m in enumerate(rows) for key, v in m.items()
            if torch.is_tensor(v)]
    if lazy:
        vals = torch.stack([v.reshape(()).to(device=lazy[0][2].device,
                                             dtype=torch.float64)
                            for _, _, v in lazy]).tolist()
        for (k, key, _), val in zip(lazy, vals):
            metrics[key][k] = val
    for k, m in enumerate(rows):
        for key, v in m.items():
            if not torch.is_tensor(v):
                metrics[key][k] = float(v)
    metrics["active"] = active
    return state, step_times, metrics


def superstep_batched(
    geom: Geometry, params: PhysParams, states: SimState, Vd: float, heat=None,
    cg_ws=None, cc=None,
) -> Tuple[SimState, torch.Tensor, Dict]:
    """One superstep of B replicas of one device (a batched state), in the
    phase order of :func:`superstep_impl`; replica b computes what
    ``superstep_impl`` computes from replica b alone.  Returns ``(states,
    step_times, metrics)``: the step times [B] float64 and every metric a [B]
    tensor, on the device.

    Charge, boundary potential, gridless Poisson and the KMC events run with
    a replica axis: one launch of the batched gather a call site, of the
    batched pair sweep and of the batched event loop for all replicas, and
    each replica's decisions (skip, incremental residual, CG stop) are masks
    on the device, so that the host reads of this part (the CG's, one a chunk
    of iterations) do not grow with B.  Under ``event_mode = "scan"`` (the
    equivalence mode; ``graph_ready`` keeps it eager) the events run replica
    by replica through the literal scan loop
    (:func:`_scan_replica_by_replica`), as the JAX package's vmap runs
    ``execute_superstep_scan`` on each.  With ``solve_current`` (and heating)
    the transport and heat phases run replica by replica on
    ``state.unbatch_all(states)`` and are stacked again: what the JAX
    package's vmap computes; the replica axis through the transport and heat
    kernels is a later slice.

    ``cg_ws`` (``ops.boundary_cg.workspace``, made before a capture): the
    body a captured graph runs, which reads nothing back: the boundary
    system is assembled every step and solved by the device loop of
    ``ops.boundary_cg``, and with ``solve_current`` (B = 1) the transport
    phase assembles its operator on the device and solves it by the device
    loops of ``ops.transport_cg`` with the per-bias-point cache ``cc`` (band,
    workspace), the skip a mask, and the heat model runs on the device, the
    local one (``heat``) as the device loops of ``ops.heat``
    (configurations of :func:`graph_ready` only)."""
    B = batch_size(states)
    metrics: Dict = {}
    if params.solve_potential:
        states, m = charge_mod.update_charge_batched(geom, params, states)
        metrics.update(m)
        states, m = potential_mod.solve_boundary_potential_batched(geom, params, states, Vd,
                                                                   cg_ws=cg_ws)
        metrics.update(m)
        if params.poisson_compact_cap > 0:
            states, n = potential_mod.poisson_gridless_compact_batched(
                geom, params, states, cap=params.poisson_compact_cap)
            metrics["n_charged_sites"] = n
        else:
            states, _ = potential_mod.poisson_gridless_compact_batched(
                geom, replace(params, poisson_kernel="jnp"), states, cap=geom.N)

    step_times = torch.zeros(B, dtype=torch.float64, device=geom.device)
    if params.perturb_structure:
        if params.event_mode == "incremental":
            res = events_mod.execute_superstep_incremental_batched(geom, params, states)
        else:
            res = _scan_replica_by_replica(geom, params, states)
        states, step_times = res.state, res.step_time
        metrics["n_events"] = res.n_events
        metrics["n_active_rows"] = res.n_active

    if params.solve_current and cg_ws is not None:
        if B != 1:
            raise ValueError("the captured transport phase runs one replica")
        st, m = _phase_power(geom, params, _device_single(states), Vd, cc)
        if params.solve_heating_global or params.solve_heating_local:
            st, mh = _phase_heat(geom, params, heat, st, step_times[0])
            m = {**m, **mh}
        states = _device_batch(states, st)
        for key, v in m.items():
            metrics[key] = v.reshape(1).to(torch.float64)
    elif params.solve_current:
        heating = params.solve_heating_global or params.solve_heating_local
        dts = step_times.tolist()
        singles, rows = [], []
        for b, st in enumerate(unbatch_all(states)):
            st, m = _phase_power(geom, params, st, Vd)
            if heating:
                st, mh = _phase_heat(geom, params, heat, st, dts[b])
                m = {**m, **mh}
            singles.append(st)
            rows.append(m)
        states = stack_states(singles)
        for key in rows[0]:
            metrics[key] = torch.tensor([float(m[key]) for m in rows], dtype=torch.float64,
                                        device=geom.device)
    return states, step_times, metrics


def _scan_replica_by_replica(geom: Geometry, params: PhysParams,
                             states: SimState) -> events_mod.BatchedSuperstepResult:
    """The literal scan event loop (``events.execute_superstep_scan``) of
    each replica in turn, stacked again: what the JAX package's vmap of
    ``execute_superstep_scan`` computes (``n_active`` 0, as a scan
    superstep reports it)."""
    singles, times, counts = [], [], []
    for st in unbatch_all(states):
        res = events_mod.execute_superstep_scan(geom, params, st)
        singles.append(res.state)
        times.append(res.step_time)
        counts.append(res.n_events)
    dev = geom.device
    return events_mod.BatchedSuperstepResult(
        state=stack_states(singles),
        step_time=torch.tensor(times, dtype=torch.float64, device=dev),
        n_events=torch.tensor(counts, dtype=torch.int64, device=dev),
        n_active=torch.zeros(len(singles), dtype=torch.int64, device=dev))


# ----------------------------------------------------------------------------
# the superstep as one captured CUDA graph
# ----------------------------------------------------------------------------

_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))
#: a single state's host fields: its scalars, then its key and tt_valid
_SCALARS = ("kmc_time", "T_bg", "I_macro", "P_tot", "Vd_prev", "transport_Vd_prev")
_HOST = _SCALARS + ("key", "tt_valid")
#: the kernel wrappers a captured superstep launches outside its CG loops
#: (the loops' kernels count their launches on the card)
_COUNTED = (ell_gather_batched, poisson_pairwise_batched, poisson_exact_batched,
            kmc_events.kmc_event_loop_batched, wkb_window_block, wkb_fly_matvec,
            wkb_fly_pdisp)


def _device_single(states: SimState) -> SimState:
    """Replica 0 of a batched state as a single state whose scalars, key and
    tt_valid stay on the device (0-d views)."""
    return SimState(**{f: getattr(states, f)[0] for f in _FIELDS})


def _device_batch(states: SimState, single: SimState) -> SimState:
    """``states`` (B = 1) with the fields of the single state ``single``
    (:func:`_device_single`'s form) that changed."""
    kw = {}
    for f in _FIELDS:
        v, old = getattr(single, f), getattr(states, f)
        kw[f] = old if v.data_ptr() == old.data_ptr() \
            else v.reshape((1,) + tuple(old.shape[1:])).to(old.dtype)
    return SimState(**kw)


def graph_ready(params: PhysParams, batch: Optional[int] = 1,
                band: bool = True) -> Optional[str]:
    """None when the superstep of ``params`` (``batch`` replicas; None: a
    count not known yet, possibly above 1) runs as one captured graph
    (:class:`SuperstepGraph`): the headline module set with the Jacobi
    boundary CG, the incremental event loop and a Poisson bucket (either
    sweep: the exact-erfc kernel or the A&S pair-sweep kernel); with
    ``solve_current``, one replica (``batch`` 1) of the blocked solve with
    the Jacobi warm preconditioner, heating off, global or local (dense or
    matrix-free): in mixed precision
    with the on-the-fly or the stored metal block and the static band
    (``band``), with or without the bf16 inner operator (on the fly), and in
    f64 (the stored block; no band needed: the f64 operator reads the exact
    ELL rows).  Otherwise why it runs eagerly."""
    if params.solve_current:
        reason = current_mod.device_form_reason(params)
        if reason is not None:
            return f"solve_current with {reason}"
        if batch != 1:
            return ("solve_current with a replica axis (B > 1): the transport and heat "
                    "phases run replica by replica, eagerly")
        if not band and params.mixed:
            return ("solve_current without the static band (transport_banded off, or too "
                    "large): the ELL inner operator runs eagerly")
    if params.solve_potential and params.boundary_precond != "jacobi":
        return (f"boundary_precond={params.boundary_precond!r}: the deflated "
                "in-superstep solve runs eagerly")
    if params.perturb_structure and params.event_mode != "incremental":
        return f"event_mode={params.event_mode!r} runs eagerly"
    if params.solve_potential and params.poisson_compact_cap <= 0:
        return ("the dense Poisson sweep (poisson_compact_cap <= 0, no bucket) runs "
                "eagerly")
    return None


def _clone(states: SimState) -> SimState:
    return SimState(**{f: getattr(states, f).clone() for f in _FIELDS})


def _copy_into(dst: SimState, src: SimState) -> None:
    for f in _FIELDS:
        getattr(dst, f).copy_(getattr(src, f))


def _select(done: torch.Tensor, old: SimState, new: SimState) -> SimState:
    """Per replica, ``old`` where ``done`` else ``new`` (the key through its
    int32 view)."""
    kw = {}
    for f in _FIELDS:
        a, b = getattr(old, f), getattr(new, f)
        if a is b:
            kw[f] = a
            continue
        d = done.reshape(-1, *([1] * (a.dim() - 1)))
        if a.dtype == torch.uint32:
            kw[f] = torch.where(d, a.view(torch.int32), b.view(torch.int32)).view(torch.uint32)
        else:
            kw[f] = torch.where(d, a, b)
    return SimState(**kw)


def element_checksum(element: torch.Tensor) -> torch.Tensor:
    """[B] f64: each replica's sum over sites of ``element[b, i] * w_i``, with
    weights ``w_i = (i * 40503 mod 2**16) + 1``: one number that tells two
    element arrays apart, exact in f64 while the sites times 2**16 times the
    largest element code stay below 2**53."""
    n = element.shape[-1]
    w = (torch.arange(n, dtype=torch.int64, device=element.device) * 40503) % 65536 + 1
    return (element.to(torch.int64) * w).sum(dim=-1).to(torch.float64)


class SuperstepGraph:
    """The superstep of B replicas (:func:`superstep_batched` with the boundary
    CG as a device loop) and batches of ``n_steps`` of it, each captured once
    as a CUDA graph that replays as one launch and reads nothing back: the
    port's ``jax.jit(superstep_impl)`` and ``jit(multi_superstep_impl)``.  On
    the CPU a replay calls the captured function (the plain version).

    The state lives in two static batched states, ``slots``: a graph reads
    one and writes the other, so the state before a replay stays intact for
    a redo or a snapshot, and a graph is captured for each (kind, source
    slot, Vd, steps), and again after ``params`` change (a cap grew).  The
    bias and the caps are fixed at capture; the clock, key, T_bg and the bias
    of the last boundary solve are device tensors of the state.  A replay's
    host inputs are one device buffer, written by one copy before it: each
    replica's host scalars, key and tt_valid (``hin``, :func:`state.host_block`'s
    layout), which the graph writes into its source slot first, and a
    batch's ``limit``, ``t_end`` and ``Icc_A`` (``ctl``), so that one capture
    serves every batch of a bias point.  Every buffer the capture needs
    outside PyTorch's pool (the slots, the CG workspace ``ws``, ``hin``) is
    made before it.

    :meth:`step` and :meth:`multi` take and return single states (B = 1),
    the driver's form, with one read a replay; :meth:`step_batched` takes
    and returns batched states and reads nothing.  ``checksums``: after
    :meth:`multi`, :func:`element_checksum` of the elements after each step
    of the batch, [n_steps] (read with the batch's result).

    ``heat``: the simulation's heat model (``physics.heat``), whose device
    loops the local model runs in (its workspace made with the model).
    With the local model on, the read of :meth:`step` and :meth:`multi`
    also carries the loops' log of the last superstep (branch, substeps, CG
    iterations), which sets ``physics.heat.last_local``; it is no metric."""

    def __init__(self, geom: Geometry, params: PhysParams, batch: int, heat=None):
        reason = graph_ready(params, batch)
        if reason is not None:
            raise ValueError(f"the superstep of these params is not captured: {reason}")
        self.geom, self.params, self.batch = geom, params, batch
        self.heat = heat
        self.device = geom.device
        self.slots: Optional[List[SimState]] = None
        self.ws = boundary_cg.workspace(batch, geom.neigh_idx, geom.bp_interior_mask,
                                        params.dtype, self.device)
        cols = HOST_COLS
        self._hin = torch.zeros(batch * cols + 3, dtype=torch.float64, device=self.device)
        self.hin = self._hin[:batch * cols].view(batch, cols)
        self.ctl = self._hin[batch * cols:]
        self._staging = (torch.empty(self._hin.shape, dtype=torch.float64, pin_memory=True)
                         if self.device.type == "cuda" else None)
        #: the memory pool the graphs share (a new one for each set of graphs)
        self.pool = None
        self.graphs: Dict = {}
        self.keys: Dict = {}
        self.checksums = None
        #: the per-bias-point transport cache (band, transport CG workspace)
        #: the graphs of this bias point were captured with
        self.cc = None
        #: graphs captured and replays (calls of a graph) so far, and the
        #: seconds of each capture
        self.captures = self.replays = 0
        self.capture_s: List[float] = []

    def set_params(self, params: PhysParams) -> None:
        """Use ``params`` from the next replay on (captured anew)."""
        if params is not self.params:
            reason = graph_ready(params, self.batch)
            if reason is not None:
                raise ValueError(f"the superstep of these params is not captured: {reason}")
            self.params = params
            self.graphs.clear()

    def set_heat(self, heat) -> None:
        """Use the heat model ``heat`` from the next replay on (captured
        anew when it is another)."""
        if heat is not self.heat:
            self.heat = heat
            self.graphs.clear()

    def _local_log(self) -> Optional[torch.Tensor]:
        """The local heat model's loop log when the superstep runs it, else
        None."""
        p, h = self.params, self.heat
        if (p.solve_current and p.solve_heating_local and not p.solve_heating_global
                and h is not None and h.n_interface):
            return h.ws.log
        return None

    # -- the state in the slots -------------------------------------------
    def _slot_of(self, element: torch.Tensor) -> int:
        """The slot whose elements ``element`` views (a state a replay
        returned), else 0."""
        for i, s in enumerate(self.slots):
            if element.data_ptr() == s.element.data_ptr():
                return i
        return 0

    def _load_tensors(self, states: SimState, single: bool) -> int:
        """Copy the device fields of ``states`` (a single state when
        ``single``) into a slot: the one they already view, where nothing is
        copied, else slot 0 (both made anew when a shape changed).  Returns
        the slot."""
        fields = [f for f in _FIELDS if f not in _HOST]
        lead = 1 if single else 0
        if self.slots is None or any(getattr(states, f).shape
                                     != getattr(self.slots[0], f).shape[lead:] for f in fields):
            self.slots = [_clone(stack_states([states]) if single else states) for _ in range(2)]
            self.graphs.clear()
            return 0
        i = self._slot_of(states.element)
        for f in fields:
            src, dst = getattr(states, f), getattr(self.slots[i], f)
            dst = dst[0] if single else dst
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
        return i

    def load(self, states: SimState) -> int:
        """Make a slot hold the batched state ``states`` (its scalars, key
        and tt_valid through ``hin``); returns the slot."""
        i = self._load_tensors(states, single=False)
        self.hin.copy_(host_block(states))
        return i

    def load_single(self, state: SimState, ctl=(0.0, 0.0, 0.0)) -> int:
        """Make a slot hold the single state ``state`` (B = 1); its host
        fields and ``ctl`` (limit, t_end, Icc_A) go to the device in one copy.
        Returns the slot."""
        if self.batch != 1:
            raise ValueError("load_single: a graph of one replica")
        i = self._load_tensors(state, single=True)
        values = host_row(state) + [float(c) for c in ctl]
        if self._staging is None:
            self._hin.copy_(torch.tensor(values, dtype=torch.float64))
        else:
            # the previous copy from the staging buffer ended before the
            # read of the previous replay's result
            self._staging.numpy()[:] = values
            self._hin.copy_(self._staging, non_blocking=True)
        return i

    # -- capture ------------------------------------------------------------
    def _graph(self, kind: str, src: int, Vd: float, n_steps: int = 1) -> ops_graph.Graph:
        """The graph of ``kind`` ("step" or "batch" of ``n_steps``) from slot
        ``src`` at ``Vd``, captured at its first use; every call is followed
        by one replay of it."""
        key = (kind, src, Vd, n_steps, id(self.cc))
        g = self.graphs.get(key)
        if g is None:
            # a new bias point: the graphs of the last one are not replayed again
            self.graphs = {k: v for k, v in self.graphs.items()
                           if k[2] == Vd and k[4] == id(self.cc)}
            if not self.graphs and self.device.type == "cuda":
                # no graph holds the pool now: a capture into a pool whose
                # graphs were all freed fails PyTorch's allocator assert
                # (use_count > 0) until the pool is released, so the next
                # graphs take a new pool
                self.pool = torch.cuda.graph_pool_handle()
            if self.params.solve_current:
                if not current_mod.warm_device_form(self.params, self.cc, "jacobi"):
                    raise ValueError("the captured transport phase needs the bias point's "
                                     "cache (in mixed precision with the static band)")
                # made before the capture, outside PyTorch's pool
                current_mod.transport_workspace(self.geom, self.params, self.cc)
            fn = (self._step_fn if kind == "step" else self._batch_fn)(src, Vd, n_steps)
            t0 = time.perf_counter()
            g = ops_graph.Graph(fn, self.device, counted=_COUNTED, pool=self.pool,
                                tickets=batched_tickets(self.geom.N, self.batch))
            self.capture_s.append(time.perf_counter() - t0)
            g.cc = self.cc      # the buffers it reads live as long as it does
            self.graphs[key] = g
            self.captures += 1
        self.replays += 1
        return g

    def _step_fn(self, src: int, Vd: float, _n_steps: int):
        S, D = self.slots[src], self.slots[1 - src]

        def fn():
            set_host(S, self.hin)
            out, dts, m = superstep_batched(self.geom, self.params, S, Vd, heat=self.heat,
                                            cg_ws=self.ws, cc=self.cc)
            _copy_into(D, out)
            keys = self.keys["step"] = sorted(m)
            log = self._local_log()
            pack = torch.cat([dts.to(torch.float64)[:, None]]
                             + [m[k].to(torch.float64)[:, None] for k in keys]
                             + [host_block(D)]
                             + ([] if log is None else [log.to(torch.float64).expand(
                                 self.batch, -1)]), dim=1)
            return pack, dts, m

        return fn

    def _batch_fn(self, src: int, Vd: float, n_steps: int):
        """``multi_superstep_impl`` of the JAX package (a ``lax.scan``),
        unrolled: each step computes, and a step that is done (from
        ``limit`` on, or after the clock reached ``t_end`` or the current
        passed ``Icc_A``) is selected away, its step time and metrics 0 and
        ``active`` False."""
        S, D = self.slots[src], self.slots[1 - src]

        def fn():
            set_host(S, self.hin)
            limit, t_end, icc = self.ctl[0], self.ctl[1], self.ctl[2]
            st = S
            done = torch.zeros(self.batch, dtype=torch.bool, device=self.device)
            rows, sums = [], []
            for k in range(n_steps):
                done = done | (limit <= k)
                new, dts, m = superstep_batched(self.geom, self.params, st, Vd,
                                                heat=self.heat, cg_ws=self.ws, cc=self.cc)
                st = _select(done, st, new)
                keys = sorted(m)
                rows.append(torch.stack(
                    [torch.where(done, 0.0, dts.to(torch.float64)),
                     (~done).to(torch.float64)]
                    + [torch.where(done, 0.0, m[key].to(torch.float64)) for key in keys],
                    dim=1))
                sums.append(element_checksum(st.element))
                done = done | (st.kmc_time >= t_end) | (st.I_macro > icc)
            self.keys[("batch", n_steps)] = keys
            _copy_into(D, st)
            log = self._local_log()
            return torch.cat([torch.stack(rows).reshape(-1), torch.stack(sums).reshape(-1),
                              host_block(D).reshape(-1)]
                             + ([] if log is None else [log.to(torch.float64)]))

        return fn

    # -- replays ------------------------------------------------------------
    def step(self, state: SimState, Vd: float, cc=None):
        """One superstep of the single state ``state`` as one replay, then
        one read: ``(state, step_time, metrics)`` as :func:`superstep_impl`
        returns them (Python numbers), the state views of the slot written
        (valid until a replay writes that slot again).  ``cc``: the bias
        point's transport cache (with ``solve_current``)."""
        self.cc = cc
        i = self.load_single(state)
        pack, _, _ = self._graph("step", i, Vd)()
        row = pack.tolist()[0]
        keys = self.keys["step"]
        end = 1 + len(keys) + HOST_COLS
        host = host_values(row[1 + len(keys):end])
        self._note_local(row[end:])
        return _unbatch(self.slots[1 - i], 0, host), row[0], dict(zip(keys, row[1:1 + len(keys)]))

    @staticmethod
    def _note_local(log) -> None:
        """``physics.heat.last_local`` from a replay's loop log, if any."""
        if len(log):
            heat_mod.note_local(*log)

    def multi(self, state: SimState, Vd: float, Icc_A: float, t_end: float, n_steps: int,
              limit=None, cc=None):
        """:func:`multi_superstep_impl` of the single state ``state`` as one
        replay and one read: ``(state, step_times, metrics)`` with
        ``metrics["active"]``, numpy arrays [n_steps].  A step after the
        current passed ``Icc_A`` is a no-op, decided on the device."""
        self.cc = cc
        i = self.load_single(state, (n_steps if limit is None else limit, t_end, Icc_A))
        vals = np.asarray(self._graph("batch", i, Vd, n_steps)().tolist())
        keys = self.keys[("batch", n_steps)]
        width = 2 + len(keys)
        rows = vals[:n_steps * width].reshape(n_steps, width)
        self.checksums = vals[n_steps * width:n_steps * (width + 1)]
        end = n_steps * (width + 1) + HOST_COLS
        host = host_values(vals[n_steps * (width + 1):end])
        self._note_local(vals[end:])
        metrics = {key: rows[:, 2 + c] for c, key in enumerate(keys)}
        metrics["active"] = rows[:, 1] > 0
        return _unbatch(self.slots[1 - i], 0, host), rows[:, 0], metrics

    def step_batched(self, states: SimState, Vd: float):
        """One superstep of the batched state ``states`` as one replay, with
        no read: ``(states, step_times, metrics)`` as
        :func:`superstep_batched` returns them, copies of the graph's
        outputs."""
        i = self.load(states)
        _, dts, m = self._graph("step", i, Vd)()
        return _clone(self.slots[1 - i]), dts.clone(), {k: v.clone() for k, v in m.items()}
