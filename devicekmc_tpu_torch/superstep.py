"""The KMC superstep body, a batch of supersteps with the driver's stop
conditions between them (``batch_steps > 1``), and the superstep of B
replicas of one device (:func:`superstep_batched`, the body of
``parallel.batched``).  Phase order mirrors the reference main loop
(src/kmc_main.cpp:175-234): charge -> boundary potential -> gridless Poisson
-> KMC events -> transport / dissipated power -> heat."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .physics import charge as charge_mod
from .physics import current as current_mod
from .physics import events as events_mod
from .physics import heat as heat_mod
from .physics import potential as potential_mod
from .state import (Geometry, PhysParams, SimState, batch_size, replace, stack_states,
                    unbatch_all)


# ----------------------------------------------------------------------------
# phases: the units of the superstep, of the modular driver's timing and of
# the engine's cold solves (named as the JAX package's engine names them)
# ----------------------------------------------------------------------------

def _phase_charge(geom, params, state):
    return charge_mod.update_charge(geom, params, state)


def _phase_boundary(geom, params, state, Vd):
    return potential_mod.solve_boundary_potential(geom, params, state, Vd)


def _phase_poisson(geom, params, state):
    if params.poisson_compact_cap > 0:
        state, n = potential_mod.poisson_gridless_compact(
            geom, params, state, cap=params.poisson_compact_cap)
        return state, {"n_charged_sites": n}
    # dense sweep: every site is a candidate, so the compaction bucket is the
    # whole site axis and can never overflow
    state, _ = potential_mod.poisson_gridless_compact(
        geom, replace(params, poisson_kernel="jnp"), state, cap=geom.N)
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


def chunked_boundary_resolve(geom, params, state, Vd, chunk: int):
    """The boundary solve in segments of ``chunk`` iterations; the metrics
    with the iterations summed."""
    pchunk = replace(params, solver_maxiter=chunk)

    def step(st):
        st, m = _phase_boundary(geom, pchunk, st, Vd)
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
    scalars, so the loop leaves once a step is a no-op, with the results of
    the JAX package's no-ops.  All the batch's tensor metrics are read back
    in one transfer at the end."""
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
    of iterations) do not grow with B.  With ``solve_current`` (and heating)
    the transport and heat phases run replica by replica on
    ``state.unbatch_all(states)`` and are stacked again: what the JAX
    package's vmap computes; the replica axis through the transport and heat
    kernels is a later slice."""
    B = batch_size(states)
    metrics: Dict = {}
    if params.solve_potential:
        states, m = charge_mod.update_charge_batched(geom, params, states)
        metrics.update(m)
        states, m = potential_mod.solve_boundary_potential_batched(geom, params, states, Vd)
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
        if params.event_mode != "incremental":
            raise NotImplementedError(
                "batched supersteps run the incremental event loop; event_mode "
                f"{params.event_mode!r} runs only on a single state")
        res = events_mod.execute_superstep_incremental_batched(geom, params, states)
        states, step_times = res.state, res.step_time
        metrics["n_events"] = res.n_events
        metrics["n_active_rows"] = res.n_active

    if params.solve_current:
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
