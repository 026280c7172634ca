"""The KMC superstep body.  Phase order mirrors the reference main loop
(src/kmc_main.cpp:175-234): charge -> boundary potential -> gridless Poisson
-> KMC events -> transport / dissipated power -> heat."""

from __future__ import annotations

from typing import Dict, Tuple

from .physics import charge as charge_mod
from .physics import current as current_mod
from .physics import events as events_mod
from .physics import heat as heat_mod
from .physics import potential as potential_mod
from .state import Geometry, PhysParams, SimState, replace


def check_ported(params: PhysParams) -> None:
    """Raise for the options whose code is not ported yet."""
    current_mod.check_transport_ported(params)


def superstep_impl(
    geom: Geometry, params: PhysParams, state: SimState, Vd: float, cc=None,
    heat=None,
) -> Tuple[SimState, float, Dict]:
    """One superstep.  Returns ``(state, step_time, metrics)``; metric
    values are Python numbers or 0-d tensors.  ``cc``: the per-bias-point
    cache of the blocked transport operator
    (``current.assemble_transport_cache``, plus the static band); ``heat``:
    the local heat model (``heat.build_heat_model``), needed only with
    ``solve_heating_local``."""
    check_ported(params)
    metrics: Dict = {}
    if params.solve_potential:
        state, m = charge_mod.update_charge(geom, params, state)
        metrics.update(m)
        state, m = potential_mod.solve_boundary_potential(geom, params, state, Vd)
        metrics.update(m)
        if params.poisson_compact_cap > 0:
            state, n_charged = potential_mod.poisson_gridless_compact(
                geom, params, state, cap=params.poisson_compact_cap
            )
            metrics["n_charged_sites"] = n_charged
        else:
            # dense sweep: every site is a candidate, so the compaction
            # bucket is the whole site axis and can never overflow
            state, _ = potential_mod.poisson_gridless_compact(
                geom, replace(params, poisson_kernel="jnp"), state, cap=geom.N
            )

    step_time = 0.0
    if params.perturb_structure:
        res = events_mod.execute_superstep(geom, params, state)
        state, step_time = res.state, res.step_time
        metrics["n_events"] = res.n_events
        metrics["n_active_rows"] = res.n_active

    if params.solve_current:
        # allow_skip: the exact unchanged-network fast path applies only
        # here, where events may have left X identical to the last solve;
        # cold pre-solves call update_power directly and always solve
        state, m = current_mod.update_power(
            geom, params, state, Vd, cc=cc, allow_skip=True
        )
        metrics.update(m)
        # heat runs on the power of the last transport solve, also after a
        # skipped one (power and P_tot then stay in the state)
        if params.solve_heating_global or params.solve_heating_local:
            state, m = heat_mod.update_temperature(geom, params, heat, state, step_time)
            metrics.update(m)
    return state, step_time, metrics
