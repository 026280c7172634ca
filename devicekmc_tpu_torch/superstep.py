"""The KMC superstep body, and a batch of supersteps with the driver's stop
conditions between them (``batch_steps > 1``).  Phase order mirrors the
reference main loop (src/kmc_main.cpp:175-234): charge -> boundary potential
-> gridless Poisson -> KMC events -> transport / dissipated power -> heat."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

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
