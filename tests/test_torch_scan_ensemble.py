"""The port's ensemble under ``event_mode = "scan"`` (the literal scan event
loop of each replica, ``superstep._scan_replica_by_replica``) against the
JAX package's ``make_batched_superstep`` (its vmap of ``superstep_impl``,
which dispatches each replica to ``execute_superstep_scan``), on the
256-site stack of tests/torch_parity.py with a perturbed state, at B = 2 and
3, in f64 and in mixed precision."""

import numpy as np
import pytest
import torch

from torch_parity import configs, perturbed_state, record_dict, small_structure, to_port

torch.set_num_threads(1)

VD = 10.0
STEPS = 3
# mixed precision: the f32 pair sweep and rate table in another order than
# the JAX package's (tests/test_torch_graph.py's tolerance of a residence
# time); f64: the same arithmetic up to the boundary CG's sums
T_TOL = {"f64": 1e-12, "mixed": 1e-3}
CASES = [(2, "f64"), (3, "f64"), (2, "mixed"), (3, "mixed")]


def _pieces(precision):
    from devicekmc_tpu.state import build_geometry, build_params, init_state

    s = small_structure()
    kw = dict(rnd_seed_kmc=7, precision=precision, event_mode="scan", poisson_compact_cap=64)
    jcfg, tcfg = configs(s, **kw)
    jg = build_geometry(s.elements, s.coords, jcfg)
    js = perturbed_state(jg, init_state(jg, jcfg, s.elements), seed=4, n_vac=14, n_od=10)
    return jg, build_params(jcfg), js, tcfg


@pytest.mark.parametrize("B,precision", CASES)
def test_scan_ensemble_matches_jax(B, precision):
    """Each replica's elements, charges, event count and key bit-equal to the
    JAX package's vmapped scan superstep after every one of STEPS supersteps,
    the step times within T_TOL relative, n_active_rows 0 as JAX reports it
    for a scan superstep; events fire in every replica."""
    import jax

    from devicekmc_tpu.parallel.batched import batch_states as jbatch
    from devicekmc_tpu.parallel.batched import make_batched_superstep as jmake
    from devicekmc_tpu.physics import heat as jheat
    from devicekmc_tpu_torch.parallel.batched import make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import batched_state_from_numpy
    from devicekmc_tpu_torch.state import build_params as tparams
    from devicekmc_tpu_torch.superstep import graph_ready

    jg, jp, js, tcfg = _pieces(precision)
    assert jp.event_mode == "scan"
    jstates = jbatch(js, B, base_seed=11)
    jstep = jmake(jg, jp, jheat.empty_heat_model(jp))
    tg, _ = to_port(jg, js)
    tp = tparams(tcfg)
    assert "event_mode" in graph_ready(tp, batch=None)
    states = batched_state_from_numpy(record_dict(jstates), device="cpu")
    step = make_batched_superstep(tg, tp, heat_mod.empty_heat_model(tp))
    n_ev = np.zeros(B, dtype=np.int64)
    for k in range(STEPS):
        jstates, jdts, jm = jstep(jstates, VD)
        jax.block_until_ready(jstates.element)
        states, dts, m = step(states, VD)
        where = f"step {k}"
        np.testing.assert_array_equal(states.element.numpy(), np.asarray(jstates.element),
                                      err_msg=where)
        np.testing.assert_array_equal(states.charge.numpy(), np.asarray(jstates.charge),
                                      err_msg=where)
        np.testing.assert_array_equal(m["n_events"].numpy(), np.asarray(jm["n_events"]),
                                      err_msg=where)
        np.testing.assert_array_equal(states.key.numpy(), np.asarray(jstates.key),
                                      err_msg=where)
        np.testing.assert_array_equal(m["n_active_rows"].numpy(),
                                      np.asarray(jm["n_active_rows"]), err_msg=where)
        np.testing.assert_allclose(dts.numpy(), np.asarray(jdts), rtol=T_TOL[precision],
                                   err_msg=where)
        np.testing.assert_allclose(states.kmc_time.numpy(), np.asarray(jstates.kmc_time),
                                   rtol=T_TOL[precision], err_msg=where)
        n_ev += m["n_events"].numpy()
    assert (n_ev > 0).all()
    # the replicas' streams differ, so their trajectories do
    assert any(not torch.equal(states.element[0], states.element[b]) for b in range(1, B))


def test_scan_ensemble_replica_is_its_single_superstep():
    """Replica b of the port's scan ensemble is the port's single scan
    superstep from replica b's state and key, bit for bit (elements,
    charges, key, step time, events), over two supersteps."""
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import build_params as tparams
    from devicekmc_tpu_torch.state import unbatch_all
    from devicekmc_tpu_torch.superstep import superstep_impl

    jg, _, js, tcfg = _pieces("f64")
    tg, ts = to_port(jg, js)
    tp = tparams(tcfg)
    heat = heat_mod.empty_heat_model(tp)
    states = batch_states(ts, 2, base_seed=3)
    singles = unbatch_all(states)
    step = make_batched_superstep(tg, tp, heat)
    for _ in range(2):
        states, dts, m = step(states, VD)
        for b, st in enumerate(singles):
            st, dt, ms = superstep_impl(tg, tp, st, VD, heat=heat)
            singles[b] = st
            assert torch.equal(states.element[b], st.element)
            assert torch.equal(states.charge[b], st.charge)
            assert float(dts[b]) == float(dt)
            assert int(m["n_events"][b]) == int(ms["n_events"])
            assert unbatch_all(states)[b].key == st.key
