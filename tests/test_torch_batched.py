"""Batched supersteps (``batch_steps > 1``) of the port against the JAX
package: ``superstep.multi_superstep_impl`` from identical states carried
across with from_jax_arrays, and ``Simulation.run_bias_point`` in batched
mode against the JAX batched driver and the port's own per-step driver."""

import os
from functools import partial

import numpy as np
import pytest
import torch

from test_torch_slice import _parse
from torch_parity import record_dict

torch.set_num_threads(1)

VD = 2.5
K = 5


@pytest.fixture(scope="module")
def sim():
    """The setting of tests/test_multistep.py: the 256-site stack, 8 %
    substoichiometric, potential, dense transport and global heat on, the
    CB edge solved; the same state in both packages."""
    import jax

    from devicekmc_tpu.config import KMCConfig
    from devicekmc_tpu.physics import heat as jheat
    from devicekmc_tpu.physics.potential import solve_cb_edge
    from devicekmc_tpu.state import (
        build_geometry, build_params, init_state, make_substoichiometric,
    )
    from devicekmc_tpu.structure import make_test_structure
    from devicekmc_tpu_torch.config import KMCConfig as TCfg, Layer as TLayer
    from devicekmc_tpu_torch.physics import heat as theat
    from devicekmc_tpu_torch.state import build_params as tparams, from_jax_arrays
    import dataclasses

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    base = dict(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, A=1e-18, rnd_seed_kmc=7,
    )
    jcfg = KMCConfig(layers=s.layers, **base)
    tcfg = TCfg(layers=[TLayer(**dataclasses.asdict(l)) for l in s.layers], **base)
    elems = make_substoichiometric(s.elements, 0.08, seed=3)
    geom = build_geometry(elems, s.coords, jcfg)
    params = build_params(jcfg)
    state = init_state(geom, jcfg, elems)
    state, _ = jax.jit(solve_cb_edge)(geom, params, state, VD)
    tg, ts = from_jax_arrays(record_dict(geom), record_dict(state), device="cpu")
    tp = tparams(tcfg)
    return ((geom, params, jheat.empty_heat_model(params), state),
            (tg, tp, theat.empty_heat_model(tp, torch.device("cpu")), ts))


def _both(sim, n_steps, Icc_A, t_end):
    import jax
    import jax.numpy as jnp

    from devicekmc_tpu.superstep import multi_superstep_impl as jmulti
    from devicekmc_tpu_torch.superstep import multi_superstep_impl as tmulti

    (jg, jp, jh, js), (tg, tp, th, ts) = sim
    mstep = jax.jit(partial(jmulti, n_steps=n_steps))
    ref = mstep(jg, jp, jh, js, VD, jnp.asarray(Icc_A), jnp.asarray(t_end))
    got = tmulti(tg, tp, ts, VD, Icc_A, t_end, n_steps, heat=th)
    return ref, got


def test_multi_superstep_matches_jax(sim):
    """K = 5 supersteps in one batch: elements equal, events per step equal,
    every step active in both, kmc_time within 1e-12 relative, the current
    and the temperature of each step within 1e-6 and 1e-9 relative (f64,
    dense transport)."""
    (jst, jdts, jms), (tst, tdts, tms) = _both(sim, K, float("inf"), float("inf"))
    np.testing.assert_array_equal(tst.element.numpy(), np.asarray(jst.element))
    np.testing.assert_array_equal(tms["active"], np.asarray(jms["active"]))
    assert tms["active"].all() and tms["active"].shape == (K,)
    np.testing.assert_array_equal(tms["n_events"], np.asarray(jms["n_events"]))
    assert (tms["n_events"] > 0).all()
    assert tst.kmc_time == pytest.approx(float(jst.kmc_time), rel=1e-12)
    np.testing.assert_allclose(tdts, np.asarray(jdts), rtol=1e-9)
    np.testing.assert_allclose(tms["Current [uA]"], np.asarray(jms["Current [uA]"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tms["Global temperature [K]"],
                               np.asarray(jms["Global temperature [K]"]), rtol=1e-9)


def test_multi_superstep_time_window(sim):
    """t_end = 1e-30: the first step's clock passes it, so the later steps
    are no-ops in both packages (step time 0), and the state is that of one
    superstep."""
    from devicekmc_tpu_torch.superstep import superstep_impl

    (jst, jdts, jms), (tst, tdts, tms) = _both(sim, 4, float("inf"), 1e-30)
    active = np.asarray(jms["active"])
    assert active[0] and not active[1:].any()
    np.testing.assert_array_equal(tms["active"], active)
    assert not tdts[1:].any() and not np.asarray(jdts)[1:].any()
    _, (tg, tp, th, ts) = sim
    one, _, _ = superstep_impl(tg, tp, ts, VD, heat=th)
    np.testing.assert_array_equal(tst.element.numpy(), one.element.numpy())
    np.testing.assert_array_equal(tst.element.numpy(), np.asarray(jst.element))


def test_multi_superstep_compliance(sim):
    """Icc = 0: the batch stops once any current flows; the same steps are
    active in both packages and the last is not."""
    (jst, _, jms), (tst, _, tms) = _both(sim, 4, 0.0, float("inf"))
    assert tst.I_macro > 0
    np.testing.assert_array_equal(tms["active"], np.asarray(jms["active"]))
    assert tms["active"][0] and not tms["active"][-1]
    np.testing.assert_array_equal(tst.element.numpy(), np.asarray(jst.element))


def test_multi_superstep_limit(sim):
    """``limit`` runs the first steps of the batch only; the rest are
    no-ops with zero rows."""
    from devicekmc_tpu_torch.superstep import multi_superstep_impl

    _, (tg, tp, th, ts) = sim
    st, dts, ms = multi_superstep_impl(tg, tp, ts, VD, float("inf"), float("inf"), 4,
                                       heat=th, limit=2)
    assert ms["active"].tolist() == [True, True, False, False]
    assert not dts[2:].any() and not ms["n_events"][2:].any()
    st2, _, ms2 = multi_superstep_impl(tg, tp, ts, VD, float("inf"), float("inf"), 2,
                                       heat=th)
    assert torch.equal(st.element, st2.element)
    np.testing.assert_array_equal(ms["n_events"][:2], ms2["n_events"])


def test_multi_superstep_limit_rows_against_jax(sim):
    """``limit`` = 2 of K = 5 in both packages: the same two steps active,
    the same state and the same rows for them; the port's three no-op rows
    are 0 in every metric, where the JAX package's still hold the metrics
    of the superstep it computed from the frozen state and selected away
    (its ``n_events`` nonzero: a known fault of the JAX package, not
    copied)."""
    import jax
    import jax.numpy as jnp

    from devicekmc_tpu.superstep import multi_superstep_impl as jmulti
    from devicekmc_tpu_torch.superstep import multi_superstep_impl as tmulti

    (jg, jp, jh, js), (tg, tp, th, ts) = sim
    inf = float("inf")
    jst, jdts, jms = jax.jit(partial(jmulti, n_steps=K))(
        jg, jp, jh, js, VD, jnp.asarray(inf), jnp.asarray(inf),
        limit=jnp.asarray(2, dtype=jnp.int32))
    tst, tdts, tms = tmulti(tg, tp, ts, VD, inf, inf, K, heat=th, limit=2)
    active = np.asarray(jms["active"])
    assert active.tolist() == [True, True, False, False, False]
    np.testing.assert_array_equal(tms["active"], active)
    np.testing.assert_array_equal(tst.element.numpy(), np.asarray(jst.element))
    np.testing.assert_array_equal(tms["n_events"][:2], np.asarray(jms["n_events"])[:2])
    assert not tdts[2:].any() and not np.asarray(jdts)[2:].any()
    for key, rows in tms.items():
        if key != "active":
            assert not np.asarray(rows)[2:].any(), key
    assert (np.asarray(jms["n_events"])[2:] > 0).all()


DRIVER = dict(V_switch=[2.0], t_switch=[1e30], log_freq=2)
STEPS = 8


def _driver_sims(tmp_path, batch_steps, with_jax, tag=""):
    """The setting of tests/test_multistep.py::test_driver_batched_mode, with
    a window long enough for every step (there the first step's clock passes
    t_end = 1e-12)."""
    import dataclasses

    from devicekmc_tpu.structure import make_test_structure
    from devicekmc_tpu_torch.config import KMCConfig as TCfg, Layer as TLayer
    from devicekmc_tpu_torch.engine import Simulation as TSim

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    base = dict(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, pristine=True,
        initial_vacancy_concentration=0.1, A=6.25e-19, batch_steps=batch_steps,
        **DRIVER,
    )
    out = {}
    tdir = tmp_path / f"torch{batch_steps}{tag}"
    tdir.mkdir()
    tcfg = TCfg(layers=[TLayer(**dataclasses.asdict(l)) for l in s.layers],
                output_dir=str(tdir), **base)
    out["torch"] = TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu")
    if with_jax:
        from devicekmc_tpu.config import KMCConfig as JCfg
        from devicekmc_tpu.engine import Simulation as JSim

        jdir = tmp_path / f"jax{batch_steps}"
        jdir.mkdir()
        out["jax"] = JSim(JCfg(layers=s.layers, output_dir=str(jdir), **base),
                          elements=s.elements, coords=s.coords)
    return out


def _physics_lines(path):
    """output.txt without the wall-clock timing lines and the separators."""
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("Z - calculation time")
            and not ln.startswith("-") and not ln.startswith("Created folder")]


#: output.txt keys compared exactly: counts, and the logged KMC clock (six
#: significant digits); every other number to 1e-6 relative (f64 field and
#: dense transport solves of the two packages sum in other orders)
EXACT = ("KMC step count", "n_events", "Charged vacancies", "Uncharged vacancies",
         "Charged oxygen ions", "Uncharged oxygen ions", "KMC time is", "V_vcm",
         "n_active_rows", "n_charged_sites")


def test_driver_batched_matches_jax_and_per_step(tmp_path):
    """batch_steps = 3 over 8 steps (log_freq 2: snapshot steps run alone):
    output.txt of the port's batched driver equals its per-step driver's
    line by line (timing lines aside) and its snapshots byte for byte; against
    the JAX batched driver every step's keys are the same, the counts and the
    clock equal and every other number (current, global temperature, power,
    CG iterations aside) within 1e-6 relative."""
    from devicekmc_tpu_torch import engine

    b = _driver_sims(tmp_path, 3, with_jax=True)
    one = _driver_sims(tmp_path, 1, with_jax=False)["torch"]
    rj = b["jax"].run_bias_point(2.0, 1e30, max_steps=STEPS)
    rt = b["torch"].run_bias_point(2.0, 1e30, max_steps=STEPS)
    r1 = one.run_bias_point(2.0, 1e30, max_steps=STEPS)
    tsim = b["torch"]

    # the port: batched == per-step
    np.testing.assert_array_equal(tsim.state.element.numpy(), one.state.element.numpy())
    assert rt["kmc_time"] == r1["kmc_time"] and rt["steps"] == r1["steps"] == STEPS
    assert rt["completed"] == r1["completed"]
    tout = os.path.join(tsim.cfg.output_dir, "output.txt")
    assert _physics_lines(tout) == _physics_lines(
        os.path.join(one.cfg.output_dir, "output.txt"))
    d_b = os.path.join(tsim.cfg.output_dir, "Results_2.000000")
    d_1 = os.path.join(one.cfg.output_dir, "Results_2.000000")
    snaps = sorted(f for f in os.listdir(d_1) if f.startswith("snapshot"))
    assert snaps == ["snapshot_0.xyz", "snapshot_2.xyz", "snapshot_4.xyz",
                     "snapshot_6.xyz", f"snapshot_{STEPS}.xyz"]
    assert snaps == sorted(f for f in os.listdir(d_b) if f.startswith("snapshot"))
    for f in snaps:
        assert open(os.path.join(d_b, f)).read() == open(os.path.join(d_1, f)).read(), f
    assert [s["step"] for s in tsim.step_log] == list(range(STEPS))
    assert sum(s["n_events"] for s in tsim.step_log) > STEPS

    # the port against the JAX batched driver
    np.testing.assert_array_equal(tsim.state.element.numpy(),
                                  np.asarray(b["jax"].state.element))
    assert rt["kmc_time"] == pytest.approx(rj["kmc_time"], rel=1e-12)
    jout = _parse(os.path.join(b["jax"].cfg.output_dir, "output.txt"))
    tsteps = _parse(tout)
    assert len(jout) == len(tsteps) == STEPS
    for k, (a, t) in enumerate(zip(jout, tsteps)):
        assert set(t) == set(a) | ({"transport_converged", "transport_rel0"} & set(t)), k
        assert float(t["Current [uA]"]) > 0
        for key in a:
            if key.startswith("Z - calculation time") or key.startswith("cg_iters"):
                continue
            if key in EXACT:
                assert t[key] == a[key], (k, key)
            else:
                assert float(t[key]) == pytest.approx(float(a[key]), rel=1e-6), (k, key)
    assert engine._UNLOGGED.isdisjoint(tsteps[0])


def test_driver_batched_stops_inside_a_batch(tmp_path):
    """A window that ends inside the second batch (after step 5 of the
    per-step run) and a compliance current that trips at step 3: the batched
    driver stops at the same step as the per-step driver, with the same
    physics lines, clock and ``completed``."""
    one = _driver_sims(tmp_path, 1, with_jax=False, tag="w")["torch"]
    one.run_bias_point(2.0, 1e30, max_steps=STEPS)
    t = [s["step_time"] for s in one.step_log]
    t_end = sum(t[:5]) + 0.5 * t[5]
    I_uA = [s["Current [uA]"] for s in one.step_log]
    for name, t_end_, Icc in (("window", t_end, 1e30), ("compliance", 1e30,
                                                        0.5 * (I_uA[2] + I_uA[3]))):
        runs = {}
        for bs in (1, 3):
            sim = _driver_sims(tmp_path, bs, with_jax=False, tag=name)["torch"]
            sim.cfg.Icc = Icc
            summary = sim.run_bias_point(2.0, t_end_, max_steps=STEPS)
            runs[bs] = (summary, _physics_lines(os.path.join(sim.cfg.output_dir,
                                                             "output.txt")))
        (s1, lines1), (s3, lines3) = runs[1], runs[3]
        assert s1["steps"] == s3["steps"] < STEPS, name
        assert s1["kmc_time"] == s3["kmc_time"] and s1["completed"] and s3["completed"]
        assert lines1 == lines3, name
        if name == "compliance":
            assert "I_macro > Icc, compliance current reached." in lines3


def test_batch_redone_after_a_cap_grew(tmp_path):
    """The energy-window integration count too small for a batch (blocked
    transport on the small stack): the count grows, the tunnel store is
    dropped, and the whole batch is redone from the state before it; the
    result equals a batch run at the grown count from that state with a
    fresh store."""
    import dataclasses

    from devicekmc_tpu_torch.state import attach_tunnel_state
    from test_torch_transport_slice import VD as TVD, _sims

    _, sim = _sims(tmp_path, with_jax=False)
    sim.run_bias_point(TVD, 1e30, max_steps=1)
    sim.params = dataclasses.replace(sim.params, tunnel_int_steps=16)
    pre = sim.state
    calls = []

    def batch(st):
        calls.append(sim.params.tunnel_int_steps)
        return sim._msuperstep(st, TVD, float("inf"), float("inf"), 3)

    _, times, ms = sim._with_redo(batch, counts=sim._batch_peaks)
    grown = sim.params.tunnel_int_steps
    assert calls == [16, grown] and grown >= ms["tunnel_int_steps_needed"].max() > 16
    assert ms["active"].all() and (ms["transport_partial_assembly"][0] == 0)
    st, times_ref, ms_ref = sim._msuperstep(
        attach_tunnel_state(pre, sim.geom, sim.params), TVD, float("inf"), float("inf"), 3)
    assert torch.equal(sim.state.element, st.element)
    np.testing.assert_array_equal(times, times_ref)
    for key in ("n_events", "Current [uA]", "cg_iters_power"):
        np.testing.assert_array_equal(ms[key], ms_ref[key])
