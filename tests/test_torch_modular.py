"""The port's modular driver (``Simulation(fused=False)``): the superstep
phase by phase with the reference's per-module timing keys, and with
``solver_chunk_iters`` its in-superstep re-solves and the local cg heat model
in bounded segments.  Against the port's fused driver (bit for bit without
segments, step for step with them), against the JAX package's modular
driver in settings that reach none of its three known faults, and the
chunked heat phase against the single call."""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_slice import _parse
from torch_parity import configs, small_structure

torch.set_num_threads(1)

STEPS = 5
VD = 10.0
TIMING_KEYS = ("charge", "potential from boundaries", "potential from charges",
               "kmc events", "dissipated power", "temperature")


def _hash(elem_np):
    return hashlib.sha256(elem_np.astype(np.int32).tobytes()).hexdigest()[:16]


def _recorder(step_fn, records, to_np):
    def wrapped(state, Vd, *rest):
        out = step_fn(state, Vd, *rest)
        st, m = out[0], out[2]
        records.append({
            "elem_hash": _hash(to_np(st.element)),
            "n_events": int(m["n_events"]),
            "I_uA": float(m["Current [uA]"]),
            "cg_iters_boundary": int(m["cg_iters_boundary"]),
            "converged": bool(m["transport_converged"]),
            "keys": {k for k in m if k.startswith("Z - calculation time - ")},
        })
        return out
    return wrapped


def _cfgs(tmp_path, name, **kw):
    """(JAX config, port config, structure): the small stack with blocked
    transport at 10 V, mixed precision, transport_tol 1e-11."""
    s = small_structure()
    base = dict(pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
                rnd_seed_kmc=7, precision="mixed", solve_current=True,
                transport="blocked", poisson_kernel="pallas", V_switch=[VD],
                t_switch=[1e30], transport_tol=1e-11)
    base.update(kw)
    jcfg, tcfg = configs(s, **base)
    for tag, cfg in (("jax", jcfg), ("torch", tcfg)):
        d = tmp_path / name / tag
        d.mkdir(parents=True)
        cfg.output_dir = str(d)
    return jcfg, tcfg, s


def _tsim(tcfg, s, fused):
    from devicekmc_tpu_torch.engine import Simulation

    return Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu",
                      fused=fused)


def _run_port(tmp_path, name, fused, **kw):
    _, tcfg, s = _cfgs(tmp_path, name, **kw)
    sim = _tsim(tcfg, s, fused)
    rec = []
    sim._superstep = _recorder(sim._superstep, rec, lambda t: t.numpy())
    sim.run_bias_point(VD, 1e30, max_steps=STEPS)
    return sim, rec


def test_modular_equals_fused_bit_for_bit(tmp_path):
    """Without segments the modular superstep is superstep_impl with a timing
    hook: every step logs the six module times, and its elements, events and
    current, and the final fields, equal the fused driver's bit for bit (fly
    metal block, global heating)."""
    kw = dict(transport_cc="fly", coarse_slabs=4, solve_heating_global=True, A=1e-18)
    fused, rf = _run_port(tmp_path, "fused", True, **kw)
    mod, rm = _run_port(tmp_path, "modular", False, **kw)
    assert len(rf) == len(rm) == STEPS
    for k, (a, b) in enumerate(zip(rf, rm)):
        assert b["elem_hash"] == a["elem_hash"] and b["n_events"] == a["n_events"], k
        assert a["keys"] == set() and b["keys"] == {
            f"Z - calculation time - {key} [s]" for key in TIMING_KEYS}, k
    for f in ("element", "charge", "potential_boundary", "potential_charge",
              "virtual_potentials", "temperature"):
        assert torch.equal(getattr(fused.state, f), getattr(mod.state, f)), f
    assert fused.state.I_macro == mod.state.I_macro
    assert fused.state.T_bg == mod.state.T_bg


@pytest.mark.parametrize("chunk", [3, 7])
def test_modular_segments_follow_the_fused_trajectory(tmp_path, chunk):
    """With in-superstep segments of ``chunk`` iterations the boundary and
    transport re-solves restart, so their fields differ within the solver
    tolerance: the events and elements equal the fused driver's step for
    step, the current within 1e-7, every step converged, and the summed
    iterations are logged."""
    kw = dict(transport_cc="fly", coarse_slabs=4, solve_heating_global=True, A=1e-18,
              solver_chunk_iters=chunk)
    fused, rf = _run_port(tmp_path, "fused", True, **kw)
    mod, rm = _run_port(tmp_path, "modular", False, **kw)
    assert len(rf) == len(rm) == STEPS
    for k, (a, b) in enumerate(zip(rf, rm)):
        assert b["elem_hash"] == a["elem_hash"] and b["n_events"] == a["n_events"], k
        assert b["I_uA"] == pytest.approx(a["I_uA"], rel=1e-7), k
        assert b["converged"], k
    assert any(s["cg_iters_power"] > chunk for s in mod.step_log)
    assert mod.state.T_bg == pytest.approx(fused.state.T_bg, rel=1e-12)


@pytest.mark.parametrize("chunk", [0, 40], ids=["plain", "chunked"])
def test_modular_matches_jax_modular(tmp_path, chunk):
    """The port's modular driver against the JAX package's
    ``Simulation(fused=False)``, with the settings that keep the JAX driver
    off its known faults: no unchanged-network skip (its modular phase has
    none) and transport_warm_precond = transport_precond (its modular phase
    ignores the former).  Element hashes and events equal at every step,
    I_macro within 1e-5, the same timing keys in output.txt."""
    from devicekmc_tpu.engine import Simulation as JSim

    jcfg, tcfg, s = _cfgs(tmp_path, "pair", transport_skip_unchanged=False,
                          transport_warm_precond="deflated", coarse_slabs=4,
                          solver_chunk_iters=chunk)
    jsim = JSim(jcfg, elements=s.elements, coords=s.coords, fused=False)
    tsim = _tsim(tcfg, s, False)
    jrec, trec = [], []
    jsim._superstep = _recorder(jsim._superstep, jrec, np.asarray)
    tsim._superstep = _recorder(tsim._superstep, trec, lambda t: t.numpy())
    jsim.run_bias_point(VD, 1e30, max_steps=STEPS)
    jsim._flush()
    tsim.run_bias_point(VD, 1e30, max_steps=STEPS)
    assert len(jrec) == len(trec) == STEPS
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b["elem_hash"] == a["elem_hash"] and b["n_events"] == a["n_events"], k
        assert b["I_uA"] == pytest.approx(a["I_uA"], rel=1e-5), k
        assert a["converged"] and b["converged"], k
        assert b["keys"] == a["keys"], k
    jout, tout = _parse(tmp_path / "pair" / "jax" / "output.txt"), \
        _parse(tmp_path / "pair" / "torch" / "output.txt")
    assert [set(x) for x in jout] == [set(x) for x in tout]


def test_modular_driver_emits_timing_keys(tmp_path):
    """Mirror of tests/test_engine.py::test_modular_driver_emits_timing_keys
    (its device, dense transport and global heating): every per-module key
    in output.txt, the temperature's included, twice."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0, pbc=False,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, pristine=True, initial_vacancy_concentration=0.1,
        A=6.25e-19, V_switch=[2.0], t_switch=[1e-12], log_freq=2,
        output_dir=str(tmp_path))
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, device="cpu",
                     fused=False)
    sim.run_bias_point(2.0, 1e30, max_steps=2)
    out = (tmp_path / "output.txt").read_text()
    for key in TIMING_KEYS:
        assert out.count(f"Z - calculation time - {key} [s]:") == 2, key


def test_modular_batch_steps_runs_per_step(tmp_path, monkeypatch):
    """``batch_steps > 1`` with ``fused=False`` runs per step (as the JAX
    package does): no batch is run, and output.txt is the per-step one's."""
    from devicekmc_tpu_torch import engine

    def no_batch(*a, **k):
        raise AssertionError("the modular driver ran a batch")

    monkeypatch.setattr(engine, "multi_superstep_impl", no_batch)
    a, _ = _run_port(tmp_path, "per_step", False, transport_cc="fly", coarse_slabs=4)
    b, _ = _run_port(tmp_path, "batch", False, transport_cc="fly", coarse_slabs=4,
                     batch_steps=3)
    strip = lambda rows: [{k: v for k, v in r.items() if not k.startswith("Z -")}
                          for r in rows]
    assert strip(_parse(a.output_path)) == strip(_parse(b.output_path))


@pytest.fixture(scope="module")
def heated(tmp_path_factory):
    """The small stack in f64 with blocked transport and the local cg heat
    model, after one superstep at 10 V (so the sites dissipate)."""
    _, tcfg, s = _cfgs(tmp_path_factory.mktemp("heat"), "local", precision="f64",
                       poisson_kernel="jnp", solve_heating_local=True,
                       heat_solver="cg")
    sim = _tsim(tcfg, s, True)
    sim.run_bias_point(VD, 1e30, max_steps=1)
    assert sim.heat.method == "cg" and sim.heat.n_interface > 0
    assert float(sim.state.power.abs().max()) > 0
    return sim


@pytest.mark.parametrize("branch", ["transient", "steady"])
def test_chunked_local_heat_matches_single_call(heated, branch, monkeypatch):
    """run_heat_phase_chunked against the single call: 150 transient
    substeps as segments of 64, 64 and 22 (or the steady branch), the
    temperature field and T_bg within 1e-12 relative in f64, the same
    branch and substep count."""
    from devicekmc_tpu_torch import engine, superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod

    sim = heated
    p = sim.params
    step_time = (150.5 if branch == "transient" else 2e3) * p.delta_t
    windows = []
    window = superstep._phase_heat_window

    def counted(*a):
        windows.append(a[-1])
        return window(*a)

    monkeypatch.setattr(superstep, "_phase_heat_window", counted)
    st_c, m_c = engine.run_heat_phase_chunked(sim.geom, p, sim.heat, sim.state, step_time)
    log_c = dict(heat_mod.last_local)
    st_s, m_s = engine._phase_heat(sim.geom, p, sim.heat, sim.state, step_time)
    log_s = dict(heat_mod.last_local)
    assert log_c["branch"] == log_s["branch"] == branch
    assert log_c["substeps"] == log_s["substeps"]
    assert windows == ([64, 64, 23] if branch == "transient" else [])
    assert st_c.temperature.dtype == torch.float64
    np.testing.assert_allclose(st_c.temperature.numpy(), st_s.temperature.numpy(),
                               rtol=1e-12)
    assert float((st_s.temperature - 300.0).abs().max()) > 0
    assert m_c["Global temperature [K]"] == pytest.approx(m_s["Global temperature [K]"],
                                                          rel=1e-12)
