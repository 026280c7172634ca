"""The heat slice end to end: Simulation.run_bias_point with Joule heating
through both packages on the small stack, step by step, in three
configurations (dense transport + global heat, blocked on-the-fly transport
+ global heat, blocked transport + local heat); the fixed-seed golden
trajectory reproduced by the port's CPU path; the command line with the
heating keys."""

import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_golden_trajectory import GOLDEN_PATH
from test_torch_cli import REPO, _write_inputs
from test_torch_slice import _parse
from torch_parity import configs, small_structure

torch.set_num_threads(1)

STEPS = 6


def _hash(elem_np):
    return hashlib.sha256(elem_np.astype(np.int32).tobytes()).hexdigest()[:16]


def _recorder(step_fn, records, to_np):
    def wrapped(state, Vd, *rest):
        out = step_fn(state, Vd, *rest)
        st, m = out[0], out[2]
        records.append({
            "elem_hash": _hash(to_np(st.element)),
            "n_events": int(m["n_events"]),
            "step_time": float(out[1]),
            "I_uA": float(m["Current [uA]"]),
            "P_mW": float(m["Total dissipated power [mW]"]),
            "T_bg": float(st.T_bg),
            "T_metric": float(m["Global temperature [K]"]),
            "temperature": to_np(st.temperature).copy(),
            "converged": bool(m["transport_converged"]),
            "charged_V": int(m["Charged vacancies"]),
        })
        return out
    return wrapped


def _sims(tmp_path, **kw):
    from devicekmc_tpu.engine import Simulation as JSim
    from devicekmc_tpu_torch.engine import Simulation as TSim

    s = small_structure()
    jcfg, tcfg = configs(
        s, pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
        rnd_seed_kmc=7, solve_current=True, A=1e-18, t_switch=[1e30], **kw)
    for name, cfg in (("jax", jcfg), ("torch", tcfg)):
        (tmp_path / name).mkdir(parents=True)
        cfg.output_dir = str(tmp_path / name)
    return (JSim(jcfg, elements=s.elements, coords=s.coords),
            TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu"))


# dense-global is the golden trajectory's configuration (f64, the JAX default
# transport = "dense"): step times and T_bg to 1e-9, current to 1e-6.
# The two mixed-precision configurations carry the f32 rate table (step times
# to 1e-4, as in test_torch_slice.py) and two independent mixed solves at
# transport_tol 1e-11 (current to 1e-5, as in test_torch_transport_slice.py;
# the power follows the current: 1e-4); T_bg moves by far less than it rises.
CONFIGS = {
    "dense-global": (2.5, dict(
        solve_heating_global=True, V_switch=[2.5]),
        dict(t=1e-9, I=1e-6, P=1e-6, T=1e-9)),
    "blocked-fly-global": (10.0, dict(
        solve_heating_global=True, V_switch=[10.0], precision="mixed",
        transport="blocked", transport_cc="fly", solver_chunk_iters=40, coarse_slabs=4,
        poisson_kernel="pallas", transport_tol=1e-11),
        dict(t=1e-4, I=1e-5, P=1e-4, T=1e-9)),
    "blocked-local-dense": (10.0, dict(
        solve_heating_local=True, heat_solver="dense", V_switch=[10.0],
        precision="mixed", transport="blocked", poisson_kernel="pallas",
        transport_tol=1e-11),
        dict(t=1e-4, I=1e-5, P=1e-4, T=1e-7)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_run_bias_point_with_heating_matches_jax(tmp_path, name):
    """Element hashes, event counts and charged-vacancy counts equal at
    every step (the temperature feeds every event rate, so this holds the
    heat phase too); step time, current, power and T_bg within the
    configuration's tolerances; every solve converged; output.txt carries the
    same keys, with the temperature and power lines."""
    Vd, kw, tol = CONFIGS[name]
    jsim, tsim = _sims(tmp_path, **kw)
    local = bool(kw.get("solve_heating_local"))
    if local:
        assert tsim.heat.method == jsim.heat.method == "dense"
        assert tsim.heat.n_interface == jsim.heat.n_interface > 0
    jrec, trec = [], []
    jsim._superstep = _recorder(jsim._superstep, jrec, np.asarray)
    tsim._superstep = _recorder(tsim._superstep, trec, lambda t: t.numpy())
    jsim.run_bias_point(Vd, 1e30, max_steps=STEPS)
    jsim._flush()
    tsim.run_bias_point(Vd, 1e30, max_steps=STEPS)
    assert len(jrec) == len(trec) == STEPS
    assert sum(r["n_events"] for r in jrec) >= STEPS
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b["elem_hash"] == a["elem_hash"], f"step {k}"
        assert b["n_events"] == a["n_events"], f"step {k}"
        assert b["charged_V"] == a["charged_V"], f"step {k}"
        assert a["converged"] and b["converged"], f"step {k}"
        assert b["step_time"] == pytest.approx(a["step_time"], rel=tol["t"]), k
        assert b["I_uA"] > 0 and b["P_mW"] > 0
        assert b["I_uA"] == pytest.approx(a["I_uA"], rel=tol["I"]), k
        assert b["P_mW"] == pytest.approx(a["P_mW"], rel=tol["P"]), k
        assert b["T_bg"] == pytest.approx(a["T_bg"], rel=tol["T"]), k
        assert b["T_metric"] == b["T_bg"]
        if local:
            np.testing.assert_allclose(b["temperature"], a["temperature"],
                                       rtol=tol["T"], err_msg=f"step {k}")
    # the temperature moved, and under the global model it never falls
    T = [r["T_bg"] for r in trec]
    assert T[-1] != 300.0
    if not local:
        assert all(t1 >= t0 for t0, t1 in zip([300.0] + T, T)) and T[-1] > 300.0
    jout, tout = _parse(tmp_path / "jax" / "output.txt"), \
        _parse(tmp_path / "torch" / "output.txt")
    assert len(jout) == len(tout) == STEPS
    for a, b in zip(jout, tout):
        assert set(a) == set(b)
        assert "Global temperature [K]" in b and "Total dissipated power [mW]" in b
        for key in ("n_events", "n_vac_atoms", "transport_converged", "Charged vacancies"):
            assert float(b[key]) == float(a[key]), key
    # the snapshot's last column is the site power
    snap = (tmp_path / "torch" / f"Results_{Vd:.6f}" / f"snapshot_{STEPS}.xyz").read_text()
    power_col = np.array([float(l.split()[5]) for l in snap.splitlines()[2:]])
    assert power_col.shape == (tsim.geom.N,) and np.abs(power_col).max() > 0


def test_golden_trajectory_reproduced_by_the_port(tmp_path):
    """tests/golden_trajectory.json (full physics: current, global heating,
    dense transport, f64) through the port's CPU path, with
    test_golden_trajectory.py's own comparisons."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.physics.potential import solve_cb_edge
    from devicekmc_tpu_torch.structure import make_test_structure

    golden = json.load(open(GOLDEN_PATH))
    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, pristine=True, initial_vacancy_concentration=0.08,
        A=1e-18, rnd_seed=3, rnd_seed_kmc=7, V_switch=[2.5], t_switch=[1.0],
        output_dir=str(tmp_path),
    )
    assert cfg.transport == "dense" and cfg.precision == "f64"
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, device="cpu")
    Vd = 2.5
    sim.state, _ = solve_cb_edge(sim.geom, sim.params, sim.state, Vd)
    assert len(golden) >= 6
    for k, g in enumerate(golden):
        sim.state, dt, metrics = sim._superstep(sim.state, Vd)
        o = {
            "elem_hash": hashlib.sha256(sim.state.element.numpy().tobytes()).hexdigest()[:16],
            "n_events": int(metrics["n_events"]), "step_time": float(dt),
            "I_uA": float(metrics["Current [uA]"]), "T_bg": float(sim.state.T_bg),
            "charged_V": int(metrics["Charged vacancies"]),
        }
        assert o["elem_hash"] == g["elem_hash"], (
            f"step {k}: element state diverged from golden record\n"
            f"golden: {g}\n     got: {o}")
        assert o["n_events"] == g["n_events"], f"step {k} events"
        assert o["step_time"] == pytest.approx(g["step_time"], rel=1e-9), k
        assert o["I_uA"] == pytest.approx(g["I_uA"], rel=1e-6, abs=1e-12), k
        assert o["T_bg"] == pytest.approx(g["T_bg"], rel=1e-9), k
        assert o["charged_V"] == g["charged_V"], f"step {k} charged vacancies"


@pytest.mark.parametrize("extra,keys", [
    ("transport = blocked\ntransport_cc = fly\nsolver_chunk_iters = 50\ncoarse_slabs = 4\n"
     "solve_heating_global = 1\nA = 1e-9 * 1e-9\n", True),
    ("transport = dense\nprecision = f64\nsolve_heating_global = 1\nA = 1e-18\n", True),
    ("transport = blocked\nsolve_heating_local = 1\nheat_solver = dense\n", True),
    ("transport = blocked\nsolve_heating_local = 1\nheat_solver = cg\n", True),
], ids=["blocked-fly-global", "dense-global", "local-dense", "local-cg"])
def test_cli_runs_with_heating_on_cpu(tmp_path, extra, keys):
    """The heating keys and ``transport = dense`` run from the command line
    and log the temperature (and, with the global model, the power)."""
    path, n = _write_inputs(tmp_path)
    base = path.read_text().replace("solve_current = 0", "solve_current = 1")
    path.write_text(base + extra)
    r = subprocess.run(
        [sys.executable, "-m", "devicekmc_tpu_torch", str(path), "--cpu",
         "--max-steps", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    out = (tmp_path / "out" / "output.txt").read_text()
    assert out.count("KMC step count:") == 2
    assert out.count("Global temperature [K]:") == 2
    assert out.count("Total dissipated power [mW]:") == 2
    assert out.count("Current [uA]:") == 2
    assert "NotImplementedError" not in r.stderr
