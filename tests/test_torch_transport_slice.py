"""The transport slice end to end: Simulation.run_bias_point with
``solve_current`` on (blocked transport, mixed precision, heating off;
tests/test_torch_heat_slice.py has heating on)
through both packages on the small stack, step by step; the
``tunnel_int_steps`` growth redo; the command line."""

import dataclasses
import hashlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_cli import REPO, _write_inputs
from test_torch_slice import _parse
from torch_parity import configs, small_structure

torch.set_num_threads(1)

STEPS = 6
VD = 10.0


def _recorder(step_fn, records, to_np):
    def wrapped(state, Vd, *rest):
        out = step_fn(state, Vd, *rest)
        st, m = out[0], out[2]
        records.append({
            "elem_hash": hashlib.sha256(
                to_np(st.element).astype(np.int32).tobytes()).hexdigest()[:16],
            "n_events": int(m["n_events"]),
            "I_uA": float(m["Current [uA]"]),
            "rel0": float(m["transport_rel0"]),
            "iters": int(m["cg_iters_power"]),
            "converged": bool(m["transport_converged"]),
        })
        return out
    return wrapped


def _sims(tmp_path, with_jax=True, **kw):
    """(JAX Simulation or None, port Simulation) of one configuration."""
    from devicekmc_tpu_torch.engine import Simulation as TSim

    s = small_structure()
    jcfg, tcfg = configs(
        s, pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
        rnd_seed_kmc=7, precision="mixed", solve_current=True, transport="blocked",
        poisson_kernel="pallas", V_switch=[VD], t_switch=[1e30],
        # two solves that both meet the default 1e-8 agree on I_macro only to
        # ~3e-5 (the criterion's own envelope); at 1e-11 both sit on the
        # mixed-mode floor and the comparison tests the operator
        transport_tol=1e-11, **kw,
    )
    for name, cfg in (("jax", jcfg), ("torch", tcfg)):
        (tmp_path / name).mkdir(parents=True)
        cfg.output_dir = str(tmp_path / name)
    jsim = None
    if with_jax:
        from devicekmc_tpu.engine import Simulation as JSim

        jsim = JSim(jcfg, elements=s.elements, coords=s.coords)
    return jsim, TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu")


# stored: the JAX defaults (auto -> stored metal block, one-shot cold
# solves); fly: the on-the-fly kernels with the chunked cold solves and the
# deflated cold transport solve, the path the card's smoke run takes
@pytest.mark.parametrize("kw", [
    dict(),
    dict(transport_cc="fly", solver_chunk_iters=40, coarse_slabs=4,
         tunnel_vm_kernel="pallas", transport_band_kernel="pallas"),
], ids=["stored", "fly-chunked"])
def test_run_bias_point_with_current_matches_jax(tmp_path, kw):
    """Element hashes and event counts equal at every step (with heating off
    transport does not feed back into the events); Current [uA] within 1e-5;
    skipped steps (-1 sentinel) the same; every solve converged.
    cg_iters_power is printed, not compared: the inner f32 sums differ."""
    jsim, tsim = _sims(tmp_path, **kw)
    assert tsim.params.transport_cc == jsim.params.transport_cc == \
        kw.get("transport_cc", "stored")
    assert tsim.params.transport_incremental and jsim.params.transport_incremental
    assert tsim.params.tunnel_vac_cap == jsim.params.tunnel_vac_cap
    jrec, trec = [], []
    jsim._superstep = _recorder(jsim._superstep, jrec, np.asarray)
    tsim._superstep = _recorder(tsim._superstep, trec, lambda t: t.numpy())
    jsim.run_bias_point(VD, 1e30, max_steps=STEPS)
    jsim._flush()
    tsim.run_bias_point(VD, 1e30, max_steps=STEPS)
    assert len(jrec) == len(trec) == STEPS
    assert sum(r["n_events"] for r in jrec) >= STEPS
    print("cg_iters_power jax ", [r["iters"] for r in jrec])
    print("cg_iters_power port", [r["iters"] for r in trec])
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b["elem_hash"] == a["elem_hash"], f"step {k}"
        assert b["n_events"] == a["n_events"], f"step {k}"
        assert a["converged"] and b["converged"], f"step {k}"
        assert (b["rel0"] == -1.0) == (a["rel0"] == -1.0), f"step {k}"
        assert b["I_uA"] > 0
        assert b["I_uA"] == pytest.approx(a["I_uA"], rel=1e-5), f"step {k}"
    np.testing.assert_array_equal(tsim.state.CB_edge.numpy() != 0,
                                  np.asarray(jsim.state.CB_edge) != 0)
    np.testing.assert_allclose(tsim.state.CB_edge.numpy(), np.asarray(jsim.state.CB_edge),
                               rtol=0, atol=1e-7 * 1.60217663e-19 * VD)
    # output.txt: the same keys per step, the CB-edge timing line, V_vcm
    jout, tout = _parse(tmp_path / "jax" / "output.txt"), \
        _parse(tmp_path / "torch" / "output.txt")
    assert len(jout) == len(tout) == STEPS
    for a, b in zip(jout, tout):
        assert set(a) == set(b)
        for key in ("n_events", "n_vac_atoms", "tunnel_int_steps_needed",
                    "transport_converged", "Charged vacancies"):
            assert float(b[key]) == float(a[key]), key
    text = (tmp_path / "torch" / "output.txt").read_text()
    assert "Z - calculation time - CB edge [s]:" in text
    phases = [p["phase"] for p in tsim.presolve_log]
    assert phases == (["cb_edge", "boundary", "transport"]
                      if kw.get("solver_chunk_iters") else ["cb_edge", "boundary"])


def test_int_steps_growth_redo_rebuilds_the_store(tmp_path):
    """tunnel_int_steps too small for the bias: the step is redone with a
    grown count and a fresh store.  Stored rows (here overwritten with a
    marker, as truncated rows would be wrong) must not survive into the
    redo: its T_vm equals a from-scratch assembly at the grown count."""
    from devicekmc_tpu_torch.physics.current import assemble_X_blocks

    _, tsim = _sims(tmp_path, with_jax=False)
    tsim.run_bias_point(VD, 1e30, max_steps=2)
    assert tsim.state.tt_valid and tsim.params.tunnel_int_steps == 1024
    nan = float("nan")
    tsim.state = dataclasses.replace(
        tsim.state, tt_vm=torch.full_like(tsim.state.tt_vm, 7.0), transport_Vd_prev=nan)
    tsim.params = dataclasses.replace(tsim.params, tunnel_int_steps=16)
    state, _, m = tsim._superstep(tsim.state, VD)
    assert m["transport_partial_assembly"] == 1       # the marker rows were reused
    assert bool((state.tt_vm == 7.0).any())
    assert m["tunnel_int_steps_needed"] > 16
    # the engine's step: grows the count, drops the store, redoes the step
    _, _, m = tsim._step_with_redo(VD)
    assert tsim.params.tunnel_int_steps >= m["tunnel_int_steps_needed"] > 16
    assert m["transport_partial_assembly"] == 0 and tsim.state.tt_valid
    full = assemble_X_blocks(
        tsim.geom, dataclasses.replace(tsim.params, transport_incremental=False),
        tsim.state, cc=tsim._cc["cc"])
    assert torch.equal(tsim.state.tt_vm, full["T_vm"])
    assert not bool((tsim.state.tt_vm == 7.0).any())


def test_growth_inside_run_bias_point(tmp_path):
    """A run that starts with tunnel_int_steps = 8 grows it in the first
    superstep's redo and ends with the current of a run that had 1024 from
    the start."""
    _, a = _sims(tmp_path / "a", with_jax=False, tunnel_int_steps=8)
    _, b = _sims(tmp_path / "b", with_jax=False)
    a.run_bias_point(VD, 1e30, max_steps=3)
    b.run_bias_point(VD, 1e30, max_steps=3)
    assert a.params.tunnel_int_steps == 1024
    assert [s["n_events"] for s in a.step_log] == [s["n_events"] for s in b.step_log]
    assert a.state.I_macro == b.state.I_macro
    assert torch.equal(a.state.tt_vm, b.state.tt_vm)


def test_band_not_built_warns_and_runs_on_the_ell_product(tmp_path, monkeypatch):
    """A band over its size limit is not built: the engine says so once, at
    construction, and the run goes on with the ELL neighbour product."""
    from devicekmc_tpu_torch.physics import current as cur

    monkeypatch.setattr(cur, "build_banded_nb", lambda *a, **k: None)
    with pytest.warns(RuntimeWarning, match="transport_banded"):
        _, tsim = _sims(tmp_path, with_jax=False, transport_banded=True)
    assert tsim._band is None
    tsim.run_bias_point(VD, 1e30, max_steps=2)
    assert "band" not in tsim._cc
    assert all(s["transport_converged"] == 1 for s in tsim.step_log)


def test_cli_runs_with_current_on_cpu(tmp_path):
    """solve_current = 1 with transport = blocked runs from the command line
    and logs the current; so do dense transport and heating (with the
    temperature and power lines), and transport_bf16_inner, whose currents
    match the f32 inner run at its tightened tolerance (1e-10) within 2e-4
    with the same events (measured 4.6e-6)."""
    path, n = _write_inputs(tmp_path)
    base = path.read_text().replace("solve_current = 0", "solve_current = 1")
    path.write_text(base + "transport = blocked\ntransport_cc = fly\n"
                    "solver_chunk_iters = 50\ncoarse_slabs = 4\n")
    run = lambda: subprocess.run(
        [sys.executable, "-m", "devicekmc_tpu_torch", str(path), "--cpu",
         "--max-steps", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    r = run()
    assert r.returncode == 0, r.stderr[-2000:]
    out = (tmp_path / "out" / "output.txt").read_text()
    assert out.count("KMC step count:") == 2
    assert out.count("Current [uA]:") == 2 and "cg_iters_power:" in out
    assert "Z - calculation time - CB edge [s]:" in out
    for extra, heated in (("transport = dense\n", False),
                          ("solve_heating_global = 1\nA = 1e-18\n", True)):
        path.write_text(base + "transport = blocked\n" + extra)
        r = run()
        assert r.returncode == 0, r.stderr[-2000:]
        out = (tmp_path / "out" / "output.txt").read_text()
        assert out.count("Current [uA]:") == 2
        assert out.count("Global temperature [K]:") == (2 if heated else 0)
        assert out.count("Total dissipated power [mW]:") == (2 if heated else 0)
    runs = {}
    for extra in ("transport_bf16_inner = 1\n", "transport_tol = 1e-10\n"):
        path.write_text(base + "transport = blocked\n" + extra)
        r = run()
        assert r.returncode == 0, r.stderr[-2000:]
        runs[extra] = _parse(tmp_path / "out" / "output.txt")
    bf16, f32 = runs.values()
    assert len(bf16) == len(f32) == 2
    for a, b in zip(f32, bf16):
        assert b["n_events"] == a["n_events"] and float(b["transport_converged"]) == 1
        assert float(b["Current [uA]"]) == pytest.approx(float(a["Current [uA]"]),
                                                         rel=2e-4)
