"""The port's halo transport, power and heat (``devicekmc_tpu_torch.parallel.
halo_transport`` and the halo superstep's phases 5-6) on the CPU, against
the JAX package.

Four gloo ranks run as separate processes (``tests/torch_halo_ranks.py
... transport``, which imports no JAX) with a hard time limit that kills
them.  On the stack of tests/test_halo_superstep.py they run the halo
transport's functions on seeded inputs, and two whole runs (8 supersteps at
4 V, global heat and local cg heat).  While they run, this process computes
the references: the same functions of the JAX package on 4 CPU devices
(a ``shard_map`` harness), the JAX package's 4-device halo runs and the
port's single-device runs.  One more case runs the port's halo path in this
process as a world of one gloo rank.

The port's single-device reference solves each superstep's transport with
the halo path's preconditioner (``transport_warm_precond =
transport_precond``, deflated): the halo path, as the JAX package's, has no
warm preconditioner of its own, and at ``transport_tol`` 1e-8 two solvers
leave I_macro up to 25 % apart on this stack (ROADMAP §3 item 1).
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from torch_halo_ranks import (HEAT_CASES, HEAT_STEP_TIMES, MODULE_K, MODULE_VD, RUN_STEPS,
                              RUN_VD, TRANSPORT, module_config, run_config)

torch.set_num_threads(1)

WORLD = 4
#: seconds the four ranks may take together before they are killed
RANKS_TIMEOUT = 240
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PAD = WORLD * 128


def _to_jax(tcfg):
    from devicekmc_tpu.config import KMCConfig, Layer

    names = {g.name for g in dataclasses.fields(KMCConfig)}
    fields = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
              if f.name in names}
    fields["layers"] = [Layer(**dataclasses.asdict(l)) for l in tcfg.layers]
    return KMCConfig(**fields)


def _jax_mesh():
    return JaxMesh(np.array(jax.devices("cpu")[:WORLD]), ("sites",))


def _scale_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ----------------------------------------------------------------------------
# the inputs and the JAX package's functions on 4 devices
# ----------------------------------------------------------------------------

def _inputs(workdir):
    """The module cases' inputs: the stack's elements and charges, its CB
    edge at MODULE_VD (the JAX package's single-device solve), seeded
    vectors for the operator, a seeded power on the sites scaled so that
    the local model moves the temperature by about 10 K."""
    from devicekmc_tpu.physics import charge as charge_mod
    from devicekmc_tpu.physics.potential import solve_cb_edge
    from devicekmc_tpu.state import build_simulation

    tcfg, s = module_config(os.path.join(workdir, "unused"))
    geom, params, state = build_simulation(_to_jax(tcfg), elements=s.elements,
                                           coords=s.coords, pad_to=_PAD)
    state, _ = charge_mod.update_charge(geom, state)
    state, _ = solve_cb_edge(geom, params, state, MODULE_VD)
    rng = np.random.default_rng(17)
    sa = -(-geom.N_atom // WORLD)
    nf = WORLD * (-(-sa // 8) * 8) + 2          # Na_pad + 2
    nr = geom.N_real
    power = np.zeros(geom.N)
    power[:nr] = rng.uniform(0.0, 2e-6, nr)
    inp = dict(element=np.asarray(state.element), charge=np.asarray(state.charge),
               CB_edge=np.asarray(state.CB_edge), x=rng.standard_normal(nf),
               X=rng.standard_normal((nf, MODULE_K)), power=power,
               temperature=np.asarray(state.temperature))
    np.savez(os.path.join(workdir, "transport.npz"), **inp)
    return inp


def _jax_module(workdir, inp):
    """The JAX package's halo transport functions on the inputs over 4 CPU
    devices: the operator, its matrix form and int_needed in f64 and mixed,
    the transport solve and power (f64), the local heat at both step
    times."""
    from devicekmc_tpu.parallel import halo_transport as jht
    from devicekmc_tpu.parallel.halo_superstep import (_Shard, required_halo,
                                                       site_axis_specs, shard_map)
    from devicekmc_tpu.physics import heat as heat_mod
    from devicekmc_tpu.state import build_simulation

    mesh = _jax_mesh()
    out = {}
    for prec in ("f64", "mixed"):
        tcfg, s = module_config(os.path.join(workdir, "unused"), prec)
        jcfg = _to_jax(tcfg)
        geom, params, _ = build_simulation(jcfg, elements=s.elements, coords=s.coords,
                                           pad_to=_PAD)
        halo = required_halo(geom)
        ts, tspec, sizes = jht.build_transport_static(geom, params, inp["element"], mesh)
        gspec = site_axis_specs(geom, geom.N)
        pspec = jax.tree_util.tree_map(lambda _: P(), params)
        f64 = prec == "f64"

        def body(g, p, t, element, charge, cb, x, X, vp):
            sh = _Shard(g.neigh_idx, halo, "sites")
            op = jht.assemble_halo_operator(sh, g, p, t, sizes, element, charge, cb)
            res = (op["apply"](x, p.dtype), op["apply_mat"](X, p.dtype), op["int_needed"])
            if f64:
                v, I_macro, ap, P_tot, m = jht.halo_transport_power(
                    sh, g, p, t, sizes, element, charge, cb, vp, MODULE_VD)
                res += (v, I_macro, ap, P_tot, m["cg_iters_power"])
            return res

        site = P("sites")
        fn = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(gspec, pspec, tspec, site, site, site, P(), P(), P()),
            out_specs=(P(),) * (8 if f64 else 3), check_vma=False))
        r = fn(geom, params, ts, inp["element"], inp["charge"], inp["CB_edge"],
               jnp.asarray(inp["x"]), jnp.asarray(inp["X"]),
               jnp.zeros(geom.N_atom + 2, params.dtype))
        out[prec] = [np.asarray(v) for v in r]
        if not f64:
            continue
        heat = heat_mod.build_heat_model(geom, params, jcfg, inp["element"],
                                         np.asarray(geom.neigh_idx), method="cg")
        hspec = site_axis_specs(heat, geom.N)

        def heat_body(g, p, h, element, power, temp, step_time):
            sh = _Shard(g.neigh_idx, halo, "sites")
            T, T_bg, _ = jht.halo_heat_local_cg(sh, g, p, h, element, power, temp, step_time)
            return T, T_bg

        hfn = jax.jit(shard_map(
            heat_body, mesh=mesh, in_specs=(gspec, pspec, hspec, site, site, site, P()),
            out_specs=(site, P()), check_vma=False))
        out["heat"] = [[np.asarray(v) for v in hfn(
            geom, params, heat, inp["element"], inp["power"], inp["temperature"],
            jnp.asarray(st, params.dtype))] for st in HEAT_STEP_TIMES]
        out["sizes"] = sizes
    return out


def _references(workdir):
    """For each heat case: the JAX package's 4-device halo run and the
    port's single-device run (its warm solves with the halo path's
    preconditioner)."""
    from devicekmc_tpu.engine import Simulation as JaxSimulation
    from devicekmc_tpu_torch.engine import Simulation

    refs = {}
    for case, over in HEAT_CASES.items():
        tcfg, s = run_config(os.path.join(workdir, f"jax_{case}"), **TRANSPORT, **over)
        os.makedirs(tcfg.output_dir)
        jsim = JaxSimulation(_to_jax(tcfg), elements=s.elements, coords=s.coords,
                             mesh=_jax_mesh(), decomposition="halo")
        jsim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
        tcfg, s = run_config(os.path.join(workdir, f"single_{case}"), **TRANSPORT, **over)
        tcfg = dataclasses.replace(tcfg, transport_warm_precond=tcfg.transport_precond)
        os.makedirs(tcfg.output_dir)
        tsim = Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu")
        tsim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
        refs[case] = jsim, tsim
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the four ranks, compute the references while they run, wait for
    the ranks (killing them at the time limit); return what each wrote and
    the references."""
    workdir = tmp_path_factory.mktemp("halo_transport")
    inp = _inputs(str(workdir))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.path.join(ROOT, "tests")]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    helper = os.path.join(ROOT, "tests", "torch_halo_ranks.py")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, helper, str(workdir), str(r), str(WORLD),
                               "transport"], stdout=logs[r], stderr=subprocess.STDOUT, env=env)
             for r in range(WORLD)]
    deadline = time.monotonic() + RANKS_TIMEOUT
    timed_out = False
    try:
        module = _jax_module(str(workdir), inp)
        refs = _references(workdir)
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        timed_out = True
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if timed_out or any(p.returncode for p in procs):
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:]
                          for r, p in enumerate(procs))
        pytest.fail(("ranks killed after %d s" % RANKS_TIMEOUT if timed_out
                     else "a rank failed") + "\n" + tails)
    arrays = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(WORLD)]
    facts = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return dict(workdir=workdir, inputs=inp, arrays=arrays, facts=facts, module=module,
                refs=refs)


# ----------------------------------------------------------------------------
# module level: the port's functions against the JAX package's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("prec,tol", [("f64", 1e-12), ("mixed", 1e-6)])
def test_operator_matches_jax(ranks, prec, tol):
    """apply and apply_mat of the row-split operator, whole on every rank,
    within ``tol`` of their scale of the JAX package's (f64 entries; f32
    tunnel blocks in mixed precision); int_needed equal."""
    y, Y, int_needed = ranks["module"][prec][:3]
    for a in ranks["arrays"]:
        assert _scale_err(a[f"tm_{prec}_y"], y) < tol
        assert _scale_err(a[f"tm_{prec}_Y"], Y) < tol
        assert int(a[f"tm_{prec}_int_needed"]) == int(int_needed)
    assert int(int_needed) > 0
    # the same bits on every rank: the CG vectors must be identical
    for a in ranks["arrays"][1:]:
        assert a[f"tm_{prec}_y"].tobytes() == ranks["arrays"][0][f"tm_{prec}_y"].tobytes()


def test_transport_power_matches_jax(ranks):
    """The transport solve at transport_tol 1e-11: vp within 1e-9 of its
    scale, I_macro within 1e-5, the atoms' power within 1e-6 of its scale,
    CG iterations within 1 of the JAX package's and the same on every rank."""
    _, _, _, vp, I_macro, atom_power, P_tot, iters = ranks["module"]["f64"]
    facts = [f["transport_module"] for f in ranks["facts"]]
    assert {f["metrics"]["cg_iters_power"] for f in facts} == {facts[0]["metrics"][
        "cg_iters_power"]}
    assert abs(facts[0]["metrics"]["cg_iters_power"] - int(iters)) <= 1
    assert all(f["metrics"]["transport_converged"] for f in facts)
    assert facts[0]["sizes"] == ranks["module"]["sizes"]
    for a, f in zip(ranks["arrays"], facts):
        assert _scale_err(a["tm_vp"], vp) < 1e-9
        assert f["I_macro"] == pytest.approx(float(I_macro), rel=1e-5)
        assert f["metrics"]["Current [uA]"] == pytest.approx(float(I_macro) * 1e6, rel=1e-5)
        assert _scale_err(a["tm_atom_power"], atom_power) < 1e-6
        assert f["P_tot"] == pytest.approx(float(P_tot), rel=1e-6)
    assert float(I_macro) != 0.0 and float(P_tot) > 0.0


@pytest.mark.parametrize("k", range(len(HEAT_STEP_TIMES)))
def test_local_heat_matches_jax(ranks, k):
    """The matrix-free local model on a seeded power (transient: 6
    substeps; steady): temperature within 1e-8 K of the JAX package's, T_bg
    within 1e-9, and the field moved by more than 1 K."""
    T_ref, T_bg_ref = ranks["module"]["heat"][k]
    T = np.concatenate([a[f"tm_temp_{k}"] for a in ranks["arrays"]])
    assert np.abs(T - T_ref).max() < 1e-8
    assert np.abs(T_ref - 300.0).max() > 1.0
    for f in ranks["facts"]:
        assert abs(f[f"tm_T_bg_{k}"] - float(T_bg_ref)) < 1e-9
        assert f[f"tm_heat_{k}"] == ranks["facts"][0][f"tm_heat_{k}"]
    assert ranks["facts"][0][f"tm_heat_{k}"]["branch"] == ("transient", "steady")[k]


def test_cb_edge_on_slabs_matches_jax(ranks):
    """The CB edge solved on the slabs (the halo path's bias start) against
    the JAX package's single-device solve of the same network."""
    cb = np.concatenate([a["tm_cb_edge"] for a in ranks["arrays"]])
    assert _scale_err(cb, ranks["inputs"]["CB_edge"]) < 1e-9
    assert len({f["tm_cb_edge_iters"] for f in ranks["facts"]}) == 1


# ----------------------------------------------------------------------------
# whole runs: 4 ranks against the JAX halo run and the single device
# ----------------------------------------------------------------------------

def _events(output_txt, key="n_events"):
    with open(output_txt) as f:
        return [float(l.split(":")[1]) for l in f if l.startswith(key + ":")]


@pytest.mark.parametrize("case", list(HEAT_CASES))
def test_halo_transport_run_matches_single_device(ranks, case):
    _, tsim = ranks["refs"][case]
    a, run = ranks["arrays"][0], ranks["facts"][0][f"tr_{case}"]
    nr = tsim.geom.N_real
    np.testing.assert_array_equal(a[f"tr_{case}_element"][:nr], tsim.state.element.numpy())
    np.testing.assert_array_equal(a[f"tr_{case}_charge"][:nr], tsim.state.charge.numpy())
    assert [s["n_events"] for s in run["steps"]] == [r["n_events"] for r in tsim.step_log]
    assert len(run["steps"]) == RUN_STEPS
    assert run["I_macro"] == pytest.approx(tsim.state.I_macro, rel=1e-3)
    assert run["P_tot"] == pytest.approx(tsim.state.P_tot, rel=1e-3, abs=1e-30)
    assert _scale_err(a[f"tr_{case}_power"][:nr], tsim.state.power.numpy()) < 1e-3
    assert abs(run["T_bg"] - tsim.state.T_bg) < 1e-9
    assert np.abs(a[f"tr_{case}_temperature"][:nr]
                  - tsim.state.temperature.numpy()).max() < 1e-8
    for s, r in zip(run["steps"], tsim.step_log):
        assert s["Current [uA]"] == pytest.approx(r["Current [uA]"], rel=1e-3)
        assert s["transport_converged"]
    # every rank reads the same steps
    for f in ranks["facts"][1:]:
        assert f[f"tr_{case}"]["steps"] == run["steps"]


@pytest.mark.parametrize("case", list(HEAT_CASES))
def test_halo_transport_run_matches_jax_halo(ranks, case):
    jsim, _ = ranks["refs"][case]
    a, run = ranks["arrays"][0], ranks["facts"][0][f"tr_{case}"]
    nr = jsim.geom.N_real
    np.testing.assert_array_equal(a[f"tr_{case}_element"][:nr],
                                  np.asarray(jsim.state.element)[:nr])
    np.testing.assert_array_equal(a[f"tr_{case}_charge"][:nr],
                                  np.asarray(jsim.state.charge)[:nr])
    assert [s["n_events"] for s in run["steps"]] == _events(jsim.output_path)
    currents = _events(jsim.output_path, "Current [uA]")
    assert len(currents) == RUN_STEPS
    for s, c in zip(run["steps"], currents):
        assert s["Current [uA]"] == pytest.approx(c, rel=1e-5)
    assert run["I_macro"] == pytest.approx(float(jsim.state.I_macro), rel=1e-5)
    assert abs(run["T_bg"] - float(jsim.state.T_bg)) < 1e-9
    assert run["kmc_time"] == pytest.approx(float(jsim.state.kmc_time), rel=1e-6)


@pytest.mark.parametrize("case", list(HEAT_CASES))
def test_halo_transport_output_from_rank0(ranks, case):
    """One output.txt with each step once and the transport and heat keys,
    written by rank 0 alone; the collectives of the transport phase ran."""
    out = ranks["workdir"] / f"transport_{case}" / "output.txt"
    text = out.read_text()
    assert text.count("KMC step count:") == RUN_STEPS
    for key in ("Current [uA]:", "Total dissipated power [mW]:", "Global temperature [K]:",
                "cg_iters_power:", "tunnel_int_steps_needed:"):
        assert text.count(key) == RUN_STEPS, key
    assert "Z - calculation time - CB edge [s]" in text
    run = ranks["facts"][0][f"tr_{case}"]
    assert [p["phase"] for p in run["presolve"]] == ["cb_edge", "boundary"]
    # 3 all-gathers an operator application at least, the 3 inputs' gathers
    assert run["counts"]["all_gather"] > 3 * sum(s["cg_iters_power"] for s in run["steps"])


# ----------------------------------------------------------------------------
# one rank in this process
# ----------------------------------------------------------------------------

def test_world1_gloo_matches_single_device(tmp_path):
    """The halo path as a world of one gloo rank in this process, global
    heat, against the single device: the same solver on the same rows, so
    the transport observables agree to round-off."""
    import torch.distributed as dist

    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh

    sims = {}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        for tag, m in (("single", None), ("halo", mesh)):
            cfg, s = run_config(tmp_path / tag, **TRANSPORT, **HEAT_CASES["global"])
            cfg = dataclasses.replace(cfg, transport_warm_precond=cfg.transport_precond)
            os.makedirs(cfg.output_dir)
            sim = Simulation(cfg, elements=s.elements, coords=s.coords, device="cpu", mesh=m,
                             decomposition="halo" if m else "replicate")
            sim.run_bias_point(RUN_VD, 1e30, max_steps=RUN_STEPS)
            sims[tag] = sim
        power = sims["halo"].global_field("power")
    finally:
        dist.destroy_process_group()
    a, b = sims["single"], sims["halo"]
    nr = a.geom.N_real
    assert b.geom.N > nr                      # the halo structure is padded
    assert torch.equal(a.state.element, b.state.element[:nr])
    assert [r["n_events"] for r in a.step_log] == [r["n_events"] for r in b.step_log]
    assert [r["cg_iters_power"] for r in a.step_log] == [r["cg_iters_power"]
                                                          for r in b.step_log]
    assert b.state.I_macro == pytest.approx(a.state.I_macro, rel=1e-12)
    assert b.state.P_tot == pytest.approx(a.state.P_tot, rel=1e-12)
    assert _scale_err(power[:nr].numpy(), a.state.power.numpy()) < 1e-12
    assert b.state.T_bg == pytest.approx(a.state.T_bg, rel=1e-14)
