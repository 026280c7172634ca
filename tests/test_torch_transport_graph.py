"""The transport superstep as one captured graph (``superstep.SuperstepGraph``
with ``solve_current``, ``ops.transport_cg``, ``ops.heat``) through its plain
versions on the CPU: which configurations take the graph, the graph's body
against the eager engine bit for bit (heating off, global and local, dense
and matrix-free, the bf16 inner operator, the unchanged-network skip and the
persistent tunnel rows on and off), both against the JAX package's
jitted superstep and its batched driver with a compliance stop, a redo after
the integration count grew, and the transport CG's plain loop against
``cg_solve_mixed``.  All on the 256-site stack, seeded, transport_tol 1e-11
(the parity tests' setting); JAX runs on the CPU in x64 with its Pallas
kernels interpreted."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure

torch.set_num_threads(1)

VD = 10.0
STEPS = 6
# the transport configuration of the captured superstep: blocked, mixed
# precision, the on-the-fly metal block with the band, the Jacobi warm
# re-solve; chunked deflated cold solves, as the card's smoke run has them
BASE = dict(pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
            precision="mixed", solve_current=True, transport="blocked", transport_cc="fly",
            poisson_kernel="pallas", poisson_compact_cap=64, V_switch=[VD],
            t_switch=[1e30], transport_tol=1e-11, solver_chunk_iters=40, coarse_slabs=4)
HEAT = dict(solve_heating_global=True, A=1e-18)
#: the configurations beside the transport one, by test id: heating off,
#: global, local with the dense propagators and matrix-free, the bf16 inner
#: operator
CONFIGS = {"heat-off": {}, "heat-global": HEAT,
           "heat-local-dense": dict(solve_heating_local=True, heat_solver="dense"),
           "heat-local-cg": dict(solve_heating_local=True, heat_solver="cg"),
           "bf16": dict(transport_bf16_inner=True)}
#: I_macro against the JAX package, relative: two independent mixed solves at
#: 1e-11 (test_torch_transport.py's tolerance); with the bf16 inner operator
#: test_torch_bf16_inner.py's 2e-5 (the port's bf16 band keeps the vector f32
#: and each row's rounding on the diagonal, the JAX package's does not)
I_TOL = {"bf16": 2e-5}
#: the temperature field against the JAX package: test_torch_heat.py's
#: tolerances of the local models (dense 1e-10, matrix-free 1e-9, rtol and
#: atol)
TEMP_TOL = {"heat-local-dense": 1e-10, "heat-local-cg": 1e-9}


def _hash(a) -> str:
    return hashlib.sha256(np.asarray(a).astype(np.int32).tobytes()).hexdigest()[:16]


def _cfgs(tmp_path, tag, **kw):
    s = small_structure()
    jcfg, tcfg = configs(s, **{**BASE, **kw})
    for name, cfg in (("jax", jcfg), ("torch", tcfg)):
        d = tmp_path / f"{tag}_{name}"
        d.mkdir(parents=True)
        cfg.output_dir = str(d)
    return jcfg, tcfg, s


def _port(tmp_path, tag, eager=False, **kw):
    from devicekmc_tpu_torch.engine import Simulation, make_superstep

    _, tcfg, s = _cfgs(tmp_path, tag, **kw)
    sim = Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu")
    if eager:
        # the engine's superstep without a graph
        sim._make = lambda g, p, h: make_superstep(g, p, h)
    return sim


def _record(sim, to_np=lambda t: t.numpy()):
    """Wrap the superstep: each call's state fields and metrics."""
    recs = []
    step = sim._superstep

    def wrapped(state, Vd, *rest):
        out = step(state, Vd, *rest)
        st, m = out[0], out[2]
        recs.append(dict(
            elem=_hash(to_np(st.element)), charge=_hash(to_np(st.charge)),
            step_time=float(out[1]), I=float(st.I_macro), P=float(st.P_tot),
            T=float(st.T_bg), vp=to_np(st.virtual_potentials).copy(),
            power=to_np(st.power).copy(), temp=to_np(st.temperature).copy(),
            tt=[to_np(getattr(st, f)).copy() for f in
                                              ("tt_slot_atom", "tt_vm", "tt_vv")],
            tt_valid=bool(st.tt_valid), m={k: float(v) for k, v in m.items()}))
        return out

    sim._superstep = wrapped
    return recs


# ---------------------------------------------------------------------------
# which configurations run the graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over,batch,band,reason", [
    ({}, 1, True, None),
    (dict(solve_heating_global=True), 1, True, None),
    (dict(transport_incremental=False, transport_skip_unchanged=False), 1, True, None),
    (dict(transport="dense"), 1, True, "dense transport"),
    (dict(mixed=False), 1, True, "precision other than 'mixed'"),
    (dict(transport_cc="stored"), 1, True, "stored metal block"),
    (dict(transport_warm_precond="deflated"), 1, True, "deflated warm re-solve"),
    pytest.param(dict(transport_bf16_inner=True), 1, True, None, id="over7-1-True-bf16"),
    pytest.param(dict(solve_heating_local=True), 1, True, None,
                 id="over8-1-True-local heat model"),
    ({}, 3, True, "B > 1"),
    ({}, None, True, "B > 1"),
    ({}, 1, False, "static band"),
    pytest.param(dict(solve_heating_local=True, heat_solver="cg"), 1, True, None,
                 id="over12-1-True-local heat model, heat_solver cg"),
])
def test_transport_graph_route_by_configuration(over, batch, band, reason):
    """graph_ready admits the transport scope (blocked, mixed, on-the-fly
    metal block, band, Jacobi warm re-solve, with or without the bf16 inner
    operator, heating off, global or local, B = 1) and names a reason for
    everything outside it; a graph of such params refuses to be made.  The
    local model's heat_solver (dense or cg) is the heat model's, not the
    params': both take the graph (test_transport_engine_takes_the_graph)."""
    from devicekmc_tpu_torch.state import PhysParams
    from devicekmc_tpu_torch.superstep import SuperstepGraph, graph_ready

    params = PhysParams(freq=1e13, sigma=3.5e-10, k=1.0, nn_dist=3.0, high_G=1.0,
                        low_G=1e-8, background_temp=300.0, solve_current=True,
                        transport="blocked", transport_cc="fly", mixed=True,
                        poisson_compact_cap=64, poisson_kernel="pallas")
    over = {k: v for k, v in over.items() if k != "heat_solver"}
    params = dataclasses.replace(params, **over)
    got = graph_ready(params, batch, band)
    if reason is None:
        assert got is None
        return
    assert reason in got and "solve_current" in got
    if band and batch == 1:
        with pytest.raises(ValueError, match="not captured"):
            SuperstepGraph(None, params, batch)


def test_transport_engine_takes_the_graph(tmp_path):
    """The fused engine captures the transport superstep (one graph from
    each slot); without the band (transport_banded off) it runs eagerly."""
    sim = _port(tmp_path, "graph")
    sim.run_bias_point(VD, 1e30, max_steps=3)
    assert sim._graph is not None and sim._graph.captures == 2
    eager = _port(tmp_path, "noband", transport_banded=False)
    assert eager._band is None
    eager.run_bias_point(VD, 1e30, max_steps=1)
    assert eager._graph is None


@pytest.mark.parametrize("config", ["heat-local-dense", "heat-local-cg", "bf16"])
def test_engine_runs_the_new_configurations_on_the_graph(tmp_path, config):
    """The local heat model (dense and matrix-free) and the bf16 inner
    operator run on SuperstepGraph: the engine's superstep replays it, one
    capture from each slot, with the simulation's heat model
    (heat.last_local set from the replay's read with the local model); per
    step, and with batch_steps = 3 through a batch graph, to the same
    elements."""
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.superstep import SuperstepGraph

    sim = _port(tmp_path, config, **CONFIGS[config])
    sim.run_bias_point(VD, 1e30, max_steps=3)
    g = sim._graph
    assert isinstance(g, SuperstepGraph) and g.captures == 2 and g.replays == 3
    assert g.heat is sim.heat
    if config != "bf16":
        assert sim.heat.method == CONFIGS[config]["heat_solver"]
        assert heat_mod.last_local["branch"] in ("transient", "steady")
        assert (heat_mod.last_local["cg_iters"] > 0) == (config == "heat-local-cg")
    batched = _port(tmp_path, config + "-batch", batch_steps=3, log_freq=1000,
                    **CONFIGS[config])
    batched.run_bias_point(VD, 1e30, max_steps=3)
    bg = batched._graph
    assert bg is not None and bg.replays < 3
    assert any(key[0] == "batch" for key in bg.graphs)
    assert torch.equal(batched.state.element, sim.state.element)


# ---------------------------------------------------------------------------
# the graph's body against the eager engine, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("skip,incremental", [(True, "on"), (False, "on"), (True, "off"),
                                              (False, "off")])
def test_transport_graph_matches_eager_bit_for_bit(tmp_path, config, skip, incremental):
    """STEPS supersteps of the captured transport superstep (its plain
    version: the device loops through the plain kernels) against the eager
    engine from the same start, the last two without events (so that the
    network is unchanged): every field the transport and heat phases write
    (the temperature field too) and every metric bit for bit, step for
    step."""
    kw = dict(transport_skip_unchanged=skip, transport_incremental=incremental,
              **CONFIGS[config])
    g = _port(tmp_path, "g", **kw)
    e = _port(tmp_path, "e", eager=True, **kw)
    rg, re_ = _record(g), _record(e)
    for sim in (g, e):
        sim.run_bias_point(VD, 1e30, max_steps=STEPS - 2)
        # two supersteps without events: an unchanged network (the skip)
        sim.params = dataclasses.replace(sim.params, perturb_structure=False)
        for _ in range(2):
            sim.state = sim._superstep(sim.state, VD)[0]
    assert g._graph is not None and e._graph is None
    assert len(rg) == len(re_) == STEPS
    for k, (a, b) in enumerate(zip(rg, re_)):
        for key in ("elem", "charge", "step_time", "I", "P", "T", "tt_valid", "m"):
            assert a[key] == b[key], (k, key)
        for key in ("vp", "power", "temp"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{k} {key}")
        for u, v in zip(a["tt"], b["tt"]):
            np.testing.assert_array_equal(u, v, err_msg=f"{k} tt")
    assembly = {r["m"]["transport_partial_assembly"] for r in rg}
    if skip and incremental == "on":
        assert {-1.0, 1.0} <= assembly
    if not skip:
        assert -1.0 not in assembly
    if incremental == "off":
        assert 1.0 not in assembly
    assert all(r["m"]["transport_converged"] == 1.0 for r in rg)
    if config.startswith("heat-") and config != "heat-off":
        assert rg[-1]["T"] > 300.0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", list(CONFIGS))
def test_transport_graph_matches_jax(tmp_path, config):
    """The captured transport superstep against the JAX package's
    jit(superstep_impl) (its Simulation, fused): elements and events equal
    step for step, I_macro within 1e-5 relative (I_TOL), T_bg within 1e-9,
    with the local model the temperature field within TEMP_TOL, the skips at
    the same steps."""
    from devicekmc_tpu.engine import Simulation as JSim
    from devicekmc_tpu_torch.engine import Simulation as TSim

    jcfg, tcfg, s = _cfgs(tmp_path, "jx", **CONFIGS[config])
    jsim = JSim(jcfg, elements=s.elements, coords=s.coords)
    tsim = TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu")
    jrec, trec = _record(jsim, np.asarray), _record(tsim)
    jsim.run_bias_point(VD, 1e30, max_steps=STEPS)
    jsim._flush()
    tsim.run_bias_point(VD, 1e30, max_steps=STEPS)
    assert tsim._graph is not None
    assert len(jrec) == len(trec) == STEPS
    for k, (a, b) in enumerate(zip(jrec, trec)):
        assert b["elem"] == a["elem"] and b["charge"] == a["charge"], k
        assert b["m"]["n_events"] == a["m"]["n_events"], k
        assert b["I"] == pytest.approx(a["I"], rel=I_TOL.get(config, 1e-5)), k
        assert b["T"] == pytest.approx(a["T"], rel=1e-9), k
        if config in TEMP_TOL:
            tol = TEMP_TOL[config]
            np.testing.assert_allclose(b["temp"], a["temp"], rtol=tol, atol=tol,
                                       err_msg=f"step {k}")
        assert (b["m"]["transport_rel0"] == -1.0) == (a["m"]["transport_rel0"] == -1.0), k


def test_transport_graph_batch_compliance_matches_jax(tmp_path):
    """batch_steps = 4 with a compliance current that trips inside a batch:
    the port's batch graph (multi_superstep_impl with the Icc_A stop on the
    device) against the JAX batched driver (its jitted multi_superstep_impl):
    the same steps run, elements and events equal step for step, currents
    within 1e-5, the stop logged; and the port's per-step graph runs the
    same steps."""
    from devicekmc_tpu.engine import Simulation as JSim
    from devicekmc_tpu_torch.engine import Simulation as TSim

    # Icc [uA] between the currents of the stack's third and fourth steps
    kw = dict(batch_steps=4, log_freq=1000, Icc=4.0)
    jcfg, tcfg, s = _cfgs(tmp_path, "icc", **kw)
    jsim = JSim(jcfg, elements=s.elements, coords=s.coords)
    tsim = TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu")
    jrec, trec = _record(jsim, np.asarray), _record(tsim)
    multi = {}
    tmulti = tsim._msuperstep

    def counted(*a, **k):
        out = tmulti(*a, **k)
        multi["steps"] = multi.get("steps", 0) + int(out[2]["active"].sum())
        return out

    tsim._msuperstep = counted
    jsum = jsim.run_bias_point(VD, 1e30, max_steps=12)
    jsim._flush()
    tsum = tsim.run_bias_point(VD, 1e30, max_steps=12)
    assert tsim._graph is not None and multi["steps"] > 0
    assert tsum["steps"] == jsum["steps"] < 12
    tlog = [dict(ln.split(": ", 1) for ln in step.splitlines() if ": " in ln)
            for step in open(tsim.output_path).read().split("KMC step count")[1:]]
    jlog = [dict(ln.split(": ", 1) for ln in step.splitlines() if ": " in ln)
            for step in open(jsim.output_path).read().split("KMC step count")[1:]]
    assert len(tlog) == len(jlog) == tsum["steps"]
    for k, (a, b) in enumerate(zip(jlog, tlog)):
        assert b["n_events"] == a["n_events"], k
        assert float(b["Current [uA]"]) == pytest.approx(float(a["Current [uA]"]), rel=1e-5)
    assert "compliance current reached" in open(tsim.output_path).read()
    assert float(tlog[-1]["Current [uA]"]) > 4.0 > float(tlog[-2]["Current [uA]"])
    # the per-step graph stops at the same step
    psim = _port(tmp_path, "perstep", log_freq=1000, Icc=4.0)
    prec = _record(psim)
    psum = psim.run_bias_point(VD, 1e30, max_steps=12)
    assert psum["steps"] == tsum["steps"]
    assert prec[-1]["elem"] == _hash(tsim.state.element.numpy())


# ---------------------------------------------------------------------------
# cap growth, and the solver against cg_solve_mixed
# ---------------------------------------------------------------------------

def test_transport_graph_redo_after_int_steps_growth(tmp_path):
    """An integration count that the first assembly finds too small: the
    driver grows it, drops the stored tunnel rows, captures again and redoes
    the step through the graph, so the run equals one that had the grown
    count from its start, step for step."""
    runs = {}
    for tag, n in (("grown", 8), ("large", None)):
        # no cold transport solve (its operator would hold the small count):
        # the first superstep solves from the same start in both runs
        sim = _port(tmp_path, tag, solver_chunk_iters=0)
        if n is None:
            n = runs["grown"][1].params.tunnel_int_steps
        sim.params = dataclasses.replace(sim.params, tunnel_int_steps=n)
        recs = _record(sim)
        sim.run_bias_point(VD, 1e30, max_steps=3)
        runs[tag] = (recs, sim)
    (grown, gsim), (large, lsim) = runs["grown"], runs["large"]
    assert gsim.params.tunnel_int_steps > 8 and gsim._graph.captures > 2
    assert len(grown) == len(large) + 1 == 4
    for a, b in zip(grown[1:], large):
        for key in ("elem", "I", "step_time", "m"):
            assert a[key] == b[key], key
    assert gsim.state.I_macro == lsim.state.I_macro


def test_transport_cg_plain_matches_cg_solve_mixed(tmp_path):
    """The transport CG's plain loop (the device form of the warm re-solve)
    against cg_solve_mixed (update_power_blocked with the Jacobi
    preconditioner) on one fixed system, the state after two supersteps with
    its stored solution perturbed: both meet the criterion, and I_macro, the
    iterations and the iterate agree bit for bit (the same operations in the
    same order)."""
    from devicekmc_tpu_torch.physics import current

    sim = _port(tmp_path, "cg", eager=True)
    sim.run_bias_point(VD, 1e30, max_steps=2)
    g, p = sim.geom, sim.params
    rng = np.random.default_rng(0)
    vp = sim.state.virtual_potentials
    vp = vp * torch.as_tensor(1 + 1e-2 * rng.standard_normal(vp.shape[0]))
    st = dataclasses.replace(sim.state, virtual_potentials=vp, transport_Vd_prev=float("nan"))
    ref, mr = current.update_power_blocked(g, p, st, VD, cc=sim._cc, precond="jacobi")
    got, mg = current.update_power(g, p, st, VD, cc=dict(sim._cc), allow_skip=True)
    assert mr["transport_converged"] and mg["transport_converged"]
    assert mg["cg_iters_power"] == mr["cg_iters_power"] > 0
    assert got.I_macro == pytest.approx(ref.I_macro, rel=1e-6)
    assert got.I_macro == ref.I_macro
    assert torch.equal(got.virtual_potentials, ref.virtual_potentials)
    assert mg["transport_rel0"] == mr["transport_rel0"]


@pytest.mark.parametrize("branch", [0, 3])
def test_fork_refuses_a_branch_out_of_range(branch):
    """The inner body forks two branches (the fly matvec and
    transport_blocks); a branch number outside 1 .. MAX_BRANCHES, whose
    stream no capture made beforehand, raises before any stream is made."""
    from devicekmc_tpu_torch.ops.graph import MAX_BRANCHES, fork, join

    assert MAX_BRANCHES == 2
    with pytest.raises(ValueError):
        fork("cpu", branch=branch)
    with pytest.raises(ValueError):
        join("cpu", branch=branch)
