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
#: the stored metal block (what transport_cc="auto" picks) in mixed
#: precision, heating off, global and local matrix-free, and f64 (which
#: always stores), heating off and global; all with the pair-sweep kernel
#: and a Poisson bucket (BASE)
STORED = dict(transport_cc="stored")
F64 = dict(precision="f64", transport_cc="stored")
NEW_CONFIGS = {"stored-heat-off": STORED, "stored-heat-global": dict(STORED, **HEAT),
               "stored-heat-local-cg": dict(STORED, solve_heating_local=True,
                                            heat_solver="cg"),
               "f64-heat-off": F64, "f64-heat-global": dict(F64, **HEAT)}
CONFIGS = {**CONFIGS, **NEW_CONFIGS}
#: I_macro against the JAX package, relative: two independent mixed solves at
#: 1e-11 (test_torch_transport.py's tolerance); with the bf16 inner operator
#: test_torch_bf16_inner.py's 2e-5 (the port's bf16 band keeps the vector f32
#: and each row's rounding on the diagonal, the JAX package's does not); in
#: f64 1e-10 (the same CG in both packages, products summed in other orders)
I_TOL = {"bf16": 2e-5, "f64-heat-off": 1e-10, "f64-heat-global": 1e-10}
#: P_tot against the JAX package in f64, relative (the two f64 solves' I_macro
#: agree to about 3e-12 on this stack, P_tot to about 5e-15)
P_TOL = 1e-10
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
    pytest.param(dict(mixed=False), 1, True, None,
                 id="over4-1-True-precision other than 'mixed'"),
    pytest.param(dict(transport_cc="stored"), 1, True, None,
                 id="over5-1-True-stored metal block"),
    (dict(transport_warm_precond="deflated"), 1, True, "deflated warm re-solve"),
    pytest.param(dict(transport_bf16_inner=True), 1, True, None, id="over7-1-True-bf16"),
    pytest.param(dict(solve_heating_local=True), 1, True, None,
                 id="over8-1-True-local heat model"),
    ({}, 3, True, "B > 1"),
    ({}, None, True, "B > 1"),
    ({}, 1, False, "static band"),
    pytest.param(dict(solve_heating_local=True, heat_solver="cg"), 1, True, None,
                 id="over12-1-True-local heat model, heat_solver cg"),
    (dict(transport_cc="stored", transport_bf16_inner=True), 1, True, "bf16 twin"),
    (dict(mixed=False, transport_cc="stored", poisson_kernel="jnp"), 1, True,
     "Poisson sweep without the pair-sweep kernel"),
    (dict(mixed=False, dtype=torch.float32), 1, True, "precision 'f32'"),
    (dict(mixed=False, transport_cc="stored"), 1, False, None),
    (dict(mixed=False, transport_cc="stored"), 2, True, "B > 1"),
    (dict(mixed=False, transport_cc="stored", transport_warm_precond="deflated"), 1, True,
     "deflated warm re-solve"),
    (dict(transport_cc="stored", transport="dense"), 1, True, "dense transport"),
])
def test_transport_graph_route_by_configuration(over, batch, band, reason):
    """graph_ready admits the transport scope (blocked, Jacobi warm
    re-solve, heating off, global or local, B = 1; mixed precision with the
    on-the-fly or the stored metal block and the band, the bf16 inner
    operator on the fly; f64, with or without the band, as the f64 operator
    reads the ELL rows) and names a reason for everything outside it (bf16
    with a stored block, f32 precision, f64 with the exact-erfc Poisson
    sweep among them); a graph of such params refuses to be made.  The
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
    assert reason in got
    # the Poisson sweep's reason is the superstep's, not the transport's
    assert ("solve_current" in got) != ("Poisson" in reason)
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


@pytest.mark.parametrize("config", ["heat-local-dense", "heat-local-cg", "bf16",
                                    "stored-heat-local-cg", "f64-heat-global"])
def test_engine_runs_the_new_configurations_on_the_graph(tmp_path, config):
    """The local heat model (dense and matrix-free), the bf16 inner
    operator, the stored metal block and f64 run on SuperstepGraph: the
    engine's superstep replays it, one capture from each slot, with the
    simulation's heat model (heat.last_local set from the replay's read with
    the local model); per step, and with batch_steps = 3 through a batch
    graph, to the same elements."""
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.superstep import SuperstepGraph

    sim = _port(tmp_path, config, **CONFIGS[config])
    sim.run_bias_point(VD, 1e30, max_steps=3)
    g = sim._graph
    assert isinstance(g, SuperstepGraph) and g.captures == 2 and g.replays == 3
    assert g.heat is sim.heat
    if "heat_solver" in CONFIGS[config]:
        assert sim.heat.method == CONFIGS[config]["heat_solver"]
        assert heat_mod.last_local["branch"] in ("transient", "steady")
        assert (heat_mod.last_local["cg_iters"] > 0) == config.endswith("heat-local-cg")
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

_COMBOS = [(True, "on"), (False, "on"), (True, "off"), (False, "off")]
#: every (skip, incremental) pair of the fly configurations; the stored and
#: f64 ones each with one pair, both on or both off, so that each precision
#: takes both
NEW_COMBOS = {"stored-heat-off": (True, "on"), "stored-heat-global": (False, "off"),
              "stored-heat-local-cg": (True, "on"), "f64-heat-off": (False, "off"),
              "f64-heat-global": (True, "on")}
BIT_CASES = ([pytest.param(c, sk, inc, id=f"{sk}-{inc}-{c}") for sk, inc in _COMBOS
              for c in CONFIGS if c not in NEW_CONFIGS]
             + [pytest.param(c, sk, inc, id=f"{sk}-{inc}-{c}")
                for c, (sk, inc) in NEW_COMBOS.items()])


@pytest.mark.parametrize("config,skip,incremental", BIT_CASES)
def test_transport_graph_matches_eager_bit_for_bit(tmp_path, config, skip, incremental):
    """STEPS supersteps of the captured transport superstep (its plain
    version: the device loops through the plain kernels) against the eager
    engine from the same start, the last two without events (so that the
    network is unchanged): every field the transport and heat phases write
    (the temperature field too) and every metric bit for bit, step for
    step (a NaN metric, f64's transport_rel0 as the eager f64 solve has it,
    equal to a NaN)."""
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
        for key in ("elem", "charge", "step_time", "I", "P", "T", "tt_valid"):
            assert a[key] == b[key], (k, key)
        np.testing.assert_equal(a["m"], b["m"], err_msg=f"{k} metrics")
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
        if config.startswith("f64"):
            # one f64 Jacobi CG with criterion "pre" in each package: the
            # same iterations, P_tot within P_TOL
            assert b["m"]["cg_iters_power"] == a["m"]["cg_iters_power"], k
            assert b["P"] == pytest.approx(a["P"], rel=P_TOL, abs=1e-300), k


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


def _f64_system(tmp_path):
    """The f64 stored configuration after two supersteps, its stored solution
    perturbed: the device form's operator and workspace as the warm re-solve
    builds them (the solve run once), and the state."""
    from devicekmc_tpu_torch.ops import transport_cg
    from devicekmc_tpu_torch.physics import current

    sim = _port(tmp_path, "cg64", eager=True, **F64)
    sim.run_bias_point(VD, 1e30, max_steps=2)
    rng = np.random.default_rng(0)
    vp = sim.state.virtual_potentials
    vp = vp * torch.as_tensor(1 + 1e-2 * rng.standard_normal(vp.shape[0]))
    st = dataclasses.replace(sim.state, virtual_potentials=vp, transport_Vd_prev=float("nan"))
    cap = {}
    solve = transport_cg.solve_f64

    def grab(tws, op, x0, go, tol, maxiter):
        cap.update(tws=tws, op=op, x0=x0.clone(), tol=tol, maxiter=maxiter)
        return solve(tws, op, x0, go, tol, maxiter)

    transport_cg.solve_f64 = grab
    try:
        got, mg = current.update_power(sim.geom, sim.params, st, VD, cc=dict(sim._cc),
                                       allow_skip=True)
    finally:
        transport_cg.solve_f64 = solve
    return sim, st, got, mg, cap


def test_transport_f64_plain_loop_matches_cg_solve(tmp_path):
    """The f64 device loop's plain version (transport_cg.solve_f64: the
    stored block's product, transport_blocks, the rows of A p and the
    update, direction and packing) inside the warm re-solve against
    update_power_blocked's f64 branch (ops.cg.cg_solve, Jacobi, criterion
    "pre") on the same state: iterations, the iterate and I_macro bit for
    bit (the same operations in the same order); and against the JAX
    package's cg_solve(criterion="pre") on the same operator, made dense
    from the port's product (x64): the same iterations, the iterate within
    1e-12 of its largest entry (f64 sums in other orders), both meeting the
    criterion."""
    import jax
    import jax.numpy as jnp
    from devicekmc_tpu.ops.cg import cg_solve as jax_cg_solve
    from devicekmc_tpu_torch.physics import current

    sim, st, got, mg, cap = _f64_system(tmp_path)
    ref, mr = current.update_power_blocked(sim.geom, sim.params, st, VD, cc=sim._cc,
                                           precond="jacobi")
    assert mr["transport_converged"] and mg["transport_converged"]
    assert mg["cg_iters_power"] == mr["cg_iters_power"] > 0
    assert got.I_macro == ref.I_macro
    assert torch.equal(got.virtual_potentials, ref.virtual_potentials)
    assert np.isnan(mg["transport_rel0"]) and np.isnan(mr["transport_rel0"])

    op = cap["op"]
    blk = current.assemble_X_blocks(sim.geom, sim.params, st, cc=sim._cc["cc"])
    nsub = op.b.shape[0]
    eye = torch.eye(nsub + 1, dtype=torch.float64)
    A = torch.stack([current._apply_X_blocks(blk, eye[j], torch.float64)[:nsub]
                     for j in range(nsub)], dim=1)
    assert jax.config.jax_enable_x64
    Aj = jnp.asarray(A.numpy())
    res = jax_cg_solve(lambda x: Aj @ x, jnp.asarray(op.b.numpy()),
                       x0=jnp.asarray(cap["x0"].numpy()),
                       diag=jnp.asarray(blk["diag"][:nsub].numpy()), tol=cap["tol"],
                       maxiter=cap["maxiter"], criterion="pre")
    jx, jit = np.asarray(res.x), int(res.iters)
    assert bool(res.converged) and Aj.dtype == jnp.float64
    assert jit == mg["cg_iters_power"]
    v = got.virtual_potentials[:nsub].numpy()
    assert np.abs(v - jx).max() <= 1e-12 * np.abs(jx).max()


def test_stored_matvec_plain_is_the_product():
    """stored_matvec_out on CPU tensors writes the plain version, the stored
    block's T_cc @ x in its dtype (what physics.current._apply_X_blocks
    computes), into the caller's buffer, f32 and f64."""
    from devicekmc_tpu_torch.ops.transport_cg import stored_matvec_out, stored_matvec_plain

    g = torch.Generator().manual_seed(5)
    for dtype in (torch.float32, torch.float64):
        for n in (1, 7, 130):
            T = torch.randn((n, n), generator=g, dtype=dtype)
            x = torch.randn(n, generator=g, dtype=dtype)
            y = torch.full((n,), float("nan"), dtype=dtype)
            stored_matvec_out(T, x, y)
            assert torch.equal(y, torch.matmul(T, x)) and torch.equal(y, stored_matvec_plain(T, x))


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
