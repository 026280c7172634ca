"""Shared configurations and helpers of the transport-superstep graph tests
(``tests/test_torch_transport_graph_*.py``, one file a group of
configurations): the transport superstep as one captured graph
(``superstep.SuperstepGraph`` with ``solve_current``, ``ops.transport_cg``,
``ops.heat``) through its plain versions on the CPU, on the 256-site stack,
seeded, transport_tol 1e-11 (the parity tests' setting); JAX runs on the
CPU in x64 with its Pallas kernels interpreted.  The checks that several
files parametrise over their configurations are the ``check_*`` functions
here."""

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
# the parametrised checks
# ---------------------------------------------------------------------------

def check_engine_runs_on_the_graph(tmp_path, config):
    """The configuration ``config`` runs on SuperstepGraph: the engine's
    superstep replays it, one capture from each slot, with the simulation's
    heat model (heat.last_local set from the replay's read with the local
    model); per step, and with batch_steps = 3 through a batch graph, to the
    same elements."""
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.superstep import SuperstepGraph

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



_COMBOS = [(True, "on"), (False, "on"), (True, "off"), (False, "off")]
#: every (skip, incremental) pair of the fly configurations; the stored and
#: f64 ones each with one pair, both on or both off, so that each precision
#: takes both
NEW_COMBOS = {"stored-heat-off": (True, "on"), "stored-heat-global": (False, "off"),
              "stored-heat-local-cg": (True, "on"), "f64-heat-off": (False, "off"),
              "f64-heat-global": (True, "on")}
_BIT_CASES = ([pytest.param(c, sk, inc, id=f"{sk}-{inc}-{c}") for sk, inc in _COMBOS
              for c in CONFIGS if c not in NEW_CONFIGS]
             + [pytest.param(c, sk, inc, id=f"{sk}-{inc}-{c}")
                for c, (sk, inc) in NEW_COMBOS.items()])



def bit_cases(configs):
    """The (config, skip, incremental) cases of the configurations
    ``configs``, with their ids, in the order of the full list."""
    return [p for p in _BIT_CASES if p.values[0] in configs]


def check_bit_for_bit(tmp_path, config, skip, incremental):
    """STEPS supersteps of the captured transport superstep (its plain
    version: the device loops through the plain kernels) against the eager
    engine from the same start, the last two without events (so that the
    network is unchanged): every field the transport and heat phases write
    (the temperature field too) and every metric bit for bit, step for
    step (a NaN metric, f64's transport_rel0 as the eager f64 solve has it,
    equal to a NaN)."""
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



def check_matches_jax(tmp_path, config):
    """The captured transport superstep against the JAX package's
    jit(superstep_impl) (its Simulation, fused): elements and events equal
    step for step, I_macro within 1e-5 relative (I_TOL), T_bg within 1e-9,
    with the local model the temperature field within TEMP_TOL, the skips at
    the same steps."""
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


