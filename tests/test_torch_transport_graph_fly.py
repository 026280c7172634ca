"""The transport superstep as one captured graph, with the on-the-fly metal
block, heating off and global: which configurations take the graph, the
engine's capture, the graph's body against the eager engine bit for bit
(the unchanged-network skip and the persistent tunnel rows on and off), both
against the JAX package's jitted superstep and its batched driver with a
compliance stop, a redo after the integration count grew, and the
transport CG's plain loop against ``cg_solve_mixed``
(``torch_transport_graph`` holds the configurations)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_transport_graph import (VD, _cfgs, _hash, _port, _record, bit_cases,
                                   check_bit_for_bit, check_matches_jax)

torch.set_num_threads(1)

#: this file's configurations (heating off and global, the on-the-fly metal block)
GROUP = ["heat-off", "heat-global"]


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
    # f64 with the exact-erfc sweep and a bucket (the JAX package's default
    # configuration): its kernel reads the count on the device
    pytest.param(dict(mixed=False, transport_cc="stored", poisson_kernel="jnp"), 1, True, None,
                 id="over14-1-True-Poisson sweep without the pair-sweep kernel"),
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
    reads the ELL rows; f64 also with the exact-erfc Poisson sweep) and
    names a reason for everything outside it (bf16 with a stored block and
    f32 precision among them); a graph of such params refuses to be made.  The
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


@pytest.mark.parametrize("config,skip,incremental", bit_cases(GROUP))
def test_transport_graph_matches_eager_bit_for_bit(tmp_path, config, skip, incremental):
    """The graph against the eager engine bit for bit, step for step
    (torch_transport_graph.check_bit_for_bit)."""
    check_bit_for_bit(tmp_path, config, skip, incremental)


@pytest.mark.parametrize("config", GROUP)
def test_transport_graph_matches_jax(tmp_path, config):
    """The graph against the JAX package's jitted superstep
    (torch_transport_graph.check_matches_jax)."""
    check_matches_jax(tmp_path, config)


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
