"""The local heat model's device loops (``ops.heat``: the transient substeps
and the steady branch as device loops, the matrix-free model's CG nested in
its substeps) through their plain versions on the CPU, in the form a
captured superstep runs them (the step time and T_bg 0-d tensors, nothing
read): against the JAX package's ``update_temperature_local`` and
``update_temperature_local_cg`` in both branches, at a step time right at
1e3 delta_t and at step times of 1, 2 and 151 substeps; against the host
form of the same update bit for bit; the branch and substep count on the
device against the host's; the operator forms against the Laplacian.  The
stack of tests/test_torch_heat.py (seeded site power), f64."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_heat import _models, hs  # noqa: F401  (hs: a fixture)

torch.set_num_threads(1)

#: step times in units of delta_t: 1, 2 and 151 transient substeps, right at
#: 1e3 delta_t (still transient: 1001 substeps), the steady branch
MULTS = [0.5, 1.5, 150.5, 1000.0, 5e3]
#: (steady, substeps) of each
BRANCH = {0.5: (0, 1), 1.5: (0, 2), 150.5: (0, 151), 1000.0: (0, 1001), 5e3: (1, 0)}
#: the dense model: the JAX test's tolerance against its oracle (two
#: products of one propagator that sum in another order); the matrix-free
#: model: two CGs at tolerance 1e-10 whose operators round in another order
#: (the port's ELL form, JAX's x - s L x)
TOL = {"dense": dict(rtol=1e-10, atol=1e-10), "cg": dict(rtol=1e-9, atol=1e-9)}
#: T_bg against JAX, relative
TBG_TOL = {"dense": 1e-12, "cg": 1e-9}


def _device_form(state):
    """The state as a captured superstep holds it: its scalars 0-d tensors."""
    return dataclasses.replace(state, T_bg=torch.tensor(state.T_bg, dtype=torch.float64),
                               P_tot=torch.tensor(state.P_tot, dtype=torch.float64))


def _update(method):
    from devicekmc_tpu_torch.physics import heat as theat

    return (theat.update_temperature_local if method == "dense"
            else theat.update_temperature_local_cg)


@pytest.mark.parametrize("mult", MULTS)
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_device_loops_match_jax(hs, method, mult):
    """The device form (a 0-d step time, T_bg kept on the device) against
    the JAX package's model: the temperature field within TOL, T_bg within
    TBG_TOL relative, the loops' log the branch and substep count the JAX
    package's lax.cond and while_loop take."""
    from devicekmc_tpu.physics import heat as jheat

    jh, th = _models(hs, method)
    step_time = mult * hs["jcfg"].delta_t
    jupd = jheat.update_temperature_local if method == "dense" \
        else jheat.update_temperature_local_cg
    jst, _ = jupd(hs["jg"], hs["jp"], jh, hs["js"], jnp.asarray(step_time, hs["jp"].dtype))
    st, m = _update(method)(hs["tg"], hs["tp"], th, _device_form(hs["ts"]),
                            torch.tensor(step_time, dtype=torch.float64))
    assert torch.is_tensor(st.T_bg) and torch.is_tensor(m["Global temperature [K]"])
    steady, substeps, iters = th.ws.log.tolist()
    assert (steady, substeps) == BRANCH[mult]
    assert (iters > 0) == (method == "cg")
    ref = np.asarray(jst.temperature)
    assert np.abs(ref - 300.0).max() > 1e-3
    np.testing.assert_allclose(st.temperature.numpy(), ref, **TOL[method])
    assert float(st.T_bg) == pytest.approx(float(jst.T_bg), rel=TBG_TOL[method])
    # sites outside the interface keep their temperature
    outside = np.ones(hs["tg"].N, bool)
    outside[th.interface_idx.numpy()] = False
    assert bool((st.temperature[torch.as_tensor(outside)] == 300.0).all())


@pytest.mark.parametrize("mult", [0.5, 150.5, 5e3])
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_device_form_equals_host_form(hs, method, mult):
    """The device form and the host form (a float step time, T_bg read
    back with the loops' log into last_local) run the same loops: the field
    and T_bg bit for bit, the log equal; the state that went in is left as
    it was."""
    from devicekmc_tpu_torch.physics import heat as theat

    _, th = _models(hs, method)
    step_time = mult * hs["jcfg"].delta_t
    before = hs["ts"].temperature.clone()
    st_d, _ = _update(method)(hs["tg"], hs["tp"], th, _device_form(hs["ts"]),
                              torch.tensor(step_time, dtype=torch.float64))
    log = th.ws.log.tolist()
    st_h, m_h = _update(method)(hs["tg"], hs["tp"], th, hs["ts"], step_time)
    assert torch.equal(st_d.temperature, st_h.temperature)
    assert float(st_d.T_bg) == st_h.T_bg == m_h["Global temperature [K]"]
    assert th.ws.log.tolist() == log
    assert theat.last_local == dict(branch=("transient", "steady")[log[0]], substeps=log[1],
                                    cg_iters=log[2])
    assert torch.equal(hs["ts"].temperature, before)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_branch_on_the_device_matches_the_host(hs, dtype):
    """heat.branch of a 0-d step time against is_steady and n_substeps of
    the same float, in the working dtype: around 1e3 delta_t, at exact
    multiples, 0, and far in the steady branch (n_sub bounded there)."""
    from devicekmc_tpu_torch.physics import heat as theat

    p = dataclasses.replace(hs["tp"], dtype=dtype)
    dt = hs["jcfg"].delta_t
    f = np.float32 if dtype == torch.float32 else np.float64
    edge = float(f(1e3) * f(dt))
    times = [0.0, 0.5 * dt, dt, 2 * dt, 150.5 * dt, 999.999 * dt, edge,
             float(np.nextafter(f(edge), f(np.inf))), 1e3 * dt, 5e3 * dt, 1e30]
    for t in times:
        steady, n = theat.branch(p, torch.tensor(t, dtype=torch.float64), "cpu")
        assert bool(steady) == theat.is_steady(p, t), t
        if not bool(steady):
            assert int(n) == theat.n_substeps(p, t), t
        assert n.dtype == torch.int32 and 0 < int(n) <= 2 ** 30
    steady, n = theat.branch(p, edge, "cpu")
    assert steady is False and n == theat.n_substeps(p, edge)


def test_operator_forms_are_the_laplacian(hs):
    """The ELL forms the matrix-free loops solve (ops.heat.workspace, made
    with the model) apply ``I - s L`` and ``-L`` of the model's Laplacian
    (physics.heat._laplacian_apply) on the interface and 0 off it, within
    1e-14 of the scale; the workspace's CG has minv = 1 and every row length
    the operator's structure gives."""
    from devicekmc_tpu_torch.ops.boundary_cg import apply_operator, row_lengths
    from devicekmc_tpu_torch.physics.heat import _laplacian_apply

    _, th = _models(hs, "cg")
    ws, g = th.ws, hs["tg"]
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(g.N))
    lap = _laplacian_apply(g, th, x)
    mask = th.interface_mask
    s = th.step_scale
    for op, ref in ((ws.op_t, torch.where(mask, x - s * lap, 0.0)),
                    (ws.op_s, torch.where(mask, -lap, 0.0))):
        got = apply_operator(op, x[None])[0]
        scale = float(ref.abs().max())
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-14 * scale)
    assert bool((ws.cg.minv == 1).all()) and bool(ws.cg.act0.all())
    assert torch.equal(ws.cg.row_len, row_lengths(g.neigh_idx, mask))
    assert bool((ws.cg.row_len[~mask] == -1).all())


def test_dense_substep_plain_double_buffers(hs):
    """Two substeps of the dense plain kernel from a right-hand side: the
    first reads half 0 and writes half 1, the second the reverse, each the
    propagator's product, the field's interface written, the counter and
    the predicate advanced (2 substeps: the second ends the loop)."""
    from devicekmc_tpu_torch.ops import heat as heat_ops

    _, th = _models(hs, "dense")
    ws = th.ws
    T0, scale = 300.0, 1000.0
    temp = hs["ts"].temperature.clone()
    rng = np.random.default_rng(3)
    ws.u.zero_()
    ws.u[0].copy_(torch.as_tensor(rng.standard_normal(th.n_interface) * 1e-3))
    ws.src.copy_(torch.as_tensor(rng.standard_normal(th.n_interface) * 1e-4))
    heat_ops.prepare(ws, False, 2)
    u0 = ws.u[0].clone()
    heat_ops.dense_substep(ws, th.L_inv, temp, T0, scale, False, 0)
    t1 = (th.L_inv @ u0) * scale + T0
    assert torch.equal(temp[th.interface_idx], t1)
    assert torch.equal(ws.u[1], (t1 - T0) / scale + ws.src) and torch.equal(ws.u[0], u0)
    assert ws.k.tolist() == [1] and ws.cond.tolist() == [1, 0]
    heat_ops.dense_substep(ws, th.L_inv, temp, T0, scale, False, 0)
    t2 = (th.L_inv @ ((t1 - T0) / scale + ws.src)) * scale + T0
    assert torch.equal(temp[th.interface_idx], t2)
    assert ws.k.tolist() == [2] and ws.cond.tolist() == [0, 0]
