"""The heat slice of the port against the JAX package, module by module: the
heat state carried across, the dissipated power of the blocked transport
solve, the heat model's leaves, the global ODE, and the local model dense and
matrix-free.  Inputs are made with numpy from a seed and carried across with
from_jax_arrays / heat_from_jax_arrays; the Pallas kernel runs in interpret
mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transport import VD, _tparams, dev  # noqa: F401  (dev: a fixture)
from torch_parity import configs, record_dict, to_port

torch.set_num_threads(1)

AREA = 6.25e-19


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------

def test_state_carries_heat_fields(dev):
    """build_geometry / build_params / init_state of the port give the JAX
    package's heat geometry, parameters and initial state; from_jax_arrays
    carries temperature, power, P_tot and T_bg."""
    from devicekmc_tpu_torch.state import build_geometry, build_params, init_state

    s, jg, js = dev["s"], dev["jg"], dev["js"]
    tcfg = dataclasses.replace(dev["tcfg"], A=AREA, background_temp=312.5)
    tg = build_geometry(dev["elems"], s.coords, tcfg, device="cpu")
    np.testing.assert_array_equal(tg.inner_mask.numpy(), np.asarray(jg.inner_mask))
    assert 0 < int(tg.inner_mask.sum()) < tg.N
    ts = init_state(tg, tcfg, dev["elems"])
    assert ts.temperature.shape == (tg.N,) and ts.temperature.dtype == torch.float64
    assert bool((ts.temperature == 312.5).all()) and ts.P_tot == 0.0 and ts.T_bg == 312.5
    tp, jp = build_params(tcfg), dev["jp"]
    for f in ("dissipation_constant", "t_ox", "c_p", "delta_t", "tau",
              "k_th_interface", "k_th_vacancies"):
        assert getattr(tp, f) == float(getattr(jp, f)), f
    assert tp.A == AREA and tp.num_layers_contact == jp.num_layers_contact

    rng = np.random.default_rng(0)
    js2 = js.replace(
        temperature=jnp.asarray(300 + rng.random(tg.N)),
        power=jnp.asarray(rng.random(tg.N) * 1e-6),
        P_tot=jnp.asarray(0.25), T_bg=jnp.asarray(321.0))
    _, ts2 = to_port(jg, js2)
    np.testing.assert_array_equal(ts2.temperature.numpy(), np.asarray(js2.temperature))
    np.testing.assert_array_equal(ts2.power.numpy(), np.asarray(js2.power))
    assert ts2.P_tot == 0.25 and ts2.T_bg == 321.0


# ---------------------------------------------------------------------------
# dissipated power of the blocked solve
# ---------------------------------------------------------------------------

def _heat_params(dev, **kw):
    jp = dev["jbase"].replace(solve_heating_global=True, **kw)
    tp = dataclasses.replace(dev["tbase"], solve_heating_global=True, **kw)
    return jp, tp


_CONVERGED = {}


def _converged(dev, mixed):
    """Both packages' states warm-started from one converged solution (the
    JAX blocked solve at tolerance 1e-13 in the same precision), so that the
    solves below leave at once and what is compared is the power extraction
    alone."""
    from devicekmc_tpu.physics import current as jcur

    if mixed not in _CONVERGED:
        jp = dev["jbase"].replace(transport_precond="deflated", coarse_slabs=8,
                                  mixed=mixed, transport_cc="stored")
        jst, m = jcur.update_power(dev["jg"], jp, dev["js"], VD, cg_tol=1e-13)
        assert bool(m["transport_converged"])
        js = dev["js"].replace(virtual_potentials=jst.virtual_potentials)
        _CONVERGED[mixed] = (js, to_port(dev["jg"], js)[1])
    return _CONVERGED[mixed]


@pytest.mark.parametrize("cc,mixed,tol", [
    ("stored", False, 1e-9), ("stored", True, 2e-6), ("fly", True, 1e-5),
], ids=["stored-f64", "stored-mixed", "fly-mixed"])
@pytest.mark.parametrize("precond", ["jacobi", "deflated"])
def test_update_power_blocked_power_matches_jax(dev, precond, cc, mixed, tol):
    """From the same converged potentials: site power within ``tol`` of its
    largest entry and P_tot within ``tol`` relative.  1e-9 in f64 precision
    (f64 entries, f64 products); 2e-6 in mixed precision with the stored
    blocks (f64 products of f32 entries whose exp and pow differ by an ulp
    between XLA and PyTorch); 1e-5 with the on-the-fly metal block (f32
    throughout in both packages, sums in another order)."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp

    js, ts = _converged(dev, mixed)
    jp, tp = _heat_params(dev, transport_precond=precond, coarse_slabs=8,
                          transport_cc=cc, mixed=mixed)
    jst, jm = jcur.update_power(dev["jg"], jp, js, VD)
    tst, tm = tcur.update_power(dev["tg"], tp, ts, VD)
    assert tm["cg_iters_power"] <= 2 and int(jm["cg_iters_power"]) <= 2
    ref = np.asarray(jst.power)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(tst.power.numpy(), ref, rtol=0, atol=tol * scale)
    assert tst.P_tot == pytest.approx(float(jst.P_tot), rel=tol)
    assert tst.P_tot == float(tst.power.sum())
    assert tm["Total dissipated power [mW]"] == tst.P_tot * 1e3
    assert set(tm) - {"transport_partial_assembly"} == set(jm)
    # metals and the injection / extraction layers dissipate nothing
    ai = dev["tg"].atom_ind.long()
    metal = dev["tg"].metal_mask_table[tst.element[ai].long()]
    assert not tst.power[ai][metal].any() and bool((tst.power[ai][~metal] != 0).any())
    assert wkb_fly_pdisp.launches == 0          # CPU tensors: the plain version


def test_update_power_blocked_power_cold_and_negative_bias(dev):
    """A cold solve in each package at transport_tol 1e-12, Vd of both
    signs: power within 1e-5 of its largest entry (two independent CG
    solutions; the stored blocks)."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu.physics import potential as jpot
    from devicekmc_tpu_torch.physics import current as tcur

    for Vd in (VD, -VD):
        js, _ = jpot.solve_cb_edge(dev["jg"], dev["jp"], dev["js0"], Vd)
        _, ts = to_port(dev["jg"], js)
        jp, tp = _heat_params(dev, transport_tol=1e-12, transport_cc="stored")
        jst, _ = jcur.update_power(dev["jg"], jp, js, Vd)
        tst, tm = tcur.update_power(dev["tg"], tp, ts, Vd)
        assert tm["transport_converged"]
        ref = np.asarray(jst.power)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(tst.power.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_transport_skip_with_heating_keeps_power(dev):
    """A skipped transport step with heating on: power and P_tot of the last
    solve stay in the state, the power key is reported again, and the heat
    phase still runs on them (superstep_impl, events off); the JAX superstep
    reports the same keys."""
    from devicekmc_tpu.physics import heat as jheat
    from devicekmc_tpu.superstep import superstep_impl as jstep
    from devicekmc_tpu_torch.superstep import superstep_impl as tstep

    kw = dict(perturb_structure=False, A=AREA)
    jp, tp = _heat_params(dev, **kw)
    tg, ts = dev["tg"], dev["ts"]
    st1, _, m1 = tstep(tg, tp, ts, VD)
    st2, _, m2 = tstep(tg, tp, st1, VD)
    assert m1["transport_rel0"] != -1.0 and m2["transport_rel0"] == -1.0
    assert st2.power is st1.power and st2.P_tot == st1.P_tot > 0
    assert m2["Total dissipated power [mW]"] == m1["Total dissipated power [mW]"]
    assert "Global temperature [K]" in m2
    jst1, _, jm1 = jstep(dev["jg"], jp, jheat.empty_heat_model(jp), dev["js"], VD)
    _, _, jm2 = jstep(dev["jg"], jp, jheat.empty_heat_model(jp), jst1, VD)
    assert float(jm2["transport_rel0"]) == -1.0
    assert set(m2) - {"transport_partial_assembly", "boundary_converged"} == set(jm2)
    # with a step time the heat phase moves T_bg on the kept power
    from devicekmc_tpu_torch.physics.heat import update_temperature

    st3, m3 = update_temperature(tg, tp, None, st2, 1e-9)
    assert st3.T_bg > st2.T_bg and m3["Total dissipated power [mW]"] == st2.P_tot * 1e3


# ---------------------------------------------------------------------------
# heat model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hs():
    """The stack of tests/test_heat_local.py (6 vacancies, local heating on)
    with seeded site power, in both packages."""
    from devicekmc_tpu.state import build_geometry, build_params, init_state
    from devicekmc_tpu.structure import Element, make_test_structure
    from devicekmc_tpu_torch.state import build_params as tbuild_params

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    elems = s.elements.copy()
    rng = np.random.default_rng(7)
    oxide = np.nonzero(elems == int(Element.O))[0]
    elems[rng.choice(oxide, size=6, replace=False)] = int(Element.VACANCY)
    jcfg, tcfg = configs(s, solve_current=True, solve_heating_local=True, A=AREA)
    jg = build_geometry(elems, s.coords, jcfg)
    jp = build_params(jcfg)
    js = init_state(jg, jcfg, elems)
    power = np.random.default_rng(11).uniform(0, 1e-6, jg.N)
    js = js.replace(power=jnp.asarray(power, jp.dtype))
    tg, ts = to_port(jg, js)
    return dict(s=s, elems=elems, jcfg=jcfg, tcfg=tcfg, jg=jg, jp=jp, js=js,
                tg=tg, ts=ts, tp=tbuild_params(tcfg), nb=np.asarray(jg.neigh_idx))


def _models(hs, method, spans=None):
    from devicekmc_tpu.physics.heat import build_heat_model as jbuild
    from devicekmc_tpu_torch.physics.heat import build_heat_model as tbuild

    jh = jbuild(hs["jg"], hs["jp"], hs["jcfg"], hs["elems"], hs["nb"], method,
                contact_spans=spans)
    th = tbuild(hs["tg"], hs["tp"], hs["tcfg"], hs["elems"], hs["nb"], method,
                contact_spans=spans)
    return jh, th


@pytest.mark.parametrize("spans", [None, "symmetric"], ids=["reference-spans", "symmetric-spans"])
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_build_heat_model_matches_jax(hs, method, spans):
    """Every leaf of the model: integers and masks equal, floats to 1e-12 of
    the largest entry (numpy inverts both; only the casts differ)."""
    from devicekmc_tpu_torch.physics.heat import heat_from_jax_arrays

    if spans == "symmetric":
        # both contacts with their interstitials, as a crossbar-scale caller
        # passes them
        spans = (20, 18)
    jh, th = _models(hs, method, spans)
    for f in ("n_interface", "n_left", "n_right", "method"):
        assert getattr(th, f) == getattr(jh, f), f
    assert th.n_interface > 0
    if spans is not None:
        assert (th.n_left, th.n_right) == spans
    assert th.step_scale == float(jh.step_scale)
    np.testing.assert_array_equal(th.interface_idx.numpy(), np.asarray(jh.interface_idx))
    np.testing.assert_array_equal(th.interface_mask.numpy(), np.asarray(jh.interface_mask))
    for f in ("L_inv", "L_ss_inv", "diag_base"):
        ref = np.asarray(getattr(jh, f))
        got = getattr(th, f).numpy()
        assert got.shape == ref.shape, f
        if ref.size:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max(),
                                       err_msg=f)
    if method == "dense":
        assert th.L_inv.shape == (th.n_interface,) * 2 and float(th.L_inv.abs().max()) > 0
    else:
        assert bool(th.interface_mask.any()) and bool((th.diag_base < 0).any())
    # the JAX model carried across is the same model
    carried = heat_from_jax_arrays(record_dict(jh), hs["tg"])
    for f in ("L_inv", "L_ss_inv", "diag_base", "interface_idx", "interface_mask"):
        assert torch.equal(getattr(carried, f), getattr(th, f).to(getattr(carried, f).dtype)) \
            or np.allclose(getattr(carried, f).numpy(), getattr(th, f).numpy(), rtol=1e-12), f
    assert (carried.method, carried.n_interface) == (th.method, th.n_interface)


def test_contact_span_helpers_match_jax(hs):
    from devicekmc_tpu.physics import heat as jh
    from devicekmc_tpu_torch.physics import heat as th

    e = hs["elems"]
    for m in (1, 5, hs["jcfg"].num_atoms_contact):
        assert th._num_in_contact_left(e, m) == jh._num_in_contact_left(e, m)
        assert th._num_in_contact_right(e, m) == jh._num_in_contact_right(e, m)
    empty = th.empty_heat_model(hs["tp"])
    assert empty.n_interface == 0 and empty.L_inv.shape == (0, 0)


# ---------------------------------------------------------------------------
# global model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ambient", [False, True])
@pytest.mark.parametrize("T_bg,P_tot,dt", [
    (300.0, 0.0, 1e-9), (300.0, 2.5e-4, 3e-8), (347.25, 1e-3, 1e-12), (310.0, 5e-5, 1e-3),
])
def test_global_ode_matches_jax(hs, T_bg, P_tot, dt, ambient):
    """rel 1e-12 (exp differs by an ulp between XLA and numpy); the source
    term's coupling to the current T_bg (the reference's quirk) makes T_bg
    rise monotonically under power."""
    from devicekmc_tpu.physics.heat import global_ode as jode
    from devicekmc_tpu_torch.physics.heat import global_ode as tode

    ref = float(jode(hs["jp"], jnp.asarray(T_bg), jnp.asarray(P_tot), jnp.asarray(dt),
                     ambient))
    got = tode(hs["tp"], T_bg, P_tot, dt, ambient)
    assert got == pytest.approx(ref, rel=1e-12)
    if not ambient:
        assert got >= T_bg and (got > T_bg) == (P_tot > 0)


def test_update_temperature_global_matches_jax(hs):
    from devicekmc_tpu.physics.heat import update_temperature as jupd
    from devicekmc_tpu_torch.physics.heat import update_temperature as tupd

    jp = hs["jp"].replace(solve_heating_global=True)
    tp = dataclasses.replace(hs["tp"], solve_heating_global=True)
    jst, jm = jupd(hs["jg"], jp, None, hs["js"], jnp.asarray(2e-8))
    tst, tm = tupd(hs["tg"], tp, None, hs["ts"], 2e-8)
    assert set(tm) == set(jm)
    assert tst.T_bg == pytest.approx(float(jst.T_bg), rel=1e-12) and tst.T_bg > 300.0
    assert tst.P_tot == pytest.approx(float(jst.P_tot), rel=1e-13)
    assert tm["Total dissipated power [mW]"] == pytest.approx(
        float(jm["Total dissipated power [mW]"]), rel=1e-13)
    assert tm["Global temperature [K]"] == tst.T_bg
    # heating off: the state passes through
    st, m = tupd(hs["tg"], dataclasses.replace(hs["tp"], solve_heating_local=False),
                 None, hs["ts"], 2e-8)
    assert st is hs["ts"] and m == {}


# ---------------------------------------------------------------------------
# local model
# ---------------------------------------------------------------------------

# 2.5 and 3.0 (an exact multiple) x delta_t: transient, floor(.) + 1 substeps;
# 999 x: still transient, 1000 substeps; 5e3 x: the steady branch
@pytest.mark.parametrize("mult,branch", [(2.5, "transient"), (3.0, "transient"),
                                         (999.0, "transient"), (5e3, "steady")])
def test_update_temperature_local_matches_jax(hs, mult, branch):
    """Dense propagators: temperature to rtol 1e-10 (the JAX test's own
    tolerance against its oracle), T_bg to 1e-12."""
    from devicekmc_tpu.physics.heat import update_temperature_local as jupd
    from devicekmc_tpu_torch.physics import heat as theat

    jh, th = _models(hs, "dense")
    step_time = mult * hs["jcfg"].delta_t
    jst, jm = jupd(hs["jg"], hs["jp"], jh, hs["js"], jnp.asarray(step_time, hs["jp"].dtype))
    tst, tm = theat.update_temperature_local(hs["tg"], hs["tp"], th, hs["ts"], step_time)
    assert theat.last_local["branch"] == branch
    if branch == "transient":
        assert theat.last_local["substeps"] == \
            int(np.floor(np.float64(step_time) / np.float64(hs["jcfg"].delta_t))) + 1
    ref = np.asarray(jst.temperature)
    assert np.abs(ref - 300.0).max() > 0
    np.testing.assert_allclose(tst.temperature.numpy(), ref, rtol=1e-10, atol=1e-10)
    assert tst.T_bg == pytest.approx(float(jst.T_bg), rel=1e-12)
    assert set(tm) == set(jm) and tm["Global temperature [K]"] == tst.T_bg
    # sites outside the interface keep their temperature
    outside = np.ones(hs["tg"].N, bool)
    outside[th.interface_idx.numpy()] = False
    assert bool((tst.temperature[torch.as_tensor(outside)] == 300.0).all())


def test_laplacian_apply_matches_jax(hs):
    from devicekmc_tpu.physics.heat import _laplacian_apply as jlap
    from devicekmc_tpu_torch.physics.heat import _laplacian_apply as tlap

    jh, th = _models(hs, "cg")
    x = np.random.default_rng(2).standard_normal(hs["tg"].N)
    ref = np.asarray(jlap(hs["jg"], jh, jnp.asarray(x)))
    got = tlap(hs["tg"], th, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13 * np.abs(ref).max())
    assert (got[~th.interface_mask.numpy()] == 0).all()


@pytest.mark.parametrize("mult", [2.5, 3.0, 5e3])
def test_update_temperature_local_cg_matches_jax_and_dense(hs, mult):
    """Matrix-free model: against the JAX matrix-free model to rtol 1e-9 (two
    CG runs at tolerance 1e-12 with sums in another order) and against the
    port's dense model at the JAX test's tolerance (rtol 1e-7, atol 1e-8)."""
    from devicekmc_tpu.physics.heat import update_temperature_local_cg as jcg
    from devicekmc_tpu_torch.physics import heat as theat

    jh, th = _models(hs, "cg")
    _, td = _models(hs, "dense")
    step_time = mult * hs["jcfg"].delta_t
    jst, _ = jcg(hs["jg"], hs["jp"], jh, hs["js"], jnp.asarray(step_time), tol=1e-12)
    tst, tm = theat.update_temperature_local_cg(hs["tg"], hs["tp"], th, hs["ts"],
                                                step_time, tol=1e-12)
    assert theat.last_local["cg_iters"] > 0
    assert theat.last_local["branch"] == ("steady" if mult > 1e3 else "transient")
    dst, _ = theat.update_temperature_local(hs["tg"], hs["tp"], td, hs["ts"], step_time)
    np.testing.assert_allclose(tst.temperature.numpy(), np.asarray(jst.temperature),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tst.temperature.numpy(), dst.temperature.numpy(),
                               rtol=1e-7, atol=1e-8)
    assert tst.T_bg == pytest.approx(float(jst.T_bg), rel=1e-9)
    assert tm["Global temperature [K]"] == tst.T_bg


@pytest.mark.parametrize("method", ["dense", "cg"])
def test_update_temperature_dispatch_local(hs, method):
    """update_temperature picks the model's method; the global model takes
    precedence over the local one."""
    from devicekmc_tpu.physics.heat import update_temperature as jupd
    from devicekmc_tpu_torch.physics.heat import update_temperature as tupd

    jh, th = _models(hs, method)
    dt = 2.5 * hs["jcfg"].delta_t
    jst, _ = jupd(hs["jg"], hs["jp"], jh, hs["js"], jnp.asarray(dt))
    tst, _ = tupd(hs["tg"], hs["tp"], th, hs["ts"], dt)
    np.testing.assert_allclose(tst.temperature.numpy(), np.asarray(jst.temperature),
                               rtol=1e-9, atol=1e-9)
    both = dataclasses.replace(hs["tp"], solve_heating_global=True)
    st, m = tupd(hs["tg"], both, th, hs["ts"], dt)
    assert "Total dissipated power [mW]" in m
    assert torch.equal(st.temperature, hs["ts"].temperature)


def test_heat_refuses_tf32(hs):
    """The f32 propagator products must be IEEE f32."""
    from devicekmc_tpu_torch.physics import heat as theat

    _, th = _models(hs, "dense")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            theat.update_temperature_local(hs["tg"], hs["tp"], th, hs["ts"], 1e-13)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
