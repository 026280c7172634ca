"""The blocked transport path of the port against the JAX package: the
mixed-precision CG, the CB-edge solve, the operator's pieces, its products,
the solve (I_macro), the persistent tunnel blocks, the unchanged-network
skip and the engine's chunked cold solves.  Inputs are carried across with
from_jax_arrays; Pallas kernels run in interpret mode."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import configs, to_port

torch.set_num_threads(1)

VD = 2.0


# ---------------------------------------------------------------------------
# cg_solve_mixed
# ---------------------------------------------------------------------------

def _spd(n=120, seed=1):
    rng = np.random.default_rng(seed)
    Qm = rng.standard_normal((n, n))
    A = Qm @ Qm.T + n * np.eye(n)
    return A, rng.standard_normal(n), rng.standard_normal(n) * 1e-3


@pytest.mark.parametrize("variant", ["plain", "jacobi", "gated"])
def test_cg_solve_mixed_matches_jax(variant):
    """Same SPD system: x to 1e-9 relative, the same converged flag, inner
    iterations within 2 (f32 dot products sum in another order)."""
    from devicekmc_tpu.ops.cg import cg_solve_mixed as jmixed
    from devicekmc_tpu_torch.ops.cg import cg_solve_mixed as tmixed

    A, b, x0 = _spd()
    dinv = 1.0 / np.diag(A)
    ja, ja32 = jnp.asarray(A), jnp.asarray(A, jnp.float32)
    ta, ta32 = torch.as_tensor(A), torch.as_tensor(A).float()
    jkw, tkw = {}, {}
    if variant == "jacobi":
        jkw = dict(diag=jnp.asarray(np.diag(A)))
        tkw = dict(diag=torch.as_tensor(np.diag(A).copy()))
    elif variant == "gated":
        jd, td = jnp.asarray(dinv, jnp.float32), torch.as_tensor(dinv).float()
        jkw = dict(
            inner_precond=lambda r, g: jnp.where(g, jd * r, r),
            inner_start=lambda bb, g: jnp.where(g, 0.5 * jd * bb, 0.0 * bb),
            inner_gate_rel=1e-6,
        )
        tkw = dict(
            inner_precond=lambda r, g: td * r if g else r,
            inner_start=lambda bb, g: 0.5 * td * bb if g else 0.0 * bb,
            inner_gate_rel=1e-6,
        )
    ref = jmixed(lambda x: ja @ x, lambda x: ja32 @ x, jnp.asarray(b),
                 x0=jnp.asarray(x0), tol=1e-12, inner_tol=1e-5, **jkw)
    got = tmixed(lambda x: ta @ x, lambda x: ta32 @ x, torch.as_tensor(b),
                 x0=torch.as_tensor(x0), tol=1e-12, inner_tol=1e-5, **tkw)
    assert got.converged and bool(ref.converged)
    assert abs(got.iters - int(ref.iters)) <= 2
    assert got.rel0 == pytest.approx(float(ref.rel0), rel=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-9,
                               atol=1e-9 * np.abs(np.asarray(ref.x)).max())


def test_cg_solve_mixed_leaves_unconverged_below_maxiter():
    """max_outer binds: the solver leaves with fewer iterations than maxiter
    and says so through ``converged``, in both packages."""
    from devicekmc_tpu.ops.cg import cg_solve_mixed as jmixed
    from devicekmc_tpu_torch.ops.cg import cg_solve_mixed as tmixed

    A, b, _ = _spd()
    ja, ja32 = jnp.asarray(A), jnp.asarray(A, jnp.float32)
    ta, ta32 = torch.as_tensor(A), torch.as_tensor(A).float()
    kw = dict(tol=1e-13, inner_tol=1e-2, max_outer=2, inner_maxiter=3, maxiter=1000)
    ref = jmixed(lambda x: ja @ x, lambda x: ja32 @ x, jnp.asarray(b), **kw)
    got = tmixed(lambda x: ta @ x, lambda x: ta32 @ x, torch.as_tensor(b), **kw)
    assert not got.converged and not bool(ref.converged)
    assert got.iters == int(ref.iters) == 6 < 1000


# ---------------------------------------------------------------------------
# one small device, bias applied, in both packages
# ---------------------------------------------------------------------------

def _tparams(tcfg, **kw):
    from devicekmc_tpu_torch.state import build_params

    return dataclasses.replace(build_params(tcfg), **kw)


@pytest.fixture(scope="module")
def dev():
    """The small stack of tests/test_wkb_fly.py (8 vacancies, heating off)
    after the charge rule and the CB-edge solve at Vd = 2 V."""
    from devicekmc_tpu.physics import charge as jcharge
    from devicekmc_tpu.physics import potential as jpot
    from devicekmc_tpu.state import build_geometry, build_params, init_state
    from devicekmc_tpu.structure import Element, make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    jcfg, tcfg = configs(s, pbc=False, solve_current=True, transport="blocked")
    elems = s.elements.copy()
    rng = np.random.default_rng(7)
    oxide = np.nonzero(elems == int(Element.O))[0]
    elems[rng.choice(oxide, size=8, replace=False)] = int(Element.VACANCY)
    jg = build_geometry(elems, s.coords, jcfg)
    jp = build_params(jcfg)
    js = init_state(jg, jcfg, elems)
    js, _ = jcharge.update_charge(jg, js)
    js0 = js
    js, _ = jpot.solve_cb_edge(jg, jp, js, VD)
    n_vac = int((elems[np.asarray(jg.atom_ind)] == int(Element.VACANCY)).sum())
    vcap = max(16, n_vac + 4)
    jbase = jp.replace(transport="blocked", tunnel_vac_cap=vcap, mixed=True)
    tg, ts = to_port(jg, js)
    tbase = _tparams(tcfg, transport="blocked", tunnel_vac_cap=vcap, mixed=True)
    return dict(jg=jg, jp=jp, js=js, js0=js0, jbase=jbase, tg=tg, ts=ts,
                tbase=tbase, tcfg=tcfg, n_vac=n_vac, s=s, elems=elems)


def test_geometry_and_state_carry_transport_fields(dev):
    """build_geometry of the port gives the JAX package's transport
    geometry; from_jax_arrays carries the transport state."""
    from devicekmc_tpu_torch.state import build_geometry, init_state

    s, jg = dev["s"], dev["jg"]
    tg = build_geometry(dev["elems"], s.coords, dev["tcfg"], device="cpu")
    for f in ("atom_ind", "atom_metalp_idx", "atom_metalp_inv", "atom_neigh_idx",
              "left_mask", "right_mask", "interior_mask"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    ts = init_state(tg, dev["tcfg"], dev["elems"])
    assert ts.virtual_potentials.shape == (tg.N_atom + 2,)
    assert not ts.tt_valid and np.isnan(ts.transport_Vd_prev)
    np.testing.assert_array_equal(dev["ts"].CB_edge.numpy(), np.asarray(dev["js"].CB_edge))


@pytest.mark.parametrize("precond", ["jacobi", "deflated"])
def test_solve_cb_edge_matches_jax(dev, precond):
    """CB edge to 1e-9 of its scale (q * Vd / 2), iterations within 1 (the
    tolerance of test_torch_solvers.py's Laplace solves)."""
    from devicekmc_tpu.physics.potential import solve_cb_edge as jsolve
    from devicekmc_tpu_torch.physics.potential import solve_cb_edge as tsolve

    jp = dev["jp"].replace(boundary_precond=precond, coarse_slabs=4, solver_tol=1e-10)
    tp = dataclasses.replace(dev["tbase"], boundary_precond=precond, coarse_slabs=4,
                             solver_tol=1e-10)
    tg, ts0 = to_port(dev["jg"], dev["js0"])
    ref, jm = jsolve(dev["jg"], jp, dev["js0"], VD)
    got, tm = tsolve(tg, tp, ts0, VD)
    assert tm["cb_edge_converged"]
    assert tm["cg_iters_cb_edge"] > 0
    assert abs(tm["cg_iters_cb_edge"] - int(jm["cg_iters_cb_edge"])) <= 1
    scale = 1.60217663e-19 * VD / 2
    np.testing.assert_allclose(got.CB_edge.numpy(), np.asarray(ref.CB_edge),
                               rtol=1e-9, atol=1e-9 * scale)


@pytest.fixture(scope="module")
def blocks(dev):
    """assemble_X_blocks of both packages with the stored metal block and
    the static band."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    jband = jcur.build_banded_nb(dev["jg"], dev["jbase"], dev["js"])
    tband = tcur.build_banded_nb(dev["tg"], dev["tbase"], dev["ts"])
    jblk = jcur.assemble_X_blocks(dev["jg"], dev["jbase"], dev["js"], band=jband)
    tblk = tcur.assemble_X_blocks(dev["tg"], dev["tbase"], dev["ts"], band=tband)
    return jblk, tblk, jband, tband


def test_build_banded_nb_matches_jax(blocks):
    """The port's band, built from the atom graph without the dense blocks,
    is band_slots of the JAX package's dense band bit for bit."""
    from devicekmc_tpu_torch.ops.banded import band_slots

    _, _, jband, tband = blocks
    ref = band_slots(np.asarray(jband["C"]))
    got = tband["slots"]
    assert got.shape == ref.shape == tuple(jband["C"].shape[:3])
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(tband["pi"].numpy(), np.asarray(jband["pi"]))
    np.testing.assert_array_equal(tband["inv"].numpy(), np.asarray(jband["inv"]))
    assert tband["front"] == jband["front"].shape[0]


def test_assemble_X_blocks_matches_jax(blocks):
    """Exact pieces equal or to f64 round-off; f32 tunnel blocks within
    1e-5 of their largest entry (exp, sqrt and pow differ by an ulp between
    XLA and PyTorch; the window block also spells x**1.5 as x*sqrt(x))."""
    jblk, tblk, _, _ = blocks
    for k in ("vidx", "v_ok", "nb_safe", "band_vnb_safe", "mp"):
        np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jblk[k]), k)
    assert tblk["int_steps_needed"] == int(jblk["int_steps_needed"])
    for k in ("nb_vals", "src_vals", "gnd_vals", "band_dyn_vals"):
        np.testing.assert_array_equal(tblk[k].numpy(), np.asarray(jblk[k]), k)
    # the diagonal is the exact neighbour part plus f32 sums of the f32
    # tunnel rows: rows without a tunnel part to f64 round-off, all rows to
    # f32 round-off
    tunnel = np.zeros(tblk["diag"].shape[0], bool)
    tunnel[2 + tblk["mp"].numpy()] = True
    tunnel[2 + tblk["vidx"].numpy()[tblk["v_ok"].numpy()]] = True
    got_d, ref_d = tblk["diag"].numpy(), np.asarray(jblk["diag"])
    assert (~tunnel).sum() > 10
    np.testing.assert_allclose(got_d[~tunnel], ref_d[~tunnel], rtol=1e-12)
    np.testing.assert_allclose(got_d, ref_d, rtol=2e-6)
    assert tblk["loop_G"] == float(jblk["loop_G"])
    for k in ("T_vv", "T_vm", "T_cc"):
        ref = np.asarray(jblk[k])
        assert tblk[k].dtype == torch.float32 and np.abs(ref).max() > 0
        np.testing.assert_allclose(tblk[k].numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def test_assemble_fly_has_no_cc_block_and_needs_f32(dev):
    from devicekmc_tpu_torch.physics import current as tcur

    fly = dataclasses.replace(dev["tbase"], transport_cc="fly")
    assert tcur.assemble_cc_block(dev["tg"], fly, dev["ts"]) is None
    blk = tcur.assemble_X_blocks(dev["tg"], fly, dev["ts"])
    assert blk["T_cc"] is None and "fly" in blk
    with pytest.raises(ValueError, match="transport_cc='fly'"):
        tcur.assemble_X_blocks(dev["tg"], dataclasses.replace(fly, mixed=False), dev["ts"])


@pytest.mark.parametrize("wd,tol", [("float32", 2e-6), ("float64", 1e-9)])
@pytest.mark.parametrize("use_band", [False, True])
def test_apply_X_blocks_matches_jax(blocks, wd, tol, use_band):
    """y = X x on a seeded vector: f64 path to 1e-9 of max|y|, f32 path to
    2e-6 (f32 sums in another order), with the ELL gather and with the
    banded operator."""
    from devicekmc_tpu.physics.current import _apply_X_blocks as japply
    from devicekmc_tpu_torch.physics.current import _apply_X_blocks as tapply

    jblk, tblk, _, _ = blocks
    if not use_band:
        jblk = {k: v for k, v in jblk.items() if k != "band"}
        tblk = {k: v for k, v in tblk.items() if k != "band"}
    n = tblk["diag"].shape[0]
    x = np.random.default_rng(5).standard_normal(n)
    ref = np.asarray(japply(jblk, jnp.asarray(x), getattr(jnp, wd)))
    got = tapply(tblk, torch.as_tensor(x), getattr(torch, wd)).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_apply_X_blocks_mat_matches_jax(blocks):
    from devicekmc_tpu.physics.current import _apply_X_blocks_mat as japply
    from devicekmc_tpu_torch.physics.current import _apply_X_blocks_mat as tapply

    jblk, tblk, _, _ = blocks
    n = tblk["diag"].shape[0]
    X = np.random.default_rng(6).standard_normal((n, 5))
    ref = np.asarray(japply(jblk, jnp.asarray(X), jnp.float64))
    got = tapply(tblk, torch.as_tensor(X), torch.float64).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.abs(ref).max())
    # column k of the multi-RHS product is the single-vector product
    from devicekmc_tpu_torch.physics.current import _apply_X_blocks as tvec

    one = tvec(tblk, torch.as_tensor(X[:, 2].copy()), torch.float64).numpy()
    np.testing.assert_allclose(got[:, 2], one, rtol=0, atol=1e-9 * np.abs(ref).max())


def test_coarse_restriction_matches_jax(dev):
    from devicekmc_tpu.physics.current import _coarse_restriction as jr
    from devicekmc_tpu_torch.physics.current import _coarse_restriction as tr

    for kw in (dict(coarse_slabs=8, coarse_yz=1), dict(coarse_slabs=4, coarse_yz=2)):
        ref = np.asarray(jr(dev["jg"], dev["jbase"].replace(**kw)))
        got = tr(dev["tg"], dataclasses.replace(dev["tbase"], **kw)).numpy()
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def direct_I(dev):
    from devicekmc_tpu.physics import current as jcur

    st, _ = jcur.update_power(dev["jg"], dev["jp"], dev["js"], VD, method="direct")
    return float(st.I_macro)


@pytest.mark.parametrize("cc", ["stored", "fly"])
@pytest.mark.parametrize("precond", ["jacobi", "deflated"])
def test_update_power_blocked_matches_jax(dev, direct_I, precond, cc):
    """I_macro within 1e-5 of the JAX blocked solve and 2e-4 of the JAX
    dense direct solve (the envelope of tests/test_wkb_fly.py at the default
    transport_tol 1e-8); both converge; iteration counts are reported."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    kw = dict(transport_precond=precond, coarse_slabs=8, transport_cc=cc)
    jst, jm = jcur.update_power(dev["jg"], dev["jbase"].replace(**kw), dev["js"], VD)
    tst, tm = tcur.update_power(dev["tg"], dataclasses.replace(dev["tbase"], **kw),
                                dev["ts"], VD)
    print(f"cg_iters_power {precond}/{cc}: jax {int(jm['cg_iters_power'])}, "
          f"port {tm['cg_iters_power']}")
    assert tm["transport_converged"] and bool(jm["transport_converged"])
    assert tst.I_macro > 0
    assert tst.I_macro == pytest.approx(float(jst.I_macro), rel=1e-5)
    assert tst.I_macro == pytest.approx(direct_I, rel=2e-4)
    assert tm["Current [uA]"] == pytest.approx(tst.I_macro * 1e6)
    assert set(tm) - {"transport_partial_assembly"} == set(jm)
    assert tm["n_vac_atoms"] == int(jm["n_vac_atoms"]) == dev["n_vac"]
    assert tm["tunnel_int_steps_needed"] == int(jm["tunnel_int_steps_needed"])
    assert float(tst.power.abs().max()) == 0.0


def test_update_power_f64_matches_jax(dev):
    """Pure f64 (no mixed refinement, f64 tunnel entries through
    tunnel_block): I_macro to 1e-7 at transport_tol 1e-12."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    kw = dict(mixed=False, transport_precond="jacobi", transport_tol=1e-12,
              transport_cc="stored")
    jst, _ = jcur.update_power(dev["jg"], dev["jbase"].replace(**kw), dev["js"], VD)
    tst, tm = tcur.update_power(dev["tg"], dataclasses.replace(dev["tbase"], **kw),
                                dev["ts"], VD)
    assert tm["transport_converged"]
    assert tst.I_macro == pytest.approx(float(jst.I_macro), rel=1e-7)


def test_unported_options_raise(dev):
    """No option raises "not ported" any longer: dense transport, global and
    local heating solve, and so does transport_bf16_inner, whose solve
    matches the JAX package's bf16 inner solve (I_macro within 2e-5: see
    tests/test_torch_bf16_inner.py) and the dense direct solve (2e-4)."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    dense = dataclasses.replace(dev["tbase"], transport="dense", tunnel_int_steps=256)
    st, m = tcur.update_power(dev["tg"], dense, dev["ts"], VD)
    assert m["transport_converged"] and st.I_macro > 0
    bf16 = dataclasses.replace(dev["tbase"], transport_bf16_inner=True)
    st, m = tcur.update_power_blocked(dev["tg"], bf16, dev["ts"], VD)
    jst, jm = jcur.update_power_blocked(
        dev["jg"], dev["jbase"].replace(transport_bf16_inner=True), dev["js"], VD)
    assert m["transport_converged"] and bool(jm["transport_converged"])
    assert st.I_macro == pytest.approx(float(jst.I_macro), rel=2e-5)
    st_d, _ = tcur.update_power(dev["tg"], bf16, dev["ts"], VD, method="direct")
    assert st.I_macro == pytest.approx(st_d.I_macro, rel=2e-4)
    st, m = tcur.update_power_blocked(
        dev["tg"], dataclasses.replace(dev["tbase"], solve_heating_global=True),
        dev["ts"], VD)
    assert float(st.power.abs().max()) > 0 and st.P_tot > 0
    assert m["Total dissipated power [mW]"] == st.P_tot * 1e3


def test_resolvers_match_jax(dev):
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    for args in (("stored", 10 ** 6, True), ("fly", 10, True), ("auto", 24_768, True),
                 ("auto", 112_000, True), ("auto", 112_000, False)):
        assert tcur.resolve_transport_cc(*args) == jcur.resolve_transport_cc(*args)
    n_mp = int(dev["tg"].atom_metalp_idx.shape[0])
    tp, jp = dev["tbase"], dev["jbase"]
    for mode in ("auto", "on", "off"):
        assert tcur.resolve_transport_incremental(mode, tp, n_mp) == \
            jcur.resolve_transport_incremental(mode, jp, n_mp)
    big = dataclasses.replace(tp, tunnel_vac_cap=1 << 20)
    assert not tcur.resolve_transport_incremental("auto", big, 1 << 20)
    with pytest.raises(ValueError):
        tcur.resolve_transport_incremental(
            "on", dataclasses.replace(tp, transport="dense"), n_mp)


# ---------------------------------------------------------------------------
# skip branch
# ---------------------------------------------------------------------------

def test_skip_unchanged_network(dev):
    """allow_skip: the second call on an unchanged network reuses the stored
    solution (same metric keys, -1 sentinels, 0 iterations, the state object
    itself); a changed element or bias solves again."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur
    from devicekmc_tpu_torch.structure import Element

    tg, tp = dev["tg"], dev["tbase"]
    st1, m1 = tcur.update_power(tg, tp, dev["ts"], VD, allow_skip=True)
    assert m1["cg_iters_power"] > 0 and m1["transport_partial_assembly"] == 0
    st2, m2 = tcur.update_power(tg, tp, st1, VD, allow_skip=True)
    assert st2 is st1
    assert set(m2) == set(m1)
    assert m2["cg_iters_power"] == 0 and m2["transport_converged"] is True
    assert m2["transport_rel0"] == -1.0 and m2["tunnel_int_steps_needed"] == -1
    assert m2["transport_partial_assembly"] == -1
    assert m2["Current [uA]"] == m1["Current [uA]"]
    assert m2["contact_potential_drop"] == pytest.approx(m1["contact_potential_drop"])
    # the JAX package's skip reports the same keys and sentinels
    jst1, _ = jcur.update_power(dev["jg"], dev["jbase"], dev["js"], VD, allow_skip=True)
    _, jm2 = jcur.update_power(dev["jg"], dev["jbase"], jst1, VD, allow_skip=True)
    assert set(jm2) == set(m2) - {"transport_partial_assembly"}
    assert float(jm2["transport_rel0"]) == -1.0 and int(jm2["cg_iters_power"]) == 0
    # a changed bias, or one changed atom element, solves again
    _, m3 = tcur.update_power(tg, tp, st1, VD + 0.5, allow_skip=True)
    assert m3["transport_rel0"] != -1.0
    elem = st1.element.clone()
    ox = int(torch.nonzero(elem == int(Element.O))[0])
    elem[ox] = int(Element.VACANCY)
    _, m4 = tcur.update_power(tg, tp, dataclasses.replace(st1, element=elem), VD,
                              allow_skip=True)
    assert m4["transport_rel0"] != -1.0 and m4["n_vac_atoms"] == m1["n_vac_atoms"] + 1
    # allow_skip off (cold pre-solves) always solves
    _, m5 = tcur.update_power(tg, tp, st1, VD)
    assert m5["transport_rel0"] != -1.0
    _, m6 = tcur.update_power(
        tg, dataclasses.replace(tp, transport_skip_unchanged=False), st1, VD,
        allow_skip=True)
    assert m6["transport_rel0"] != -1.0


# ---------------------------------------------------------------------------
# persistent tunnel blocks
# ---------------------------------------------------------------------------

def _port_sim(incremental, delta_cap=16, vcap=32, Vd=8.0):
    """The stack of tests/test_transport_incremental.py in the port, heating
    off, after the bias-start CB-edge solve."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.physics.potential import solve_cb_edge
    from devicekmc_tpu_torch.state import (
        attach_tunnel_state, build_geometry, build_params, init_state,
    )
    from devicekmc_tpu_torch.structure import Element, make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=3, nz=3, seed=3)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0, pbc=False,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=True, perturb_structure=True,
        transport="blocked", tunnel_vac_cap=vcap, precision="mixed",
    )
    elems = s.elements.copy()
    rng = np.random.default_rng(7)
    oxide = np.nonzero(elems == int(Element.O))[0]
    elems[rng.choice(oxide, size=10, replace=False)] = int(Element.VACANCY)
    geom = build_geometry(elems, s.coords, cfg, device="cpu")
    params = dataclasses.replace(
        build_params(cfg), transport_incremental=incremental,
        transport_delta_cap=delta_cap)
    state = attach_tunnel_state(init_state(geom, cfg, elems), geom, params)
    state, _ = solve_cb_edge(geom, params, state, Vd)
    return geom, params, state


def _steps(geom, params, state, n, Vd=8.0):
    from devicekmc_tpu_torch.superstep import superstep_impl

    ms = []
    for _ in range(n):
        state, _, m = superstep_impl(geom, params, state, Vd)
        ms.append(m)
    return state, ms


def _full_blocks(geom, params, state):
    from devicekmc_tpu_torch.physics.current import assemble_X_blocks

    return assemble_X_blocks(
        geom, dataclasses.replace(params, transport_incremental=False), state)


def test_incremental_store_bit_identical_to_full_assembly():
    """Through supersteps with events the stored blocks equal the
    from-scratch assembly of the same state bit for bit, a partial assembly
    was taken, and the trajectory equals the one with the store off."""
    geom, params, state = _port_sim(True)
    partial = events = 0
    for _ in range(6):
        state, (m,) = _steps(geom, params, state, 1)
        events += int(m["n_events"])
        partial += m["transport_partial_assembly"] == 1
        if m["transport_partial_assembly"] >= 0:
            full = _full_blocks(geom, params, state)
            assert torch.equal(state.tt_vm, full["T_vm"])
            assert torch.equal(state.tt_vv, full["T_vv"])
            assert torch.equal(state.tt_slot_atom.long(),
                               torch.where(full["v_ok"], full["vidx"], -1))
    assert events >= 3 and partial >= 1 and state.tt_valid
    occ = state.tt_slot_atom[state.tt_slot_atom >= 0]
    assert bool((occ[1:] > occ[:-1]).all())                 # ascending, unique
    g2, p2, s2 = _port_sim(False)
    s2, ms2 = _steps(g2, p2, s2, 6)
    assert torch.equal(state.element, s2.element)
    assert state.I_macro == s2.I_macro
    assert torch.equal(state.virtual_potentials, s2.virtual_potentials)
    assert all(m["transport_partial_assembly"] <= 0 for m in ms2)


def test_incremental_delta_cap_overflow_falls_back():
    """delta_cap = 0: any atom entering the bucket forces the full rebuild;
    the result is that of the store off."""
    g1, p1, s1 = _port_sim(True, delta_cap=0)
    s1, ms = _steps(g1, p1, s1, 6)
    g2, p2, s2 = _port_sim(False)
    s2, _ = _steps(g2, p2, s2, 6)
    assert sum(int(m["n_events"]) for m in ms) >= 3
    assert torch.equal(s1.element, s2.element)
    assert s1.I_macro == s2.I_macro
    assert torch.equal(s1.virtual_potentials, s2.virtual_potentials)
    full = _full_blocks(g1, p1, s1)
    assert torch.equal(s1.tt_vm, full["T_vm"])


def test_incremental_invalidation_rebuilds():
    """tt_valid False (bias boundary, cap growth) rebuilds every row and
    leaves the state of a run that never invalidated."""
    geom, params, state = _port_sim(True)
    state, _ = _steps(geom, params, state, 3)
    nan = float("nan")
    garbage = dataclasses.replace(
        state, tt_valid=False, transport_Vd_prev=nan,
        tt_vm=torch.full_like(state.tt_vm, 7.0), tt_vv=torch.full_like(state.tt_vv, 7.0))
    st1, m1 = _steps(geom, params, garbage, 1)
    st2, m2 = _steps(geom, params, dataclasses.replace(state, transport_Vd_prev=nan), 1)
    assert m1[0]["transport_partial_assembly"] == 0
    for f in ("element", "virtual_potentials", "tt_vm", "tt_vv"):
        assert torch.equal(getattr(st1, f), getattr(st2, f)), f
    assert st1.I_macro == st2.I_macro


# ---------------------------------------------------------------------------
# the engine's chunked cold solves loop on `converged`
# ---------------------------------------------------------------------------

def _engine(tmp_path, **kw):
    from devicekmc_tpu_torch.engine import Simulation
    from torch_parity import small_structure

    s = small_structure()
    _, tcfg = configs(
        s, pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
        rnd_seed_kmc=7, precision="mixed", solve_current=True, transport="blocked",
        V_switch=[VD], t_switch=[1e30], output_dir=str(tmp_path), **kw)
    return Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu")


def test_chunked_solves_end_on_exact_chunk(tmp_path):
    """A cold solve that converges in exactly ``chunk`` iterations is one
    segment: no further segment is run (the count alone would ask for
    one)."""
    from devicekmc_tpu_torch.physics import potential as tpot
    from devicekmc_tpu_torch.state import replace

    sim = _engine(tmp_path)
    st0 = sim.state
    n_cb = sim._chunked_cb_edge(VD, 10 ** 6)
    sim.state = st0
    n_b = sim._chunked_boundary(VD, 10 ** 6, replace(sim.params, boundary_precond="deflated"))
    assert n_cb > 1 and n_b > 1
    calls = {"cb": 0, "b": 0}
    real_cb, real_b = tpot.solve_cb_edge, tpot.solve_boundary_potential

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    tpot.solve_cb_edge = count("cb", real_cb)
    tpot.solve_boundary_potential = count("b", real_b)
    try:
        sim.state = st0
        assert sim._chunked_cb_edge(VD, n_cb) == n_cb
        sim.state = st0
        assert sim._chunked_boundary(
            VD, n_b, replace(sim.params, boundary_precond="deflated")) == n_b
        assert calls == {"cb": 1, "b": 1}
        # one iteration short: the first segment stops at the cap
        # unconverged and a second one finishes
        sim.state = st0
        sim._chunked_cb_edge(VD, n_cb - 1)
        sim.state = st0
        sim._chunked_boundary(VD, n_b - 1, replace(sim.params, boundary_precond="deflated"))
        assert calls["cb"] >= 3 and calls["b"] >= 3
    finally:
        tpot.solve_cb_edge, tpot.solve_boundary_potential = real_cb, real_b


def test_chunked_loops_never_take_an_unconverged_segment(tmp_path):
    """Scripted segments: fewer iterations than ``chunk`` with
    converged=False (cg_solve_mixed leaving at max_outer) goes on; the loop
    ends only on converged=True."""
    from devicekmc_tpu_torch.physics import current as tcur
    from devicekmc_tpu_torch.physics import potential as tpot

    sim = _engine(tmp_path)
    script = [(3, False), (50, False), (0, False), (7, True), (1, True)]

    def scripted(key_iters, key_conv):
        it = iter(script)

        def fn(geom, params, state, Vd, **kw):
            iters, conv = next(it)
            return state, {key_iters: iters, key_conv: conv}
        return fn

    saved = tpot.solve_cb_edge, tpot.solve_boundary_potential, tcur.update_power
    try:
        tpot.solve_cb_edge = scripted("cg_iters_cb_edge", "cb_edge_converged")
        assert sim._chunked_cb_edge(VD, 50) == 60
        tpot.solve_boundary_potential = scripted("cg_iters_boundary", "boundary_converged")
        assert sim._chunked_boundary(VD, 50) == 60
        tcur.update_power = scripted("cg_iters_power", "transport_converged")
        assert sim._chunked_transport(VD, 50) == 60
    finally:
        tpot.solve_cb_edge, tpot.solve_boundary_potential, tcur.update_power = saved


def test_boundary_metrics_report_converged(dev):
    """solve_boundary_potential reports the CG's flag: True after a solve
    that met the tolerance and on the skip path, False at the iteration
    cap."""
    from devicekmc_tpu_torch.physics.potential import solve_boundary_potential

    tg, tp, ts = dev["tg"], dev["tbase"], dev["ts"]
    st, m = solve_boundary_potential(tg, tp, ts, VD)
    assert m["cg_iters_boundary"] > 2 and m["boundary_converged"] is True
    _, m2 = solve_boundary_potential(tg, tp, st, VD)
    assert m2["cg_iters_boundary"] == 0 and m2["boundary_converged"] is True
    _, m3 = solve_boundary_potential(
        tg, dataclasses.replace(tp, solver_maxiter=2), ts, VD)
    assert m3["cg_iters_boundary"] == 2 and m3["boundary_converged"] is False
