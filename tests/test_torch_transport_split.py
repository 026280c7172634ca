"""The transport CG's product in two kernels and its update that packs the
next direction (``ops.transport_cg``: transport_blocks, then
transport_rows_update, the rows with the update and direction; the f64
transport_rows) through their plain versions on the CPU: the two parts
against the one product they replace bit for bit, the product against the
JAX package's ``_apply_X_blocks``, the packing against ``pack_plain``, the
fused tail's CPU path against the rows and the update one after the other
(f32 and bf16 band, active and stopped iterate), and the solve through the
new body against ``cg_solve_mixed``.  On the 256-site stack of tests/torch_parity.py with the
transport settings of tests/test_torch_transport_graph.py (seeded,
transport_tol 1e-11); JAX runs on the CPU in x64 with its Pallas kernels
interpreted."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure

torch.set_num_threads(1)

VD = 10.0
BASE = dict(pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
            precision="mixed", solve_current=True, transport="blocked", transport_cc="fly",
            poisson_kernel="pallas", poisson_compact_cap=64, V_switch=[VD],
            t_switch=[1e30], transport_tol=1e-11, solver_chunk_iters=40, coarse_slabs=4)


def _sim(tmp_path, tag, **kw):
    """The port's eager engine on the stack after two supersteps."""
    from devicekmc_tpu_torch.engine import Simulation, make_superstep

    s = small_structure()
    _, tcfg = configs(s, **{**BASE, **kw})
    d = tmp_path / tag
    d.mkdir(parents=True)
    tcfg.output_dir = str(d)
    sim = Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu")
    sim._make = lambda g, p, h: make_superstep(g, p, h)
    sim.run_bias_point(VD, 1e30, max_steps=2)
    return sim


def _inputs(tmp, **kw):
    """The workspace and operator of the warm re-solve of the state after
    two supersteps (a changed bias: no skip), and its blocks."""
    from devicekmc_tpu_torch.physics import current

    sim = _sim(tmp, "fixture", **kw)
    st = dataclasses.replace(sim.state, transport_Vd_prev=float("nan"))
    cap = {}
    solve = current.transport_cg.solve

    def grab(tws, op, x0, go, tol, maxiter, max_outer=40):
        cap.update(tws=tws, op=op)
        return solve(tws, op, x0, go, tol, maxiter, max_outer)

    current.transport_cg.solve = grab
    try:
        current.update_power(sim.geom, sim.params, st, VD, cc=dict(sim._cc), allow_skip=True)
    finally:
        current.transport_cg.solve = solve
    blk = current.assemble_X_blocks(sim.geom, sim.params, st, band=sim._cc["band"])
    return cap["tws"], cap["op"], blk


@pytest.fixture(scope="module")
def solve_inputs(tmp_path_factory):
    """_inputs of the transport configuration (an f32 band)."""
    return _inputs(tmp_path_factory.mktemp("split"))


@pytest.fixture(scope="module")
def bf16_inputs(tmp_path_factory):
    """_inputs with transport_bf16_inner (a bf16 band and its row_fix)."""
    return _inputs(tmp_path_factory.mktemp("split_bf16"), transport_bf16_inner=True)


def _clone(tw):
    kw = {}
    for f in dataclasses.fields(tw):
        v = getattr(tw, f.name)
        if f.name == "cg":
            v = dataclasses.replace(v, **{g.name: getattr(v, g.name).clone()
                                          for g in dataclasses.fields(v)
                                          if torch.is_tensor(getattr(v, g.name))})
        elif f.name == "fly":
            v = tuple(t.clone() for t in v)
        elif torch.is_tensor(v):
            v = v.clone()
        kw[f.name] = v
    return type(tw)(**kw)


def _seeded(tw, op, hi, seed):
    """A copy of ``tw`` holding a seeded vector packed as each part reads it
    (``hi``: the refinement's f64 iterate, else the inner direction)."""
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    tw = _clone(tw)
    rng = np.random.default_rng(seed)
    nsub = tw.x.shape[0]
    if hi:
        tw.x.copy_(torch.as_tensor(rng.standard_normal(nsub)))
        tcg.pack_plain(tw, op, True, first=True)
    else:
        tw.cg.p[0].copy_(torch.as_tensor(rng.standard_normal(nsub).astype(np.float32)))
        tw.cg.rz.fill_(0.75)
        tcg.pack_plain(tw, op, False)
        tcg.band(tw, op)
    tcg.fly(tw, op)
    return tw


@pytest.mark.parametrize("hi", [False, True], ids=["f32", "f64"])
def test_blocks_then_rows_equal_the_one_product(solve_inputs, hi):
    """blocks_plain then rows_plain give the one product they replace bit
    for bit: ap and alpha (f32), the residual and r.r (f64), as the parent's
    plain apply made them from the band's and the fly matvec's outputs
    (``physics.current``'s _band_bump, _ell_nb and _apply_tail)."""
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.cg import rowdot
    from devicekmc_tpu_torch.physics import current as cur

    tws, op, blk = solve_inputs
    tw = _seeded(tws, op, hi, seed=1)
    tcg.blocks_plain(tw, op, hi)
    tcg.rows_plain(tw, op, hi)

    nsub = op.dsi.shape[0]
    wd = torch.float64 if hi else torch.float32
    x = tw.xs64 if hi else tw.xs32
    xa = x[2:]
    if hi:
        ya = cur._ell_nb(blk, xa, wd)
    else:
        ya = cur._band_bump(blk, xa, cur._band_unpermute(blk["band"], tw.band_y, xa))
    xm = xa[blk["mp"]].to(blk["T_vv"].dtype)
    y = cur._apply_tail(blk, x, wd, ya, tw.y_cc.to(wd), xm, blk["T_vv"], blk["T_vm"],
                        torch.matmul)
    if hi:
        r = op.b - op.dsi * y[:nsub]
        assert torch.equal(tw.r, r)
        assert torch.equal(tw.rsum, torch.dot(r, r).reshape(1))
    else:
        ap = op.dsi32 * y[:nsub]
        assert torch.equal(tw.cg.ap[0], ap)
        denom = rowdot(tw.cg.p, ap[None])
        assert torch.equal(tw.cg.alpha, torch.where(denom != 0, tw.cg.rz / denom, 0.0))


def _jax_blocks(blk):
    """The port's blocks as the JAX package's _apply_X_blocks reads them."""
    import jax.numpy as jnp

    from devicekmc_tpu_torch.ops.banded import band_dense

    j = lambda t: jnp.asarray(t.numpy())
    keys = ("band_dyn_vals", "band_vnb_safe", "vidx", "v_ok", "nb_vals", "nb_safe", "T_vv",
            "T_vm", "mp", "mp_inv", "src_vals", "gnd_vals", "diag")
    out = {k: j(blk[k]) for k in keys}
    band = blk["band"]
    out["band"] = dict(C=j(band_dense(band["slots"])), pi=j(band["pi"]), inv=j(band["inv"]),
                       front=jnp.zeros(int(band["front"]), jnp.float32))
    out["loop_G"] = jnp.asarray(blk["loop_G"], jnp.float64)
    out["T_cc"] = None
    f = blk["fly"]
    env = {k: (v if k in ("pbc", "n_int_steps") else jnp.asarray(v, jnp.float32))
           for k, v in f["env"].items() if k != "cdtype"}
    env["cdtype"] = jnp.float32
    out["fly"] = dict(mpos=j(f["mpos"]), mcb=j(f["mcb"]), env=env)
    return out


def _tunnel_sizes(op, blk, xa):
    """Each row's sum of the sizes of its f32 tunnel terms (the metal
    block, T_vm and T_vv), times dsi: the rows whose product both packages
    compute in f32 whatever the working type."""
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec_plain

    n_mp = op.mp.shape[0]
    f = blk["fly"]
    eye = torch.eye(n_mp, dtype=torch.float32)
    T_cc = torch.stack([wkb_fly_matvec_plain(f["mpos"], f["mcb"], eye[k], f["env"])
                        for k in range(n_mp)], dim=1).double().abs()
    ok = blk["v_ok"]
    T_vm, T_vv = blk["T_vm"][ok].double().abs(), blk["T_vv"][ok][:, ok].double().abs()
    xm, xv = xa[op.mp].abs(), xa[blk["vidx"][ok]].abs()
    size = torch.zeros(xa.shape[0], dtype=torch.float64)
    size[op.mp] += T_cc @ xm + xv @ T_vm
    size[blk["vidx"][ok]] += T_vv @ xv + T_vm @ xm
    nsub = op.dsi.shape[0]
    return (op.dsi * torch.cat([torch.zeros(2, dtype=torch.float64), size])[:nsub]).numpy()


@pytest.mark.parametrize("hi", [False, True], ids=["f32", "f64"])
def test_product_matches_jax_apply_X_blocks(solve_inputs, hi):
    """The product through the fly matvec, blocks_plain and rows_plain (and
    the band in f32) against the JAX package's _apply_X_blocks
    (devicekmc_tpu/physics/current.py:754) of the same blocks and the same
    seeded vector: dsi * (X x) within 2e-6 of its largest row in f32 (the
    tolerance chip_smoke.py holds the card's rows to); in f64 within 1e-12
    of it, plus f32 round-off (2e-6) of a row's own f32 tunnel terms: both
    packages multiply the tunnel blocks in their f32 storage in either
    working type, and sum them in other orders."""
    import jax.numpy as jnp
    from devicekmc_tpu.physics.current import _apply_X_blocks

    from devicekmc_tpu_torch.ops import transport_cg as tcg

    tws, op, blk = solve_inputs
    nsub = op.dsi.shape[0]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(nsub + 1)
    if not hi:
        x = x.astype(np.float32)
    tw = _clone(tws)
    na = op.mp_inv.shape[0]
    xt = torch.as_tensor(x)
    if hi:
        tw.xs64.copy_(xt)
        tw.xm.copy_(xt[2:][op.mp].float())
    else:
        tw.xs32.copy_(xt)
        tw.xw[tw.front:tw.front + na] = xt[2:][tw.pi]
        tw.xm.copy_(xt[2:][op.mp])
        tcg.band(tw, op)
    tcg.fly(tw, op)
    # the residual's right-hand side 0: r = -dsi (X x)
    op0 = op._replace(b=torch.zeros_like(op.b))
    tcg.blocks_plain(tw, op0, hi)
    tcg.rows_plain(tw, op0, hi)
    got = (-tw.r if hi else tw.cg.ap[0]).double().numpy()
    wd = jnp.float64 if hi else jnp.float32
    y = np.asarray(_apply_X_blocks(_jax_blocks(blk), jnp.asarray(x), wd))[:nsub]
    dsi = (op.dsi if hi else op.dsi32).numpy()
    ref = (dsi * y).astype(np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    if not hi:
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)
        return
    tsize = _tunnel_sizes(op, blk, xt[2:])
    assert (tsize == 0).sum() > nsub // 2
    assert bool((np.abs(got - ref) <= 1e-12 * scale + 2e-6 * tsize).all())


def test_update_pack_and_refine_pack_the_direction(solve_inputs):
    """update_pack_plain (the update half of transport_rows_update's plain
    version) is cg_update_direction_plain and then pack_plain of the new
    direction; the kernels' scatter of that
    direction through the band's inverse permutation and the metal slots
    gives pack_plain's gather through the permutation and the metal
    indices; refine leaves the packed b_in, as pack_plain packs it."""
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.boundary_cg import cg_update_direction_plain

    tws, op, _ = solve_inputs
    tw = _seeded(tws, op, False, seed=2)
    tcg.blocks_plain(tw, op, False)
    tcg.rows_plain(tw, op, False)
    tw.cg.act.fill_(True)
    tw.cg.act0.fill_(True)
    got, ref = _clone(tw), _clone(tw)
    tcg.update_pack_plain(got, op)
    cg_update_direction_plain(ref.cg, tcg.INNER_MAXITER)
    tcg.pack_plain(ref, op, False)
    for f in ("x", "r", "p", "rz", "rr", "beta", "iters", "ctl", "cond", "total"):
        assert torch.equal(getattr(got.cg, f), getattr(ref.cg, f)), f
    for f in ("xs32", "xw", "xm"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert not torch.equal(got.cg.p, tw.cg.p)
    # the kernels' scatter: xs = dsi p (0 at the grounded atom), atom a at
    # front + inv[a] of the window and at mp_inv[a] of the metal vector
    na = op.mp_inv.shape[0]
    v = op.dsi32 * got.cg.p[0]
    assert torch.equal(got.xs32, torch.cat([v, torch.zeros(1)]))
    xw = torch.zeros_like(got.xw)
    xw[tw.front + tw.inv32.long()] = got.xs32[2:2 + na]
    assert torch.equal(got.xw, xw)
    metal = op.mp_inv >= 0
    xm = torch.zeros_like(got.xm)
    xm[op.mp_inv[metal].long()] = got.xs32[2:][metal]
    assert torch.equal(got.xm, xm)
    # refine: p = b_in, packed
    tw = _seeded(tws, op, True, seed=3)
    tcg.blocks_plain(tw, op, True)
    tcg.rows_plain(tw, op, True)
    tw.go.fill_(True)
    tw.thresh.fill_(float(tw.rsum) ** 0.5 * 1e-3)
    tcg.refine(tw, op, True, tcg.MAX_OUTER, 20000)
    b_in = (tw.r / torch.sqrt(tw.rsum[0])).to(torch.float32)
    assert torch.equal(tw.cg.p[0], b_in)
    ref = _clone(tw)
    tcg.pack_plain(ref, op, False)
    for f in ("xs32", "xw", "xm"):
        assert torch.equal(getattr(tw, f), getattr(ref, f)), f


@pytest.mark.parametrize("active", [True, False], ids=["active", "stopped"])
@pytest.mark.parametrize("band", ["f32", "bf16"])
def test_rows_update_cpu_is_rows_then_update(solve_inputs, bf16_inputs, band, active):
    """transport_rows_update on CPU tensors is rows_plain (f32) followed by
    update_pack_plain, bit for bit in every buffer of the workspace, with an
    f32 band and with a bf16 one (its row_fix added to the band's rows), for
    an iterating and for a stopped iterate; an iterating one advances (its
    count, x and the packed direction change), a stopped one keeps its
    count, iterate and residual."""
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    tws, op, _ = bf16_inputs if band == "bf16" else solve_inputs
    assert (op.row_fix is not None) == (band == "bf16")
    assert (op.slots.val.dtype == torch.bfloat16) == (band == "bf16")
    tw = _seeded(tws, op, False, seed=5)
    tcg.blocks_plain(tw, op, False)
    tw.cg.act.fill_(active)
    tw.cg.act0.fill_(True)
    tw.cg.iters.fill_(3)
    got, ref = _clone(tw), _clone(tw)
    tcg.rows_update(got, op)
    tcg.rows_plain(ref, op, False)
    tcg.update_pack_plain(ref, op)
    for f in dataclasses.fields(tw):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f.name
    for f in dataclasses.fields(tw.cg):
        a, b = getattr(got.cg, f.name), getattr(ref.cg, f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f"cg.{f.name}"
    assert int(got.cg.iters) == (4 if active else 3)
    assert torch.equal(got.cg.x, tw.cg.x) != active
    assert torch.equal(got.cg.r, tw.cg.r) != active
    if active:
        assert not torch.equal(got.xs32, tw.xs32)


def test_solve_through_the_new_body_matches_cg_solve_mixed(tmp_path, monkeypatch):
    """transport_cg.solve through the new inner body (products, then
    rows_update; each seen to run an inner iteration, the f64 rows a round's
    end) against cg_solve_mixed
    (update_power_blocked with the Jacobi preconditioner) on the heat
    (global) configuration's state after two supersteps with its stored
    solution perturbed: iterations, the iterate and I_macro bit for bit."""
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.physics import current

    calls = {}
    for name in ("products", "rows_update", "rows"):
        fn = getattr(tcg, name)

        def counted(*a, fn=fn, name=name, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)

        monkeypatch.setattr(tcg, name, counted)
    sim = _sim(tmp_path, "solve", solve_heating_global=True, A=1e-18)
    g, p = sim.geom, sim.params
    rng = np.random.default_rng(4)
    vp = sim.state.virtual_potentials
    vp = vp * torch.as_tensor(1 + 3e-3 * rng.standard_normal(vp.shape[0]))
    st = dataclasses.replace(sim.state, virtual_potentials=vp, transport_Vd_prev=float("nan"))
    calls.clear()
    got, mg = current.update_power(g, p, st, VD, cc=dict(sim._cc), allow_skip=True)
    ref, mr = current.update_power_blocked(g, p, st, VD, cc=sim._cc, precond="jacobi")
    n = mg["cg_iters_power"]
    assert mg["transport_converged"] and mr["transport_converged"]
    assert n == mr["cg_iters_power"] > 0
    assert calls["products"] == calls["rows_update"] == n
    # the residual of the warm start and of each round's end
    assert 2 <= calls["rows"] <= tcg.MAX_OUTER + 1 and calls["rows"] < n
    assert got.I_macro == ref.I_macro
    assert torch.equal(got.virtual_potentials, ref.virtual_potentials)
    assert torch.equal(got.power, ref.power)
