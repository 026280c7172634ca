"""The captured superstep of the port (``superstep.SuperstepGraph``,
``ops.graph``, ``ops.boundary_cg``) through its plain versions on the CPU:
the graph-ready body (the superstep with its boundary CG as a device loop)
against the JAX package's ``superstep_impl`` and ``multi_superstep_impl``
event by event, the ensemble against each replica's single run, a guard
that no host read happens inside the body, the CG loop's plain iteration
against ``cg_solve_batched``, and the graph's state through ``unbatch`` and
the npz checkpoint both packages read.  All on the 256-site stack, seeded
with numpy; JAX runs on the CPU in x64 with its Pallas sweep interpreted."""

import dataclasses
import hashlib
from functools import partial

import numpy as np
import pytest
import torch

from torch_parity import configs, perturbed_state, small_structure, to_port

torch.set_num_threads(1)

VD = 2.5
STEPS = 8
# the headline configuration of chip_smoke.synthetic_crossbar: mixed
# precision, both kernels (their plain versions here), a Poisson bucket
HEADLINE = dict(precision="mixed", poisson_kernel="pallas", ell_gather_kernel="pallas",
                poisson_compact_cap=64, rnd_seed_kmc=7)
# mixed precision: the f32 pair sweep sums in another order than the JAX
# kernel (1e-6 of the potential's scale, test_torch_slice.py's tolerance),
# and the f32 rate table's exponent turns that into up to 1.5e-4 of a
# residence time (measured here on the stack's third step)
PHI_TOL, T_TOL = 1e-6, 1e-3


def _hash(a) -> str:
    return hashlib.sha256(np.asarray(a).astype(np.int32).tobytes()).hexdigest()[:16]


@pytest.fixture(scope="module")
def both():
    """The same perturbed state of the small stack in both packages:
    (JAX geometry, params, heat, state), (port geometry, params, state)."""
    from devicekmc_tpu.physics import heat as jheat
    from devicekmc_tpu.state import build_geometry, build_params as jparams, init_state
    from devicekmc_tpu_torch.state import build_params

    s = small_structure()
    jcfg, tcfg = configs(s, **HEADLINE)
    jg = build_geometry(s.elements, s.coords, jcfg)
    jp = jparams(jcfg)
    js = perturbed_state(jg, init_state(jg, jcfg, s.elements), seed=1)
    tg, ts = to_port(jg, js)
    return (jg, jp, jheat.empty_heat_model(jp), js), (tg, build_params(tcfg), ts)


@pytest.fixture(scope="module")
def jax_steps(both):
    """STEPS supersteps of the JAX package's jitted superstep_impl: (state,
    step time, metrics) after each, as numpy."""
    import jax

    from devicekmc_tpu.superstep import superstep_impl

    (jg, jp, jh, js), _ = both
    step = jax.jit(superstep_impl)
    out = []
    for _ in range(STEPS):
        js, dt, m = step(jg, jp, jh, js, VD)
        out.append((js, float(dt), {k: float(v) for k, v in m.items()}))
    return out


def _graph(both, batch=1):
    from devicekmc_tpu_torch.superstep import SuperstepGraph

    _, (tg, tp, ts) = both
    return SuperstepGraph(tg, tp, batch), ts


def _close_phi(got, ref, what):
    phi = got.potential_boundary.numpy() + got.potential_charge.numpy()
    phi_j = np.asarray(ref.potential_boundary) + np.asarray(ref.potential_charge)
    np.testing.assert_allclose(phi, phi_j, rtol=0, atol=PHI_TOL * np.abs(phi_j).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# (a) one superstep, event by event, against jit(superstep_impl)
# ---------------------------------------------------------------------------

def test_graph_superstep_matches_jax_step_by_step(both, jax_steps):
    """STEPS supersteps of the graph-ready body (plain device loop) against
    the JAX package's: elements and charges bit for bit, event counts and
    boundary CG iterations equal, potentials and step times within the slice
    tolerances; the exact skip, the incremental skip and the solve each
    occur."""
    g, st = _graph(both)
    branches = set()
    for k, (js, jdt, jm) in enumerate(jax_steps):
        new, dt, m = g.step(st, VD)
        assert _hash(new.element.numpy()) == _hash(js.element), k
        np.testing.assert_array_equal(new.charge.numpy(), np.asarray(js.charge))
        assert m["n_events"] == jm["n_events"] and m["cg_iters_boundary"] == \
            jm["cg_iters_boundary"], k
        assert new.key == tuple(int(x) for x in np.asarray(js.key)), k
        assert dt == pytest.approx(jdt, rel=T_TOL, abs=0), k
        _close_phi(new, js, f"step {k}")
        changed = bool((new.cvac_prev != st.cvac_prev).any()) or st.Vd_prev != VD
        branches.add("solve" if m["cg_iters_boundary"] > 0
                     else "incremental" if changed else "exact")
        st = new
    assert branches == {"solve", "incremental", "exact"}
    assert sum(jm["n_events"] for _, _, jm in jax_steps) > STEPS


@pytest.mark.parametrize("active_rows_cap", [0, 128])
def test_graph_superstep_matches_eager_bit_for_bit(both, active_rows_cap):
    """On the CPU the graph-ready body is the eager single superstep bit for
    bit: every field of the state, the step time and the metrics; also with
    the rate table on the compacted source rows (active_rows_cap), which the
    batched path compacts on the device."""
    from devicekmc_tpu_torch.superstep import SuperstepGraph, superstep_impl

    _, (tg, tp, st) = both
    tp = dataclasses.replace(tp, active_rows_cap=active_rows_cap)
    g = SuperstepGraph(tg, tp, 1)
    eager = st
    for k in range(4):
        st, dt, m = g.step(st, VD)
        eager, dt_e, m_e = superstep_impl(tg, tp, eager, VD)
        assert dt == dt_e and m == {key: float(v) for key, v in m_e.items()}, k
        for f in dataclasses.fields(st):
            a, b = getattr(st, f.name), getattr(eager, f.name)
            assert (torch.equal(a, b) if torch.is_tensor(a) else
                    a == b or (a != a and b != b)), (k, f.name)


# ---------------------------------------------------------------------------
# (b) the batch against the JAX package's multi_superstep_impl
# ---------------------------------------------------------------------------

def _jax_multi(both, n_steps, Icc_A, t_end, limit):
    import jax
    import jax.numpy as jnp

    from devicekmc_tpu.superstep import multi_superstep_impl

    (jg, jp, jh, js), _ = both
    step = jax.jit(partial(multi_superstep_impl, n_steps=n_steps))
    st, dts, m = step(jg, jp, jh, js, VD, jnp.asarray(Icc_A), jnp.asarray(t_end),
                      limit=jnp.asarray(limit, jnp.int32))
    return st, np.asarray(dts), {k: np.asarray(v) for k, v in m.items()}


@pytest.mark.parametrize("stop", ["t_end", "Icc_A", "limit"])
def test_graph_batch_matches_jax(both, jax_steps, stop):
    """One batch of 5 supersteps with a stop inside it: the clock passing
    t_end after the third step, the (zero) current passing an Icc_A of -1 A
    after the first, or a limit of 2.  The active mask equal to the JAX
    package's, the step times of the steps selected away 0, the active steps'
    events equal, and the final state that of the last active step: elements
    bit for bit, the clock and potentials within the slice tolerances."""
    n = 5
    t3 = sum(dt for _, dt, _ in jax_steps[:3])
    t_end = (t3 + sum(dt for _, dt, _ in jax_steps[:2])) / 2 if stop == "t_end" else 1e30
    Icc_A = -1.0 if stop == "Icc_A" else float("inf")
    limit = 2 if stop == "limit" else n
    want = {"t_end": 3, "Icc_A": 1, "limit": 2}[stop]
    js, jdts, jm = _jax_multi(both, n, Icc_A, t_end, limit)
    g, st = _graph(both)
    got, dts, m = g.multi(st, VD, Icc_A, t_end, n, limit=limit)
    active = np.arange(n) < want
    np.testing.assert_array_equal(jm["active"], active)
    np.testing.assert_array_equal(m["active"], active)
    assert not dts[~active].any() and not jdts[~active].any()
    np.testing.assert_array_equal(m["n_events"][active], jm["n_events"][active])
    assert not m["n_events"][~active].any()
    np.testing.assert_allclose(dts, jdts, rtol=T_TOL)
    ref = jax_steps[want - 1][0]
    assert _hash(got.element.numpy()) == _hash(js.element) == _hash(ref.element)
    assert got.kmc_time == pytest.approx(float(js.kmc_time), rel=T_TOL, abs=0)
    _close_phi(got, js, stop)


def test_graph_batch_equals_steps(both):
    """A batch of 4 is the per-step graph 4 times, bit for bit (CPU), and
    the batch's element checksums are those of the per-step states."""
    from devicekmc_tpu_torch.superstep import element_checksum

    g, st = _graph(both)
    one = st
    rows, sums = [], []
    for _ in range(4):
        one, dt, m = g.step(one, VD)
        rows.append((dt, m["n_events"]))
        sums.append(float(element_checksum(one.element[None])[0]))
    one_el = one.element.clone()
    g2, _ = _graph(both)
    got, dts, m = g2.multi(st, VD, float("inf"), 1e30, 4)
    assert torch.equal(got.element, one_el)
    assert [(float(a), float(b)) for a, b in zip(dts, m["n_events"])] == rows
    assert g2.checksums.tolist() == sums and len(set(sums)) > 1


def test_graph_element_checksum_and_host_block():
    """element_checksum tells apart two element arrays that differ by a swap
    of two sites, and is exact (the int64 sum); set_host writes back what
    host_block reads, keys with their top bit set included."""
    from devicekmc_tpu_torch.state import host_block, host_row, set_host
    from devicekmc_tpu_torch.superstep import element_checksum

    rng = np.random.default_rng(5)
    el = torch.as_tensor(rng.integers(0, 8, size=(2, 1000)), dtype=torch.int32)
    sw = el.clone()
    j = int(torch.nonzero(el[0] != el[0, 0])[0, 0])
    sw[0, 0], sw[0, j] = el[0, j], el[0, 0]
    a, b = element_checksum(el), element_checksum(sw)
    w = (np.arange(1000) * 40503) % 65536 + 1
    assert a.tolist() == [float((el[k].numpy().astype(np.int64) * w).sum()) for k in range(2)]
    assert a[0] != b[0] and a[1] == b[1]

    class _S:
        pass

    singles = []
    for k, key in enumerate([(0xFFFFFFFF, 7), (0x80000000, 0x7FFFFFFF)]):
        s = _S()
        for n, v in zip(("I_macro", "P_tot", "T_bg", "Vd_prev", "kmc_time",
                         "transport_Vd_prev"), (1e-6, 2e-3, 300.5, float("nan"), 1e-13, -k)):
            setattr(s, n, v)
        s.key, s.tt_valid = key, bool(k)
        singles.append(s)
    block = torch.tensor([host_row(s) for s in singles], dtype=torch.float64)
    base = _S()
    base.__dict__.update(
        {n: torch.zeros(2, dtype=torch.float64) for n in ("I_macro", "P_tot", "T_bg", "Vd_prev",
                                                          "kmc_time", "transport_Vd_prev")},
        key=torch.zeros((2, 2), dtype=torch.uint32), tt_valid=torch.zeros(2, dtype=torch.bool))
    set_host(base, block)
    assert np.array_equal(host_block(base).numpy(), block.numpy(), equal_nan=True)
    assert [tuple(k) for k in base.key.tolist()] == [s.key for s in singles]
    assert base.tt_valid.tolist() == [False, True]


# ---------------------------------------------------------------------------
# (c) the ensemble against each replica's single run
# ---------------------------------------------------------------------------

def test_graph_ensemble_matches_single_runs(both):
    """make_batched_superstep at B = 3 (the graph route) against the single
    graph of each replica with its key, 4 supersteps: every replica's state,
    step time and event count bit for bit."""
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import unbatch

    _, (tg, tp, ts) = both
    step = make_batched_superstep(tg, tp, heat_mod.empty_heat_model(tp, "cpu"))
    states = batch_states(ts, 3, base_seed=11)
    singles = [(_graph(both)[0], unbatch(states, b)) for b in range(3)]
    for k in range(4):
        states, dts, m = step(states, VD)
        for b, (g, st) in enumerate(singles):
            st, dt, m1 = g.step(st, VD)
            singles[b] = (g, st)
            got = unbatch(states, b)
            assert torch.equal(got.element, st.element) and got.key == st.key, (k, b)
            assert torch.equal(got.potential_boundary, st.potential_boundary), (k, b)
            assert torch.equal(got.potential_charge, st.potential_charge), (k, b)
            assert float(dts[b]) == dt and int(m["n_events"][b]) == m1["n_events"]
    assert len({tuple(k) for k in states.key.tolist()}) == 3


# ---------------------------------------------------------------------------
# (d) no host read inside the body
# ---------------------------------------------------------------------------

_READS = ("item", "tolist", "__bool__", "__int__", "__float__")


@pytest.fixture
def sync_guard(monkeypatch):
    """Makes a read of a tensor's value raise while a captured function runs
    (``ops.graph.Graph.__call__``), except in the plain loop's read of its
    predicate and in the plain versions of the kernels, which stand for one
    launch each on the card (those of the transport superstep's kernels
    too)."""
    from devicekmc_tpu_torch.ops import (banded, ell_gather, graph, kmc_events, pairwise,
                                         wkb_fly, wkb_window)

    state = {"armed": False, "allowed": 0, "reads": 0}

    def guarded(name, orig):
        def read(self, *a, **kw):
            if state["armed"] and not state["allowed"]:
                raise AssertionError(f"Tensor.{name} inside the captured body")
            state["reads"] += state["armed"]
            return orig(self, *a, **kw)
        return read

    def allowed(fn):
        def run(*a, **kw):
            state["allowed"] += 1
            try:
                return fn(*a, **kw)
            finally:
                state["allowed"] -= 1
        return run

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name, guarded(name, getattr(torch.Tensor, name)))
    for mod, name in ((graph, "_predicate"), (kmc_events, "kmc_event_loop_batched_plain"),
                      (pairwise, "poisson_pairwise_batched_plain"),
                      (pairwise, "poisson_exact_batched_plain"),
                      (ell_gather, "ell_gather_batched_plain"),
                      (wkb_window, "wkb_window_block_plain"), (wkb_fly, "wkb_fly_matvec_plain"),
                      (wkb_fly, "wkb_fly_pdisp_plain"), (banded, "banded_matvec_plain")):
        monkeypatch.setattr(mod, name, allowed(getattr(mod, name)))
    call = graph.Graph.__call__

    def armed(self):
        state["armed"] = True
        try:
            return call(self)
        finally:
            state["armed"] = False

    monkeypatch.setattr(graph.Graph, "__call__", armed)
    return state


@pytest.mark.parametrize("kind", ["step", "batch", "ensemble", "bf16", "heat-local-dense",
                                  "heat-local-cg", "jnp"])
def test_graph_body_reads_nothing(both, sync_guard, kind, tmp_path):
    """The body of the per-step graph, of a batch of 3 and of the ensemble at
    B = 3 runs 3 times with every read of a tensor's value an error outside
    the plain device loop's predicate and the plain kernels (which do read);
    so does the per-step graph's with the exact-erfc Poisson sweep
    (poisson_kernel "jnp"), and the transport superstep's with the bf16
    inner operator and with the local heat model, dense and matrix-free (the
    engine's per-step graph, 3 supersteps after the cold solves, which run
    outside the graph)."""
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod

    if kind in ("bf16", "heat-local-dense", "heat-local-cg"):
        from torch_transport_graph import CONFIGS, VD as VD_T, _port

        sim = _port(tmp_path, kind, **CONFIGS[kind])
        sim.run_bias_point(VD_T, 1e30, max_steps=3)
        assert sim._graph is not None and sim._graph.replays == 3
        assert sync_guard["reads"] > 0
        return
    g, st = _graph(both)
    _, (tg, tp, ts) = both
    if kind == "jnp":
        from devicekmc_tpu_torch.superstep import SuperstepGraph

        g = SuperstepGraph(tg, dataclasses.replace(tp, poisson_kernel="jnp"), 1)
    if kind == "ensemble":
        step = make_batched_superstep(tg, tp, heat_mod.empty_heat_model(tp, "cpu"))
        states = batch_states(ts, 3, base_seed=11)
    for _ in range(3):
        if kind in ("step", "jnp"):
            st, _, m = g.step(st, VD)
        elif kind == "batch":
            st, _, m = g.multi(st, VD, float("inf"), 1e30, 3)
        else:
            states, _, m = step(states, VD)
    assert sync_guard["reads"] > 0      # the exempt reads were taken


# ---------------------------------------------------------------------------
# (e) the CG loop's plain iteration against cg_solve_batched
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active,maxiter", [((1, 1, 1), 50000), ((1, 0, 1), 5),
                                            ((0, 0, 0), 50000)])
def test_cg_device_plain_matches_cg_solve_batched(both, active, maxiter):
    """cg_solve_device through the plain device loop against cg_solve_batched
    on three replicas' boundary systems of the small stack (warm starts of
    random size): iteration counts equal, the iterate within 1e-12 of its
    scale (here bit for bit), residuals and flags equal; a replica not
    active keeps its start, and with none active no iteration runs."""
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops.cg import cg_solve_batched
    from devicekmc_tpu_torch.parallel.batched import batch_states
    from devicekmc_tpu_torch.physics import potential as pot

    _, (tg, tp, ts) = both
    states = batch_states(ts, 3)
    edge_g = pot._edge_conductance_boundary(tg, states, tp)
    masks = (tg.bp_left_mask, tg.bp_right_mask, tg.bp_interior_mask)
    b, matvec, diag, vals, pre = pot._dirichlet_system(tg, edge_g, -1.25, 1.25, masks)
    rng = np.random.default_rng(3)
    x0 = torch.where(tg.bp_interior_mask,
                     torch.as_tensor(rng.standard_normal((3, tg.N))), 0.0)
    act = torch.tensor(active, dtype=torch.bool)
    ref = cg_solve_batched(matvec, b, x0, pre, tol=1e-12, maxiter=maxiter, active=act)
    ws = bcg.workspace(3, tg.neigh_idx, tg.bp_interior_mask, torch.float64, "cpu")
    got = bcg.cg_solve_device((diag, vals, tg.neigh_idx, tg.bp_interior_mask), b, x0, pre,
                              1e-12, maxiter, act, ws)
    assert got.iters.tolist() == ref.iters.tolist()
    assert int(ws.total) == max(ref.iters.tolist())
    scale = float(ref.x.abs().max())
    assert float((got.x - ref.x).abs().max()) <= 1e-12 * scale
    assert torch.equal(got.x, ref.x)
    assert torch.equal(got.residual, ref.residual)
    assert torch.equal(got.converged, ref.converged)
    for k, a in enumerate(active):
        if not a:
            assert torch.equal(got.x[k], x0[k]) and int(got.iters[k]) == 0
        elif maxiter == 5:
            assert int(got.iters[k]) == 5
        else:
            assert 10 < int(got.iters[k]) < maxiter


def _parent_update(ws, z, maxiter):
    """The update of the boundary CG's body before it was fused with the
    direction (x, r, z = M^-1 r, r.z, beta, counts, then the stop flags and
    the predicate), in that version's arithmetic, with ``z`` a buffer of its
    own."""
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops.cg import rowdot

    act = ws.act
    alpha = ws.alpha[:, None]
    x_n = ws.x + alpha * ws.p
    r_n = ws.r - alpha * ws.ap
    z.copy_(ws.minv * r_n)
    rz_n = rowdot(r_n, z)
    ws.beta.copy_(torch.where(ws.rz != 0, rz_n / ws.rz, 0.0))
    a2 = act[:, None]
    ws.x.copy_(torch.where(a2, x_n, ws.x))
    ws.r.copy_(torch.where(a2, r_n, ws.r))
    ws.rz.copy_(torch.where(act, rz_n, ws.rz))
    ws.iters.add_(act)
    ws.ctl[0] += 1
    ws.total += 1
    bcg._decide(ws, maxiter)


@pytest.mark.parametrize("maxiter", [50000, 4])
def test_cg_update_direction_plain_matches_parent_pair(both, maxiter):
    """cg_update_direction_plain against the update and the direction of the
    body before they were fused (``_parent_update``, then p = z + beta p), on
    three replicas of the small stack's boundary system, one not solving, the
    others stopping at their own iteration or at the cap ``maxiter``: after
    every iteration x, r, p, r.z, r.r, beta, the counts, the flags, the
    loop's count and predicate equal bit for bit."""
    import dataclasses

    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.parallel.batched import batch_states
    from devicekmc_tpu_torch.physics import potential as pot

    _, (tg, tp, ts) = both
    states = batch_states(ts, 3)
    edge_g = pot._edge_conductance_boundary(tg, states, tp)
    masks = (tg.bp_left_mask, tg.bp_right_mask, tg.bp_interior_mask)
    b, _, diag, vals, pre = pot._dirichlet_system(tg, edge_g, -1.25, 1.25, masks)
    rng = np.random.default_rng(5)
    x0 = torch.where(tg.bp_interior_mask,
                     torch.as_tensor(rng.standard_normal((3, tg.N)) * [[1.0], [1.0], [1e-3]]), 0.0)
    op = (diag, vals, tg.neigh_idx, tg.bp_interior_mask)
    act = torch.tensor([True, False, True])
    ws = bcg.workspace(3, tg.neigh_idx, tg.bp_interior_mask, torch.float64, "cpu")
    bcg.cg_setup(op, b, x0, pre, 1e-12, maxiter, act, ws)
    old = dataclasses.replace(ws, **{f.name: getattr(ws, f.name).clone()
                                     for f in dataclasses.fields(ws)
                                     if isinstance(getattr(ws, f.name), torch.Tensor)})
    z = torch.zeros_like(ws.x)
    fields = ("x", "r", "p", "rz", "rr", "beta", "iters", "act", "ctl", "cond", "total")
    stops = []
    while int(ws.cond):
        bcg.cg_matvec_dot(ws, op)
        bcg.cg_matvec_dot(old, op)
        bcg.cg_update_direction_plain(ws, maxiter)
        _parent_update(old, z, maxiter)
        old.p.copy_(z + old.beta[:, None] * old.p)
        for f in fields:
            assert torch.equal(getattr(ws, f), getattr(old, f)), (int(ws.ctl[0]), f)
        stops.append(ws.act.tolist())
    assert not int(old.cond) and int(ws.iters[1]) == 0
    if maxiter == 4:
        assert ws.iters.tolist() == [4, 0, 4] and stops[-1] == [True, False, True]
    else:
        # the replicas stop at iterations of their own, one while the other runs
        assert [True, False, False] in stops or [False, False, True] in stops
        assert 10 < int(ws.ctl[0]) < maxiter


def _crossbar_geometry():
    """A small synthetic crossbar (``structure.make_crossbar_structure``)
    with the headline's site order "x", built by the port on the CPU."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.state import build_simulation
    from devicekmc_tpu_torch.structure import make_crossbar_structure

    s = make_crossbar_structure(nx_contact=3, nx_oxide=6, ny=8, nz=8, seed=1)
    cfg = KMCConfig(lattice=list(s.lattice), nn_dist=3.5, pbc=False, site_order="x",
                    num_atoms_first_layer=s.num_atoms_first_layer,
                    num_layers_contact=s.num_layers_contact,
                    num_atoms_contact=s.num_atoms_contact, layers=s.layers)
    return build_simulation(cfg, elements=s.elements, coords=s.coords, device="cpu")[0]


@pytest.mark.parametrize("where", ["stack", "crossbar"])
def test_cg_row_lengths(both, where):
    """The row lengths that cg_matvec_dot reads on the card
    (``boundary_cg.row_lengths``, made by the workspace from the operator's
    structure): each interior row's ``neigh_valid.sum(-1)`` and -1 on every
    contact row; every row of the neighbour list left-packed (its valid
    slots first, pads -1 after), so that a row's nonzeros are the prefix the
    kernel loads; rows of every length from 0 to max_nn's neighbours; a row
    that is not left-packed raises."""
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.superstep import SuperstepGraph

    geom = both[1][0] if where == "stack" else _crossbar_geometry()
    valid, interior = geom.neigh_valid, geom.bp_interior_mask
    row_len = bcg.row_lengths(geom.neigh_idx, interior)
    assert row_len.dtype == torch.int32 and row_len.shape == (geom.N,)
    counts = valid.sum(-1)
    assert torch.equal(row_len[interior], counts[interior].to(torch.int32))
    assert bool((row_len[~interior] == -1).all()) and bool((~interior).any())
    slots = torch.arange(geom.max_nn)
    assert torch.equal(valid, slots < counts[:, None])
    assert torch.equal(valid, geom.neigh_idx >= 0)
    assert int(counts.max()) == geom.max_nn and int(counts.min()) > 0
    if where == "crossbar":
        assert geom.max_nn > 32
    ws = SuperstepGraph(geom, both[1][1], 1).ws if where == "stack" \
        else bcg.workspace(1, geom.neigh_idx, interior, torch.float64, "cpu")
    assert torch.equal(ws.row_len, row_len)
    broken = geom.neigh_idx.clone()
    broken[int(counts.argmax()), 0] = -1
    with pytest.raises(ValueError, match="left-packed"):
        bcg.row_lengths(broken, interior)


# ---------------------------------------------------------------------------
# (f) the graph's state through unbatch and the npz checkpoint
# ---------------------------------------------------------------------------

def test_graph_state_round_trip(both, monkeypatch):
    """A slot of the graph viewed as a single state is unbatch of that slot
    field for field; loading that view back copies no field of the slot,
    only the one packed copy of the host fields, and the clock the driver
    sets on the host is the one the next replay starts from."""
    from devicekmc_tpu_torch.state import replace, unbatch

    g, st = _graph(both)
    st, dt, _ = g.step(st, VD)
    i = g._slot_of(st.element)
    ref = unbatch(g.slots[i], 0)
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(ref, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b or (a != a and b != b))
    copies = []
    real = torch.Tensor.copy_
    monkeypatch.setattr(torch.Tensor, "copy_",
                        lambda self, *a, **kw: copies.append(self) or real(self, *a, **kw))
    assert g.load_single(st) == i and g.load_single(replace(st, kmc_time=st.kmc_time)) == i
    assert len(copies) == 2 and all(c is g._hin for c in copies)
    assert g.load_single(replace(st, kmc_time=0.0)) == i
    monkeypatch.undo()
    new, dt2, _ = g.step(replace(st, kmc_time=0.0), VD)
    assert new.kmc_time == dt2 > 0 and float(g.slots[i].kmc_time[0]) == 0.0


def _sims(tmp_path, tag, **over):
    from devicekmc_tpu.engine import Simulation as JSim
    from devicekmc_tpu_torch.engine import Simulation as TSim

    s = small_structure()
    jcfg, tcfg = configs(s, pristine=True, initial_vacancy_concentration=0.08, rnd_seed=3,
                         V_switch=[VD], t_switch=[1e30], **{**HEADLINE, **over})
    for name, cfg in (("jax", jcfg), ("torch", tcfg)):
        d = tmp_path / tag / name
        d.mkdir(parents=True)
        cfg.output_dir = str(d)
    return (JSim(jcfg, elements=s.elements, coords=s.coords),
            TSim(tcfg, elements=s.elements, coords=s.coords, device="cpu"))


def _continue(sim, to_np, steps=2):
    """Run the loaded bias point on for ``steps`` supersteps; each step's
    element hash and events."""
    recs = []
    step = sim._superstep

    def wrapped(state, Vd, *rest):
        out = step(state, Vd, *rest)
        recs.append((_hash(to_np(out[0].element)), int(out[2]["n_events"])))
        return out

    sim._superstep = wrapped
    sim.run_bias_point(VD, 1e30, max_steps=sim._pos[1] + steps, resume_step=sim._pos[1])
    return recs


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_graph_checkpoint_exchanged_with_jax(tmp_path, writer):
    """The port's driver on the graph route and the JAX driver: one runs 2
    supersteps and writes the npz; fresh drivers of both packages read it and
    run 2 more: element hashes and events equal step for step, and the
    port's payload is the file's, field for field."""
    jw, tw = _sims(tmp_path, "writer")
    assert tw._graph_for(tw.params) is not None
    w = tw if writer == "torch" else jw
    w.run_bias_point(VD, 1e30, max_steps=2)
    path = str(tmp_path / "ck.npz")
    w.save_checkpoint(path)
    jr, tr = _sims(tmp_path, "readers")
    jr.load_checkpoint(path)
    tr.load_checkpoint(path)
    with np.load(path) as data:
        back = tr._checkpoint_payload()
        for f in data.files:
            np.testing.assert_array_equal(back[f], data[f], err_msg=f)
    jrec = _continue(jr, np.asarray)
    jr._flush()
    trec = _continue(tr, lambda t: t.numpy())
    # one capture from each of the two slots the state alternates between
    assert tr._graph is not None and tr._graph.captures == 2
    assert len(trec) == len(jrec) == 2 and trec == jrec


def test_graph_redo_after_cap_growth(tmp_path):
    """A Poisson bucket that overflows on the graph route: the driver grows
    it, captures again and redoes the step from the slot the replay read, so
    the run equals one that had the grown bucket from its start, step for
    step (element hashes, events, clock)."""
    runs = {}
    for tag, cap in (("grown", 1), ("large", 256)):
        _, sim = _sims(tmp_path, tag, poisson_compact_cap=-1)
        sim.params = dataclasses.replace(sim.params, poisson_compact_cap=cap)
        recs = []
        step = sim._superstep

        def wrapped(state, Vd, *rest, step=step, recs=recs):
            out = step(state, Vd, *rest)
            recs.append((_hash(out[0].element.numpy()), out[2]["n_events"], out[1]))
            return out

        sim._superstep = wrapped
        sim.run_bias_point(VD, 1e30, max_steps=3)
        runs[tag] = (recs, sim)
    (grown, gsim), (large, lsim) = runs["grown"], runs["large"]
    assert gsim.params.poisson_compact_cap == 256 and gsim._graph.captures > 2
    # the overflowing first step is redone: one record more than steps
    assert len(grown) == len(large) + 1 == 4
    assert grown[1:] == large
    assert gsim.state.kmc_time == lsim.state.kmc_time


# ---------------------------------------------------------------------------
# which configurations run the graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("over,reason", [
    ({}, None),
    (dict(solve_current=True), "solve_current"),
    (dict(boundary_precond="deflated"), "deflated"),
    (dict(event_mode="scan"), "event_mode"),
    # the exact-erfc sweep with a bucket: its kernel reads the count on the
    # device, so it takes the graph
    pytest.param(dict(poisson_kernel="jnp"), None, id="over4-Poisson"),
    (dict(poisson_compact_cap=0), "Poisson"),
])
def test_graph_route_by_configuration(both, over, reason):
    """superstep.graph_ready names why a configuration runs eagerly; the
    graph of such params refuses to be made, with that reason."""
    from devicekmc_tpu_torch.superstep import SuperstepGraph, graph_ready

    _, (tg, tp, _) = both
    params = dataclasses.replace(tp, **over)
    got = graph_ready(params)
    if reason is None:
        assert got is None
        return
    assert reason in got
    with pytest.raises(ValueError, match="not captured"):
        SuperstepGraph(tg, params, 1)


def test_modular_driver_runs_eagerly(tmp_path):
    """The modular driver (fused=False) never takes the graph; the fused
    driver of the same configuration does, with one capture from each
    slot."""
    from devicekmc_tpu_torch.engine import Simulation

    _, tsim = _sims(tmp_path, "fused")
    s = small_structure()
    mod = Simulation(tsim.cfg, elements=s.elements, coords=s.coords, device="cpu",
                     fused=False)
    mod.run_bias_point(VD, 1e30, max_steps=2)
    assert mod._graph is None
    tsim.run_bias_point(VD, 1e30, max_steps=2)
    assert tsim._graph is not None and tsim._graph.captures == 2
    assert torch.equal(tsim.state.element, mod.state.element)
