"""Device ensembles of the port (``devicekmc_tpu_torch.parallel.batched``):
B replicas of one device through one superstep with a replica axis, against
the port's single superstep replica by replica and against the JAX
package's ``make_batched_superstep`` (its vmap), on the small stacks of
``tests/test_batched.py`` and ``examples/ensemble.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import configs, record_dict, small_structure

torch.set_num_threads(1)

B = 3
STEPS = 4
VD = 10.0


def _perturb(elem, seed, n_vac=14, n_od=10):
    """Random vacancies and oxygen ions (numpy, seeded) and their charges,
    so that a superstep fires events of every type."""
    from devicekmc_tpu_torch.structure import Element

    rng = np.random.default_rng(seed)
    elem = np.asarray(elem).copy()
    ox = np.nonzero(elem == int(Element.O))[0]
    elem[rng.choice(ox, size=n_vac, replace=False)] = int(Element.VACANCY)
    d = np.nonzero(elem == int(Element.DEFECT))[0]
    elem[rng.choice(d, size=n_od, replace=False)] = int(Element.OXYGEN_DEFECT)
    charge = np.where(elem == int(Element.VACANCY), 2,
                      np.where(elem == int(Element.OXYGEN_DEFECT), -2, 0))
    return elem, charge


def _port_sim(**kw):
    """The 256-site stack in the port on the CPU with a perturbed state."""
    from devicekmc_tpu_torch.state import build_simulation, replace

    s = small_structure()
    _, tcfg = configs(s, rnd_seed_kmc=7, **kw)
    geom, params, state = build_simulation(tcfg, elements=s.elements, coords=s.coords,
                                           device="cpu")
    elem, charge = _perturb(state.element.numpy(), seed=4)
    state = replace(state, element=torch.as_tensor(elem, dtype=torch.int32),
                    charge=torch.as_tensor(charge, dtype=torch.int32))
    return geom, params, state


# the headline configuration of chip_smoke.synthetic_crossbar (mixed
# precision, both kernels, a Poisson bucket), its f64 form with the
# compacted rate-table rows, and the deflated in-superstep boundary solve
HEADLINE = dict(precision="mixed", poisson_kernel="pallas", ell_gather_kernel="pallas",
                poisson_compact_cap=64)
CASES = {
    "headline": HEADLINE,
    "f64-active-rows": dict(precision="f64", poisson_compact_cap=64, active_rows_cap=128),
    "deflated": dict(HEADLINE, boundary_precond="deflated"),
}


# ---------------------------------------------------------------------------
# (a) the replicas' streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11, 42, 2**40 + 5])
def test_fold_in_matches_jax(seed):
    """rng.fold_in is jax.random.fold_in bit for bit, data past 2^31 too."""
    import jax

    from devicekmc_tpu_torch import rng

    key = jax.random.PRNGKey(seed)
    for data in (0, 1, 7, 1000, 2**31 + 3, 2**32 - 1):
        ref = np.asarray(jax.random.fold_in(key, np.uint32(data)))
        assert rng.fold_in(rng.key_from_array(key), data) == tuple(int(x) for x in ref)


def test_batch_states_keys_match_jax():
    """batch_states gives JAX's keys ([B, 2] uint32) and replicates every
    field: tensors with a leading [B] axis, host scalars as [B] tensors."""
    from devicekmc_tpu.parallel.batched import batch_states as jbatch
    from devicekmc_tpu.state import build_geometry, init_state
    from devicekmc_tpu_torch.parallel.batched import batch_states
    from devicekmc_tpu_torch.state import unbatch
    from torch_parity import to_port

    s = small_structure()
    jcfg, _ = configs(s)
    jg = build_geometry(s.elements, s.coords, jcfg)
    js = init_state(jg, jcfg, s.elements)
    _, ts = to_port(jg, js)
    got = batch_states(ts, 5, base_seed=11)
    ref = np.asarray(jbatch(js, 5, base_seed=11).key)
    assert got.key.dtype == torch.uint32 and tuple(got.key.shape) == (5, 2)
    np.testing.assert_array_equal(got.key.numpy(), ref)
    assert got.element.shape == (5, ts.element.shape[0]) and got.T_bg.shape == (5,)
    one = unbatch(got, 3)
    assert torch.equal(one.element, ts.element) and one.T_bg == ts.T_bg
    assert one.key == tuple(int(x) for x in ref[3])


# ---------------------------------------------------------------------------
# (b) each batched plain kernel against its single plain version
# ---------------------------------------------------------------------------

def test_batched_gather_plain_matches_single():
    """Shared plan and one plan a replica, one and two channels: replica b
    is ell_gather_plain of its channels at its plan, bit for bit."""
    from devicekmc_tpu_torch.ops.ell_gather import (
        ell_gather, ell_gather_batched, ell_gather_plain,
    )

    rng = np.random.default_rng(5)
    N, M = 300, 13
    nb = rng.integers(-1, N, (N, M)).astype(np.int32)
    idx = torch.as_tensor(nb)
    per = torch.as_tensor(rng.integers(-1, N, (B, 40, M)).astype(np.int32))
    f32 = torch.as_tensor(rng.standard_normal((B, N)).astype(np.float32))
    i32 = torch.as_tensor(rng.integers(-(1 << 30), 1 << 30, (B, N)).astype(np.int32))
    for plan in (idx, per):
        for vals in ([f32], [f32, i32]):
            got = ell_gather_batched(plan, vals)
            for c, g in enumerate(got):
                assert g.shape == (B,) + tuple(plan.shape[-2:])
                for b in range(B):
                    p = plan if plan.dim() == 2 else plan[b]
                    assert torch.equal(g[b], ell_gather_plain(p, [vals[c][b]])[0])
                    assert torch.equal(g[b], ell_gather(p, [vals[c][b]])[0])


def test_batched_pair_sweep_plain_matches_single():
    """The device compaction (nonzero_fixed_batched) equals nonzero_fixed
    replica by replica, and the batched sweep equals the single plain sweep
    of each replica's charged sites, bit for bit, a replica past the bucket
    (its first ``cap`` sites, the true count reported) included."""
    from devicekmc_tpu_torch.ops.compact import nonzero_fixed, nonzero_fixed_batched
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_pairwise_batched, poisson_pairwise_plain,
    )

    rng = np.random.default_rng(6)
    N, cap = 500, 24
    coords = torch.as_tensor(rng.uniform(0, 30, (N, 3)).astype(np.float32))
    charge = np.zeros((B, N), dtype=np.int32)
    for b, n in enumerate((5, 17, 40)):
        charge[b, rng.choice(N, n, replace=False)] = rng.choice([-2, 2], n)
    charge = torch.as_tensor(charge)
    cidx, counts = nonzero_fixed_batched(charge != 0, cap)
    assert counts.tolist() == [5, 17, 40]
    scal = kernel_scalars(3.5e-10, 8.987552e9 / 23, [30.0, 30.0, 30.0], torch.float32)
    cq = torch.gather(charge, 1, cidx.long()).float()
    for pbc in (False, True):
        got = poisson_pairwise_batched(coords, cidx, cq, counts, *scal, pbc)
        for b in range(B):
            ci, n = nonzero_fixed(charge[b] != 0, cap)
            assert torch.equal(ci, cidx[b]) and int(n) == int(counts[b])
            k = min(int(n), cap)
            ref = poisson_pairwise_plain(coords, ci[:k], charge[b, ci[:k].long()].float(),
                                         *scal, pbc)
            assert torch.equal(got[b], ref)


@pytest.mark.parametrize("case", ["headline", "f64-active-rows"])
def test_batched_event_loop_plain_matches_single(case):
    """The tables of a batched state (rate table with each replica's own
    T_bg, sums, compacted rows) equal incremental_tables replica by replica, and the
    batched loop equals the single plain loop of each replica from its key:
    elements, charges, keys, counts and times bit for bit."""
    from devicekmc_tpu_torch.ops.kmc_events import (
        kmc_event_loop_batched, kmc_event_loop_plain,
    )
    from devicekmc_tpu_torch.parallel.batched import batch_states
    from devicekmc_tpu_torch.physics.events import incremental_tables
    from devicekmc_tpu_torch.state import replace, unbatch

    geom, params, state = _port_sim(**CASES[case])
    rng = np.random.default_rng(8)
    states = batch_states(replace(state, potential_boundary=torch.as_tensor(
        3.0 * rng.standard_normal(geom.N), dtype=params.dtype)), B, base_seed=3)
    states = replace(states, T_bg=torch.tensor([300.0, 350.0, 420.0], dtype=torch.float64))
    tabs = incremental_tables(geom, params, states)
    refs = [incremental_tables(geom, params, unbatch(states, b)) for b in range(B)]
    for b, ref_tabs in enumerate(refs):
        for got, ref in zip(tabs[:5], ref_tabs[:5]):
            assert torch.equal(got if got.dim() == ref.dim() else got[b], ref)
        if params.active_rows_cap:
            assert int(tabs[5][b]) == int(ref_tabs[5])
    args = (geom.neigh_idx, geom.rev_slot)
    # the loops overwrite the tables and sums they are given
    element, charge, keys, res = kmc_event_loop_batched(
        *tabs[:5], *args, states.element, states.charge, states.key, 1.0 / params.freq,
        params.max_events_per_superstep, params.dtype)
    assert res.shape == (B, 4) and keys.dtype == torch.uint32
    for b, ref_tabs in enumerate(refs):
        single = unbatch(states, b)
        e, q, r = kmc_event_loop_plain(*ref_tabs[:5], *args, single.element, single.charge,
                                       single.key, 1.0 / params.freq,
                                       params.max_events_per_superstep, params.dtype)
        assert torch.equal(element[b], e) and torch.equal(charge[b], q)
        assert torch.equal(res[b], r)
        assert tuple(keys[b].tolist()) == (int(r[2]), int(r[3]))
        assert r[1] > 0
    assert not torch.equal(element[0], element[1])


@pytest.mark.parametrize("delta_cap", [256, 5])
def test_batched_incremental_residual_matches_single(delta_cap):
    """The batched incremental boundary update (each replica's changed sites
    compacted on the device, only the rows they touch recomputed) equals the
    single update replica by replica: residual and RHS bit for bit, the
    convergence flag equal.  The neutral vacancies of the solved state get
    0, 3 and 8 new neighbours (oxide sites made neutral vacancies), so rows
    of unchanged sites change too; with a cap of 5 the last overflows and
    does not converge."""
    from devicekmc_tpu_torch.physics import potential
    from devicekmc_tpu_torch.state import replace, stack_states
    from devicekmc_tpu_torch.structure import Element

    geom, params, state = _port_sim(**HEADLINE)
    params = replace(params, boundary_delta_cap=delta_cap)
    vac = state.element == int(Element.VACANCY)
    state = replace(state, charge=torch.where(vac, 0, state.charge))
    state, _ = potential.solve_boundary_potential(geom, params, state, VD)
    oxide = ~geom.metal_mask_table[state.element.long()] & ~vac
    nb = geom.neigh_idx[vac]
    near = torch.unique(nb[(nb >= 0) & oxide[nb.clamp(min=0).long()]]).numpy()
    rng = np.random.default_rng(5)
    singles = []
    for n_new in (0, 3, 8):
        sites = torch.as_tensor(rng.choice(near, size=n_new, replace=False))
        element, charge = state.element.clone(), state.charge.clone()
        element[sites], charge[sites] = int(Element.VACANCY), 0
        singles.append(replace(state, element=element, charge=charge))
    states = stack_states(singles)
    vl = float(torch.tensor(-VD / 2.0, dtype=params.dtype))
    vr = float(torch.tensor(VD / 2.0, dtype=params.dtype))
    cvac = (states.element == int(Element.VACANCY)) & (states.charge == 0)
    r, b, conv = potential._incremental_boundary_residual_batched(
        geom, params, states, cvac, cvac != states.cvac_prev, vl, vr)
    assert r.shape == b.shape == (3, geom.N) and conv.shape == (3,)
    for k, single in enumerate(singles):
        r1, b1, conv1 = potential._incremental_boundary_residual(
            geom, params, single, cvac[k], cvac[k] != single.cvac_prev, vl, vr)
        assert torch.equal(r[k], r1) and torch.equal(b[k], b1)
        assert bool(conv[k]) == conv1
    assert torch.equal(r[0], state.boundary_r) and bool(conv[0])
    # rows of sites that did not change moved too (neighbours of changed ones)
    assert bool(((r[1] != state.boundary_r) & (cvac[1] == states.cvac_prev[1])).any())
    if delta_cap < 8:
        assert not bool(conv[2])


# ---------------------------------------------------------------------------
# (c) replica b of the batch against the port's single superstep with key b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_batched_superstep_matches_single(case):
    """STEPS supersteps of B replicas against superstep_impl of each replica
    alone: elements, charges, keys, event counts, CG iterations and every
    field and step time bit for bit (on the CPU each replica's dot products
    go through torch.dot, as the single solve's do); the replicas' streams
    differ."""
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import unbatch
    from devicekmc_tpu_torch.superstep import superstep_impl

    geom, params, state = _port_sim(**CASES[case])
    step = make_batched_superstep(geom, params, heat_mod.empty_heat_model(params))
    states = batch_states(state, B, base_seed=11)
    singles = [unbatch(states, b) for b in range(B)]
    fields = ("element", "charge", "potential_boundary", "potential_charge",
              "boundary_r", "boundary_b", "cvac_prev")
    events = np.zeros((STEPS, B), dtype=int)
    for k in range(STEPS):
        states, dts, m = step(states, VD)
        assert dts.shape == (B,) and all(v.shape == (B,) for v in m.values())
        for b in range(B):
            singles[b], dt, ms = superstep_impl(geom, params, singles[b], VD)
            got = unbatch(states, b)
            for f in fields:
                assert torch.equal(getattr(got, f), getattr(singles[b], f)), (k, b, f)
            assert got.key == singles[b].key and got.kmc_time == singles[b].kmc_time
            assert float(dts[b]) == dt
            for key in ("n_events", "n_active_rows", "n_charged_sites",
                        "cg_iters_boundary", "boundary_converged"):
                assert int(m[key][b]) == int(ms[key]), (k, b, key)
            events[k, b] = int(ms["n_events"])
    assert events.sum() >= STEPS * B
    assert len({tuple(states.key[b].tolist()) for b in range(B)}) == B
    assert any(not torch.equal(states.element[0], states.element[b]) for b in range(1, B))


# ---------------------------------------------------------------------------
# (d), (e) against the JAX package's make_batched_superstep
# ---------------------------------------------------------------------------

def _jax_batch(jg, jp, js, steps, vd, heat=None, base_seed=11, n=B):
    import jax

    from devicekmc_tpu.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu.physics import heat as jheat

    states = batch_states(js, n, base_seed=base_seed)
    step = make_batched_superstep(jg, jp, heat or jheat.empty_heat_model(jp))
    first = states
    out = []
    for _ in range(steps):
        states, dts, m = step(states, vd)
        jax.block_until_ready(states.element)
        out.append((states, np.asarray(dts), {k: np.asarray(v) for k, v in m.items()}))
    return first, out


def test_batched_matches_jax():
    """The headline configuration (mixed precision, the Pallas gather and
    pair sweep in interpret mode on the JAX side, a Poisson bucket in both):
    the port's batch, carried across from JAX's batch_states, against JAX's
    vmapped superstep.  Elements and event counts equal per replica; step
    times within 1e-4 relative and potentials within 1e-6 of their scale
    (the f32 rate table and f32 Poisson sweep in another order, as in
    tests/test_torch_slice.py)."""
    from devicekmc_tpu.state import build_geometry, build_params, init_state
    from devicekmc_tpu_torch.parallel.batched import make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import batched_state_from_numpy
    from devicekmc_tpu_torch.state import build_params as tparams
    from torch_parity import perturbed_state, to_port

    s = small_structure()
    jcfg, tcfg = configs(s, rnd_seed_kmc=7, **HEADLINE)
    jg = build_geometry(s.elements, s.coords, jcfg)
    jp = build_params(jcfg)
    js = perturbed_state(jg, init_state(jg, jcfg, s.elements), seed=4, n_vac=14, n_od=10)
    first, jout = _jax_batch(jg, jp, js, 3, VD)
    tg, _ = to_port(jg, js)
    tp = tparams(tcfg)
    states = batched_state_from_numpy(record_dict(first), device="cpu")
    step = make_batched_superstep(tg, tp, heat_mod.empty_heat_model(tp))
    n_ev = 0
    for k, (jst, jdts, jm) in enumerate(jout):
        states, dts, m = step(states, VD)
        np.testing.assert_array_equal(states.element.numpy(), np.asarray(jst.element))
        np.testing.assert_array_equal(m["n_events"].numpy(), jm["n_events"])
        np.testing.assert_array_equal(m["n_charged_sites"].numpy(), jm["n_charged_sites"])
        np.testing.assert_array_equal(states.key.numpy(), np.asarray(jst.key))
        np.testing.assert_allclose(dts.numpy(), jdts, rtol=1e-4)
        phi = np.asarray(jst.potential_boundary) + np.asarray(jst.potential_charge)
        got = (states.potential_boundary + states.potential_charge).numpy()
        np.testing.assert_allclose(got, phi, rtol=0, atol=1e-6 * np.abs(phi).max(),
                                   err_msg=f"step {k}")
        n_ev += int(jm["n_events"].sum())
    assert n_ev >= 3 * B


def _ensemble_pieces():
    """examples/ensemble.py's configuration in both packages (dense
    transport and the global heat model, f64), the CB edge solved."""
    import jax

    from devicekmc_tpu.config import KMCConfig
    from devicekmc_tpu.physics.potential import solve_cb_edge
    from devicekmc_tpu.state import (
        build_geometry, build_params, init_state, make_substoichiometric,
    )
    from devicekmc_tpu.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=5)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, A=1e-18,
    )
    elems = make_substoichiometric(s.elements, 0.05, seed=1)
    geom = build_geometry(elems, s.coords, cfg)
    params = build_params(cfg)
    state = init_state(geom, cfg, elems)
    state, _ = jax.jit(solve_cb_edge)(geom, params, state, 3.0)
    return geom, params, state


def test_ensemble_configuration_matches_jax(capsys):
    """examples/ensemble.py's configuration at B = 2, 3 supersteps at 3 V:
    the transport and heat phases run replica by replica.  Elements equal,
    I_macro within 1e-5 and T_bg within 1e-9 relative of JAX's batch; then
    examples/ensemble_torch.py on the CPU prints examples/ensemble.py's
    lines with these numbers."""
    import os
    import sys

    from devicekmc_tpu_torch.parallel.batched import make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import batched_state_from_numpy
    from torch_parity import to_port

    jg, jp, js = _ensemble_pieces()
    first, jout = _jax_batch(jg, jp, js, 3, 3.0, base_seed=42, n=2)
    from devicekmc_tpu_torch.config import KMCConfig as TCfg, Layer as TLayer
    from devicekmc_tpu_torch.state import build_params as tparams
    from devicekmc_tpu.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=5)
    tcfg = TCfg(lattice=list(s.lattice), nn_dist=3.0,
                num_atoms_first_layer=s.num_atoms_first_layer,
                num_layers_contact=s.num_layers_contact,
                num_atoms_contact=s.num_atoms_contact,
                layers=[TLayer(**dataclasses.asdict(l)) for l in s.layers],
                solve_potential=True, solve_current=True, solve_heating_global=True,
                perturb_structure=True, A=1e-18)
    tg, _ = to_port(jg, js)
    tp = tparams(tcfg)
    states = batched_state_from_numpy(record_dict(first), device="cpu")
    step = make_batched_superstep(tg, tp, heat_mod.empty_heat_model(tp))
    for jst, _, jm in jout:
        states, dts, m = step(states, 3.0)
        np.testing.assert_array_equal(states.element.numpy(), np.asarray(jst.element))
        np.testing.assert_array_equal(m["n_events"].numpy(), jm["n_events"])
        np.testing.assert_allclose(states.I_macro.numpy(), np.asarray(jst.I_macro),
                                   rtol=1e-5)
        np.testing.assert_allclose(states.T_bg.numpy(), np.asarray(jst.T_bg), rtol=1e-9)
        assert m["Current [uA]"].shape == (2,)
    assert float(states.T_bg.max()) > 300.0

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    try:
        import ensemble_torch
    finally:
        sys.path.pop(0)
    ex_states, _ = ensemble_torch.main(["--batch", "2", "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    I = np.asarray(jout[-1][0].I_macro) * 1e6
    T = np.asarray(jout[-1][0].T_bg)
    assert lines == [
        "ensemble of 2 devices after 3 supersteps at Vd=3.0 V:",
        f"  I [uA]: mean {I.mean():.4g}  std {I.std():.3g}  "
        f"range [{I.min():.4g}, {I.max():.4g}]",
        f"  T_bg [K]: mean {T.mean():.6g}  std {T.std():.3g}",
        f"  events/superstep (last): {jout[-1][2]['n_events'].tolist()}",
    ]
    assert torch.equal(ex_states.element, states.element)


# ---------------------------------------------------------------------------
# (f) what the port does not take
# ---------------------------------------------------------------------------

def test_mesh_and_shard_batch_raise():
    """The replica axis over a mesh, which raised until it was ported, now
    runs: over a world of one gloo rank along "batch", ``shard_batch`` keeps
    every replica, the superstep with ``mesh=`` is the one without it bit
    for bit, and ``gather_batch`` gives the batch back; a mesh along
    "sites" raises."""
    import torch.distributed as dist

    from devicekmc_tpu_torch.parallel import batched, make_mesh

    geom, params, state = _port_sim(**HEADLINE)
    states = batched.batch_states(state, 2)
    want, want_dts, _ = batched.make_batched_superstep(geom, params, None)(states, VD)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu", axis_names=("batch",))
        mine = batched.shard_batch(states, mesh)
        out, dts, _ = batched.make_batched_superstep(geom, params, None, mesh=mesh)(mine, VD)
        out = batched.gather_batch(out, mesh)
        with pytest.raises(ValueError, match="needs a mesh along 'batch'"):
            batched.shard_batch(states, make_mesh(1, device="cpu"))
    finally:
        dist.destroy_process_group()
    assert torch.equal(dts, want_dts)
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), f.name


def test_default_device_is_the_card():
    """Without device="cpu" the entry points ask for the card, and raise
    without one."""
    import os
    import sys

    from devicekmc_tpu_torch.parallel.batched import batch_states
    from devicekmc_tpu_torch.state import batched_state_from_numpy

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    geom, params, state = _port_sim(**HEADLINE)
    d = {f.name: getattr(batch_states(state, 2), f.name)
         for f in dataclasses.fields(state)}
    d = {k: v.numpy() if torch.is_tensor(v) else v for k, v in d.items()}
    with pytest.raises(RuntimeError, match="CUDA"):
        batched_state_from_numpy(d)
    assert batched_state_from_numpy(d, device="cpu").element.shape == (2, geom.N)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    try:
        import ensemble_torch
    finally:
        sys.path.pop(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ensemble_torch.main(["--batch", "2", "--steps", "1"])
