"""The exact-erfc Poisson sweep of ``poisson_kernel = "jnp"`` (the default):
``ops.pairwise.poisson_exact_batched`` and its plain version, which the CPU
runs, against the JAX package's ``_poisson_rows_compact`` (JAX on the CPU
in x64); ``physics.potential.poisson_gridless_compact`` on the CPU bit for
bit the port's PyTorch sweep over the compacted list it computed before the
kernel; and the headline graph superstep with ``"jnp"`` against the JAX
package's jitted superstep, step by step.  Inputs from numpy seeds on the
256-site stack.  The kernel itself runs on the card only
(``tests/test_torch_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import configs, perturbed_state, small_structure, to_port

torch.set_num_threads(1)

#: the parity tolerances of tests/test_torch_slice.py, of the potential's
#: scale: f64 sums in another order; f32 sums in another order and another
#: erfc
TOL = {"f64": 1e-12, "f32": 1e-6}
DTYPES = {"f64": torch.float64, "f32": torch.float32}
#: sigma [m] and k of the stack's configurations
SIGMA, K = 3.5e-10, 1.0
CAP = 48


def _stack():
    s = small_structure()
    return np.asarray(s.coords, np.float64), np.asarray(s.lattice, np.float64)


def _charges(n, count, seed):
    """A charge vector of ``n`` sites with ``count`` charged ones (+-1, +-2)."""
    rng = np.random.default_rng(seed)
    q = np.zeros(n, np.int32)
    q[rng.choice(n, count, replace=False)] = rng.choice([-2, -1, 1, 2], count)
    return q


def _jax_rows(coords, q, lattice, dt, pbc, cap):
    """The JAX package's _poisson_rows_compact in ``dt``: (V [N], count)."""
    import jax.numpy as jnp
    from devicekmc_tpu.physics.potential import _poisson_rows_compact

    jd = jnp.float64 if dt == "f64" else jnp.float32
    v, n = _poisson_rows_compact(jnp.asarray(coords, jd), jnp.asarray(q),
                                 jnp.asarray(lattice, jd), jnp.asarray(SIGMA, jd),
                                 jnp.asarray(K, jd), pbc, 64, cap)
    return np.asarray(v, np.float64), int(n)


def _port_inputs(coords, qs, lattice, dt, cap):
    """The exact sweep's sources of the charge vectors ``qs`` as the port
    compacts them: (rows, source coordinates [B, cap, 3], ids, charges,
    counts [B], lattice, sigma, k), values of the dtype."""
    from devicekmc_tpu_torch.ops.compact import nonzero_fixed_batched
    from devicekmc_tpu_torch.state import _as_dtype

    td = DTYPES[dt]
    rows = torch.as_tensor(coords).to(td).contiguous()
    charge = torch.as_tensor(np.stack(qs))
    cidx, counts = nonzero_fixed_batched(charge != 0, cap)
    ci = cidx.long()
    return (rows, rows[ci], cidx, torch.gather(charge, 1, ci).to(td), counts,
            [_as_dtype(x, td) for x in lattice], _as_dtype(SIGMA, td), _as_dtype(K, td))


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("counts", [(0,), (30,), (70,), (0, 30, 70)],
                         ids=["none", "below-cap", "above-cap", "B3"])
def test_plain_matches_jax_poisson_rows_compact(dt, pbc, counts):
    """poisson_exact_batched on CPU tensors (its plain version) against the
    JAX package's _poisson_rows_compact, replica by replica: counts 0,
    below and above the bucket (the first CAP charged sites swept), B = 1
    and 3; the charged count equal, V within TOL of its scale (exact zeros
    with nothing charged)."""
    from devicekmc_tpu_torch.ops.pairwise import poisson_exact_batched

    coords, lattice = _stack()
    qs = [_charges(coords.shape[0], c, seed=7 + b) for b, c in enumerate(counts)]
    rows, c, i, q, n, lat, sig, k = _port_inputs(coords, qs, lattice, dt, CAP)
    v = poisson_exact_batched(rows, 0, c, i, q, n, lat, sig, k, pbc)
    assert v.dtype == DTYPES[dt] and tuple(v.shape) == (len(counts), coords.shape[0])
    for b, count in enumerate(counts):
        ref, nj = _jax_rows(coords, qs[b], lattice, dt, pbc, CAP)
        assert nj == int(n[b]) == count
        got = v[b].double().numpy()
        if count == 0:
            assert not got.any() and not ref.any()
            continue
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL[dt] * scale,
                                   err_msg=f"replica {b}")


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_plain_row_range_matches_jax(dt):
    """A row range (the rows [100, 164) of the sweep, as one rank's rows
    under the replicated decomposition) against the same rows of the JAX
    package's sweep, PBC on."""
    from devicekmc_tpu_torch.ops.pairwise import poisson_exact_batched

    coords, lattice = _stack()
    q = _charges(coords.shape[0], 40, seed=3)
    rows, c, i, qq, n, lat, sig, k = _port_inputs(coords, [q], lattice, dt, CAP)
    got = poisson_exact_batched(rows[100:164].contiguous(), 100, c, i, qq, n, lat, sig, k,
                                True, n_sweep=coords.shape[0])[0].double().numpy()
    ref, _ = _jax_rows(coords, q, lattice, dt, True, CAP)
    np.testing.assert_allclose(got, ref[100:164], rtol=0,
                               atol=TOL[dt] * np.abs(ref[100:164]).max())


def test_wrapper_refuses_other_devices():
    """A tensor on neither the CPU nor a CUDA card raises; nothing falls
    back to the plain version."""
    from devicekmc_tpu_torch.ops.pairwise import poisson_exact_batched

    meta = dict(device="meta")
    rows = torch.empty((8, 3), **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        poisson_exact_batched(rows, 0, torch.empty((1, 4, 3), **meta),
                              torch.empty((1, 4), dtype=torch.int32, **meta),
                              torch.empty((1, 4), **meta),
                              torch.empty(1, dtype=torch.int32, **meta),
                              [1.0, 1.0, 1.0], SIGMA, K, False)


# ---------------------------------------------------------------------------
# the CPU path: the port's PyTorch sweep, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack_state():
    """The port's geometry and state of the perturbed small stack (made by
    the JAX package and carried across)."""
    from devicekmc_tpu.state import build_geometry, init_state

    s = small_structure()
    jcfg, _ = configs(s, precision="f64")
    jg = build_geometry(s.elements, s.coords, jcfg)
    js = perturbed_state(jg, init_state(jg, jcfg, s.elements), seed=1)
    tg, ts = to_port(jg, js)
    return tg, ts


@pytest.mark.parametrize("precision", ["f64", "mixed"])
@pytest.mark.parametrize("cap", [64, 8])
def test_cpu_path_is_the_pytorch_sweep(stack_state, precision, cap):
    """poisson_gridless_compact with "jnp" on the CPU (single state, and its
    batched form at B = 2) equals, bit for bit, the port's PyTorch sweep
    (poisson_exact_plain) over the first min(count, cap) charged sites in
    ascending order, in f32 (mixed) or f64, what the CPU path computed
    before the kernel; the true count returned (cap 8 overflows)."""
    from devicekmc_tpu_torch.ops.pairwise import poisson_exact_plain
    from devicekmc_tpu_torch.physics import potential
    from devicekmc_tpu_torch.state import (_as_dtype, build_params, stack_states,
                                           unbatch_all)

    tg, ts = stack_state
    s = small_structure()
    _, tcfg = configs(s, precision=precision, poisson_kernel="jnp", poisson_compact_cap=cap)
    p = build_params(tcfg)
    cd = torch.float32 if p.mixed else p.dtype
    ci = torch.nonzero(ts.charge != 0).reshape(-1)
    n = int(ci.numel())
    ci = ci[:min(n, cap)]
    coords = tg.coords.to(cd)
    ref = poisson_exact_plain(coords, coords[ci], ci, ts.charge[ci].to(cd),
                              [_as_dtype(x, cd) for x in tg.lattice_host],
                              _as_dtype(p.sigma, cd), _as_dtype(p.k, cd), tg.pbc, 512)
    st, nc = potential.poisson_gridless_compact(tg, p, ts, cap)
    assert int(nc) == n > 0
    assert torch.equal(st.potential_charge, ref.to(p.dtype))
    other = dataclasses.replace(ts, charge=torch.flip(ts.charge, [0]))
    sts, ncb = potential.poisson_gridless_compact_batched(tg, p, stack_states([ts, other]),
                                                          cap)
    assert ncb.tolist() == [n, int((other.charge != 0).sum())]
    one = unbatch_all(sts)
    assert torch.equal(one[0].potential_charge, st.potential_charge)
    assert torch.equal(one[1].potential_charge,
                       potential.poisson_gridless_compact(tg, p, other, cap)[0]
                       .potential_charge)


# ---------------------------------------------------------------------------
# which configurations take the graph with the default sweep
# ---------------------------------------------------------------------------

_TRANSPORT = dict(solve_current=True, transport="blocked")


@pytest.mark.parametrize("over,batch,reason", [
    ({}, 1, None),
    ({}, None, None),
    (dict(_TRANSPORT, transport_cc="stored"), 1, None),
    (dict(_TRANSPORT, transport_cc="stored", solve_heating_global=True), 1, None),
    (dict(_TRANSPORT, transport_cc="stored", mixed=False), 1, None),
    (dict(poisson_compact_cap=0), 1, "Poisson"),
    (dict(_TRANSPORT, transport_cc="stored", mixed=False, poisson_compact_cap=0), 1,
     "Poisson"),
], ids=["headline", "ensemble", "stored", "stored-heat-global", "f64-stored", "dense",
        "f64-dense"])
def test_graph_ready_admits_the_default_sweep(over, batch, reason):
    """poisson_kernel "jnp" with a bucket takes the graph in the headline,
    its ensemble (a replica count not known yet), stored mixed transport
    without and with global heat, and f64 with the stored block; without a
    bucket (poisson_compact_cap 0, the dense sweep) graph_ready keeps its
    Poisson reason."""
    from devicekmc_tpu_torch.state import PhysParams
    from devicekmc_tpu_torch.superstep import graph_ready

    params = dataclasses.replace(
        PhysParams(freq=1e13, sigma=SIGMA, k=K, nn_dist=3.0, high_G=1.0, low_G=1e-8,
                   background_temp=300.0, mixed=True, poisson_compact_cap=64,
                   poisson_kernel="jnp"), **over)
    got = graph_ready(params, batch)
    if reason is None:
        assert got is None
    else:
        assert reason in got and "solve_current" not in got


# ---------------------------------------------------------------------------
# the headline graph superstep with "jnp" against the JAX package
# ---------------------------------------------------------------------------

VD = 2.5
STEPS = 8
HEADLINE_JNP = dict(precision="mixed", poisson_kernel="jnp", ell_gather_kernel="pallas",
                    poisson_compact_cap=64, rnd_seed_kmc=7)
#: as tests/test_torch_graph.py: potentials to 1e-6 of their scale (f32
#: sweeps in another order), residence times to 1e-3 relative (the f32 rate
#: table's exponent)
PHI_TOL, T_TOL = 1e-6, 1e-3


def _hash(a) -> str:
    import hashlib

    return hashlib.sha256(np.asarray(a).astype(np.int32).tobytes()).hexdigest()[:16]


def test_jnp_graph_superstep_matches_jax_step_by_step():
    """STEPS supersteps of the graph-ready body with poisson_kernel "jnp"
    (the exact sweep's plain version) against the JAX package's jitted
    superstep_impl with the same setting: elements and charges bit for bit,
    event counts, boundary CG iterations and charged counts equal,
    potentials and step times within the slice tolerances."""
    import jax

    from devicekmc_tpu.physics import heat as jheat
    from devicekmc_tpu.state import build_geometry, build_params as jparams, init_state
    from devicekmc_tpu.superstep import superstep_impl
    from devicekmc_tpu_torch.state import build_params
    from devicekmc_tpu_torch.superstep import SuperstepGraph, graph_ready

    s = small_structure()
    jcfg, tcfg = configs(s, **HEADLINE_JNP)
    jg = build_geometry(s.elements, s.coords, jcfg)
    jp = jparams(jcfg)
    js = perturbed_state(jg, init_state(jg, jcfg, s.elements), seed=1)
    tg, st = to_port(jg, js)
    tp = build_params(tcfg)
    assert tp.poisson_kernel == "jnp" and graph_ready(tp) is None
    g = SuperstepGraph(tg, tp, 1)
    step = jax.jit(superstep_impl)
    jh = jheat.empty_heat_model(jp)
    for k in range(STEPS):
        js, jdt, jm = step(jg, jp, jh, js, VD)
        st, dt, m = g.step(st, VD)
        assert _hash(st.element.numpy()) == _hash(js.element), k
        np.testing.assert_array_equal(st.charge.numpy(), np.asarray(js.charge))
        for key in ("n_events", "cg_iters_boundary", "n_charged_sites"):
            assert m[key] == float(jm[key]), (k, key)
        assert dt == pytest.approx(float(jdt), rel=T_TOL, abs=0), k
        phi = st.potential_boundary.numpy() + st.potential_charge.numpy()
        phi_j = np.asarray(js.potential_boundary) + np.asarray(js.potential_charge)
        np.testing.assert_allclose(phi, phi_j, rtol=0, atol=PHI_TOL * np.abs(phi_j).max(),
                                   err_msg=f"step {k}")
