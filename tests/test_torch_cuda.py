"""The CUDA kernels against their plain PyTorch versions on the card.

Needs an NVIDIA card and nvcc, and no JAX; on a machine without JAX run it
without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# (N, max_nn, bw, offset, active): n_pairs % 4 of 0, 1, 2 and 3 (and fewer
# pairs than a 16-byte group); ``offset`` words between a 16-byte boundary
# and the index tensor's data_ptr; ``active`` rows taken as the rate table
# takes them through active_idx (geom.neigh_idx[a].contiguous()), one at the
# smallest bucket of rows (1,024 x 51); the cases of 20,000 sites and more
# run four slots a lane on an H100, the others one (gather_grid)
GATHER_CASES = [
    (515, 52, 510, 0, False), (20000, 27, 3000, 0, False),
    (513, 13, 100, 0, False), (255, 6, 50, 0, False), (1001, 3, 200, 0, False),
    (1, 1, 0, 0, False), (2, 1, 1, 0, False), (3, 1, 2, 0, False),
    (515, 52, 510, 1, False), (513, 13, 100, 2, False), (255, 6, 50, 3, False),
    (2, 1, 1, 3, False), (20000, 27, 3000, 0, True), (1001, 51, 500, 0, True),
    (3072, 51, 1500, 0, True), (20001, 27, 3000, 3, False), (30000, 51, 5000, 0, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,max_nn,bw,offset,active", GATHER_CASES)
def test_cuda_gather_bit_equal(N, max_nn, bw, offset, active):
    """Bit-equal to the plain version on every slot, pads included: one and
    two channels, f32 and int32 sources in either place."""
    _need_card()
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather, ell_gather_plain

    rng = np.random.default_rng(N * 8 + offset)
    site = np.arange(N)[:, None]
    nb = np.clip(site + rng.integers(-bw, bw + 1, (N, max_nn)), 0, N - 1)
    nb[rng.random((N, max_nn)) < 0.15] = -1
    idx = torch.as_tensor(nb, dtype=torch.int32, device="cuda")
    if active:
        a = torch.as_tensor(np.sort(rng.choice(N, N // 3, replace=False)), device="cuda")
        idx = idx[a].contiguous()
    if offset:
        buf = torch.empty(idx.numel() + 8, dtype=torch.int32, device="cuda")
        head = (-(buf.data_ptr() // 4)) % 4
        view = buf[head + offset:head + offset + idx.numel()].view(idx.shape)
        view.copy_(idx)
        idx = view
        assert idx.is_contiguous() and idx.data_ptr() % 16 == 4 * offset
    f32 = torch.as_tensor(rng.standard_normal(N).astype(np.float32), device="cuda")
    i32 = torch.as_tensor(rng.integers(-(1 << 30), 1 << 30, N).astype(np.int32),
                          device="cuda")
    before = ell_gather.launches
    sets = ([f32], [i32], [f32, i32], [i32, f32])
    for vals in sets:
        got = ell_gather(idx, vals)
        ref = ell_gather_plain(idx, vals)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == idx.shape
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
    assert ell_gather.launches == before + len(sets)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", [20000 * 27 + 3, 1000 * 27 + 1])
def test_cuda_gather_stream_copy(offset, n):
    """The measurement aid copies the index words into every channel, with
    four and with one slot a lane."""
    _need_card()
    from devicekmc_tpu_torch.ops.ell_gather import (
        ell_gather, ell_gather_plain, ell_stream_copy,
    )

    rng = np.random.default_rng(5)
    buf = torch.as_tensor(rng.integers(-1, 20000, n + 8).astype(np.int32), device="cuda")
    head = (-(buf.data_ptr() // 4)) % 4
    idx = buf[head + offset:head + offset + n].view(1, n)
    for nch in (1, 2):
        outs = ell_stream_copy(idx, nch)
        torch.cuda.synchronize()
        assert len(outs) == nch and all(torch.equal(o, idx) for o in outs)
    vals = [torch.randn(20000, device="cuda")]
    assert torch.equal(ell_gather(idx, vals)[0], ell_gather_plain(idx, vals)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
def test_cuda_poisson_close_to_plain(pbc):
    """Within atol 2e-6 * max|plain| (f32 sums in another order, FMA)."""
    _need_card()
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_pairwise, poisson_pairwise_plain,
    )

    rng = np.random.default_rng(0)
    N, n_c = 5000, 300
    coords = rng.uniform(0, 30, (N, 3)).astype(np.float32)
    cidx = rng.choice(N, n_c, replace=False).astype(np.int32)
    args = (torch.as_tensor(coords, device="cuda"),
            torch.as_tensor(cidx, device="cuda"),
            torch.as_tensor(rng.choice([-2.0, 2.0], n_c).astype(np.float32),
                            device="cuda"),
            *kernel_scalars(3.5e-10, 8.987552e9 / 23, [30.0, 30.0, 30.0],
                            torch.float32))
    before = poisson_pairwise.launches
    got = poisson_pairwise(*args, pbc)
    ref = poisson_pairwise_plain(*args, pbc)
    torch.cuda.synchronize()
    assert poisson_pairwise.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               atol=2e-6 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("n_c", [1, 7, 128, 129, 502, 8192])
def test_cuda_poisson_shapes(n_c, pbc):
    """A ragged row count (20,001), charged sets of one site to the largest
    compaction cap, one split and several (poisson_grid), a charged site
    with a charged twin and one with an uncharged twin at the same
    coordinates (pairs of squared distance 0 add 0): within atol 2e-6 *
    max|plain|, finite, two calls bit-equal, one launch a call."""
    _need_card()
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_grid, poisson_pairwise, poisson_pairwise_plain,
    )

    rng = np.random.default_rng(n_c)
    N = 20_001
    coords = rng.uniform(0, 60, (N, 3)).astype(np.float32)
    cidx = rng.choice(N, n_c, replace=False).astype(np.int32)
    if n_c > 1:
        coords[cidx[1]] = coords[cidx[0]]
    coords[np.setdiff1d(np.arange(N), cidx)[0]] = coords[cidx[-1]]
    args = (torch.as_tensor(coords, device="cuda"), torch.as_tensor(cidx, device="cuda"),
            torch.as_tensor(rng.choice([-2.0, -1.0, 1.0, 2.0], n_c).astype(np.float32),
                            device="cuda"),
            *kernel_scalars(3.5e-10, 8.987552e9 / 23, [60.0, 60.0, 60.0], torch.float32),
            pbc)
    before = poisson_pairwise.launches
    got = poisson_pairwise(*args)
    got2 = poisson_pairwise(*args)
    ref = poisson_pairwise_plain(*args)
    torch.cuda.synchronize()
    assert poisson_pairwise.launches == before + 2
    assert got.shape == (N,) and bool(torch.isfinite(got).all())
    assert torch.equal(got, got2)
    if n_c >= 64:
        assert poisson_grid(N, n_c)[1] > 1
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=2e-6 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("n_c", [1, 129, 8192])
def test_cuda_poisson_rows_bit_equal_to_whole(n_c, pbc):
    """The pair sweep over a row range (a rank's rows under the replicated
    decomposition): ranges of 4 and 3 ranks over 20,001 rows, a ragged one
    and a single row, each bit-equal to the same rows of one whole launch,
    within atol 2e-6 * max|plain| (over every row) of the plain version's
    range, one launch a call."""
    _need_card()
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_pairwise, poisson_pairwise_plain, poisson_pairwise_rows,
    )

    rng = np.random.default_rng(n_c + 7)
    N = 20_001
    coords = torch.as_tensor(rng.uniform(0, 60, (N, 3)).astype(np.float32), device="cuda")
    cidx = torch.as_tensor(rng.choice(N, n_c, replace=False).astype(np.int32), device="cuda")
    cq = torch.as_tensor(rng.choice([-2.0, 2.0], n_c).astype(np.float32), device="cuda")
    sc = kernel_scalars(3.5e-10, 8.987552e9 / 23, [60.0, 60.0, 60.0], torch.float32)
    whole = poisson_pairwise(coords, cidx, cq, *sc, pbc)
    atol = 2e-6 * float(poisson_pairwise_plain(coords, cidx, cq, *sc, pbc).abs().max())
    ranges = [(r * 5000, 5000) for r in range(4)] + [(r * 6667, 6667) for r in range(3)]
    for row0, n in ranges + [(20_000, 1), (17, 2003), (0, N)]:
        before = poisson_pairwise.launches
        got = poisson_pairwise_rows(coords, row0, n, cidx, cq, *sc, pbc)
        ref = poisson_pairwise_plain(coords, cidx, cq, *sc, pbc, row0=row0, n_rows=n)
        torch.cuda.synchronize()
        assert poisson_pairwise.launches == before + 1
        assert torch.equal(got, whole[row0:row0 + n]), (row0, n)
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=atol)


#: the exact kernel against its plain version, of the potential's scale:
#: f32 sums of thousands of terms in another order and libdevice's erfcf
#: against PyTorch's; f64 the sums' order alone
EXACT_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


def _exact_inputs(N, cap, B, dtype, seed):
    """Rows [N, 3] and B replicas' source lists of ``cap`` random sites
    (charges +-1, +-2) on the card, with a source at a row's own site and
    two sources at one position among them."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 60, (N, 3))
    ids = np.stack([rng.choice(N, cap, replace=False) for _ in range(B)]).astype(np.int32)
    if cap > 1:
        coords[ids[0, 1]] = coords[ids[0, 0]]
    rows = torch.as_tensor(coords, dtype=dtype, device="cuda")
    idx = torch.as_tensor(ids, device="cuda")
    q = torch.as_tensor(rng.choice([-2.0, -1.0, 1.0, 2.0], (B, cap)), dtype=dtype,
                        device="cuda")
    return rows, rows[idx.long()].contiguous(), idx, q


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("counts", [(129,), (0,), (600,), (0, 129, 600, 513)])
def test_cuda_poisson_exact_close_to_plain(counts, pbc, dtype):
    """The exact-erfc kernel against its plain version over 20,001 rows and
    buckets of 513 sources: counts 0, below and above the bucket, B = 1 and
    4; within EXACT_TOL of the scale (all zeros where nothing is swept), two
    calls bit-equal, each replica of a batch its own launch's bits, one
    launch a call counted on the host and on the card."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops.pairwise import (poisson_exact_batched,
                                                  poisson_exact_batched_plain)

    B, cap = len(counts), 513
    rows, c, i, q = _exact_inputs(20_001, cap, B, dtype, seed=sum(counts) + pbc)
    n = torch.tensor(counts, dtype=torch.int32, device="cuda")
    args = (rows, 0, c, i, q, n, [60.0, 60.0, 60.0], 3.5e-10, 1.0, pbc)
    card = _build.launch_counts("cuda")
    slot = _build.COUNTED_ON_CARD.index("poisson_exact_batched")
    before, on_card = poisson_exact_batched.launches, int(card[slot])
    got = poisson_exact_batched(*args)
    got2 = poisson_exact_batched(*args)
    ref = poisson_exact_batched_plain(*args)
    torch.cuda.synchronize()
    assert poisson_exact_batched.launches == before + 2 and int(card[slot]) == on_card + 2
    assert got.dtype == dtype and got.shape == (B, 20_001) and torch.equal(got, got2)
    for b, count in enumerate(counts):
        if count == 0:
            assert not bool(got[b].any())
            continue
        scale = float(ref[b].abs().max())
        assert float((got[b] - ref[b]).abs().max()) <= EXACT_TOL[dtype] * scale, b
        if B > 1:
            one = poisson_exact_batched(rows, 0, c[b:b + 1], i[b:b + 1], q[b:b + 1],
                                        n[b:b + 1], *args[6:])
            assert torch.equal(one[0], got[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_c", [1, 129, 4096])
def test_cuda_poisson_exact_rows_bit_equal_to_whole(n_c, dtype):
    """The exact kernel over a row range (a rank's rows, ``n_sweep`` the
    whole sweep's rows): ranges of 4 and 3 ranks over 20,001 rows, a
    ragged one and a single row, each bit-equal to the same rows of one
    whole launch and within EXACT_TOL of the plain version's range."""
    _need_card()
    from devicekmc_tpu_torch.ops.pairwise import (poisson_exact_batched,
                                                  poisson_exact_batched_plain)

    N = 20_001
    rows, c, i, q = _exact_inputs(N, n_c, 1, dtype, seed=n_c)
    n = torch.tensor([n_c], dtype=torch.int32, device="cuda")
    sc = ([60.0, 60.0, 60.0], 3.5e-10, 1.0, True)
    whole = poisson_exact_batched(rows, 0, c, i, q, n, *sc)
    ranges = [(r * 5000, 5000) for r in range(4)] + [(r * 6667, 6667) for r in range(3)]
    for row0, m in ranges + [(20_000, 1), (17, 2003), (0, N)]:
        part = rows[row0:row0 + m].contiguous()
        got = poisson_exact_batched(part, row0, c, i, q, n, *sc, n_sweep=N)
        ref = poisson_exact_batched_plain(part, row0, c, i, q, n, *sc)
        torch.cuda.synchronize()
        assert torch.equal(got[0], whole[0, row0:row0 + m]), (row0, m)
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= EXACT_TOL[dtype] * max(scale, 1e-300)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_cuda_graph_superstep_jnp_matches_eager(tmp_path, precision):
    """poisson_kernel "jnp" (the exact kernel) on the engine's per-step
    graph of the small stack against the eager superstep_impl from the same
    state, step by step: elements, charges, events and the charges'
    potential bit for bit (the same kernel on the same charges), the
    boundary potential within 1e-12 of its scale; the exact kernel launched
    once a superstep on each path, the pair sweep never."""
    _need_card()
    from devicekmc_tpu_torch.ops.pairwise import poisson_exact_batched, poisson_pairwise_batched
    from devicekmc_tpu_torch.superstep import superstep_impl

    sim = _graph_sim(tmp_path, poisson_kernel="jnp", precision=precision)
    sim.run_bias_point(2.5, 1e30, max_steps=1)
    assert sim._graph is not None
    eager = sim.state
    for k in range(6):
        before = (poisson_exact_batched.launches, poisson_pairwise_batched.launches)
        got, dt, m = sim._superstep(sim.state, 2.5)
        assert poisson_exact_batched.launches == before[0] + 1
        sim.state = got
        eager, dt_e, m_e = superstep_impl(sim.geom, sim.params, eager, 2.5)
        assert poisson_exact_batched.launches == before[0] + 2
        assert poisson_pairwise_batched.launches == before[1]
        assert torch.equal(got.element, eager.element), k
        assert torch.equal(got.charge, eager.charge), k
        assert m["n_events"] == int(m_e["n_events"]), k
        assert torch.equal(got.potential_charge, eager.potential_charge), k
        pb, pb_e = got.potential_boundary, eager.potential_boundary
        assert float((pb - pb_e).abs().max()) <= 1e-12 * float(pb_e.abs().max()), k


# ---------------------------------------------------------------------------
# transport kernels
# ---------------------------------------------------------------------------

Q = 1.60217663e-19
HBAR = 1.054571817e-34
M0 = 9.11e-31


def _env(pbc, n_int_steps=64):
    f = lambda v: float(np.float32(v))
    return dict(
        cdtype=torch.float32,
        prefac=f(-(np.sqrt(2 * 0.85 * M0) / HBAR) * (2 / 3)),
        qV0=f(Q * 1.6), dE_step=f(Q * 0.01), ctol=f(Q * 0.01), nn=f(3.5),
        lattice=(100.0, 60.0, 60.0), pbc=pbc, n_int_steps=n_int_steps,
    )


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.array([100.0, 60.0, 60.0])).astype(np.float32)
    cb = (rng.random(n) * Q * 2 - Q).astype(np.float32)
    return (torch.as_tensor(pos, device="cuda"), torch.as_tensor(cb, device="cuda"), rng)


@pytest.mark.cuda
@pytest.mark.parametrize("R,m_pad,B,dtype", [
    (5, 3, 128, torch.float32),
    (3, 16, 128, torch.float32),
    (37, 56, 128, torch.float32),
    (2, 120, 128, torch.float32),
    (3, 8, 256, torch.float32),
    (4, 8, 128, torch.bfloat16),
])
def test_cuda_banded_matvec(R, m_pad, B, dtype):
    """A fully dense random band (every entry a slot): bit-equal to the
    plain version (each row's sum in ascending slot order, a rounded
    multiply then a rounded add); bf16 values with f32 sums."""
    _need_card()
    from devicekmc_tpu_torch.ops.banded import band_slots, banded_matvec, banded_matvec_plain

    g = torch.Generator(device="cpu").manual_seed(R * 100 + m_pad)
    C4 = torch.randn((R, m_pad, B, B), generator=g).to(dtype)
    slots = band_slots(C4).to("cuda")
    xw = torch.randn((R + m_pad - 1) * B, generator=g).cuda()
    before = banded_matvec.launches
    y = banded_matvec(slots, xw)
    ref = banded_matvec_plain(slots, xw)
    torch.cuda.synchronize()
    assert banded_matvec.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (R * B,)
    assert torch.equal(y, ref)


def _sparse_entries(g, R, m_pad, B, most):
    """Random entries of a band: row i (of the first R*B - B // 2, the rest
    empty) gets 0 .. ``most`` slots at random window offsets (repeats
    included)."""
    n_rows = R * B - B // 2
    counts = torch.randint(0, most + 1, (n_rows,), generator=g)
    row = torch.repeat_interleave(torch.arange(n_rows), counts)
    off = torch.randint(0, m_pad * B, (row.numel(),), generator=g)
    return row, off, torch.randn(row.numel(), generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("R,m_pad,B,most", [(13, 7, 96, 40), (41, 61, 32, 70), (607, 3, 32, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_banded_matvec_ragged_bit_equal(R, m_pad, B, most, dtype):
    """A sparse band at a ragged R, m_pad and B (rows of 0 .. ``most``
    slots, the last half block empty), its slots built on the card: the
    storage equals the CPU's bit for bit, and the kernel its plain version
    bit for bit, through both entries; the empty rows give 0."""
    _need_card()
    from devicekmc_tpu_torch.ops.banded import (
        banded_matvec, banded_matvec_out, banded_matvec_plain, slots_from_entries,
    )

    g = torch.Generator(device="cpu").manual_seed(R + m_pad + most)
    row, off, val = _sparse_entries(g, R, m_pad, B, most)
    cpu = slots_from_entries(row, off, val.to(dtype), (R, m_pad, B))
    slots = slots_from_entries(row.cuda(), off.cuda(), val.to(dtype).cuda(), (R, m_pad, B))
    for a, b in zip(slots[:3], cpu[:3]):
        assert torch.equal(a.cpu(), b)
    xw = torch.randn((R + m_pad - 1) * B, generator=g).cuda()
    y = banded_matvec(slots, xw)
    out = torch.full((R * B,), float("nan"), device="cuda")
    banded_matvec_out(slots, xw, out)
    ref = banded_matvec_plain(slots, xw)
    torch.cuda.synchronize()
    assert torch.equal(y, ref) and torch.equal(out, ref)
    assert torch.equal(ref.cpu(), banded_matvec_plain(cpu, xw.cpu()))
    assert not bool(y[R * B - B // 2:].any())


FLY_N = [1, 31, 128, 129, 300, 1153, 3527]


def _assert_close_to_plain(got, ref):
    """atol 1e-5 * max|plain| (f32 sums in another order, FMA, the value's
    square roots and division within 2 ulp); an all-zero plain version
    (n = 1: only the self pair) must be met exactly."""
    scale = float(ref.abs().max())
    if got.shape[0] > 1:
        assert scale > 0
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n", FLY_N)
def test_cuda_fly_matvec(n, symmetric, pbc):
    """atol 1e-5 * max|plain| (f32 sums in another order, FMA); two launches
    on the same input give the same bits.  The widths cover one row, less
    than a warp, one tile exactly, one row more, ragged tiles and the
    transport path's 3,527."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec, wkb_fly_matvec_plain

    pos, cb, rng = _points(n, 42)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device="cuda")
    env = _env(pbc)
    before = wkb_fly_matvec.launches
    y = wkb_fly_matvec(pos, cb, x, env, symmetric=symmetric)
    y2 = wkb_fly_matvec(pos, cb, x, env, symmetric=symmetric)
    ref = wkb_fly_matvec_plain(pos, cb, x, env)
    torch.cuda.synchronize()
    assert wkb_fly_matvec.launches == before + 2
    assert torch.equal(y, y2)
    _assert_close_to_plain(y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("K,KB", [(12, 8), (24, 8), (24, 24), (5, 4), (5, None), (24, None), (40, None)])
def test_cuda_fly_matmat(K, KB):
    """atol 1e-5 * max|plain|: the K-column contraction is FP32 FMA; two
    launches give the same bits."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matmat_plain

    n = 1153
    pos, cb, rng = _points(n, 7)
    X = torch.as_tensor(rng.standard_normal((n, K)).astype(np.float32), device="cuda")
    env = _env(True)
    before = wkb_fly_matmat.launches
    Y = wkb_fly_matmat(pos, cb, X, env, KB=KB)
    Y2 = wkb_fly_matmat(pos, cb, X, env, KB=KB)
    ref = wkb_fly_matmat_plain(pos, cb, X, env)
    torch.cuda.synchronize()
    assert wkb_fly_matmat.launches == before + 2
    assert torch.equal(Y, Y2)
    _assert_close_to_plain(Y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("K", [1, 5, 24, 40])
@pytest.mark.parametrize("n", FLY_N)
def test_cuda_fly_matmat_shapes(n, K, pbc):
    """The widths of test_cuda_fly_matvec with one column, a ragged group,
    the deflation basis's 24 and two groups; bit-equal repeat."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matmat_plain

    pos, cb, rng = _points(n, 11)
    X = torch.as_tensor(rng.standard_normal((n, K)).astype(np.float32), device="cuda")
    env = _env(pbc)
    Y = wkb_fly_matmat(pos, cb, X, env)
    Y2 = wkb_fly_matmat(pos, cb, X, env)
    ref = wkb_fly_matmat_plain(pos, cb, X, env)
    torch.cuda.synchronize()
    assert Y.shape == (n, K) and torch.equal(Y, Y2)
    _assert_close_to_plain(Y, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("n_a", [64, 200, 700])
def test_cuda_fly_contact_zeros(n_a, pbc):
    """The first n_a atoms are one contact whose CB edges agree to within
    ctol: all their pairs are ineligible, so an operand that lives on that
    contact alone gives exact zeros on its rows, in both matvec forms, the
    matmat and the dissipation sums, while the rows of the other atoms
    agree with the plain version (the chunk skip leaves out only zeros)."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import (
        wkb_fly_matmat, wkb_fly_matmat_plain, wkb_fly_matvec, wkb_fly_matvec_plain,
        wkb_fly_pdisp, wkb_fly_pdisp_plain,
    )

    n = 1153
    pos, cb, rng = _points(n, 5)
    env = _env(pbc)
    cb[:n_a] = torch.as_tensor(
        (0.3 * Q + rng.random(n_a) * 0.009 * Q).astype(np.float32), device="cuda")
    x = torch.zeros(n, device="cuda")
    x[:n_a] = torch.as_tensor(rng.standard_normal(n_a).astype(np.float32), device="cuda")
    X = x[:, None] * torch.arange(1, 25, device="cuda")[None, :]
    ref = wkb_fly_matvec_plain(pos, cb, x, env)
    torch.cuda.synchronize()
    assert not ref[:n_a].any() and ref[n_a:].any()
    for symmetric in (False, True):
        y = wkb_fly_matvec(pos, cb, x, env, symmetric=symmetric)
        assert not y[:n_a].any()
        _assert_close_to_plain(y, ref)
    Y = wkb_fly_matmat(pos, cb, X.contiguous(), env)
    assert not Y[:n_a].any()
    _assert_close_to_plain(Y, wkb_fly_matmat_plain(pos, cb, X, env))
    ms = torch.as_tensor((rng.random(n) * 7e-10).astype(np.float32), device="cuda")
    _assert_close_to_plain(wkb_fly_pdisp(pos, cb, ms, 1.0, env),
                           wkb_fly_pdisp_plain(pos, cb, ms, 1.0, env))


def _straddle(a, b, axis, below, cell=None):
    """b moved along ``axis`` by single f32 steps until its distance from a,
    computed as the plain version computes it (minimum image along y and z
    in a cell of sides ``cell``), is the last one below ``below`` (returned
    first) and the first one not below it."""
    f = np.float32

    def dist(q):
        d = a - q
        if cell is not None:
            for ax in (1, 2):
                d[ax] = d[ax] - f(np.round(d[ax] / cell[ax]) * cell[ax])
        return np.sqrt(f(f(d[0] * d[0]) + f(d[1] * d[1])) + f(d[2] * d[2]))

    b = b.copy()
    away = f(np.inf) if b[axis] > a[axis] else f(-np.inf)
    while dist(b) < below:
        b[axis] = np.nextafter(b[axis], away)
    while not dist(b) < below:
        b[axis] = np.nextafter(b[axis], a[axis])
    outside = b.copy()
    outside[axis] = np.nextafter(b[axis], away)
    assert dist(b) < below and not dist(outside) < below
    return b, outside


def _at_squared_distance(t, z):
    """Two atoms whose squared distance, summed as the plain version sums it,
    is the float t exactly: one at the origin of the xy plane (so that the
    differences are the other's coordinates), the other's small y tuned."""
    f = np.float32
    dx = f(np.sqrt(float(t)) * 0.999)
    dy = f(np.sqrt(float(t) - float(dx) ** 2))
    d2 = lambda y: f(f(dx * dx) + f(y * y))
    for _ in range(4000):
        if d2(dy) == t:
            break
        dy = np.nextafter(dy, f(np.inf) if d2(dy) < t else f(0))
    assert d2(dy) == t
    return np.array([0, 0, z], f), np.array([dx, dy, z], f)


def _threshold_points(pbc, nn):
    """Pairs of atoms (CB edges well apart) around the neighbour distance:
    seven whose squared distances are the floats from three below fl(nn^2)
    to three above it, then pairs one f32 step of a coordinate either side
    of nn in random directions (under PBC every other one reaches its
    partner across the cell's y face), then pairs half a cell apart along
    y.  Returns positions [n, 3], CB edges [n], the pairs' index triples
    (anchor, partner, partner) or pairs, and the kernels' env."""
    f = np.float32
    env = dict(_env(pbc), nn=float(f(nn)))
    nn = f(nn)
    cell = np.asarray(env["lattice"], dtype=f)
    rng = np.random.default_rng(21)
    pts, cbs, exact, groups = [], [], [], []
    t = f(nn * nn)
    for _ in range(3):
        t = np.nextafter(t, f(0))
    for k in range(7):
        exact.append((len(pts), len(pts) + 1))
        pts += list(_at_squared_distance(t, f(3 + 8 * k)))
        cbs += [0.5 * Q, -0.5 * Q]
        t = np.nextafter(t, f(np.inf))
    for k in range(30):
        a = (np.array([12.0 + k % 10 * 8.0, 8.0 + k // 10 * 14.0, 6.0])
             + rng.random(3) * 2.0).astype(f)
        wrap = pbc and k % 2 == 1
        u = rng.standard_normal(3)
        u /= np.linalg.norm(u)
        u[0] = np.sign(u[0]) * max(abs(u[0]), 0.3)
        if wrap:
            a[1] = f(rng.random())
            u[1] = -abs(u[1]) - 0.4
        b = (a + u / np.linalg.norm(u) * float(nn)).astype(f)
        if wrap:
            b[1] += cell[1]
        inside, outside = _straddle(a, b, 0, nn, cell if pbc else None)
        groups.append((len(pts), len(pts) + 1, len(pts) + 2))
        pts += [a, inside, outside]
        cbs += [0.5 * Q, -0.5 * Q, -0.3 * Q]
    for k in range(12):
        a = (np.array([5.0 + 7 * k, 4.0, 50.0]) + rng.random(3)).astype(f)
        b = a.copy()
        b[1] = a[1] + cell[1] / 2
        for _ in range(k % 4):
            b[1] = np.nextafter(b[1], f(np.inf) if k % 2 else f(-np.inf))
        pts += [a, b]
        cbs += [0.4 * Q, -0.6 * Q]
    return (torch.as_tensor(np.stack(pts).astype(f)),
            torch.as_tensor(np.asarray(cbs, dtype=f)), exact, groups, env)


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("nn", [3.5, 3.3, 2.9, 4.1])
def test_cuda_fly_neighbour_threshold_is_exact(nn, pbc):
    """Pairs whose squared distance is each float within three of fl(nn^2),
    pairs one f32 step either side of nn, pairs half a cell apart: the
    kernels' entries are exact zeros exactly where the plain version's are
    (it takes sqrt(d2) < nn; the kernels compare d2 with a threshold made on
    the host).  T is read column by column: the matmat on the identity, both
    matvec forms on unit vectors."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import (
        pair_vals_plain, wkb_fly_matmat, wkb_fly_matvec,
    )

    pos, cb, exact, groups, env = _threshold_points(pbc, nn)
    n = pos.shape[0]
    T_ref = pair_vals_plain(env, pos, cb, pos, cb)
    zeros = [bool(T_ref[a, b] == 0) for a, b in exact]
    assert zeros[0] and not zeros[-1] and zeros == sorted(zeros, reverse=True)
    for a, inside, outside in groups:
        assert T_ref[a, inside] == 0 and T_ref[a, outside] != 0
    pc, cc = pos.cuda(), cb.cuda()
    eye = torch.eye(n, device="cuda")
    T_mm = wkb_fly_matmat(pc, cc, eye, env).cpu()
    assert torch.equal(T_mm == 0, T_ref == 0)
    _assert_close_to_plain(T_mm, T_ref)
    for symmetric in (False, True):
        T_mv = torch.stack([wkb_fly_matvec(pc, cc, eye[j].contiguous(), env,
                                           symmetric=symmetric) for j in range(n)],
                           dim=1).cpu()
        assert torch.equal(T_mv == 0, T_ref == 0)
        _assert_close_to_plain(T_mv, T_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
def test_cuda_window_block(pbc):
    """atol 1e-5 * max|plain|; rows with v_ok False are exact zeros."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_window import (
        wkb_window_block, wkb_window_block_plain,
    )

    n, nv = 1153, 37
    pos, cb, _ = _points(n, 42)
    vpos = (pos[:nv] + 0.5).contiguous()
    vcb = (cb[:nv] * 0.7).contiguous()
    v_ok = torch.arange(nv, device="cuda") < nv - 5
    env = _env(pbc, n_int_steps=256)
    before = wkb_window_block.launches
    T = wkb_window_block(vpos, vcb, v_ok, pos, cb, env)
    ref = wkb_window_block_plain(vpos, vcb, v_ok, pos, cb, env)
    torch.cuda.synchronize()
    assert wkb_window_block.launches == before + 1
    assert float(ref.abs().max()) > 0
    np.testing.assert_allclose(T.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    assert bool((T[nv - 5:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nv,n_int_steps,pbc,dead", [
    (16, 256, False, "none"),      # the partial assembly's shape, all rows live
    (16, 256, True, "none"),
    (40, 256, False, "some"),
    (300, 256, False, "some"),
    (300, 256, True, "tail"),      # the bucket's form: live rows first
    (37, 1, False, "some"),
    (37, 1024, False, "some"),     # windows over 256 steps: the table in parts
    (37, 1024, True, "none"),
    (300, 256, False, "all"),
])
def test_cuda_window_block_shapes(nv, n_int_steps, pbc, dead):
    """3,527 metal atoms (the transport path's count), CB edges over 6 V so
    that windows reach past 256 steps: atol 1e-5 * max|plain|, rows with
    v_ok False exact zeros, two calls bit-equal, one launch a call."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block, wkb_window_block_plain

    n = 3527
    pos, _, rng = _points(n, nv + n_int_steps)
    cb = torch.as_tensor(((rng.random(n) * 2 - 1) * Q * 6).astype(np.float32),
                         device="cuda")
    vpos = (pos[:nv] + 0.5).contiguous()
    vcb = (cb[:nv] * 0.7).contiguous()
    v_ok = {"none": np.ones(nv, bool), "all": np.zeros(nv, bool),
            "some": rng.random(nv) < 0.6, "tail": np.arange(nv) < nv * 0.56}[dead]
    v_ok = torch.as_tensor(v_ok, device="cuda")
    env = _env(pbc, n_int_steps=n_int_steps)
    before = wkb_window_block.launches
    T = wkb_window_block(vpos, vcb, v_ok, pos, cb, env)
    T2 = wkb_window_block(vpos, vcb, v_ok, pos, cb, env)
    ref = wkb_window_block_plain(vpos, vcb, v_ok, pos, cb, env)
    torch.cuda.synchronize()
    assert wkb_window_block.launches == before + 2
    assert torch.equal(T, T2)
    assert bool((T[~v_ok] == 0).all())
    if dead == "all":
        assert not T.any() and not ref.any()
        return
    assert float(ref.abs().max()) > 0
    np.testing.assert_allclose(T.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("Vd", [2.0, -1.5, 0.0])
@pytest.mark.parametrize("n", [1, 127, 128, 300, 1153])
def test_cuda_fly_pdisp(n, Vd, pbc):
    """Dissipation row sums over the upper-triangle tiles: atol 1e-5 *
    max|plain| against the plain version and against the sweep of the
    stored block with f64 potentials (f32 sums in another order, FMA, the
    value's square roots and division within 2 ulp); Vd = 0 and a single
    atom give exact zeros; two launches on the same input give the same
    bits (no float atomics).  The widths cover one atom, one row short of a
    tile, one tile exactly, ragged tiles and a width at which the kernel
    takes one warp group a tile."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp, wkb_fly_pdisp_plain
    from devicekmc_tpu_torch.physics.current import (
        _pdisp_rows_cols, tunnel_block, wkb_single_T,
    )

    pos, cb, rng = _points(n, 42)
    ms = rng.standard_normal(n).astype(np.float32) * 1e-10
    ms = torch.as_tensor(ms + np.abs(ms.min()), device="cuda")
    env = _env(pbc)
    before = wkb_fly_pdisp.launches
    row = wkb_fly_pdisp(pos, cb, ms, Vd, env)
    row2 = wkb_fly_pdisp(pos, cb, ms, Vd, env)
    ref = wkb_fly_pdisp_plain(pos, cb, ms, Vd, env)
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    T = tunnel_block(env, pos, cb, ones, pos, cb, ones, wkb_single_T)
    stored, _ = _pdisp_rows_cols(T, ms.double(), ms.double(), Vd)
    torch.cuda.synchronize()
    assert wkb_fly_pdisp.launches == before + 2
    assert row.dtype == torch.float32 and row.shape == (n,)
    assert torch.equal(row, row2)
    if Vd == 0.0 or n == 1:
        assert not row.any() and not ref.any() and not stored.any()
        return
    scale = float(ref.abs().max())
    assert scale > 0
    np.testing.assert_allclose(row.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(row.double().cpu().numpy(), stored.cpu().numpy(), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_heated_solve_launches_pdisp_once():
    """update_power with a heating flag and the on-the-fly metal block
    launches the dissipation kernel once per solve; the site power agrees
    with the CPU path's to 1e-5 of its largest entry (two mixed solves at
    tolerance 1e-11)."""
    _need_card()
    import dataclasses

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp
    from devicekmc_tpu_torch.physics import current, potential
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, pristine=True, initial_vacancy_concentration=0.08,
        A=1e-18, rnd_seed=3, precision="mixed", transport="blocked",
        transport_cc="fly", transport_tol=1e-11, V_switch=[10.0], t_switch=[1e30],
    )
    power = {}
    for device in ("cuda", "cpu"):
        sim = Simulation(dataclasses.replace(cfg), elements=s.elements, coords=s.coords,
                         device=device)
        st, _ = potential.solve_cb_edge(sim.geom, sim.params, sim.state, 10.0)
        before = wkb_fly_pdisp.launches
        st, m = current.update_power(sim.geom, sim.params, st, 10.0)
        st, m = current.update_power(sim.geom, sim.params, st, 10.0)
        assert wkb_fly_pdisp.launches == before + (2 if device == "cuda" else 0)
        assert m["transport_converged"] and st.P_tot > 0
        power[device] = st.power.cpu().numpy()
    np.testing.assert_allclose(power["cuda"], power["cpu"], rtol=0,
                               atol=1e-5 * np.abs(power["cpu"]).max())


def _event_state(precision, cap, seed=4, n_vac=14, n_od=10, phi_scale=3.0):
    """The 256-site stack on the card with random vacancies, oxygen ions
    and potentials (numpy, seeded), so that one superstep fires tens of
    events of every type."""
    import dataclasses

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.state import build_simulation
    from devicekmc_tpu_torch.structure import Element, make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, perturb_structure=True, precision=precision,
        active_rows_cap=cap, rnd_seed_kmc=7,
    )
    geom, params, state = build_simulation(cfg, elements=s.elements, coords=s.coords,
                                           device="cuda")
    rng = np.random.default_rng(seed)
    elem = state.element.cpu().numpy().copy()
    ox = np.nonzero(elem == int(Element.O))[0]
    elem[rng.choice(ox, size=n_vac, replace=False)] = int(Element.VACANCY)
    d = np.nonzero(elem == int(Element.DEFECT))[0]
    elem[rng.choice(d, size=n_od, replace=False)] = int(Element.OXYGEN_DEFECT)
    charge = np.where(elem == int(Element.VACANCY), 2,
                      np.where(elem == int(Element.OXYGEN_DEFECT), -2, 0))
    n = elem.shape[0]
    cuda = lambda a, dt: torch.as_tensor(a, dtype=dt, device="cuda")
    state = dataclasses.replace(
        state, element=cuda(elem, torch.int32), charge=cuda(charge, torch.int32),
        potential_boundary=cuda(phi_scale * rng.standard_normal(n), params.dtype),
        potential_charge=cuda(0.1 * phi_scale * rng.standard_normal(n), params.dtype))
    return geom, params, state


def _assert_same_superstep(got, ref, rel):
    assert got.n_events == ref.n_events and got.n_active == ref.n_active
    assert torch.equal(got.state.element, ref.state.element)
    assert torch.equal(got.state.charge, ref.state.charge)
    assert got.state.key == ref.state.key
    assert got.step_time == pytest.approx(ref.step_time, rel=rel)


def _straddle_tables(geom, prob, seed=0, lo=112, hi=144):
    """A full table (a row a site) whose only rates, seeded and positive on
    every valid slot, are on the rows [lo, hi) around the first block
    boundary (row 128), so that every event's touched rows straddle it;
    and its f64 row and block sums.  ``prob`` [n_rows, m] or [B, n_rows, m]
    gives the shape and dtype."""
    from devicekmc_tpu_torch.ops.kmc_events import BLOCK

    n_rows = prob.shape[-2]
    assert n_rows > BLOCK and ((geom.neigh_idx[lo:hi] >= 0) & (geom.neigh_idx[lo:hi] < BLOCK)
                               ).any() and (geom.neigh_idx[lo:hi] >= BLOCK).any()
    rng = np.random.default_rng(seed)
    rates = torch.as_tensor(rng.uniform(0.5, 1.5, tuple(prob.shape)), device=prob.device)
    rows = torch.arange(n_rows, device=prob.device)
    keep = ((rows >= lo) & (rows < hi))[:, None] & (geom.neigh_idx >= 0)
    prob = torch.where(keep, rates, 0.0).to(prob.dtype).contiguous()
    n_blocks = -(-n_rows // BLOCK)
    row_sums = torch.zeros((*prob.shape[:-2], n_blocks * BLOCK), dtype=torch.float64,
                           device=prob.device)
    row_sums[..., :n_rows] = prob.double().sum(-1)
    return prob, row_sums, row_sums.view(*row_sums.shape[:-1], n_blocks, BLOCK).sum(-1)


def _same_loop(got, ref, rel):
    """Two results of the single event loop: elements, charges, count and
    key equal, the time within rel (or both inf)."""
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got[2][1:], ref[2][1:])
    t, t_ref = float(got[2][0]), float(ref[2][0])
    assert t == t_ref or t == pytest.approx(t_ref, rel=rel)


@pytest.mark.cuda
@pytest.mark.parametrize("precision,rel", [("f64", 1e-9), ("mixed", 2.4e-7)])
@pytest.mark.parametrize("cap", [0, 128])
def test_cuda_event_loop_matches_plain(precision, rel, cap):
    """Three supersteps from the same state, the kernel against the plain
    host loop on the card: events, elements, charges and keys equal;
    step_time within 1e-9 relative (f64 table) or 2 f32 ulps (f32 table:
    the log of the time draw and the sums' order may differ by an ulp);
    the kernel launched once a superstep, the input state untouched."""
    _need_card()
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop, kmc_event_loop_plain
    from devicekmc_tpu_torch.physics.events import execute_superstep_incremental

    geom, params, state = _event_state(precision, cap)
    elem0 = state.element.clone()
    total = 0
    for _ in range(3):
        before = kmc_event_loop.launches
        got = execute_superstep_incremental(geom, params, state)
        ref = execute_superstep_incremental(geom, params, state,
                                            event_loop=kmc_event_loop_plain)
        assert kmc_event_loop.launches == before + 1
        _assert_same_superstep(got, ref, rel)
        assert got.n_events > 0
        total += got.n_events
        assert torch.equal(state.element, elem0)
        state = got.state
        elem0 = state.element.clone()
    assert total > 10
    if cap:
        return
    # events whose touched rows straddle the first block boundary, at the
    # event caps 1 and 5 and to the end of the table's rates
    from devicekmc_tpu_torch.physics.events import incremental_tables

    prob, _, _, aidx, inv, _ = incremental_tables(geom, params, state)
    prob, row_sums, block_sums = _straddle_tables(geom, prob)
    for max_events in (1, 5, 10000):
        args = (aidx, inv, geom.neigh_idx, geom.rev_slot, state.element, state.charge,
                state.key, float("inf"), max_events, params.dtype)
        got = kmc_event_loop(prob.clone(), row_sums.clone(), block_sums.clone(), *args)
        ref = kmc_event_loop_plain(prob.clone(), row_sums.clone(), block_sums.clone(), *args)
        _same_loop(got, ref, rel)
        count = int(got[2][1])
        assert count == max_events if max_events < 10000 else count > 5


@pytest.mark.cuda
@pytest.mark.parametrize("max_events", [1, 5])
def test_cuda_event_loop_max_events(max_events):
    """The event cap is hit exactly, with the same state as the plain
    loop."""
    _need_card()
    import dataclasses

    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop_plain
    from devicekmc_tpu_torch.physics.events import execute_superstep_incremental

    geom, params, state = _event_state("f64", 0)
    params = dataclasses.replace(params, max_events_per_superstep=max_events)
    got = execute_superstep_incremental(geom, params, state)
    ref = execute_superstep_incremental(geom, params, state,
                                        event_loop=kmc_event_loop_plain)
    assert got.n_events == max_events
    _assert_same_superstep(got, ref, 1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_event_loop_no_valid_event(dtype):
    """A table without a positive rate (psum = 0): event_time = inf, no
    event, the key split once, elements untouched."""
    _need_card()
    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop, kmc_event_loop_plain

    geom, params, state = _event_state("f64", 0)
    N, m = geom.N, geom.max_nn
    n_blocks = -(-N // 128)
    outs = []
    for loop in (kmc_event_loop, kmc_event_loop_plain):
        prob = torch.zeros((N, m), dtype=dtype, device="cuda")
        row_sums = torch.zeros(n_blocks * 128, dtype=torch.float64, device="cuda")
        block_sums = torch.zeros(n_blocks, dtype=torch.float64, device="cuda")
        aidx = torch.arange(N, dtype=torch.int32, device="cuda")
        outs.append(loop(prob, row_sums, block_sums, aidx, aidx, geom.neigh_idx,
                         geom.rev_slot, state.element, state.charge, state.key,
                         1.0 / params.freq, 100, torch.float64))
    for element, charge, res in outs:
        t, count, k0, k1 = res.tolist()
        assert t == float("inf") and count == 0
        assert (int(k0), int(k1)) == rng.split(state.key, 3)[0]
        assert torch.equal(element, state.element) and torch.equal(charge, state.charge)


@pytest.mark.cuda
def test_cuda_threefry_matches_rng():
    """The kernel's stream: 2,000 successive splits and the f64 and f32
    draws of both keys, bit for bit against rng.py."""
    _need_card()
    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import threefry_draws

    key = rng.prng_key(7)
    keys, u64, u32 = threefry_draws(key, 2000)
    keys, u64, u32 = keys.tolist(), u64.tolist(), u32.tolist()
    for e in range(2000):
        key, k_sel, k_time = rng.split(key, 3)
        assert tuple(keys[e]) == key
        assert u64[e] == [rng.uniform(k_sel, np.float64), rng.uniform(k_time, np.float64)]
        assert u32[e] == [rng.uniform(k_sel, np.float32), rng.uniform(k_time, np.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_event_loop_large_table(dtype):
    """A table of 800,000 rows (6,250 blocks of sums: 50 KB of shared
    memory, past the 48 KB default) on a ring graph of 4 neighbours with
    random rates and elements: 30 events (the cap) equal to the plain loop's,
    with the same key, elements, charges and time."""
    _need_card()
    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import BLOCK, kmc_event_loop, kmc_event_loop_plain

    N, d = 800_000, np.array([-1, 1, -2, 2])
    gen = np.random.default_rng(3)
    site = np.arange(N)[:, None]
    nb = torch.as_tensor((site + d) % N, dtype=torch.int32, device="cuda")
    rev = torch.as_tensor(np.broadcast_to([1, 0, 3, 2], (N, 4)).copy(), dtype=torch.int32,
                          device="cuda")
    elem = gen.integers(0, 4, N)
    charge = np.where(elem == 2, 2, np.where(elem == 1, -2, 0))
    prob = torch.as_tensor(gen.random((N, 4)) * (gen.random((N, 4)) < 0.3), dtype=dtype,
                           device="cuda")
    n_blocks = -(-N // BLOCK)
    row_sums = torch.nn.functional.pad(prob.double().sum(dim=1), (0, n_blocks * BLOCK - N))
    block_sums = row_sums.reshape(n_blocks, BLOCK).sum(dim=1)
    aidx = torch.arange(N, dtype=torch.int32, device="cuda")
    outs = []
    for loop in (kmc_event_loop, kmc_event_loop_plain):
        outs.append(loop(prob.clone(), row_sums.clone(), block_sums.clone(), aidx, aidx, nb,
                         rev, torch.as_tensor(elem, dtype=torch.int32, device="cuda"),
                         torch.as_tensor(charge, dtype=torch.int32, device="cuda"),
                         rng.prng_key(11), 1e30, 30, torch.float64))
    (e_k, q_k, r_k), (e_p, q_p, r_p) = outs
    t_k, n_k, *key_k = r_k.tolist()
    t_p, n_p, *key_p = r_p.tolist()
    assert n_k == n_p == 30 and key_k == key_p
    assert torch.equal(e_k, e_p) and torch.equal(q_k, q_p)
    assert (e_k.cpu().numpy() != elem).any()
    assert t_k == pytest.approx(t_p, rel=1e-9 if dtype == torch.float64 else 2.4e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cuda_event_loop_wide_rows(dtype):
    """Rows of more than the 128 slots the kernel holds in registers: a
    seeded random symmetric graph of 400 sites with 100 to some 160
    neighbours a site (left-packed, ascending, with its reverse slots),
    random rates and elements.  At the event caps 1, 5 and 40 the single
    loop equals the plain loop (key, elements, charges, count; the time
    within the table type's rounding), and the batched entry (two replicas,
    their own keys and elements) each replica's single launch and the plain
    batched loop."""
    _need_card()
    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import (
        BLOCK, kmc_event_loop, kmc_event_loop_batched, kmc_event_loop_batched_plain,
        kmc_event_loop_plain,
    )

    N = 400
    gen = np.random.default_rng(5)
    adj = np.triu(gen.random((N, N)) < 0.34, 1)
    adj |= adj.T
    deg = adj.sum(1)
    m = int(deg.max())
    assert m > 128 + 16 and int(deg.min()) < 128
    nb = np.full((N, m), -1, dtype=np.int64)
    for i in range(N):
        nb[i, :deg[i]] = np.flatnonzero(adj[i])
    slot_of = {(i, int(j)): k for i in range(N) for k, j in enumerate(nb[i, :deg[i]])}
    rev = np.array([[slot_of[(int(j), i)] if j >= 0 else -1 for j in nb[i]]
                    for i in range(N)])
    elem = gen.integers(0, 4, (2, N))
    charge = np.where(elem == 2, 2, np.where(elem == 1, -2, 0))
    rates = gen.random((N, m)) * (gen.random((N, m)) < 0.6) * (nb >= 0)
    cuda = lambda a, dt=torch.int32: torch.as_tensor(a, device="cuda").to(dt).contiguous()
    nb_t, rev_t = cuda(nb), cuda(rev)
    prob = cuda(rates, dtype)
    n_blocks = -(-N // BLOCK)
    row_sums = torch.nn.functional.pad(prob.double().sum(dim=1), (0, n_blocks * BLOCK - N))
    block_sums = row_sums.reshape(n_blocks, BLOCK).sum(dim=1)
    aidx = torch.arange(N, dtype=torch.int32, device="cuda")
    keys = [rng.prng_key(21), rng.prng_key(22)]
    rel = 1e-9 if dtype == torch.float64 else 2.4e-7
    for max_events in (1, 5, 40):
        singles = []
        for b in range(2):
            args = (aidx, aidx, nb_t, rev_t, cuda(elem[b]), cuda(charge[b]), keys[b], 1e30,
                    max_events, torch.float64)
            got = kmc_event_loop(prob.clone(), row_sums.clone(), block_sums.clone(), *args)
            ref = kmc_event_loop_plain(prob.clone(), row_sums.clone(), block_sums.clone(),
                                       *args)
            _same_loop(got, ref, rel)
            assert int(got[2][1]) == max_events
            singles.append(got)
        stack = lambda t: torch.stack([t, t]).contiguous()
        bargs = (aidx, aidx, nb_t, rev_t, cuda(elem), cuda(charge),
                 cuda(np.array(keys, dtype=np.int64), torch.int64).to(torch.uint32), 1e30,
                 max_events, torch.float64)
        got = kmc_event_loop_batched(stack(prob), stack(row_sums), stack(block_sums), *bargs)
        ref = kmc_event_loop_batched_plain(stack(prob), stack(row_sums), stack(block_sums),
                                           *bargs)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(got[2], ref[2]) and torch.equal(got[3][:, 1:], ref[3][:, 1:])
        np.testing.assert_allclose(got[3][:, 0].cpu().numpy(), ref[3][:, 0].cpu().numpy(),
                                   rtol=rel)
        for b, (e, q, r) in enumerate(singles):
            assert torch.equal(got[0][b], e) and torch.equal(got[1][b], q)
            assert torch.equal(got[3][b], r)
    assert (singles[0][0].cpu().numpy() != elem[0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("R,m_pad", [(4, 8), (37, 56), (2, 120)])
def test_cuda_banded_matvec_bf16_band_f32_vector(R, m_pad):
    """A bf16 band with an f32 vector (what transport_bf16_inner runs):
    bit-equal to the plain version on the same inputs; the vector is not
    rounded (the bf16-rounded vector gives another product)."""
    _need_card()
    from devicekmc_tpu_torch.ops.banded import band_slots, banded_matvec, banded_matvec_plain

    g = torch.Generator(device="cpu").manual_seed(R * 100 + m_pad)
    C4 = torch.randn((R, m_pad, 128, 128), generator=g).to(torch.bfloat16)
    slots = band_slots(C4).to("cuda")
    xw = torch.randn((R + m_pad - 1) * 128, generator=g).cuda()
    before = banded_matvec.launches
    y = banded_matvec(slots, xw)
    ref = banded_matvec_plain(slots, xw)
    rounded = banded_matvec_plain(slots, xw.to(torch.bfloat16))
    torch.cuda.synchronize()
    assert banded_matvec.launches == before + 1
    assert torch.equal(y, ref)
    assert not torch.equal(rounded, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [((300, 70), (70,)), ((70,), (70, 300)),
                                   ((1024, 3527), (3527,)), ((1024,), (1024, 3527)),
                                   ((3527, 3527), (3527,))],
                         ids=["matvec", "vecmat", "T_vm", "T_vm'", "T_cc"])
def test_cuda_twin_matmul_matches_plain(shape):
    """The bf16 twin product of transport_bf16_inner on the card (one
    library call, aten::mm.dtype: bf16 operands, f32 result) against its
    plain version (f32 upcast in row chunks) on the same card: f32 results,
    within 1e-6 of the terms' magnitude, at the small stack's and the
    crossbar's block shapes."""
    _need_card()
    from devicekmc_tpu_torch.physics.current import twin_matmul, twin_matmul_plain

    g = torch.Generator(device="cuda").manual_seed(sum(shape[0]))
    a = torch.randn(shape[0], generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(shape[1], generator=g, device="cuda").to(torch.bfloat16)
    got = twin_matmul(a, b)
    ref = twin_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = float((a.float().abs() @ b.float().abs()).max())
    assert float((got - ref).abs().max()) <= 1e-6 * scale


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_and_resume(tmp_path):
    """A checkpoint written on the card: read back on the card and on the
    CPU, every field equal; the card run resumed from it in a fresh
    Simulation ends in the uninterrupted run's state bit for bit."""
    import dataclasses

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.structure import make_test_structure

    _need_card()
    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    base = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, perturb_structure=True, pristine=True,
        initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
        precision="mixed", poisson_kernel="pallas", V_switch=[2.5], t_switch=[1e30],
        log_freq=1000)

    def sim(tag, device="cuda"):
        d = tmp_path / tag
        d.mkdir()
        return Simulation(dataclasses.replace(base, output_dir=str(d)),
                          elements=s.elements, coords=s.coords, device=device)

    a = sim("a")
    a.run_bias_point(2.5, 1e30, max_steps=4)
    b = sim("b")
    b.run_bias_point(2.5, 1e30, max_steps=2)
    ck = str(tmp_path / "ck.npz")
    b.save_checkpoint(ck)
    saved = b._checkpoint_payload()
    for tag, device in (("c", "cuda"), ("cpu", "cpu")):
        r = sim(tag, device)
        r.load_checkpoint(ck)
        back = r._checkpoint_payload()
        for f, v in saved.items():
            assert np.array_equal(back[f], v, equal_nan=v.dtype.kind == "f"), (tag, f)
    c = sim("d")
    c.load_checkpoint(ck)
    c.run_bias_point(2.5, 1e30, max_steps=4, resume_step=2)
    for f in ("element", "charge", "potential_boundary", "potential_charge"):
        assert torch.equal(getattr(c.state, f), getattr(a.state, f)), f
    assert c.state.key == a.state.key and c.state.kmc_time == a.state.kmc_time


# ---------------------------------------------------------------------------
# device ensembles: the batched kernels (one launch for B replicas)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("N,max_nn,per_replica", [
    (515, 52, False), (20000, 27, False), (3, 1, False), (30000, 51, False),
    (1001, 51, True), (20001, 27, True)])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_cuda_gather_batched(N, max_nn, per_replica, B):
    """B replicas in one launch, bit-equal on every slot to the batched
    plain version and to B single launches; the plan shared or one a
    replica, one and two channels."""
    _need_card()
    from devicekmc_tpu_torch.ops.ell_gather import (
        ell_gather, ell_gather_batched, ell_gather_batched_plain,
    )

    rng = np.random.default_rng(N + B)
    shape = (B, max(1, N // 3), max_nn) if per_replica else (N, max_nn)
    nb = rng.integers(-1, N, shape).astype(np.int32)
    idx = torch.as_tensor(nb, device="cuda")
    f32 = torch.as_tensor(rng.standard_normal((B, N)).astype(np.float32), device="cuda")
    i32 = torch.as_tensor(rng.integers(-(1 << 30), 1 << 30, (B, N)).astype(np.int32),
                          device="cuda")
    for vals in ([f32], [i32, f32]):
        before = ell_gather_batched.launches
        got = ell_gather_batched(idx, vals)
        assert ell_gather_batched.launches == before + 1
        ref = ell_gather_batched_plain(idx, vals)
        torch.cuda.synchronize()
        for c, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == (B,) + shape[-2:]
            assert torch.equal(g.view(torch.int32), r.view(torch.int32))
            for b in range(B):
                one = ell_gather(idx[b] if per_replica else idx, [vals[c][b]])[0]
                assert torch.equal(g[b].view(torch.int32), one.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("counts", [(1, 129, 502), (0, 8192, 7000, 64), (900,)])
def test_cuda_poisson_batched(counts, pbc):
    """Each replica's count read on the device, its charged set split as a
    single launch splits it: replica b bit-equal to the single kernel on its
    first min(count, cap) charged sites, within 2e-6 of the largest plain
    value of the batched plain version, one launch; a count past the bucket
    sweeps the first cap sites."""
    _need_card()
    from devicekmc_tpu_torch.ops.compact import nonzero_fixed_batched
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_pairwise, poisson_pairwise_batched,
        poisson_pairwise_batched_plain,
    )

    rng = np.random.default_rng(sum(counts))
    N, B = 20_001, len(counts)
    cap = min(max(counts), 6000)
    coords = torch.as_tensor(rng.uniform(0, 60, (N, 3)).astype(np.float32), device="cuda")
    charge = np.zeros((B, N), dtype=np.int32)
    for b, n in enumerate(counts):
        charge[b, rng.choice(N, n, replace=False)] = rng.choice([-2, -1, 1, 2], n)
    charge = torch.as_tensor(charge, device="cuda")
    cidx, n_c = nonzero_fixed_batched(charge != 0, cap)
    cq = torch.gather(charge, 1, cidx.long()).float()
    scal = kernel_scalars(3.5e-10, 8.987552e9 / 23, [60.0, 60.0, 60.0], torch.float32)
    before = poisson_pairwise_batched.launches
    got = poisson_pairwise_batched(coords, cidx, cq, n_c, *scal, pbc)
    assert poisson_pairwise_batched.launches == before + 1
    ref = poisson_pairwise_batched_plain(coords, cidx, cq, n_c, *scal, pbc)
    torch.cuda.synchronize()
    assert n_c.tolist() == list(counts) and bool(torch.isfinite(got).all())
    for b, n in enumerate(counts):
        k = min(n, cap)
        one = poisson_pairwise(coords, cidx[b, :k].contiguous(), cq[b, :k].contiguous(),
                               *scal, pbc)
        assert torch.equal(got[b], one), b
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=2e-6 * max(float(ref.abs().max()), 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("precision,rel", [("f64", 1e-9), ("mixed", 2.4e-7)])
@pytest.mark.parametrize("cap", [0, 128])
def test_cuda_event_loop_batched(precision, rel, cap):
    """Four replicas (own keys and T_bg) in one launch: each replica
    bit-equal to a single launch on its tables and key, and against the
    batched plain loop events, elements, charges and keys equal, times
    within 1e-9 relative (f64) or 2 f32 ulps (f32); the tables of each
    replica (own compacted rows with a bucket) those of
    incremental_tables."""
    _need_card()
    import dataclasses

    from devicekmc_tpu_torch.ops.kmc_events import (
        kmc_event_loop, kmc_event_loop_batched, kmc_event_loop_batched_plain,
    )
    from devicekmc_tpu_torch.parallel.batched import batch_states
    from devicekmc_tpu_torch.physics.events import incremental_tables
    from devicekmc_tpu_torch.state import unbatch

    geom, params, state = _event_state(precision, cap)
    states = dataclasses.replace(batch_states(state, 4, base_seed=5), T_bg=torch.tensor(
        [300.0, 330.0, 360.0, 400.0], dtype=torch.float64, device="cuda"))
    tabs = incremental_tables(geom, params, states)
    singles = [incremental_tables(geom, params, unbatch(states, b)) for b in range(4)]
    for b, one in enumerate(singles):
        for t, o in zip(tabs[:5], one[:5]):
            assert torch.equal(t if t.dim() == o.dim() else t[b], o)
    args = (geom.neigh_idx, geom.rev_slot)
    tail = (1.0 / params.freq, params.max_events_per_superstep, params.dtype)
    before = kmc_event_loop_batched.launches
    got = kmc_event_loop_batched(*[t.clone() for t in tabs[:3]], *tabs[3:5], *args,
                                 states.element, states.charge, states.key, *tail)
    assert kmc_event_loop_batched.launches == before + 1
    ref = kmc_event_loop_batched_plain(*tabs[:5], *args, states.element, states.charge,
                                       states.key, *tail)
    torch.cuda.synchronize()
    for b, one in enumerate(singles):
        u = unbatch(states, b)
        e, q, r = kmc_event_loop(*one[:5], *args, u.element, u.charge, u.key, *tail)
        assert torch.equal(got[0][b], e) and torch.equal(got[1][b], q)
        assert torch.equal(got[3][b], r)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3][:, 1:], ref[3][:, 1:])
    np.testing.assert_allclose(got[3][:, 0].cpu().numpy(), ref[3][:, 0].cpu().numpy(),
                               rtol=rel)
    assert (got[3][:, 1] > 0).all() and not torch.equal(got[0][0], got[0][1])
    if cap:
        return
    # events whose touched rows straddle the first block boundary, at the
    # event caps 1 and 5: against the plain loop and each replica's launch
    prob, row_sums, block_sums = _straddle_tables(geom, tabs[0])
    for max_events in (1, 5):
        tail = (float("inf"), max_events, params.dtype)
        got = kmc_event_loop_batched(prob.clone(), row_sums.clone(), block_sums.clone(),
                                     *tabs[3:5], *args, states.element, states.charge,
                                     states.key, *tail)
        ref = kmc_event_loop_batched_plain(prob.clone(), row_sums.clone(), block_sums.clone(),
                                           *tabs[3:5], *args, states.element, states.charge,
                                           states.key, *tail)
        torch.cuda.synchronize()
        assert got[3][:, 1].tolist() == [float(max_events)] * 4
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.equal(got[2], ref[2]) and torch.equal(got[3][:, 1:], ref[3][:, 1:])
        np.testing.assert_allclose(got[3][:, 0].cpu().numpy(), ref[3][:, 0].cpu().numpy(),
                                   rtol=rel)
        for b in range(4):
            u = unbatch(states, b)
            e, q, r = kmc_event_loop(prob[b].clone(), row_sums[b].clone(),
                                     block_sums[b].clone(), *tabs[3:5], *args, u.element,
                                     u.charge, u.key, *tail)
            assert torch.equal(got[0][b], e) and torch.equal(got[1][b], q)
            assert torch.equal(got[3][b], r)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_cuda_batched_superstep_matches_single(precision):
    """Three replicas of the 256-site stack on the card, 3 supersteps:
    each replica's elements, charges, keys and events equal to the single
    superstep's on the card with its key; the batched gather launched twice
    (charge flags, rate table), the pair sweep and the event loop once a
    superstep, and no single kernel launched."""
    _need_card()
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather, ell_gather_batched
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop, kmc_event_loop_batched
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise, poisson_pairwise_batched
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import replace, unbatch
    from devicekmc_tpu_torch.superstep import superstep_impl

    geom, params, state = _event_state(precision, 0, phi_scale=0.0)
    params = replace(params, poisson_compact_cap=64, poisson_kernel="pallas")
    step = make_batched_superstep(geom, params, heat_mod.empty_heat_model(params, "cuda"))
    states = batch_states(state, 3, base_seed=11)
    singles = [unbatch(states, b) for b in range(3)]
    counters = (ell_gather_batched, poisson_pairwise_batched, kmc_event_loop_batched,
                ell_gather, poisson_pairwise, kmc_event_loop)
    for _ in range(3):
        before = [c.launches for c in counters]
        states, dts, m = step(states, 10.0)
        torch.cuda.synchronize()
        assert [c.launches - n for c, n in zip(counters, before)] == [
            2 if precision == "mixed" else 1, 1, 1, 0, 0, 0]
        for b in range(3):
            singles[b], dt, ms = superstep_impl(geom, params, singles[b], 10.0)
            got = unbatch(states, b)
            assert torch.equal(got.element, singles[b].element)
            assert torch.equal(got.charge, singles[b].charge)
            assert got.key == singles[b].key
            assert int(m["n_events"][b]) == ms["n_events"]
            assert float(dts[b]) == pytest.approx(dt, rel=1e-6)


# ---------------------------------------------------------------------------
# the captured superstep: the boundary CG kernels, the WHILE node, the graphs
# ---------------------------------------------------------------------------

def _boundary_system(B, dtype, seed=4):
    """B replicas' Dirichlet boundary systems of the 256-site stack on the
    card (random vacancies a replica, a warm start of random size), as
    physics.potential._dirichlet_system assembles them."""
    from devicekmc_tpu_torch.physics import potential as pot
    from devicekmc_tpu_torch.state import replace, stack_states

    geom, params, state = _event_state("f64", 0, seed=seed)
    states = stack_states([_event_state("f64", 0, seed=seed + b)[2] for b in range(B)])
    edge_g = pot._edge_conductance_boundary(geom, states, params).to(dtype)
    masks = (geom.bp_left_mask, geom.bp_right_mask, geom.bp_interior_mask)
    b_sys, matvec, diag, vals, pre = pot._dirichlet_system(geom, edge_g, -1.25, 1.25, masks)
    rng = np.random.default_rng(seed)
    x0 = torch.where(geom.bp_interior_mask,
                     torch.as_tensor(rng.standard_normal((B, geom.N)), device="cuda"),
                     0.0).to(dtype)
    return geom, b_sys, matvec, (diag, vals, geom.neigh_idx, geom.bp_interior_mask), pre, x0


def _ragged_operator(B, m, dtype, seed=0):
    """An operator in the layout of physics.potential._dirichlet_system with
    rows of every length from 0 to ``m``, three rows of each, a fifth of them
    contact rows: neighbours ascending and left-packed (pad -1), values
    negative on interior neighbours and 0 on contact neighbours and pads;
    the direction p 0 on contact sites, as a CG keeps it.  Returns
    ``(op, p, rz)``."""
    rng = np.random.default_rng(seed)
    lens = np.repeat(np.arange(m + 1), 3)
    rng.shuffle(lens)
    N = lens.size
    interior = rng.random(N) > 0.2
    interior[np.argmax(lens == 0)] = True    # an interior row with no neighbour
    nb = np.full((N, m), -1, dtype=np.int32)
    for i, n_i in enumerate(lens):
        nb[i, :n_i] = np.sort(rng.choice(np.delete(np.arange(N), i), n_i, replace=False))
    keep = (nb >= 0) & interior[np.clip(nb, 0, None)]
    vals = np.where(keep, -rng.uniform(0.1, 1.0, (B, N, m)), 0.0)
    diag = rng.uniform(1.0, 2.0, (B, N)) * (m + 1)
    p = np.where(interior, rng.standard_normal((B, N)), 0.0)
    cuda = lambda a, dt=dtype: torch.as_tensor(a, device="cuda").to(dt).contiguous()
    nb_t = cuda(nb, torch.int32)
    interior_t = cuda(interior, torch.bool)
    op = (cuda(diag), cuda(vals), nb_t, interior_t)
    return op, cuda(p), cuda(rng.uniform(0.5, 1.5, B))


def _matvec(op, p, rz, act):
    from devicekmc_tpu_torch.ops import boundary_cg as bcg

    ws = bcg.workspace(p.shape[0], op[2], op[3], p.dtype, "cuda")
    ws.p.copy_(p)
    ws.rz.copy_(rz)
    ws.act.copy_(torch.as_tensor(act, device="cuda"))
    ws.ap.fill_(7.0)
    ws.alpha.fill_(7.0)
    bcg.cg_matvec_dot(ws, op)
    torch.cuda.synchronize()
    return ws


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
def test_cuda_boundary_cg_kernels_match_plain(dtype, tol):
    """The two kernels, launched eagerly in a loop that reads the predicate,
    against cg_solve_batched (its plain version) on three replicas, one not
    solving: equal iteration counts, the iterate within tol of its scale,
    the inactive replica untouched, and the kernels' iterations counted on
    the device.  Then cg_matvec_dot alone on operators with rows of every
    length from 0 to max_nn (51, 70 and 133: one, two and three passes of a
    row's lanes) and contact rows, against its plain version (ap and alpha
    within tol of their scale) at B = 1 and 3, a stopped replica untouched,
    and each replica's bits at B = 3 those of its own launch at B = 1."""
    _need_card()
    from devicekmc_tpu_torch.ops import boundary_cg as bcg

    for m in (51, 70, 133):
        op, p, rz = _ragged_operator(3, m, dtype, seed=m)
        got = _matvec(op, p, rz, [True, False, True])
        ref = _matvec(op, p, rz, [True, True, True])
        row_len = got.row_len
        assert int(row_len.max()) == m and int(row_len.min()) == -1
        assert bool(((row_len == 0) & op[3]).any())
        bcg.cg_matvec_dot_plain(ref, op)
        for b in (0, 2):
            scale = float(ref.ap[b].abs().max())
            assert float((got.ap[b] - ref.ap[b]).abs().max()) <= tol * scale, (m, b)
            assert abs(float(got.alpha[b] - ref.alpha[b])) <= tol * abs(float(ref.alpha[b]))
        assert bool((got.ap[1] == 7.0).all()) and float(got.alpha[1]) == 7.0
        assert bool((got.ap[[0, 2]][:, ~op[3]] == 0).all())
        for b in (0, 2):
            one = _matvec(tuple(t[b:b + 1] if k < 2 else t for k, t in enumerate(op)),
                          p[b:b + 1], rz[b:b + 1], [True])
            assert torch.equal(one.ap[0], got.ap[b]) and torch.equal(one.alpha[0], got.alpha[b])

    from devicekmc_tpu_torch.ops.cg import cg_solve_batched

    geom, b, matvec, op, pre, x0 = _boundary_system(3, dtype)
    active = torch.tensor([True, False, True], device="cuda")
    ctol = 1e-10 if dtype == torch.float64 else 1e-5
    ref = cg_solve_batched(matvec, b, x0, pre, tol=ctol, maxiter=5000, active=active)
    ws = bcg.workspace(3, geom.neigh_idx, geom.bp_interior_mask, dtype, "cuda")
    bcg.cg_setup(op, b, x0, pre, ctol, 5000, active, ws)
    stream = torch.cuda.current_stream().cuda_stream
    while int(ws.cond):
        bcg.cg_matvec_dot(ws, op, stream)
        bcg.cg_update_direction(ws, 5000, 0, stream)
    got, want = ws.iters.tolist(), ref.iters.tolist()
    assert want[0] > 5 and got[1] == want[1] == 0
    if dtype == torch.float64:
        assert got == want
    else:
        # f32 sums in another order: a stop may move by an iteration or two
        assert all(abs(a - b) <= 2 for a, b in zip(got, want))
    assert bcg.device_iterations(ws) == max(got)
    scale = float(ref.x.abs().max())
    assert float((ws.x - ref.x).abs().max()) <= tol * scale
    assert torch.equal(ws.x[1], x0[1])
    assert ws.rr.le(ws.thresh2).tolist() == ref.converged.tolist()


#: rows of the vectors cg_update_direction is checked on: 391 tiles of 512
#: rows, the last one partial: at B = 1 a block a tile (an H100 holds 528 or
#: more blocks of it), at B = 3 and 8 several tiles a block (the direction
#: reads r, minv and p again for all but its first), a block's tiles
#: spanning two replicas
UD_ROWS = 200_001


def _update_state(B, dtype, seed=0, n=UD_ROWS):
    """A workspace of B replicas of ``n`` rows in the middle of a solve
    (random iterate, residual, direction, its product, Jacobi inverse, alpha
    and r.z; r.r as stored by the last iteration), every replica asked to
    solve and iterating; the structure a one-row-per-site chain.  Each
    replica's values depend on its seed alone."""
    from devicekmc_tpu_torch.ops import boundary_cg as bcg

    nb = torch.full((n, 1), -1, dtype=torch.int32)
    ws = bcg.workspace(B, nb, torch.ones(n, dtype=torch.bool), dtype, "cuda")
    for b in range(B):
        rng = np.random.default_rng(seed + b)
        for name in ("x", "r", "p", "ap"):
            getattr(ws, name)[b] = torch.as_tensor(rng.standard_normal(n))
        ws.minv[b] = torch.as_tensor(rng.uniform(0.02, 0.05, n))
        ws.alpha[b], ws.rz[b], ws.rr[b] = (float(v) for v in rng.uniform(0.5, 1.5, 3))
    ws.act0.fill_(True)
    ws.act.fill_(True)
    ws.ctl[1] = B
    return ws


def _clone_ws(ws):
    import dataclasses

    return dataclasses.replace(ws, **{f.name: getattr(ws, f.name).clone()
                                      for f in dataclasses.fields(ws)
                                      if isinstance(getattr(ws, f.name), torch.Tensor)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
def test_cuda_cg_update_direction_matches_plain(dtype, tol):
    """cg_update_direction against its plain version at B = 1, 3 and 8 on
    vectors of 200,001 rows: x, r, p, r.z, r.r and beta of every iterating
    replica within tol of their scale, counts, flags, the loop's count and
    predicate equal; a replica not solving untouched (its p too); a replica
    whose r.r falls under its threshold stops, its p still updated; the
    predicate 0 once the loop reaches maxiter; the grid within the blocks
    the card holds at once; each replica's bits at B = 3 and 8 those of its
    own launch at B = 1."""
    _need_card()
    from devicekmc_tpu_torch.ops import boundary_cg as bcg

    fields = ("x", "r", "p", "rz", "rr", "beta")
    maxiter = 40
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B in (1, 3, 8):
        for capped in (False, True):
            ws = _update_state(B, dtype)
            if capped:
                ws.ctl[0] = maxiter - 1
            if B > 1:
                ws.act0[1] = ws.act[1] = False
                ws.ctl[1] = B - 1
                ws.thresh2[2] = 1e30         # r.r falls under it: stops now
            grid, per = bcg.update_direction_grid(ws)
            assert grid * per >= B * bcg.n_tiles(UD_ROWS) and grid <= 8 * sms
            assert (per > 1) == (B > 1)
            before, ref = _clone_ws(ws), _clone_ws(ws)
            bcg.cg_update_direction(ws, maxiter)
            bcg.cg_update_direction_plain(ref, maxiter)
            torch.cuda.synchronize()
            on = [b for b in range(B) if B == 1 or b != 1]
            for f in fields:
                got, want = getattr(ws, f)[on], getattr(ref, f)[on]
                scale = float(want.abs().max())
                assert float((got - want).abs().max()) <= tol * scale, (B, capped, f)
            for f in ("iters", "act", "ctl", "cond", "total"):
                assert torch.equal(getattr(ws, f), getattr(ref, f)), (B, capped, f)
            assert int(ws.cond) == (0 if capped else 1) and int(ws.ctl[0]) == (
                maxiter if capped else 1)
            if B > 1:
                assert ws.act.tolist()[:3] == [True, False, False]
                assert ws.iters.tolist()[:3] == [1, 0, 1] and int(ws.ctl[1]) == B - 2
                for f in fields:
                    assert torch.equal(getattr(ws, f)[1], getattr(before, f)[1]), (B, f)
                assert not torch.equal(ws.p[2], before.p[2])
    for B in (3, 8):
        ws = _update_state(B, dtype)
        bcg.cg_update_direction(ws, maxiter)
        for b in range(B):
            one = _update_state(1, dtype, seed=b)
            bcg.cg_update_direction(one, maxiter)
            torch.cuda.synchronize()
            for f in fields + ("iters", "act"):
                assert torch.equal(getattr(one, f)[0], getattr(ws, f)[b]), (B, b, f)


def _capture_solve(B, dtype, active, maxiter=5000):
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops.graph import Graph

    geom, b, matvec, op, pre, x0 = _boundary_system(B, dtype)
    ws = bcg.workspace(B, geom.neigh_idx, geom.bp_interior_mask, dtype, "cuda")
    g = Graph(lambda: bcg.cg_solve_device(op, b, x0, pre, 1e-10, maxiter, active, ws), "cuda")
    return g, ws, (matvec, b, x0, pre)


@pytest.mark.cuda
@pytest.mark.parametrize("maxiter", [5000, 7])
def test_cuda_boundary_cg_graph_while_node(maxiter):
    """cg_solve_device captured with its WHILE node: a replay equals
    cg_solve_batched (counts equal, iterate within 1e-12 of its scale, the
    cap at maxiter kept), replays are bit-equal, and with no replica active
    the node runs no iteration."""
    _need_card()
    from devicekmc_tpu_torch.ops.cg import cg_solve_batched

    active = torch.tensor([True, True, False], device="cuda")
    g, ws, (matvec, b, x0, pre) = _capture_solve(3, torch.float64, active, maxiter)
    ref = cg_solve_batched(matvec, b, x0, pre, tol=1e-10, maxiter=maxiter, active=active)
    ws.total.zero_()
    res = g()
    x1 = res.x.clone()
    assert res.iters.tolist() == ref.iters.tolist()
    assert int(ws.total) == int(ref.iters.max()) <= maxiter
    assert float((res.x - ref.x).abs().max()) <= 1e-12 * float(ref.x.abs().max())
    assert torch.equal(g().x, x1)
    active.zero_()
    ws.total.zero_()
    res = g()
    assert res.iters.tolist() == [0, 0, 0] and int(ws.total) == 0
    assert torch.equal(res.x, x0)


@pytest.mark.cuda
def test_cuda_device_while_raises_without_node(monkeypatch):
    """device_while outside a capture raises, and a WHILE node that cannot be
    made fails the capture: nothing runs eagerly instead."""
    _need_card()
    from devicekmc_tpu_torch.ops import graph as og

    cond = torch.ones(1, dtype=torch.int32, device="cuda")
    ran = []
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        og.device_while(cond, lambda h, s: ran.append(1))
    real = og._fn

    def failing(name):
        if name == "dkmc_while_begin":
            return lambda *a: 801     # cudaErrorNotSupported
        return real(name)

    monkeypatch.setattr(og, "_fn", failing)
    active = torch.tensor([True], device="cuda")
    with pytest.raises(RuntimeError, match="WHILE node could not be added"):
        _capture_solve(1, torch.float64, active)
    assert not ran


@pytest.mark.cuda
def test_cuda_graph_capture_rejects_a_read():
    """A capture runs with synchronizing calls an error: a read of the device
    inside the captured function fails the capture."""
    _need_card()
    from devicekmc_tpu_torch.ops.graph import Graph

    x = torch.ones(4, device="cuda")
    with pytest.raises(RuntimeError):
        Graph(lambda: float(x.sum()), "cuda")
    assert torch.cuda.get_sync_debug_mode() == 0


def _graph_sim(tmp_path, **over):
    import dataclasses

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, perturb_structure=True, pristine=True,
        initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
        precision="mixed", poisson_kernel="pallas", V_switch=[2.5], t_switch=[1e30],
        output_dir=str(tmp_path), log_freq=1000)
    cfg = dataclasses.replace(cfg, **over)
    return Simulation(cfg, elements=s.elements, coords=s.coords, device="cuda")


@pytest.mark.cuda
def test_cuda_graph_superstep_matches_eager(tmp_path):
    """The engine's per-step graph on the small stack against the eager
    superstep_impl from the same state, step by step: elements and events
    equal, cg_iters_boundary equal, potentials within 1e-12 of their scale;
    one capture from each of the two slots the state alternates between,
    and the three kernels counted a replay."""
    _need_card()
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather_batched
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop_batched
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise_batched
    from devicekmc_tpu_torch.superstep import superstep_impl

    sim = _graph_sim(tmp_path)
    sim.run_bias_point(2.5, 1e30, max_steps=1)
    assert sim._graph is not None and sim._graph.captures == 1
    eager = sim.state
    counters = (ell_gather_batched, poisson_pairwise_batched, kmc_event_loop_batched)
    for k in range(6):
        before = [c.launches for c in counters]
        got, dt, m = sim._superstep(sim.state, 2.5)
        assert [c.launches - n for c, n in zip(counters, before)] == [2, 1, 1]
        sim.state = got
        eager, dt_e, m_e = superstep_impl(sim.geom, sim.params, eager, 2.5)
        assert torch.equal(got.element, eager.element), k
        assert torch.equal(got.charge, eager.charge), k
        assert got.key == eager.key and m["n_events"] == m_e["n_events"], k
        assert m["cg_iters_boundary"] == m_e["cg_iters_boundary"], k
        phi, phi_e = (s.potential_boundary + s.potential_charge for s in (got, eager))
        assert float((phi - phi_e).abs().max()) <= 1e-12 * float(phi_e.abs().max()), k
        # the f32 rate table of potentials that differ in their last bits
        assert dt == pytest.approx(dt_e, rel=1e-6)
    assert sim._graph.captures == 2


@pytest.mark.cuda
def test_cuda_graph_batch_matches_per_step(tmp_path):
    """batch_steps = 4 through the batch graph against the per-step graph:
    the same elements, events and output.txt numbers, a limit inside a batch
    included (log_freq 3 puts snapshot steps between the batches)."""
    _need_card()
    import os

    runs = {}
    for bs in (1, 4):
        d = tmp_path / f"b{bs}"
        d.mkdir()
        sim = _graph_sim(d, batch_steps=bs, log_freq=3)
        sim.run_bias_point(2.5, 1e30, max_steps=9)
        with open(os.path.join(str(d), "output.txt")) as f:
            # the per-step driver writes no separator after its last step
            runs[bs] = ([ln for ln in f.read().splitlines()
                         if not ln.startswith(("Z - calculation time", "-", "Created folder"))],
                        sim.state.element.clone())
    assert runs[1][0] == runs[4][0]
    assert torch.equal(runs[1][1], runs[4][1])


@pytest.mark.cuda
def test_cuda_graph_ensemble_matches_eager():
    """make_batched_superstep at B = 3 (a graph a call) against the eager
    superstep_batched: elements, events and keys equal, potentials within
    1e-12 of their scale, the returned tensors the caller's own."""
    _need_card()
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import replace
    from devicekmc_tpu_torch.superstep import superstep_batched

    geom, params, state = _event_state("mixed", 0, phi_scale=0.0)
    params = replace(params, poisson_compact_cap=64, poisson_kernel="pallas")
    step = make_batched_superstep(geom, params, heat_mod.empty_heat_model(params, "cuda"))
    states = eager = batch_states(state, 3, base_seed=11)
    kept = []
    for k in range(4):
        states, dts, m = step(states, 10.0)
        kept.append(states.element.clone())
        eager, dts_e, m_e = superstep_batched(geom, params, eager, 10.0)
        assert torch.equal(states.element, eager.element), k
        assert torch.equal(states.key, eager.key), k
        assert torch.equal(m["n_events"], m_e["n_events"]), k
        assert torch.equal(m["cg_iters_boundary"], m_e["cg_iters_boundary"]), k
        phi, phi_e = (s.potential_boundary + s.potential_charge for s in (states, eager))
        assert float((phi - phi_e).abs().max()) <= 1e-12 * float(phi_e.abs().max()), k
    assert torch.equal(kept[-1], states.element)


@pytest.mark.cuda
def test_cuda_graph_launches_counted_on_card():
    """The batched kernels a captured superstep replays count their launches
    on the card (csrc/launch_count.cuh): after 3 calls of the ensemble
    superstep at B = 3 the card's counts are the wrappers' (2, 1 and 1 a
    superstep), counted by Graph at each replay."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather_batched
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop_batched
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise_batched
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import replace

    geom, params, state = _event_state("mixed", 0, phi_scale=0.0)
    params = replace(params, poisson_compact_cap=64, poisson_kernel="pallas")
    step = make_batched_superstep(geom, params, heat_mod.empty_heat_model(params, "cuda"))
    states = batch_states(state, 3, base_seed=11)
    wrappers = (ell_gather_batched, poisson_pairwise_batched, kmc_event_loop_batched)
    host0 = [w.launches for w in wrappers]
    card0 = _build.launch_counts("cuda").tolist()
    for _ in range(3):
        states, _, _ = step(states, 10.0)
    host = [w.launches - n for w, n in zip(wrappers, host0)]
    card = [a - b for a, b in zip(_build.launch_counts("cuda").tolist(), card0)][:3]
    assert list(_build.COUNTED_ON_CARD)[:3] == [w.__name__ for w in wrappers]
    assert host == card == [6, 3, 3]


# ---------------------------------------------------------------------------
# the transport solve's device loops (csrc/transport_cg.cu) and the transport
# superstep as a captured graph
# ---------------------------------------------------------------------------

def _transport_sim(tmp_path, heat=False, crossbar=False, fused=True, **over):
    """The transport configuration of the captured superstep (blocked, mixed,
    on-the-fly metal block, band, Jacobi warm re-solve) on the card: the
    small stack, or a crossbar of about 6,000 sites (``crossbar``: several
    row tiles, blocks and metal tiles); ``heat`` adds the global model."""
    import dataclasses

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.state import make_substoichiometric
    from devicekmc_tpu_torch.structure import make_crossbar_structure, make_test_structure

    if crossbar:
        s = make_crossbar_structure(nx_contact=10, nx_oxide=24, ny=10, nz=10, seed=1)
        elems = make_substoichiometric(s.elements, 0.02, seed=5)
        kw = dict(nn_dist=3.5, pbc=False, site_order="x", poisson_compact_cap=2048,
                  tunnel_int_steps=256, V_switch=[1.0])
    else:
        s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
        elems = make_substoichiometric(s.elements, 0.08, seed=3)
        kw = dict(nn_dist=3.0, V_switch=[10.0], poisson_compact_cap=64)
    cfg = KMCConfig(
        lattice=list(s.lattice), num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact, num_atoms_contact=s.num_atoms_contact,
        layers=s.layers, solve_potential=True, perturb_structure=True, rnd_seed_kmc=7,
        precision="mixed", poisson_kernel="pallas", solve_current=True, transport="blocked",
        transport_cc="fly", transport_precond="deflated", coarse_slabs=4,
        solver_chunk_iters=40, tunnel_vac_cap=-1, transport_tol=1e-11, t_switch=[1e30],
        output_dir=str(tmp_path), log_freq=1000, **kw)
    if heat:
        cfg = dataclasses.replace(cfg, solve_heating_global=True,
                                  A=s.lattice[1] * 1e-10 * s.lattice[2] * 1e-10)
    cfg = dataclasses.replace(cfg, **over)
    return Simulation(cfg, elements=elems, coords=s.coords, device="cuda", fused=fused)


@pytest.mark.cuda
def test_cuda_band_and_fly_out_entries_bit_equal():
    """The out= entries of the band (row 3) and the symmetric fly matvec
    (row 5) write into the caller's buffers the allocating entries' bits,
    on a side stream too, and the card counts one launch of each a call."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops.banded import band_slots, banded_matvec, banded_matvec_out
    from devicekmc_tpu_torch.ops.wkb_fly import (
        matvec_scratch, wkb_fly_matvec, wkb_fly_matvec_out,
    )

    g = torch.Generator(device="cpu").manual_seed(3)
    R, m_pad, B = 7, 8, 128
    C4 = band_slots(torch.randn((R, m_pad, B, B), generator=g)).to("cuda")
    xp = torch.randn((R + m_pad - 1) * B, generator=g).cuda()
    out = torch.full((R * B,), float("nan"), device="cuda")
    names = _build.COUNTED_ON_CARD
    card0 = _build.launch_counts("cuda").tolist()
    side = torch.cuda.Stream()
    banded_matvec_out(C4, xp, out, side.cuda_stream)
    side.synchronize()
    assert torch.equal(out, banded_matvec(C4, xp))
    env = _env(False)
    for n in (3527, 2001):
        pos, cb, _ = _points(n, n)
        x = torch.randn(n, generator=g).cuda()
        y = torch.full((n,), float("nan"), device="cuda")
        wkb_fly_matvec_out(pos, cb, x, env, y, matvec_scratch(n, "cuda"))
        assert torch.equal(y, wkb_fly_matvec(pos, cb, x, env))
    card = [a - b for a, b in zip(_build.launch_counts("cuda").tolist(), card0)]
    assert card[names.index("banded_matvec_out")] == 1
    assert card[names.index("wkb_fly_matvec_out")] == 2


def _transport_op(sim, seed=0):
    """The device-form operator of ``sim``'s state and its workspace, the
    inner direction p and the refinement's iterate set from seeded noise."""
    import dataclasses

    from devicekmc_tpu_torch.physics import current

    cc = dict(sim._cc)
    captured = {}
    solve = current.transport_cg.solve

    def grab(tws, op, x0, go, tol, maxiter, max_outer=40):
        captured.update(tws=tws, op=op, x0=x0.clone(), tol=tol, maxiter=maxiter)
        return solve(tws, op, x0, go, tol, maxiter, max_outer)

    current.transport_cg.solve = grab
    try:
        # a changed bias of the last solve: no unchanged-network skip
        state = dataclasses.replace(sim.state, transport_Vd_prev=float("nan"))
        current.update_power(sim.geom, sim.params, state, sim.cfg.V_switch[0], cc=cc,
                             allow_skip=True)
    finally:
        current.transport_cg.solve = solve
    tws, op = captured["tws"], captured["op"]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n = tws.x.shape[0]
    tws.cg.p[0].copy_(torch.randn(n, generator=gen).float())
    tws.cg.x[0].copy_(torch.randn(n, generator=gen).float())
    tws.x.copy_(captured["x0"])
    tws.scale.fill_(1e-3)
    return tws, op, captured


def _map_tws(tws, fn):
    """A transport workspace with ``fn`` applied to every tensor, those of
    its nested CG states (``cg``, ``c64``) and the fly scratch too."""
    import copy
    import dataclasses

    kw = {}
    for f in dataclasses.fields(tws):
        v = getattr(tws, f.name)
        if torch.is_tensor(v):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.replace(v, **{
                g.name: fn(getattr(v, g.name)) for g in dataclasses.fields(v)
                if torch.is_tensor(getattr(v, g.name))})
        elif f.name == "fly":
            v = tuple(fn(t) for t in v)
        else:
            v = copy.copy(v)
        kw[f.name] = v
    return type(tws)(**kw)


def _clone_tws(tws):
    return _map_tws(tws, lambda t: t.clone())


def _cpu_ws(ws):
    """A transport workspace's CPU copy."""
    return _map_tws(ws, lambda t: t.cpu())


def _cpu_op(op):
    """The operator's CPU twin for the plain versions (whose blocks stay on
    the card: the plain operator parts run there and come back)."""
    cpu = lambda v: v.cpu() if torch.is_tensor(v) else v
    cuda = lambda v: v.cuda() if torch.is_tensor(v) else v
    op_c = op._replace(**{k: cpu(v) for k, v in op._asdict().items()
                          if k not in ("plain_blocks", "plain_rows", "env", "slots")},
                       slots=None if op.slots is None else op.slots.to("cpu"))
    blocks, rows = op.plain_blocks, op.plain_rows
    return op_c._replace(
        plain_blocks=lambda x, wd: tuple(cpu(v) for v in blocks(x.cuda(), wd)),
        plain_rows=lambda x, wd, band_y, y_cc, parts: rows(
            x.cuda(), wd, cuda(band_y), y_cc.cuda(), tuple(cuda(v) for v in parts)).cpu())


def _rows_update_close(k, p, start):
    """transport_rows_update's workspace ``k`` (card) against its plain
    version's ``p`` (CPU), both from the iterating state ``start``: the
    tolerances of test_cuda_transport_kernels_match_plain."""
    ref = p.cg.ap
    scale = float(ref.abs().max())
    assert float((k.cg.ap.cpu() - ref).abs().max()) <= 2e-6 * scale
    # p.ap (= r.z / alpha) within 1e-6 of the sum of its terms' sizes
    terms = float((start.cg.p.cpu() * ref).abs().sum())
    rz = float(start.cg.rz)
    assert abs(rz / float(k.cg.alpha) - rz / float(p.cg.alpha)) <= 1e-6 * terms
    for f in ("x", "r", "p"):
        want = getattr(p.cg, f)
        err = float((getattr(k.cg, f).cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), f
    for f in ("xs32", "xw", "xm"):
        want = getattr(p, f)
        err = float((getattr(k, f).cpu() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), f
    for f in ("rz", "rr", "beta"):
        assert float(getattr(k.cg, f)) == pytest.approx(float(getattr(p.cg, f)), rel=1e-4), f
    for f in ("act", "iters", "ctl", "cond", "total"):
        assert torch.equal(getattr(k.cg, f).cpu(), getattr(p.cg, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("crossbar", [False, True])
def test_cuda_transport_kernels_match_plain(tmp_path, crossbar):
    """Each kernel of the transport CG against its plain version on the same
    inputs (the operator of a state after 2 supersteps, a seeded direction):
    the f64 pack bit-equal (with and without the round's correction);
    transport_rows_update (the rows, update and direction in one launch)
    against rows_plain then update_pack_plain: ap within 2e-6 of its largest
    entry (f32 rows whose only other order is the band's and the blocks'
    sums), p.ap (= r.z / alpha) within 1e-6 of the sum of its terms' sizes,
    x, r, p and the packed xs, xw, xm within 1e-5 of their largest entry and
    r.z, r.r, beta within 1e-4 relative (the update from an alpha and ap a
    few ulps apart, f32 sums of 10^3-10^5 terms in another order), the flag,
    counts and predicate equal; the kernel's x and r bit-equal to the
    boundary build of cg_update_direction (minv 1) from the kernel's own ap
    and alpha, its packed direction bit-equal to pack_plain of its own p; a
    stopped iterate's launch leaves every vector and scalar as it was
    (the loop's count, the flag and predicate set); transport_blocks'
    products (f32 and f64) within 1e-5 of the sum of their terms' sizes,
    the dots within 1e-5 (f32) and 1e-12 (f64) of theirs; transport_rows'
    f64 residual within 1e-9 of its largest entry, r.r that of the kernel's
    residual; refine's b_in, flags, counts, scale, ||r|| and packed
    direction equal given the same residual, r.r of b_in within 1e-5."""
    _need_card()
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    sim = _transport_sim(tmp_path, crossbar=crossbar, fused=False)
    sim.run_bias_point(sim.cfg.V_switch[0], 1e30, max_steps=2)
    tws, op, cap = _transport_op(sim)
    op_c = _cpu_op(op)
    nv = int(op.n_vac)

    for first in (True, False):
        k, p = _clone_tws(tws), _cpu_ws(_clone_tws(tws))
        tcg.pack(k, op, first)
        tcg.pack_plain(p, op_c, True, first)
        for f in ("xs64", "xm", "x"):
            assert torch.equal(getattr(k, f).cpu(), getattr(p, f)), (first, f)

    # transport_rows_update: a CG state after the round's set-up and one
    # iteration's products
    base = _clone_tws(tws)
    tcg.pack(base, op, True)
    tcg.fly(base, op)
    tcg.blocks(base, op, True)
    tcg.rows(base, op)
    base.go.fill_(True)
    base.thresh.fill_(float(base.rsum) ** 0.5 * 1e-3)
    tcg.refine(base, op, True, 40, 20000)
    tcg.products(base, op)
    assert bool(base.cg.act)
    k, b = _clone_tws(base), _clone_tws(base)
    p = _cpu_ws(_clone_tws(base))
    tcg.rows_update(k, op)
    tcg.rows_update_plain(p, op_c)
    _rows_update_close(k, p, base)
    # the update half: the boundary build from the kernel's own ap and alpha
    b.cg.ap.copy_(k.cg.ap)
    b.cg.alpha.copy_(k.cg.alpha)
    bcg.cg_update_direction(b.cg, tcg.INNER_MAXITER)
    for f in ("x", "r", "act", "iters", "ctl", "cond", "total"):
        assert torch.equal(getattr(k.cg, f), getattr(b.cg, f)), f
    ref = _cpu_ws(_clone_tws(k))
    tcg.pack_plain(ref, op_c, False)
    for f in ("xs32", "xw", "xm"):
        assert torch.equal(getattr(k, f).cpu(), getattr(ref, f)), f
    # a stopped iterate: nothing moves but the loop's count, flag, predicate
    s_ = _clone_tws(base)
    # (a converged iterate: r.r at its threshold, the flag down)
    s_.cg.act.fill_(False)
    s_.cg.thresh2.copy_(s_.cg.rr)
    before = _clone_tws(s_)
    tcg.rows_update(s_, op)
    for f in ("x", "r", "p", "ap", "rz", "rr", "alpha", "beta", "iters", "act"):
        assert torch.equal(getattr(s_.cg, f), getattr(before.cg, f)), f
    for f in ("xs32", "xw", "xm"):
        assert torch.equal(getattr(s_, f), getattr(before, f)), f
    assert int(s_.cg.ctl[0]) == int(before.cg.ctl[0]) + 1 and int(s_.cg.ctl[1]) == 0
    assert int(s_.cg.cond) == 0 and int(s_.cg.total) == int(before.cg.total) + 1

    # transport_blocks of the direction (lo) and of the iterate (hi)
    for hi in (False, True):
        k = _clone_tws(base)
        if hi:
            tcg.pack(k, op, True)
        p = _cpu_ws(_clone_tws(k))
        tcg.blocks(k, op, hi)
        tcg.blocks_plain(p, op_c, hi)
        xs = (p.xs64 if hi else p.xs32).double()
        xa = xs[2:]
        T_vm, T_vv = op_c.T_vm[:nv].double().abs(), op_c.T_vv[:nv, :nv].double().abs()
        xv = xa[op_c.vidx[:nv].long()].abs()
        xm = xa[op_c.mp.long()].abs()
        sizes = {"mv": xv @ T_vm, "y_vm": T_vm @ xm, "y_vv": T_vv @ xv}
        if not hi:
            nb = op_c.anb[op_c.vidx[:nv].long()].long()
            sizes["y_bump"] = (op_c.dyn[:nv].double().abs() * xa[nb.clamp(min=0)].abs()).sum(1)
        for f, size in sizes.items():
            got, want = getattr(k, f).cpu().double(), getattr(p, f).double()
            n = size.shape[0]
            assert bool(((got[:n] - want[:n]).abs() <= 1e-5 * size + 1e-30).all()), (hi, f)
        dots = (k.dots64 if hi else k.dots32).cpu().double()
        want = (p.dots64 if hi else p.dots32).double()
        na = op_c.anb.shape[0]
        dsize = torch.stack([(op_c.gnd.abs() * xa[:na].abs())[op.gnd_lo:].sum(),
                             (op_c.src.abs() * xa[:na].abs())[:op.nsi].sum()])
        assert bool(((dots - want).abs() <= (1e-12 if hi else 1e-5) * dsize).all()), hi

    # transport_rows (f64) from the iterate's products
    k = _clone_tws(base)
    tcg.pack(k, op, True)
    tcg.fly(k, op)
    tcg.blocks(k, op, True)
    p = _cpu_ws(_clone_tws(k))
    tcg.rows(k, op)
    tcg.rows_plain(p, op_c, True)
    ref = p.r
    scale = float((op_c.b - ref).abs().max())
    assert float((k.r.cpu() - ref).abs().max()) <= 1e-9 * scale
    # r.r of the kernel's own residual, in its tile order
    assert float(k.rsum) == pytest.approx(float((k.r * k.r).sum()), rel=1e-12)

    for first in (True, False):
        k = _clone_tws(tws)
        tcg.pack(k, op, True)
        tcg.fly(k, op)
        tcg.blocks(k, op, True)
        tcg.rows(k, op, True)
        k.go.fill_(True)
        k.thresh.fill_(float(k.rsum) ** 0.5 * 1e-3)
        k.cg.iters.fill_(17)
        k.it_in.fill_(100)
        p = _cpu_ws(_clone_tws(k))
        tcg.refine(k, op, first, 40, 20000)
        tcg.refine_plain(p, op_c, first, 40, 20000)
        for f in ("it_out", "it_in", "rnorm", "scale", "cond", "xs32", "xw", "xm"):
            assert torch.equal(getattr(k, f).cpu(), getattr(p, f)), (first, f)
        for f in ("x", "r", "p", "act", "act0", "iters", "ctl", "cond"):
            assert torch.equal(getattr(k.cg, f).cpu(), getattr(p.cg, f)), (first, f)
        assert float(k.cg.rz) == pytest.approx(float(p.cg.rz), rel=1e-5)
        assert float(k.cg.thresh2) == pytest.approx(float(p.cg.thresh2), rel=1e-4)
        # the last ticket's block set the ticket back; a second launch from
        # the same state gives the same bits
        assert int(k.ticket_b) == 0
        again = _clone_tws(k)
        for w in (k, again):
            w.it_out.fill_(3)
            w.cg.iters.fill_(17)
        tcg.refine(k, op, first, 40, 20000)
        tcg.refine(again, op, first, 40, 20000)
        assert torch.equal(k.cg.rz, again.cg.rz) and torch.equal(k.cg.p, again.cg.p)
        assert torch.equal(k.xw, again.xw) and torch.equal(k.cond, again.cond)


@pytest.mark.cuda
@pytest.mark.parametrize("crossbar,inner_cap", [(False, None), (True, None), (True, 5)])
def test_cuda_transport_solve_graph_equals_eager(tmp_path, monkeypatch, crossbar, inner_cap):
    """transport_cg.solve captured (two nested WHILE nodes) and run from the
    host loop on the same operator and warm start: the iterate and the
    counts bit for bit, also when rounds stop at an inner cap of 5
    iterations inside the host loop's chunks; both meet the criterion (but
    at that cap, where the 40 rounds run out first); the
    captured replay allocates nothing and reads nothing (sync debug mode
    "error" around it), and a replay with go False runs no round.  The
    nesting, counted on the card: each replay's inner WHILE node runs the
    solve's inner iterations and no more (``cg.total``), inside the outer
    node's rounds (``it_out``: all 40 at the inner cap), and the fused
    tail (transport_rows_update) launched once an inner iteration."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.graph import Graph

    if inner_cap is not None:
        monkeypatch.setattr(tcg, "INNER_MAXITER", inner_cap)

    sim = _transport_sim(tmp_path, crossbar=crossbar, fused=False)
    sim.run_bias_point(sim.cfg.V_switch[0], 1e30, max_steps=2)
    tws, op, cap = _transport_op(sim)
    x0, tol, maxiter = cap["x0"], cap["tol"], cap["maxiter"]
    x0 = x0 * (1 + 1e-3 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(1),
                                       dtype=torch.float64).cuda())
    go = torch.ones(1, dtype=torch.bool, device="cuda")
    res = tcg.solve(tws, op, x0, go, tol, maxiter)
    eager = (res.x.clone(), int(res.iters), float(res.residual), int(tws.it_out))
    # at the inner cap of 5 the rounds run out before the criterion is met
    assert (float(res.residual) <= float(res.thresh)) == (inner_cap is None) and eager[1] > 0
    g = Graph(lambda: tcg.solve(tws, op, x0, go, tol, maxiter), "cuda")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    counts = _build.launch_counts("cuda")
    try:
        tws.cg.total.zero_()
        counts.zero_()
        out = g()
        g()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.equal(out.x, eager[0])
    assert (int(out.iters), float(out.residual), int(tws.it_out)) == eager[1:]
    assert int(tws.cg.total) == 2 * eager[1]
    # one launch of the fused tail an inner iteration, counted on the card
    ru = _build.COUNTED_ON_CARD.index("transport_rows_update")
    assert int(counts[ru]) == 2 * eager[1]
    assert eager[3] == (tcg.MAX_OUTER if inner_cap is not None else eager[3]) >= 1
    go.fill_(False)
    out = g()
    assert torch.equal(out.x, x0) and int(out.iters) == 0 and int(tws.it_out) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("heat", [False, True])
def test_cuda_transport_graph_superstep_matches_eager(tmp_path, heat):
    """The engine's captured transport superstep (heating off or global)
    against the eager engine from the same start, step by step and bit for
    bit: elements, events, cg_iters_power, I_macro, P_tot, T_bg, the
    virtual potentials and the tunnel store; a skipped or a partial
    assembly among the steps; one capture from each slot."""
    _need_card()
    from devicekmc_tpu_torch.engine import make_superstep

    runs = {}
    for kind in ("graph", "eager"):
        d = tmp_path / kind
        d.mkdir()
        sim = _transport_sim(d, heat=heat)
        if kind == "eager":
            sim._make = lambda g, p, h: make_superstep(g, p, h)
        rec = runs[kind] = []
        step = sim._superstep

        def wrapped(state, Vd, *a, step=step, rec=rec):
            out = step(state, Vd, *a)
            st, m = out[0], out[2]
            rec.append((st.element.clone(), m["n_events"], m["cg_iters_power"], st.I_macro,
                        st.P_tot, st.T_bg, st.virtual_potentials.clone(),
                        st.tt_vm.clone(), st.tt_vv.clone(), st.tt_slot_atom.clone(),
                        st.tt_valid, m["transport_partial_assembly"]))
            return out

        sim._superstep = wrapped
        sim.run_bias_point(10.0, 1e30, max_steps=6)
        if kind == "graph":
            assert sim._graph is not None and sim._graph.captures == 2
        else:
            assert sim._graph is None
    assert len(runs["graph"]) == len(runs["eager"]) == 6
    for k, (a, b) in enumerate(zip(runs["graph"], runs["eager"])):
        for j, (u, v) in enumerate(zip(a, b)):
            same = torch.equal(u, v) if torch.is_tensor(u) else u == v
            assert same, (k, j)
    assert any(r[-1] != 0 for r in runs["graph"])


@pytest.mark.cuda
def test_cuda_transport_graph_batch_matches_per_step(tmp_path):
    """batch_steps = 4 through the transport batch graph (one replay a
    batch) against the per-step graph: the same output.txt numbers and
    elements (log_freq 3 puts snapshot steps between the batches)."""
    _need_card()
    import os

    runs = {}
    for bs in (1, 4):
        d = tmp_path / f"b{bs}"
        d.mkdir()
        sim = _transport_sim(d, batch_steps=bs, log_freq=3)
        sim.run_bias_point(10.0, 1e30, max_steps=9)
        assert sim._graph is not None
        with open(os.path.join(str(d), "output.txt")) as f:
            runs[bs] = ([ln for ln in f.read().splitlines()
                         if not ln.startswith(("Z - calculation time", "-", "Created folder"))],
                        sim.state.element.clone())
    assert runs[1][0] == runs[4][0]
    assert torch.equal(runs[1][1], runs[4][1])


# ---------------------------------------------------------------------------
# the local heat model's device loops (csrc/heat.cu) and the bf16 inner
# operator inside the captured transport superstep
# ---------------------------------------------------------------------------

def _heat_ws_to(ws, device):
    """A copy of a heat workspace (ops.heat.Workspace) on ``device``."""
    import dataclasses

    move = lambda v: v.to(device, copy=True) if torch.is_tensor(v) else v  # noqa: E731
    kw = {}
    for f in dataclasses.fields(ws):
        v = getattr(ws, f.name)
        if f.name == "cg" and v is not None:
            v = dataclasses.replace(v, **{g.name: move(getattr(v, g.name))
                                          for g in dataclasses.fields(v)})
        elif isinstance(v, tuple) and f.name.startswith("op"):
            v = tuple(move(t) for t in v)
        else:
            v = move(v)
        kw[f.name] = v
    return type(ws)(**kw)


def _heat_sim(tmp_path, method):
    """The small stack's transport configuration with the local heat model
    ``method`` on the card, after one superstep at 10 V (so that sites
    dissipate)."""
    sim = _transport_sim(tmp_path, solve_heating_local=True, heat_solver=method)
    sim.run_bias_point(10.0, 1e30, max_steps=1)
    assert sim.heat.method == method and sim.heat.n_interface > 0
    assert float(sim.state.power.abs().max()) > 0
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_cuda_heat_kernels_match_plain(tmp_path, method):
    """Each heat kernel against its plain version on the same inputs (the
    model of the small stack, f32): the dense substep three times from a
    seeded right-hand side (the field and both halves of the right-hand side
    within 1e-5 of their scale, the counter and the predicates equal); the
    CG set-up warm from the field and cold (x0 bit-equal, r and p within
    1e-5 of the scale of b, r.r, r.z and the threshold within 1e-4, flags,
    counts and the predicate equal) and the CG end from one iterate (the
    field bit-equal, the counts, counter and predicate equal)."""
    _need_card()
    from devicekmc_tpu_torch.ops import heat as heat_ops

    sim = _heat_sim(tmp_path, method)
    h, st = sim.heat, sim.state
    T0, scale = 300.0, 1000.0
    gen = torch.Generator().manual_seed(4)
    temp = st.temperature.clone() + torch.rand(st.temperature.shape, generator=gen).cuda()
    k, p = _heat_ws_to(h.ws, "cuda"), _heat_ws_to(h.ws, "cpu")
    tk, tp = temp.clone(), temp.cpu()
    if method == "dense":
        ni = h.n_interface
        u0 = torch.rand(ni, generator=gen, dtype=torch.float64) * 1e-3
        src = torch.rand(ni, generator=gen, dtype=torch.float64) * 1e-4
        for ws in (k, p):
            ws.u.zero_()
            ws.u[0].copy_(u0)
            ws.src.copy_(src)
            heat_ops.prepare(ws, False, 3)
        for _ in range(3):
            heat_ops.dense_substep(k, h.L_inv, tk, T0, scale, False, 0)
            heat_ops.dense_substep_plain(p, h.L_inv.cpu(), tp, T0, scale, False, 0)
        for got, want in ((tk, tp), (k.u, p.u)):
            sc = float(want.abs().max())
            assert float((got.cpu() - want).abs().max()) <= 1e-5 * sc
        assert k.k.tolist() == p.k.tolist() == [3] and k.cond.tolist() == p.cond.tolist()
        return
    src = torch.rand(h.interface_mask.shape[0], generator=gen) * 1e-4
    for warm, op_k, op_p in ((True, k.op_t, p.op_t), (False, k.op_s, p.op_s)):
        for ws in (k, p):
            ws.src.copy_(torch.where(ws.op_t[3], src.to(ws.src), 0.0))
        heat_ops.cg_begin(k, op_k, warm, tk, T0, scale, 1e-10, 1000)
        heat_ops.cg_begin_plain(p, op_p, warm, tp, T0, scale, 1e-10, 1000)
        assert torch.equal(k.cg.x.cpu(), p.cg.x), warm
        b = torch.where(p.op_t[3], p.cg.x[0] + p.src, 0.0)
        sc = float(b.abs().max())
        for f in ("r", "p"):
            assert float((getattr(k.cg, f).cpu() - getattr(p.cg, f)).abs().max()) <= 1e-5 * sc
        for f in ("rr", "rz", "thresh2"):
            assert float(getattr(k.cg, f)) == pytest.approx(float(getattr(p.cg, f)), rel=1e-4)
        for f in ("act", "iters", "ctl", "cond"):
            assert torch.equal(getattr(k.cg, f).cpu(), getattr(p.cg, f)), (warm, f)
    heat_ops.prepare(k, False, 2)
    heat_ops.prepare(p, False, 2)
    x = torch.randn(p.cg.x.shape, generator=gen) * 1e-3
    for ws in (k, p):
        ws.cg.x.copy_(x)
        ws.cg.iters.fill_(7)
    heat_ops.cg_end(k, tk, T0, scale, False, 0)
    heat_ops.cg_end_plain(p, tp, T0, scale, False, 0)
    assert torch.equal(tk.cpu(), tp)
    assert k.log.tolist() == p.log.tolist() and k.log.tolist()[2] == 7
    assert k.k.tolist() == p.k.tolist() == [1] and k.cond.tolist() == p.cond.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["dense", "cg"])
def test_cuda_heat_loops_captured_equal_host_loop(tmp_path, method):
    """The local model's update in its device form (0-d step time and T_bg)
    captured as a graph (the substep loop a WHILE node, with the CG's
    nested in it) against the host loop of the same kernels (a host state
    and step time): the field and T_bg bit for bit and the loops' log equal,
    transient (3 substeps) and steady; the replay reads nothing (sync debug
    mode "error")."""
    _need_card()
    import dataclasses

    from devicekmc_tpu_torch.ops.graph import Graph
    from devicekmc_tpu_torch.physics import heat as heat_mod

    sim = _heat_sim(tmp_path, method)
    g, p, h = sim.geom, sim.params, sim.heat
    upd = heat_mod.update_temperature_local if method == "dense" \
        else heat_mod.update_temperature_local_cg
    st_t = torch.zeros((), dtype=torch.float64, device="cuda")
    dstate = dataclasses.replace(sim.state, T_bg=torch.tensor(300.0, device="cuda",
                                                                dtype=torch.float64))
    graph = Graph(lambda: upd(g, p, h, dstate, st_t), "cuda")
    for mult in (2.5, 5e3):
        step_time = mult * p.delta_t
        st_t.fill_(step_time)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = graph()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        temp, T_bg, log = out.temperature.clone(), float(out.T_bg), h.ws.log.tolist()
        assert log[:2] == ([0, 3] if mult < 1e3 else [1, 0])
        host, m = upd(g, p, h, sim.state, step_time)
        assert torch.equal(host.temperature, temp) and host.T_bg == T_bg
        assert h.ws.log.tolist() == log
        assert heat_mod.last_local["substeps"] == log[1]
        assert float((temp - 300.0).abs().max()) > 0


def _dense_case(ni, dtype, device, seed):
    """A dense model's workspace on ``device`` with a seeded propagator
    [ni, ni] (entries of 2 / ni), right-hand side and source, its interface
    sites a seeded permutation into a field of ni + 7 sites."""
    from devicekmc_tpu_torch.ops import heat as heat_ops

    rng = np.random.default_rng(seed)
    M = torch.as_tensor(rng.random((ni, ni)) * (2.0 / ni), dtype=dtype)
    iidx = torch.as_tensor(rng.permutation(ni + 7)[:ni])
    ws = heat_ops.workspace("dense", dtype, device, iidx)
    ws.u[0].copy_(torch.as_tensor(rng.random(ni) * 1e-3))
    ws.src.copy_(torch.as_tensor(rng.random(ni) * 1e-4))
    temp = torch.as_tensor(300.0 + rng.random(ni + 7), dtype=dtype)
    return M.to(device), ws, temp.to(device)


#: ni of the dense substep's card tests: not multiples of a tile or of a
#: load's width, and each side of the switch between the two forms
DENSE_NI = (1, 31, 193, 1000, 4097, 256, 257)


@pytest.mark.cuda
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ni", DENSE_NI)
def test_cuda_heat_dense_substep_shapes(ni, dtype, negate):
    """heat_dense_substep against dense_substep_plain on the CPU, five
    substeps in a row (so both halves of the right-hand side are read): the
    field and both halves within 1e-5 of their scale, the counter and the
    predicates equal (in f32 also five ulps of the field, its rounding
    next to T0 once a substep); at the switch (ni DENSE_SMALL_MAX_NI and one
    more) the cluster and the sets; from 193 also a row a block, from 1,000
    the right-hand side in tiles of 256 columns; where 16-byte loads apply,
    the propagator one entry off 16 bytes too (the 1-entry build)."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import heat as heat_ops

    sms = _build.sm_count("cuda")
    base = heat_ops.dense_plan(ni, dtype.itemsize, True, sms)
    # (plan, propagator one entry off 16 bytes): the plan of the shapes, and
    # where it loads 16 bytes, of the offset data (the 1-entry build)
    cases = [(None, False)] + ([(None, True)] if base.vec > 1 else [])
    if ni in (heat_ops.DENSE_SMALL_MAX_NI, heat_ops.DENSE_SMALL_MAX_NI + 1):
        cases += [(heat_ops.DensePlan("cluster", 4, base.vec, ni, min(-(-ni // 32), 8)),
                   False),
                  (heat_ops.DensePlan("sets", 1, base.vec, ni, min(-(-ni // 8), 2 * sms)),
                   False)]
    if ni >= 193:
        # a row a block; and sets of 2 rows a warp over tiles of 256 columns
        cases += [(heat_ops.DensePlan("rows", 1, base.vec, ni, min(ni, 2 * sms)), False)]
    if ni >= 1000:
        cases += [(heat_ops.DensePlan("sets", 2, base.vec, 256, min(-(-ni // 16), 2 * sms)),
                   False)]
    for plan, offset in cases:
        M, k, tk = _dense_case(ni, dtype, "cuda", ni)
        Mp, p, tp = _dense_case(ni, dtype, "cpu", ni)
        if offset:
            buf = torch.empty(ni * ni + 1, dtype=dtype, device="cuda")
            M = buf[1:].view(ni, ni).copy_(M)
        for ws in (k, p):
            heat_ops.prepare(ws, False, 5)
        for _ in range(5):
            heat_ops.dense_substep(k, M, tk, 300.0, 1000.0, negate, 0, plan=plan)
            heat_ops.dense_substep_plain(p, Mp, tp, 300.0, 1000.0, negate, 0)
        torch.cuda.synchronize()
        # products summed in another order (1e-5 of the scale), and in f32 the
        # field's rounding next to T0 (an ulp of the field a substep, over
        # scale 1000 in the right-hand side)
        ulps = 5 * torch.finfo(dtype).eps * float(tp.abs().max()) if dtype == torch.float32 \
            else 0.0
        for got, want, atol in ((tk - 300.0, tp - 300.0, ulps), (k.u, p.u, ulps / 1000.0)):
            sc = float(want.abs().max())
            err = float((got.cpu() - want).abs().max())
            assert sc > 0 and err <= 1e-5 * sc + atol, (plan, offset, err, sc, atol)
        assert k.k.tolist() == p.k.tolist() == [5], plan
        assert k.cond.tolist() == p.cond.tolist() == [0, 0], plan


@pytest.mark.cuda
@pytest.mark.parametrize("ni", [193, 1000])
def test_cuda_heat_dense_loop_trip_count(ni):
    """The dense loops captured (the transient WHILE node entered on 7
    substeps, the steady one on 0; then the steady one on its 1 pass) run
    their trip count, counted on the card, and give the host loop's bits."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import heat as heat_ops
    from devicekmc_tpu_torch.ops.graph import Graph

    M, ws, temp = _dense_case(ni, torch.float64, "cuda", 3)
    M2 = torch.flip(M, (0,)).contiguous()
    _, hw, ht = _dense_case(ni, torch.float64, "cuda", 3)
    graph = Graph(lambda: heat_ops.run_dense(ws, M, M2, temp, 300.0, 1000.0), "cuda")
    idx = _build.COUNTED_ON_CARD.index("heat_dense_substep")
    for steady, n_sub, trips in ((False, 7, 7), (True, 7, 1)):
        heat_ops.prepare(ws, steady, n_sub)
        heat_ops.prepare(hw, steady, n_sub)
        before = int(_build.launch_counts("cuda")[idx])
        graph()
        torch.cuda.synchronize()
        assert int(_build.launch_counts("cuda")[idx]) - before == trips
        assert ws.k.tolist() == [trips] and ws.cond.tolist() == [0, 0]
        heat_ops.run_dense(hw, M, M2, ht, 300.0, 1000.0)
        assert torch.equal(temp, ht) and torch.equal(ws.u, hw.u)
        assert hw.k.tolist() == [trips]


def _begin_case(seed):
    """A synthetic matrix-free operator for heat_cg_begin on 1,000 rows of
    51 slots: rows of valid length 0, 1, 17 and 51, rows off the interface,
    a row whose neighbours are all off it; workspaces on the card and the
    CPU, a seeded field and source."""
    from devicekmc_tpu_torch.ops import heat as heat_ops

    rng = np.random.default_rng(seed)
    n, m = 1000, 51
    mask = rng.random(n) < 0.7
    lens = rng.integers(0, m + 1, n)
    lens[:4] = (0, 1, 17, 51)
    mask[:4] = True
    off = np.flatnonzero(~mask)
    nb = np.full((n, m), -1)
    for i in range(n):
        nb[i, :lens[i]] = rng.choice(n, lens[i], replace=False)
    nb[4] = -1
    nb[4, :9] = off[:9]
    lens[4], mask[4] = 9, True
    nb_int = (nb >= 0) & mask[np.maximum(nb, 0)]
    diag_base, src, temp = rng.random(n) + 2.0, rng.random(n) * 1e-4, 300.0 + rng.random(n)
    out = []
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
        ws = heat_ops.workspace(
            "cg", torch.float64, dev, t(np.flatnonzero(mask)), neigh_idx=t(nb),
            mask=t(mask), diag_base=t(diag_base), nb_int=t(nb_int),
            n_int_nb=t(nb_int.sum(1)), step_scale=0.3)
        ws.src.copy_(t(np.where(mask, src, 0.0)))
        out.append((ws, t(temp)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cold_l2", [False, True])
def test_cuda_heat_cg_begin_rows(cold_l2):
    """heat_cg_begin against cg_begin_plain on the synthetic operator, warm
    (transient) and cold (steady), with the L2 written over before each
    launch or not: x0 bit-equal, r and p within 1e-12 of the scale of b,
    r.r, r.z and the threshold within 1e-10, flags, counts and predicate
    equal; the rows off the interface zero; a second launch the same bits;
    the partial sums too short raise."""
    _need_card()
    from devicekmc_tpu_torch.ops import heat as heat_ops

    (k, tk), (p, tp) = _begin_case(9)
    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for warm, op_k, op_p in ((True, k.op_t, p.op_t), (False, k.op_s, p.op_s)):
        for ws in (k, p):
            heat_ops.prepare(ws, False, 1)
        if cold_l2:
            scrub.fill_(1)
        heat_ops.cg_begin(k, op_k, warm, tk, 300.0, 1000.0, 1e-10, 1000)
        heat_ops.cg_begin_plain(p, op_p, warm, tp, 300.0, 1000.0, 1e-10, 1000)
        torch.cuda.synchronize()
        assert torch.equal(k.cg.x.cpu(), p.cg.x), warm
        b = torch.where(p.op_t[3], p.cg.x[0] + p.src, 0.0)
        sc = float(b.abs().max())
        for f in ("r", "p"):
            got = getattr(k.cg, f).cpu()
            assert float((got - getattr(p.cg, f)).abs().max()) <= 1e-12 * sc, (warm, f)
            assert not bool(got[0][~p.op_t[3]].any())
        for f in ("rr", "rz", "thresh2"):
            assert float(getattr(k.cg, f)) == pytest.approx(float(getattr(p.cg, f)),
                                                            rel=1e-10)
        for f in ("act", "iters", "ctl", "cond"):
            assert torch.equal(getattr(k.cg, f).cpu(), getattr(p.cg, f)), (warm, f)
        first = {f: getattr(k.cg, f).clone() for f in ("x", "r", "p", "rr", "thresh2")}
        heat_ops.cg_begin(k, op_k, warm, tk, 300.0, 1000.0, 1e-10, 1000)
        for f, v in first.items():
            assert torch.equal(getattr(k.cg, f), v), (warm, f)
    k.part = k.part[:-2]
    with pytest.raises(ValueError, match="partial sums"):
        heat_ops.cg_begin(k, k.op_t, True, tk, 300.0, 1000.0, 1e-10, 1000)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,offset", [(108944, 0), (1003, 0), (3, 0), (1002, 1)])
def test_cuda_heat_cg_end_matches_plain(dtype, n, offset):
    """heat_cg_end against cg_end_plain: the field bit-equal on every entry
    (set where the mask is, untouched elsewhere), with runs of four entries
    of which all, some or none are on the interface, an entry count that is
    not a multiple of 4 and (offset 1) data one entry off 16 bytes (what a
    vectorised pass would branch on); negated and not; the iterations
    summed, the counter and the predicate equal, the predicate false once
    the counter reaches the trip count."""
    _need_card()
    from types import SimpleNamespace

    from devicekmc_tpu_torch.ops import heat as heat_ops

    rng = np.random.default_rng(n + offset)
    mask = rng.random(n + offset) < 0.3
    mask[offset:offset + 4 * (n // 8)] |= (np.arange(4 * (n // 8)) // 4) % 2 == 0
    mask[offset + 4 * (n // 8):offset + 4 * (n // 8) + 8] = False
    x = rng.standard_normal((1, n + offset)) * 1e-3
    temp = rng.standard_normal(n + offset) + 300.0

    def ws_on(dev):
        t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
        xt = t(x)
        return heat_ops.Workspace(
            method="cg", k=t([0], torch.int32), n=t([2, 0], torch.int32),
            cond=t([1, 0], torch.int32), log=t([0, 0, 5], torch.int64), src=xt[0],
            ticket=t([0, 0], torch.int32),
            cg=SimpleNamespace(x=xt[:, offset:], iters=t([7], torch.int64)),
            op_t=(None, None, None, t(mask, torch.bool)[offset:]))

    for negate in (False, True):
        k, p = ws_on("cuda"), ws_on("cpu")
        tk = torch.as_tensor(temp, dtype=dtype, device="cuda")[offset:]
        tp = torch.as_tensor(temp, dtype=dtype)[offset:]
        for step in range(2):
            heat_ops.cg_end(k, tk, 300.0, 1000.0, negate, 0)
            heat_ops.cg_end_plain(p, tp, 300.0, 1000.0, negate, 0)
            assert torch.equal(tk.cpu(), tp), (negate, step)
            assert k.log.tolist() == p.log.tolist() == [0, 0, 5 + 7 * (step + 1)]
            assert k.k.tolist() == p.k.tolist() == [step + 1]
            assert k.cond.tolist() == p.cond.tolist() == [int(step == 0), 0]
        off = ~p.op_t[3]
        assert torch.equal(tp[off], torch.as_tensor(temp, dtype=dtype)[offset:][off])


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["bf16", "heat-local-dense", "heat-local-cg"])
def test_cuda_new_graph_configurations_match_eager(tmp_path, config):
    """The engine's captured transport superstep with the bf16 inner
    operator and with the local heat model (dense and matrix-free) against
    the eager engine from the same start, step by step and bit for bit:
    elements, events, cg_iters_power, I_macro, P_tot, T_bg, the temperature
    field and the virtual potentials; one capture from each slot."""
    _need_card()
    from devicekmc_tpu_torch.engine import make_superstep

    over = {"bf16": dict(transport_bf16_inner=True),
            "heat-local-dense": dict(solve_heating_local=True, heat_solver="dense"),
            "heat-local-cg": dict(solve_heating_local=True, heat_solver="cg")}[config]
    runs = {}
    for kind in ("graph", "eager"):
        d = tmp_path / kind
        d.mkdir()
        sim = _transport_sim(d, **over)
        if kind == "eager":
            sim._make = lambda g, p, h: make_superstep(g, p, h)
        rec = runs[kind] = []
        step = sim._superstep

        def wrapped(state, Vd, *a, step=step, rec=rec):
            out = step(state, Vd, *a)
            st, m = out[0], out[2]
            rec.append((st.element.clone(), m["n_events"], m["cg_iters_power"], st.I_macro,
                        st.P_tot, st.T_bg, st.temperature.clone(),
                        st.virtual_potentials.clone(), m["transport_converged"]))
            return out

        sim._superstep = wrapped
        sim.run_bias_point(10.0, 1e30, max_steps=4)
        assert (sim._graph is not None and sim._graph.captures == 2) == (kind == "graph")
    assert len(runs["graph"]) == len(runs["eager"]) == 4
    for k, (a, b) in enumerate(zip(runs["graph"], runs["eager"])):
        for j, (u, v) in enumerate(zip(a, b)):
            same = torch.equal(u, v) if torch.is_tensor(u) else u == v
            assert same, (k, j)
    assert all(r[-1] == 1.0 for r in runs["graph"])


@pytest.mark.cuda
def test_cuda_transport_rows_bf16_row_fix(tmp_path):
    """transport_rows_update with the bf16 band against rows_plain then
    update_pack_plain (which add the band's row_fix as
    physics.current._band_unpermute does) at the tolerances of
    test_cuda_transport_kernels_match_plain (ap within 2e-6 of its largest
    entry), and without the row fix ap further off than that (the kernel
    applies it)."""
    _need_card()
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    sim = _transport_sim(tmp_path, fused=False, transport_bf16_inner=True)
    sim.run_bias_point(sim.cfg.V_switch[0], 1e30, max_steps=2)
    tws, op, _ = _transport_op(sim)
    assert op.slots.val.dtype == torch.bfloat16 and op.row_fix is not None
    op_c = _cpu_op(op)
    tws.cg.act.fill_(True)
    tws.cg.act0.fill_(True)
    tws.cg.rz.fill_(0.75)
    tws.cg.thresh2.zero_()
    tcg.products(tws, op)
    k, p = _clone_tws(tws), _cpu_ws(_clone_tws(tws))
    tcg.rows_update(k, op)
    tcg.rows_update_plain(p, op_c)
    _rows_update_close(k, p, tws)
    err = float((k.cg.ap.cpu() - p.cg.ap).abs().max())
    n = _clone_tws(tws)
    tcg.rows_update(n, op._replace(row_fix=torch.zeros_like(op.row_fix)))
    assert float((n.cg.ap.cpu() - p.cg.ap).abs().max()) > 10 * err


# ---------------------------------------------------------------------------
# the stored metal block's product and the f64 solve inside the captured
# transport superstep
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_cuda_stored_matvec_matches_plain(dtype, offset):
    """stored_matvec_out against the product in f64 (the plain version's
    arithmetic without its rounding) at n 1, 2, 5, 31, 33, 127, 1,001, 3,527
    and 15,001 (a block of many L2s: its loads through L1; the smaller ones
    past it), the block starting ``offset`` elements past a
    16-byte boundary (so every row's head and tail are taken, at every
    alignment of an odd n): each entry within 1e-5 (f32) and 1e-13 (f64) of
    the sum of its terms' sizes, and within that of the plain version's;
    two launches bit-equal, one on a side stream; the card counts one launch
    a call."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops.transport_cg import stored_matvec_out, stored_matvec_plain

    tol = 1e-5 if dtype == torch.float32 else 1e-13
    g = torch.Generator(device="cuda").manual_seed(21 + offset)
    idx = _build.COUNTED_ON_CARD.index("stored_matvec")
    side = torch.cuda.Stream()
    for n in (1, 2, 5, 31, 33, 127, 1001, 3527, 15001):
        buf = torch.empty(n * n + 8, dtype=dtype, device="cuda")
        head = (-(buf.data_ptr() // buf.element_size())) % (16 // buf.element_size())
        T = buf[head + offset:head + offset + n * n].view(n, n)
        T.copy_(torch.randn((n, n), generator=g, dtype=dtype, device="cuda"))
        x = torch.randn(n, generator=g, dtype=dtype, device="cuda")
        y = torch.full((n,), float("nan"), dtype=dtype, device="cuda")
        y2 = y.clone()
        c0 = int(_build.launch_counts("cuda")[idx])
        stored_matvec_out(T, x, y)
        stored_matvec_out(T, x, y2, side.cuda_stream)
        side.synchronize()
        torch.cuda.synchronize()
        assert int(_build.launch_counts("cuda")[idx]) == c0 + 2
        assert torch.equal(y, y2), n
        exact = T.double() @ x.double()
        size = T.double().abs() @ x.double().abs()
        assert bool(((y.double() - exact).abs() <= tol * size).all()), n
        plain = stored_matvec_plain(T, x).double()
        assert bool(((y.double() - plain).abs() <= 2 * tol * size).all()), n
        del buf, T, exact, size, plain
    T = torch.randn((4, 4), generator=g, dtype=dtype, device="cuda")
    with pytest.raises(ValueError):
        stored_matvec_out(T.t(), x[:4], y[:4])


def _f64_sim(tmp_path, crossbar=False, **over):
    """The f64 configuration of the captured transport superstep (the stored
    metal block) on the card: _transport_sim in f64, its cold transport
    solve in one call (segments of 40 iterations restart the f64 deflated
    CG, each with a new assembly, hundreds of times over)."""
    return _transport_sim(tmp_path, crossbar=crossbar, precision="f64", transport_cc="stored",
                          solver_chunk_iters=0, **over)


def _transport_op64(sim, seed=0):
    """The f64 solve's operator and workspace of ``sim``'s state (the warm
    re-solve of a changed bias run once), the direction p in ``xs64`` and
    the iterate and residual set from seeded noise, the flag up."""
    import dataclasses

    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.physics import current

    captured = {}
    solve = tcg.solve_f64

    def grab(tws, op, x0, go, tol, maxiter):
        captured.update(tws=tws, op=op, x0=x0.clone(), tol=tol, maxiter=maxiter)
        return solve(tws, op, x0, go, tol, maxiter)

    tcg.solve_f64 = grab
    try:
        state = dataclasses.replace(sim.state, transport_Vd_prev=float("nan"))
        current.update_power(sim.geom, sim.params, state, sim.cfg.V_switch[0],
                             cc=dict(sim._cc), allow_skip=True)
    finally:
        tcg.solve_f64 = solve
    tws, op = captured["tws"], captured["op"]
    gen = torch.Generator().manual_seed(seed)
    n = tws.x.shape[0]
    tws.xs64[:n].copy_(torch.randn(n, generator=gen, dtype=torch.float64))
    tws.xs64[n:].zero_()
    tws.xm.copy_(tws.xs64[2:][op.mp])
    tws.x.copy_(captured["x0"])
    tws.r.copy_(torch.randn(n, generator=gen, dtype=torch.float64))
    c = tws.c64
    c.act.fill_(True)
    c.rz.copy_(torch.dot(tws.r, op.minv * tws.r).reshape(1))
    c.thresh2.fill_(1e-300)
    c.iters.fill_(3)
    return tws, op, captured


def _close64(name, got, want, tol):
    got, want = got.cpu().double(), want.double()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale, name


@pytest.mark.cuda
@pytest.mark.parametrize("crossbar", [False, True])
def test_cuda_transport_f64_kernels_match_plain(tmp_path, crossbar):
    """The f64 solve's kernels against their plain versions on the same
    inputs (the f64 operator of a state after 2 supersteps, a seeded
    direction): the stored block's product within 1e-13 of its largest
    entry; transport_blocks' f64 build (f64 blocks) within 1e-12 of the sum
    of its terms' sizes, the dots within 1e-12 of theirs; transport_rows'
    residual (unscaled) within 1e-12 of its largest entry (its scale: A x);
    the tail (transport_tail64: the rows of ap = A p, alpha, the update,
    direction and packing in one launch) against rows_ap_plain then
    update_f64_plain: ap, x, r, the direction and the metal vector within
    1e-12 of their largest entry, alpha, r.z and beta within 1e-10, flag,
    count, predicate and the loop's count equal; a stopped solve's launch
    of the tail leaves every vector and scalar as they
    were (the loop's count, the flag and predicate set)."""
    _need_card()
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    sim = _f64_sim(tmp_path, crossbar=crossbar, fused=False)
    sim.run_bias_point(sim.cfg.V_switch[0], 1e30, max_steps=2)
    tws, op, cap = _transport_op64(sim)
    op_c = _cpu_op(op)
    nv = int(op.n_vac)
    assert op.T_cc.dtype == torch.float64 and tws.xm.dtype == torch.float64

    k, p = _clone_tws(tws), _cpu_ws(_clone_tws(tws))
    tcg.metal(k, op)
    tcg.metal(p, op_c)
    _close64("y_cc", k.y_cc, p.y_cc, 1e-13)
    tcg.blocks(k, op, True)
    tcg.blocks_plain(p, op_c, True)
    xa = p.xs64[2:]
    T_vm, T_vv = op_c.T_vm[:nv].abs(), op_c.T_vv[:nv, :nv].abs()
    xv = xa[op_c.vidx[:nv].long()].abs()
    xm = xa[op_c.mp.long()].abs()
    for f, size in {"mv": xv @ T_vm, "y_vm": T_vm @ xm, "y_vv": T_vv @ xv}.items():
        got, want = getattr(k, f).cpu(), getattr(p, f)
        n = size.shape[0]
        assert bool(((got[:n] - want[:n]).abs() <= 1e-12 * size + 1e-300).all()), f
    na = op_c.anb.shape[0]
    dsize = torch.stack([(op_c.gnd.abs() * xa[:na].abs())[op.gnd_lo:].sum(),
                         (op_c.src.abs() * xa[:na].abs())[:op.nsi].sum()])
    assert bool(((k.dots64.cpu() - p.dots64).abs() <= 1e-12 * dsize).all())

    # the residual form (unscaled)
    r = _clone_tws(k)
    pr = _cpu_ws(_clone_tws(k))
    tcg.rows(r, op)
    tcg.rows_plain(pr, op_c, True)
    scale = float((op_c.b - pr.r).abs().max())
    assert float((r.r.cpu() - pr.r).abs().max()) <= 1e-12 * scale

    # the tail (the rows of ap = A p, alpha, the update and the direction in
    # one launch) from the same products (the kernel's)
    p = _cpu_ws(_clone_tws(k))
    start = _clone_tws(k)
    tcg.tail_f64(k, op, 20000)
    tcg.rows_ap_plain(p, op_c)
    tcg.update_f64_plain(p, op_c, 20000)
    _close64("ap", k.c64.ap, p.c64.ap, 1e-12)
    for f in ("x", "r", "xs64", "xm"):
        _close64(f, getattr(k, f), getattr(p, f), 1e-12)
    for f in ("alpha", "rz", "beta"):
        assert float(getattr(k.c64, f)) == pytest.approx(float(getattr(p.c64, f)), rel=1e-10)
    for f in ("act", "iters", "cond", "total"):
        assert torch.equal(getattr(k.c64, f).cpu(), getattr(p.c64, f)), f
    assert int(k.c64.iters) == 4 and bool(k.c64.act)
    assert float(k.xs64[-1]) == 0.0

    # a stopped solve: nothing moves but the loop's count, flag, predicate
    s_ = _clone_tws(start)
    s_.c64.act.fill_(False)
    before = _clone_tws(s_)
    tcg.tail_f64(s_, op, 20000)
    for f in ("x", "r", "xs64", "xm"):
        assert torch.equal(getattr(s_, f), getattr(before, f)), f
    for f in ("ap", "rz", "alpha", "beta", "iters", "act"):
        assert torch.equal(getattr(s_.c64, f), getattr(before.c64, f)), f
    assert int(s_.c64.cond) == 0 and int(s_.c64.total) == int(before.c64.total) + 1


# (label, live slots, bucket, metal atoms): no live slot; one; a full bucket
# at the crossbar's widths (every row and column tile live); metal atoms
# odd, not a multiple of 128
BLOCKS_EDGES = [("empty", 0, 96, 384), ("one", 1, 96, 384), ("full", 1024, 1024, 3527),
                ("odd_metal", 45, 96, 301)]


def _blocks_case(nv, vcap, n_mp, build, seed=5):
    """A seeded operator of transport_blocks alone (``build``: "lo" the inner
    direction, "hi" the mixed refinement's iterate, "f64" the f64 solve)
    with ``nv`` live slots of a bucket of ``vcap``, ``n_mp`` metal atoms and
    its workspace on the card, the plain products physics.current's
    apply_blocks of the same tensors."""
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.physics.current import apply_blocks

    rng = np.random.default_rng(seed)
    na, max_nn = vcap + n_mp + 64, 51
    f64 = build == "f64"
    sd = torch.float64 if f64 else torch.float32
    T_vm = torch.tensor(rng.standard_normal((vcap, n_mp)), dtype=sd, device="cuda")
    T_vv = torch.tensor(rng.standard_normal((vcap, vcap)), dtype=sd, device="cuda")
    perm = rng.permutation(na)
    vidx = torch.tensor(perm[:vcap], dtype=torch.int32, device="cuda")
    mp = torch.tensor(np.sort(perm[vcap:vcap + n_mp]), dtype=torch.int64, device="cuda")
    anb = rng.integers(0, na, (na, max_nn))
    anb[rng.random((na, max_nn)) < 0.3] = -1
    anb = torch.tensor(anb, dtype=torch.int32, device="cuda")
    vnb = anb[vidx.long()]
    dyn = torch.tensor(rng.standard_normal((vcap, max_nn)), dtype=torch.float32,
                       device="cuda") * (vnb >= 0)
    gnd_lo, nsi = na - 37, 41
    gnd = torch.tensor(rng.standard_normal(na), dtype=torch.float64, device="cuda")
    gnd[:gnd_lo] = 0
    src = torch.tensor(rng.standard_normal(na), dtype=torch.float64, device="cuda")
    src[nsi:] = 0
    mp_inv = torch.full((na,), -1, dtype=torch.int32, device="cuda")
    mp_inv[mp] = torch.arange(n_mp, dtype=torch.int32, device="cuda")
    blk = {"mp": mp, "T_vv": T_vv, "T_vm": T_vm, "vidx": vidx.long(),
           "v_ok": torch.arange(vcap, device="cuda") < nv, "gnd_vals": gnd, "src_vals": src,
           "band": None if build != "lo" else {}, "band_dyn_vals": dyn,
           "band_vnb_safe": vnb.long().clamp(min=0)}
    op = tcg.Operator(
        dsi=None, dsi32=None, b=None, diag=None, diag32=None, gnd=gnd, gnd32=gnd.float(),
        src=src, src32=src.float(), gnd_lo=gnd_lo, nsi=nsi, loop_G=0.0, slots=None,
        row_fix=None, dyn=dyn, anb=anb, nb_idx=None, nb_start=None, cls=None, g_hi=0.0,
        g_lo=0.0, T_vm=T_vm, T_vv=T_vv, vidx=vidx, vslot=None,
        n_vac=torch.tensor([nv], dtype=torch.int32, device="cuda"), mp_inv=mp_inv, mp=mp,
        mpos=None, mcb=None, env=None, plain_blocks=lambda x, wd: apply_blocks(blk, x, wd),
        plain_rows=None)
    tw = tcg.workspace(na, vcap, n_mp, None, "cuda", f64_solve=f64)
    x = torch.tensor(rng.standard_normal(na + 2), device="cuda")
    x[na + 1] = 0
    if build == "lo":
        tw.xs32.copy_(x)
    else:
        tw.xs64.copy_(x)
    tw.xm.copy_(x[2:][mp].to(tw.xm.dtype))
    return tw, op


@pytest.mark.cuda
@pytest.mark.parametrize("build", ["lo", "hi", "f64"])
@pytest.mark.parametrize("label,nv,vcap,n_mp", BLOCKS_EDGES)
def test_cuda_transport_blocks_edges(label, nv, vcap, n_mp, build):
    """transport_blocks' three builds (a block a work item, the live items
    first, n_vac read on the device) against their plain version at the
    edges: no live slot (zero column sums, the dots), one, a full bucket of
    1,024 at 3,527 metal atoms, metal atoms odd and not a multiple of 128.  The products within 1e-5 (f32 blocks) or 1e-12
    (f64) of the sum of their terms' sizes, the dots within 1e-5 (f32
    vector) or 1e-12 (f64) of theirs; two launches give the same bits and
    leave every ticket at 0."""
    _need_card()
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    tw, op = _blocks_case(nv, vcap, n_mp, build)
    hi = build != "lo"
    fields = ("mv", "y_vm", "y_vv", "y_bump", "dots32", "dots64")
    for f in fields:
        getattr(tw, f).fill_(float("nan"))
    k, p = _clone_tws(tw), _clone_tws(tw)
    tcg.blocks(k, op, hi)
    torch.cuda.synchronize()
    tcg.blocks_plain(p, op, hi)
    assert int(k.tickets.abs().sum()) == 0
    xs = (p.xs64 if hi else p.xs32).double()
    xa = xs[2:]
    tol = 1e-12 if build == "f64" else 1e-5
    T_vm, T_vv = op.T_vm[:nv].double().abs(), op.T_vv[:nv, :nv].double().abs()
    xv = xa[op.vidx[:nv].long()].abs()
    xm = xa[op.mp].abs()
    sizes = {"mv": xv @ T_vm if nv else torch.zeros(n_mp, dtype=torch.float64, device="cuda"),
             "y_vm": T_vm @ xm, "y_vv": T_vv @ xv}
    if not hi:
        nb = op.anb[op.vidx[:nv].long()].long()
        sizes["y_bump"] = (op.dyn[:nv].double().abs() * xa[nb.clamp(min=0)].abs()).sum(1)
    for f, size in sizes.items():
        got, want = getattr(k, f).double(), getattr(p, f).double()
        n = size.shape[0]
        assert bool(((got[:n] - want[:n]).abs() <= tol * size + 1e-30).all()), f
    if nv == 0:
        assert bool((k.mv == 0).all())
    dots_k, dots_p = (k.dots64, p.dots64) if hi else (k.dots32, p.dots32)
    na = op.anb.shape[0]
    dsize = torch.stack([(op.gnd.abs() * xa[:na].abs())[op.gnd_lo:].sum(),
                         (op.src.abs() * xa[:na].abs())[:op.nsi].sum()])
    assert bool(((dots_k.double() - dots_p.double()).abs()
                 <= (1e-12 if hi else 1e-5) * dsize).all())
    again = _clone_tws(tw)
    tcg.blocks(again, op, hi)
    bits = lambda t: t.view(torch.int64 if t.element_size() == 8 else torch.int32)  # noqa
    for f in fields:
        assert torch.equal(bits(getattr(again, f)), bits(getattr(k, f))), f
    assert int(again.tickets.abs().sum()) == 0


@pytest.mark.cuda
def test_cuda_transport_f64_tail_edges(tmp_path):
    """The f64 solve's tail (tail_f64: the rows of ap = A p, alpha, the
    update and the direction in one cooperative launch) against
    rows_ap_plain then update_f64_plain on the same inputs:
    an iterating state (ap, x, r, the direction and the metal vector within
    1e-12 of their largest entry, alpha, r.z and beta within 1e-10, flag,
    count, predicate equal; a second launch from the same state gives the
    same bits); a stopped iterate (only the loop's count, the flag and the
    predicate change); the iteration at maxiter (the predicate falls, the
    flag stays up)."""
    _need_card()
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    run = tcg.tail_f64
    sim = _f64_sim(tmp_path, fused=False)
    sim.run_bias_point(sim.cfg.V_switch[0], 1e30, max_steps=2)
    tws, op, cap = _transport_op64(sim)
    op_c = _cpu_op(op)
    tcg.metal(tws, op)
    tcg.blocks(tws, op, True)
    k, again = _clone_tws(tws), _clone_tws(tws)
    p = _cpu_ws(_clone_tws(tws))
    run(k, op, 20000)
    run(again, op, 20000)
    tcg.rows_ap_plain(p, op_c)
    tcg.update_f64_plain(p, op_c, 20000)
    _close64("ap", k.c64.ap, p.c64.ap, 1e-12)
    for f in ("x", "r", "xs64", "xm"):
        _close64(f, getattr(k, f), getattr(p, f), 1e-12)
    for f in ("alpha", "rz", "beta"):
        assert float(getattr(k.c64, f)) == pytest.approx(float(getattr(p.c64, f)), rel=1e-10), f
    for f in ("act", "iters", "cond", "total"):
        assert torch.equal(getattr(k.c64, f).cpu(), getattr(p.c64, f)), f
    for f in ("x", "r", "xs64", "xm"):
        assert torch.equal(getattr(k, f), getattr(again, f)), f
    for f in ("ap", "alpha", "rz", "beta", "act", "iters", "cond", "total"):
        assert torch.equal(getattr(k.c64, f), getattr(again.c64, f)), f
    assert int(k.c64.iters) == 4 and bool(k.c64.act) and int(k.c64.cond) == 1

    # a stopped iterate: nothing moves but the loop's count, flag, predicate
    s_ = _clone_tws(tws)
    s_.c64.act.fill_(False)
    before = _clone_tws(s_)
    run(s_, op, 20000)
    for f in ("x", "r", "xs64", "xm"):
        assert torch.equal(getattr(s_, f), getattr(before, f)), f
    for f in ("ap", "rz", "alpha", "beta", "iters", "act"):
        assert torch.equal(getattr(s_.c64, f), getattr(before.c64, f)), f
    assert int(s_.c64.cond) == 0 and int(s_.c64.total) == int(before.c64.total) + 1

    # the iteration at maxiter: it runs, the predicate falls
    m = _clone_tws(tws)
    run(m, op, 4)
    assert int(m.c64.iters) == 4 and bool(m.c64.act) and int(m.c64.cond) == 0
    for f in ("x", "xs64"):
        assert torch.equal(getattr(m, f), getattr(k, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("crossbar", [False, True])
def test_cuda_transport_f64_solve_graph_equals_eager(tmp_path, crossbar):
    """transport_cg.solve_f64 captured (one WHILE node) and run from the
    host loop on the same operator and warm start: the iterate and the
    count bit for bit, the criterion met; the replay reads nothing (sync
    debug mode "error"), and one with go False runs no iteration.  Counted
    on the card: the update once an iteration a replay, the stored block's
    product once an iteration and once at the set-up, the fly matvec never."""
    _need_card()
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.graph import Graph

    sim = _f64_sim(tmp_path, crossbar=crossbar, fused=False)
    sim.run_bias_point(sim.cfg.V_switch[0], 1e30, max_steps=2)
    tws, op, cap = _transport_op64(sim)
    x0, tol, maxiter = cap["x0"], cap["tol"], cap["maxiter"]
    x0 = x0 * (1 + 1e-3 * torch.randn(x0.shape, generator=torch.Generator().manual_seed(1),
                                       dtype=torch.float64).cuda())
    go = torch.ones(1, dtype=torch.bool, device="cuda")
    res = tcg.solve_f64(tws, op, x0, go, tol, maxiter)
    eager = (res.x.clone(), int(res.iters), float(res.residual))
    assert bool(res.converged) and eager[1] > 0
    g = Graph(lambda: tcg.solve_f64(tws, op, x0, go, tol, maxiter), "cuda")
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    counts = _build.launch_counts("cuda")
    try:
        tws.c64.total.zero_()
        counts.zero_()
        out = g()
        g()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert torch.equal(out.x, eager[0])
    assert (int(out.iters), float(out.residual)) == eager[1:]
    names = _build.COUNTED_ON_CARD
    assert int(tws.c64.total) == int(counts[names.index("transport_tail64")]) == 2 * eager[1]
    assert int(counts[names.index("stored_matvec")]) == 2 * (eager[1] + 1)
    assert int(counts[names.index("wkb_fly_matvec_out")]) == 0
    go.fill_(False)
    out = g()
    assert torch.equal(out.x, x0) and int(out.iters) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["stored", "stored-heat", "f64", "f64-heat"])
def test_cuda_stored_f64_graph_superstep_matches_eager(tmp_path, config):
    """The engine's captured transport superstep with the stored metal block
    (mixed) and in f64, heating off and global, against the eager engine
    from the same start, step by step and bit for bit: elements, events,
    cg_iters_power, I_macro, P_tot, T_bg, the virtual potentials and the
    tunnel store; every solve converged; the stored block's product
    launched on the card in the graph run, the fly matvec never."""
    _need_card()
    from devicekmc_tpu_torch.engine import make_superstep
    from devicekmc_tpu_torch.ops import _build

    over = dict(transport_cc="stored")
    if config.startswith("f64"):
        over.update(precision="f64", solver_chunk_iters=0)
    runs, card = {}, {}
    for kind in ("graph", "eager"):
        d = tmp_path / kind
        d.mkdir()
        sim = _transport_sim(d, heat=config.endswith("heat"), **over)
        if kind == "eager":
            sim._make = lambda g, p, h: make_superstep(g, p, h)
        rec = runs[kind] = []
        step = sim._superstep

        def wrapped(state, Vd, *a, step=step, rec=rec):
            out = step(state, Vd, *a)
            st, m = out[0], out[2]
            rec.append((st.element.clone(), m["n_events"], m["cg_iters_power"], st.I_macro,
                        st.P_tot, st.T_bg, st.virtual_potentials.clone(),
                        st.tt_vm.clone(), st.tt_vv.clone(), st.tt_slot_atom.clone(),
                        st.tt_valid, m["transport_converged"]))
            return out

        sim._superstep = wrapped
        _build.launch_counts("cuda").zero_()
        sim.run_bias_point(10.0, 1e30, max_steps=4)
        card[kind] = dict(zip(_build.COUNTED_ON_CARD, _build.launch_counts("cuda").tolist()))
        assert (sim._graph is not None and sim._graph.captures == 2) == (kind == "graph")
    assert len(runs["graph"]) == len(runs["eager"]) == 4
    for k, (a, b) in enumerate(zip(runs["graph"], runs["eager"])):
        for j, (u, v) in enumerate(zip(a, b)):
            same = torch.equal(u, v) if torch.is_tensor(u) else u == v
            assert same, (k, j)
    assert all(r[-1] == 1.0 for r in runs["graph"])
    assert card["graph"]["stored_matvec"] > 0 and card["graph"]["wkb_fly_matvec_out"] == 0
    assert (card["graph"]["transport_tail64"] > 0) == config.startswith("f64")
