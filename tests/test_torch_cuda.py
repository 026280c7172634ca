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


@pytest.mark.cuda
@pytest.mark.parametrize("N,max_nn,bw", [(515, 52, 510), (20000, 27, 3000)])
def test_cuda_gather_bit_equal(N, max_nn, bw):
    """Both channels bit-equal to the plain version on valid slots."""
    _need_card()
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather, ell_gather_plain

    rng = np.random.default_rng(N)
    site = np.arange(N)[:, None]
    nb = np.clip(site + rng.integers(-bw, bw + 1, (N, max_nn)), 0, N - 1)
    nb[rng.random((N, max_nn)) < 0.15] = -1
    idx = torch.as_tensor(nb, dtype=torch.int32, device="cuda")
    vals = [torch.as_tensor(rng.standard_normal(N).astype(np.float32), device="cuda"),
            torch.as_tensor(rng.integers(0, 1 << 16, N).astype(np.int32), device="cuda")]
    valid = idx >= 0
    before = ell_gather.launches
    for c in (1, 2):
        got = ell_gather(idx, vals[:c])
        ref = ell_gather_plain(idx, vals[:c])
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g[valid], r[valid])
    assert ell_gather.launches == before + 2


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
@pytest.mark.parametrize("R,m_pad,B,dtype,rtol,atol", [
    (5, 3, 128, torch.float32, 2e-5, 1e-4),
    (3, 16, 128, torch.float32, 2e-5, 1e-4),
    (37, 56, 128, torch.float32, 2e-5, 1e-4),
    (2, 120, 128, torch.float32, 2e-5, 2e-4),
    (3, 8, 256, torch.float32, 2e-5, 1e-4),
    (4, 8, 128, torch.bfloat16, 2e-2, 2e-1),
])
def test_cuda_banded_matvec(R, m_pad, B, dtype, rtol, atol):
    """f32 sums in another order than the einsum; bf16 storage with f32
    accumulation (the tolerances of the TPU kernel's own tests)."""
    _need_card()
    from devicekmc_tpu_torch.ops.banded import banded_matvec, banded_matvec_plain

    g = torch.Generator(device="cuda").manual_seed(R * 100 + m_pad)
    C4 = torch.randn((R, m_pad, B, B), generator=g, device="cuda").to(dtype)
    xp2 = torch.randn((R + m_pad - 1, B), generator=g, device="cuda").to(dtype)
    before = banded_matvec.launches
    y = banded_matvec(C4, xp2)
    ref = banded_matvec_plain(C4, xp2)
    torch.cuda.synchronize()
    assert banded_matvec.launches == before + 1
    assert y.dtype == torch.float32 and y.shape == (R, B)
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=rtol, atol=atol)


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
@pytest.mark.parametrize("n", [300, 1153])
def test_cuda_fly_pdisp(n, Vd, pbc):
    """Dissipation row sums: atol 1e-5 * max|plain| (f32 sums in another
    order, FMA); Vd = 0 gives exact zeros; two launches on the same input
    give the same bits (no float atomics)."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp, wkb_fly_pdisp_plain

    pos, cb, rng = _points(n, 42)
    ms = rng.standard_normal(n).astype(np.float32) * 1e-10
    ms = torch.as_tensor(ms + np.abs(ms.min()), device="cuda")
    env = _env(pbc)
    before = wkb_fly_pdisp.launches
    row = wkb_fly_pdisp(pos, cb, ms, Vd, env)
    row2 = wkb_fly_pdisp(pos, cb, ms, Vd, env)
    ref = wkb_fly_pdisp_plain(pos, cb, ms, Vd, env)
    torch.cuda.synchronize()
    assert wkb_fly_pdisp.launches == before + 2
    assert row.dtype == torch.float32 and row.shape == (n,)
    assert torch.equal(row, row2)
    if Vd == 0.0:
        assert not row.any() and not ref.any()
        return
    assert float(ref.abs().max()) > 0
    np.testing.assert_allclose(row.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


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
