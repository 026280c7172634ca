"""The plain PyTorch versions of the four transport kernels against the JAX
package's Pallas kernels (interpret mode on the CPU), on the same numpy
inputs.

Tolerances are the JAX tests' own (tests/test_banded_pallas.py,
tests/test_wkb_fly.py): XLA and PyTorch differ by an ulp in exp and sqrt and
sum in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

torch.set_num_threads(1)

Q = 1.602176634e-19
HBAR = 1.054571817e-34
M0 = 9.1093837015e-31
LATTICE = (100.0, 60.0, 60.0)


def _envs(pbc, n_int_steps=64):
    """(JAX env, port env) with the same f32 scalars."""
    vals = dict(
        prefac=np.float32(-(np.sqrt(2 * 0.85 * M0) / HBAR) * (2 / 3)),
        qV0=np.float32(Q * 1.6), dE_step=np.float32(Q * 0.01),
        ctol=np.float32(Q * 0.01), nn=np.float32(3.5),
    )
    jenv = dict(cdtype=jnp.float32, lattice=jnp.asarray(LATTICE, jnp.float32),
                pbc=pbc, n_int_steps=n_int_steps,
                **{k: jnp.float32(v) for k, v in vals.items()})
    tenv = dict(cdtype=torch.float32, lattice=LATTICE, pbc=pbc,
                n_int_steps=n_int_steps, **{k: float(v) for k, v in vals.items()})
    return jenv, tenv


def _points(n, seed=42):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * np.array(LATTICE)).astype(np.float32)
    cb = (rng.random(n) * Q * 2 - Q).astype(np.float32)
    return pos, cb, rng


@pytest.mark.parametrize("R,m_pad,B,dtype,rtol,atol", [
    (4, 3, 128, "float32", 2e-5, 1e-4),
    (3, 16, 128, "float32", 2e-5, 1e-4),
    (1, 8, 128, "float32", 2e-5, 1e-4),
    (2, 8, 128, "bfloat16", 2e-2, 2e-1),
])
def test_banded_plain_matches_pallas(R, m_pad, B, dtype, rtol, atol):
    """The port's plain version on ``band_slots`` of a fully dense random
    band against the Pallas kernel on the dense band (bf16: the band and
    the vector rounded as the JAX test rounds them)."""
    from devicekmc_tpu.ops.banded_pallas import banded_matvec_pallas
    from devicekmc_tpu_torch.ops.banded import band_slots, banded_matvec

    rng = np.random.default_rng(R * 100 + m_pad)
    C4 = rng.standard_normal((R, m_pad, B, B)).astype(np.float32)
    xp2 = rng.standard_normal((R + m_pad - 1, B)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    ref = np.asarray(banded_matvec_pallas(jnp.asarray(C4, jdt), jnp.asarray(xp2, jdt),
                                          interpret=True))
    slots = band_slots(torch.as_tensor(C4).to(tdt))
    got = banded_matvec(slots, torch.as_tensor(xp2).to(tdt).reshape(-1))
    assert got.dtype == torch.float32 and tuple(got.shape) == (R * B,)
    np.testing.assert_allclose(got.reshape(R, B).numpy(), ref, rtol=rtol, atol=atol)


def _dense_einsum(C4, xw):
    """The dense band's product over the window stack, as the port computed
    it before its band kept only nonzeros, written as the einsum's terms
    (each product rounded to f32) summed over (k, j)."""
    R, m_pad, B, _ = C4.shape
    x2 = xw.reshape(R + m_pad - 1, B).float()
    xst = torch.stack([x2[k:k + R] for k in range(m_pad)], dim=1)
    return (C4.float() * xst[:, :, None, :]).sum(dim=(1, 3)).reshape(-1)


def _sparse_band(rng, R, m_pad, B, per_row, dtype=np.float32):
    """A random band with at most ``per_row`` nonzeros a row at random
    offsets (repeats collapse), rows past the first ``R * B - B // 2``
    empty (the padded rows past Na)."""
    C4 = np.zeros((R, m_pad, B, B), dtype)
    for i in range(R * B - B // 2):
        offs = rng.integers(0, m_pad * B, per_row)
        C4[i // B, offs // B, i % B, offs % B] = rng.standard_normal(per_row)
    return C4


@pytest.mark.parametrize("R,m_pad,B,per_row", [(3, 5, 32, 2), (5, 3, 64, 7), (2, 17, 32, 30)])
def test_band_slots_layout(R, m_pad, B, per_row):
    """band_slots keeps every nonzero once, each row's in ascending offset
    order, in the sliced ELL layout the kernel reads (a slice's slots a row
    a multiple of GROUP, pads offset 0 and value 0), and band_dense gives
    the band back."""
    from devicekmc_tpu_torch.ops import banded as bd

    rng = np.random.default_rng(R + 10 * per_row)
    C4 = _sparse_band(rng, R, m_pad, B, per_row)
    slots = bd.band_slots(C4)
    assert slots.shape == (R, m_pad, B) and slots.start.dtype == torch.int32
    assert slots.off.dtype == torch.int16 and slots.val.dtype == torch.float32
    assert torch.equal(bd.band_dense(slots), torch.as_tensor(C4))
    width = (slots.start[1:] - slots.start[:-1]) // bd.SLICE
    assert int(slots.start[0]) == 0 and bool((width % bd.GROUP == 0).all())
    pos, held = bd._rows(slots)
    off = slots.off.long() & 0xFFFF
    for i in range(R * B):
        p = pos[i][held[i]]
        v, o = slots.val[p], off[p]
        n = int((v != 0).sum())
        assert n == int((C4[i // B, :, i % B, :] != 0).sum())
        # the row's slots first, in ascending offset order, then its pads
        assert bool((v[:n] != 0).all()) and not bool(v[n:].any()) and not bool(o[n:].any())
        assert bool((o[1:n] > o[:max(n - 1, 0)]).all())
        k, j = o[:n] // B, o[:n] % B
        assert torch.equal(v[:n], torch.as_tensor(C4[i // B, k.numpy(), i % B, j.numpy()]))


def test_band_slots_of_a_jax_bf16_band():
    """A bf16 band as numpy holds it from JAX (ml_dtypes' bfloat16) gives the
    slots of the same band as a torch tensor, values bit for bit."""
    from devicekmc_tpu_torch.ops.banded import band_slots

    rng = np.random.default_rng(4)
    C4 = _sparse_band(rng, 2, 3, 32, 5)
    a = band_slots(np.asarray(jnp.asarray(C4, jnp.bfloat16)))
    b = band_slots(torch.as_tensor(C4).to(torch.bfloat16))
    assert a.val.dtype == torch.bfloat16
    for x, y in zip(a[:3], b[:3]):
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                           y.view(torch.int16) if y.dtype == torch.bfloat16 else y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("R,m_pad,B,per_row", [(3, 5, 32, 1), (3, 5, 32, 2), (4, 9, 64, 12)])
def test_banded_plain_matches_dense_einsum(R, m_pad, B, per_row, dtype):
    """The plain version on a random sparse band against the dense band's
    einsum terms summed: bit-equal on the rows of at most two nonzeros (the
    zeros add exactly, so their sum has one order), within f32 summation
    error elsewhere; the empty rows past the last give exact zeros."""
    from devicekmc_tpu_torch.ops.banded import band_slots, banded_matvec_plain

    rng = np.random.default_rng(R * 7 + per_row)
    C4 = torch.as_tensor(_sparse_band(rng, R, m_pad, B, per_row)).to(getattr(torch, dtype))
    xw = torch.as_tensor(rng.standard_normal((R + m_pad - 1) * B).astype(np.float32))
    got = banded_matvec_plain(band_slots(C4), xw)
    ref = _dense_einsum(C4, xw)
    nnz = (C4 != 0).sum(dim=(1, 3)).reshape(-1)
    short = nnz <= 2
    assert bool(short.any())
    assert torch.equal(got[short], ref[short])
    assert not bool(got[R * B - B // 2:].any())
    scale = float(_dense_einsum(C4.abs(), xw.abs()).max())
    assert float((got - ref).abs().max()) <= 1e-6 * scale


def test_banded_plain_sums_in_slot_order():
    """Each row's sum is a rounded multiply then a rounded add a slot, in
    ascending offset order from 0: the kernel's arithmetic, repeated here in
    numpy f32 on a row whose terms do not commute in f32."""
    from devicekmc_tpu_torch.ops.banded import band_slots, banded_matvec_plain

    B, m_pad = 32, 3
    C4 = np.zeros((1, m_pad, B, B), np.float32)
    offs = np.array([70, 3, 40, 95, 11])
    C4[0, offs // B, 0, offs % B] = [1e8, 1.0, -1e8, 3.0, 0.5]
    xw = np.linspace(0.5, 1.5, m_pad * B).astype(np.float32)
    got = banded_matvec_plain(band_slots(C4), torch.as_tensor(xw))
    acc = np.float32(0)
    for o in sorted(offs):
        acc = np.float32(acc + np.float32(C4[0, o // B, 0, o % B] * xw[o]))
    assert float(got[0]) == float(acc)
    assert not bool(got[1:].any())


@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_fly_matvec_plain_matches_pallas(pbc, symmetric):
    """n = 300 is a multiple of no tile of either implementation."""
    from devicekmc_tpu.ops.wkb_pallas import wkb_fly_matvec as jfly
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec as tfly

    pos, cb, rng = _points(300)
    x = rng.standard_normal(300).astype(np.float32)
    jenv, tenv = _envs(pbc)
    ref = np.asarray(jfly(jnp.asarray(pos), jnp.asarray(cb), jnp.asarray(x), jenv,
                          interpret=True, symmetric=symmetric))
    got = tfly(torch.as_tensor(pos), torch.as_tensor(cb), torch.as_tensor(x), tenv,
               symmetric=symmetric).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("pbc", [False, True])
def test_fly_matmat_plain_matches_pallas(pbc):
    from devicekmc_tpu.ops.wkb_pallas import wkb_fly_matmat as jmm
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat as tmm

    pos, cb, rng = _points(300)
    X = rng.standard_normal((300, 12)).astype(np.float32)
    jenv, tenv = _envs(pbc)
    ref = np.asarray(jmm(jnp.asarray(pos), jnp.asarray(cb), jnp.asarray(X), jenv,
                         interpret=True))
    got = tmm(torch.as_tensor(pos), torch.as_tensor(cb), torch.as_tensor(X), tenv).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_fly_plain_matches_stored_block():
    """The on-the-fly product against the stored block of tunnel_block
    (x**1.5 by pow there, x*sqrt(x) here: one ulp)."""
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec_plain
    from devicekmc_tpu_torch.physics.current import tunnel_block, wkb_single_T

    pos, cb, rng = _points(257)
    x = rng.standard_normal(257).astype(np.float32)
    _, tenv = _envs(True)
    tp, tc = torch.as_tensor(pos), torch.as_tensor(cb)
    ones = torch.ones(257, dtype=torch.bool)
    T = tunnel_block(tenv, tp, tc, ones, tp, tc, ones, wkb_single_T)
    ref = T.double().numpy() @ x.astype(np.float64)
    got = wkb_fly_matvec_plain(tp, tc, torch.as_tensor(x), tenv).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("pbc", [False, True])
def test_window_plain_matches_pallas(pbc):
    """Rows with v_ok False are exact zeros; 24 x 300 is ragged for every
    tile."""
    from devicekmc_tpu.ops.wkb_pallas import wkb_window_block as jwin
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block as twin

    pos, cb, _ = _points(300)
    nv = 24
    vpos = (pos[:nv] + 0.5).astype(np.float32)
    vcb = (cb[:nv] * 0.7).astype(np.float32)
    v_ok = np.arange(nv) < nv - 5
    jenv, tenv = _envs(pbc)
    ref = np.asarray(jwin(jnp.asarray(vpos), jnp.asarray(vcb), jnp.asarray(v_ok),
                          jnp.asarray(pos), jnp.asarray(cb), jenv, interpret=True))
    got = twin(torch.as_tensor(vpos), torch.as_tensor(vcb), torch.as_tensor(v_ok),
               torch.as_tensor(pos), torch.as_tensor(cb), tenv).numpy()
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    assert (got[nv - 5:] == 0).all()


def _window_rows_stepwise(env, vpos, vcb, v_ok, pos, cb):
    """The plain version's rows as they were before the step table: e1, e15
    and the offset computed step by step."""
    import math

    dev = vpos.device
    dx = vpos[:, None, 0] - pos[None, :, 0]
    dy = vpos[:, None, 1] - pos[None, :, 1]
    dz = vpos[:, None, 2] - pos[None, :, 2]
    if env["pbc"]:
        ly, lz = env["lattice"][1], env["lattice"][2]
        dy = dy - torch.round(dy / ly) * ly
        dz = dz - torch.round(dz / lz) * lz
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    abs_dE = torch.abs(vcb[:, None] - cb[None, :])
    elig = v_ok[:, None] & (abs_dE > env["ctol"]) & ~(dist < env["nn"])
    safe = torch.where(elig, abs_dE, 1.0)
    s = env["prefac"] * (dist * 1e-10) / safe
    qV0 = torch.tensor(env["qV0"], dtype=torch.float32, device=dev)
    dE_step = torch.tensor(env["dE_step"], dtype=torch.float32, device=dev)
    widest = float(torch.where(elig, abs_dE, 0.0).max()) if elig.numel() else 0.0
    n_steps = min(int(env["n_int_steps"]), int(math.ceil(widest / env["dE_step"])) + 1)
    T = torch.zeros_like(s)
    for k in range(n_steps):
        iv = torch.tensor(float(k), dtype=torch.float32, device=dev) * dE_step
        e1 = qV0 + iv
        e2 = e1 - safe
        e15 = e1 * torch.sqrt(e1)
        e2p = torch.where(e2 > 0, e2, 0.0)
        term = torch.where(
            e2 > 0,
            torch.exp(s * (e15 - e2p * torch.sqrt(e2p))),
            torch.where(e2 < 0, torch.exp(s * e15), 0.0),
        )
        T = T + torch.where(iv < safe, term, 0.0)
    return torch.where(elig, -T, 0.0)


@pytest.mark.parametrize("n_steps", [1, 256, 1024, 4096])
def test_window_step_table_is_the_step_loop(n_steps):
    """window_step_table's offset, e1 and e15 are bit for bit what the step
    loop computed at each step."""
    from devicekmc_tpu_torch.ops.wkb_window import window_step_table

    _, tenv = _envs(False, n_int_steps=n_steps)
    iv, e1, e15 = window_step_table(tenv, n_steps)
    assert iv.dtype == e1.dtype == e15.dtype == torch.float32
    qV0 = torch.tensor(tenv["qV0"], dtype=torch.float32)
    dE = torch.tensor(tenv["dE_step"], dtype=torch.float32)
    for k in sorted({0, 1, 2, 3, 52, 53, 255, n_steps - 2, n_steps - 1} & set(range(n_steps))):
        ivk = torch.tensor(float(k), dtype=torch.float32) * dE
        e1k = qV0 + ivk
        assert torch.equal(iv[k], ivk) and torch.equal(e1[k], e1k)
        assert torch.equal(e15[k], e1k * torch.sqrt(e1k))
    # the kernel builds the table with correctly rounded f32 operations, as
    # numpy does here: the same offsets and e1; e15 within two ulp, since
    # PyTorch's f32 square root on the CPU is not always correctly rounded
    # (one ulp off, and the product rounds once more)
    ivn = np.arange(n_steps, dtype=np.float32) * np.float32(tenv["dE_step"])
    e1n = np.float32(tenv["qV0"]) + ivn
    np.testing.assert_array_equal(iv.numpy(), ivn)
    np.testing.assert_array_equal(e1.numpy(), e1n)
    np.testing.assert_array_max_ulp(e15.numpy(), e1n * np.sqrt(e1n), maxulp=2)


@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("n_int_steps", [1, 48, 256, 1024])
def test_window_plain_with_table_is_bit_equal(pbc, n_int_steps):
    """The plain version on the step table gives the bits it gave with the
    values computed step by step; CB edges over 3 V so that wide windows
    and both barrier forms occur."""
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block_plain

    pos, _, rng = _points(300, seed=n_int_steps)
    cb = ((rng.random(300) * 2 - 1) * Q * 3).astype(np.float32)
    _, tenv = _envs(pbc, n_int_steps=n_int_steps)
    tp, tc = torch.as_tensor(pos), torch.as_tensor(cb)
    vpos, vcb = (tp[:24] + 0.5).contiguous(), (tc[:24] * 0.7).contiguous()
    v_ok = torch.arange(24) < 19
    got = wkb_window_block_plain(vpos, vcb, v_ok, tp, tc, tenv)
    ref = _window_rows_stepwise(tenv, vpos, vcb, v_ok, tp, tc)
    assert float(ref.abs().max()) > 0
    assert torch.equal(got, ref)


def test_window_steps_and_lane_share():
    """window_steps_plain counts the steps k with k * dE_step < |dE| of each
    eligible pair (0 otherwise), and window_lane_share is the steps over 32
    times each warp's longest window."""
    from devicekmc_tpu_torch.ops.wkb_window import (
        window_lane_share, window_step_table, window_steps_plain,
    )

    pos, _, rng = _points(100, seed=3)
    cb = ((rng.random(100) * 2 - 1) * Q * 3).astype(np.float32)
    _, tenv = _envs(False, n_int_steps=256)
    tp, tc = torch.as_tensor(pos), torch.as_tensor(cb)
    vpos, vcb = (tp[:6] + 0.5).contiguous(), (tc[:6] * 0.7).contiguous()
    v_ok = torch.tensor([True, True, False, True, True, True])
    steps = window_steps_plain(vpos, vcb, v_ok, tp, tc, tenv)
    iv, _, _ = window_step_table(tenv, 256)
    abs_dE = (vcb[:, None] - tc[None, :]).abs()
    dist = torch.cdist(vpos.double(), tp.double()).float()
    for r in range(6):
        for c in range(100):
            elig = bool(v_ok[r]) and abs_dE[r, c] > tenv["ctol"] and not dist[r, c] < 3.5
            want = int((iv < abs_dE[r, c]).sum()) if elig else 0
            assert int(steps[r, c]) == want
    assert int(steps[2].abs().sum()) == 0 and int(steps.max()) == 256
    # two rows of 40 columns: warps of 32 and 8 columns
    s = torch.zeros((2, 40), dtype=torch.int64)
    s[0, :32] = 10
    s[0, 5] = 20
    s[1, 32:] = 4
    s[1, 39] = 0
    assert window_lane_share(s) == pytest.approx((31 * 10 + 20 + 7 * 4) / (32 * (20 + 4)))
    assert window_lane_share(torch.zeros((3, 5), dtype=torch.int64)) == 1.0


def test_window_plain_matches_tunnel_block_window():
    """The kernel's plain version (x*sqrt(x), early exit) against the pow
    form tunnel_block(wkb_window_T), which pure-f64 runs use."""
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block_plain
    from devicekmc_tpu_torch.physics.current import tunnel_block, wkb_window_T

    pos, cb, _ = _points(200)
    nv = 16
    _, tenv = _envs(False, n_int_steps=48)
    tp, tc = torch.as_tensor(pos), torch.as_tensor(cb)
    vpos, vcb = tp[:nv] + 0.5, tc[:nv] * 0.7
    v_ok = torch.arange(nv) < nv - 3
    ref = tunnel_block(tenv, vpos, vcb, v_ok, tp, tc,
                       torch.ones(200, dtype=torch.bool), wkb_window_T).numpy()
    got = wkb_window_block_plain(vpos, vcb, v_ok, tp, tc, tenv).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """On a CUDA tensor a wrapper launches or raises; here only the checks
    that need no card: a device that is neither CPU nor CUDA."""
    from devicekmc_tpu_torch.ops.banded import BandSlots, banded_matvec
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matvec
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block

    _, tenv = _envs(False)
    m = torch.zeros((4, 3), device="meta")
    v = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        wkb_fly_matvec(m, v, v, tenv)
    with pytest.raises(ValueError):
        wkb_fly_matmat(m, v, torch.zeros((4, 2), device="meta"), tenv)
    with pytest.raises(ValueError):
        wkb_window_block(m, v, v.bool(), m, v, tenv)
    with pytest.raises(ValueError):
        banded_matvec(BandSlots(torch.zeros(0, dtype=torch.int16, device="meta"),
                                torch.zeros(0, device="meta"),
                                torch.zeros(5, dtype=torch.int32, device="meta"), (1, 1, 128)),
                      torch.zeros(128, device="meta"))


# ---------------------------------------------------------------------------
# the kernels' chunk skip and grid rules (Python side)
# ---------------------------------------------------------------------------

from hypothesis import given, settings, strategies as st


def _skipped_entries(skip, vals):
    """The entries of vals [R, C] that lie in a skipped 32 x 32 chunk."""
    R, C = vals.shape
    full = skip.repeat_interleave(32, dim=0).repeat_interleave(32, dim=1)[:R, :C]
    return vals[full]


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), R=st.integers(1, 150), C=st.integers(1, 150),
       spread=st.sampled_from([0.0, 0.004, 0.0099, 0.01, 0.0101, 0.05, 2.0]),
       pbc=st.booleans())
def test_chunk_skip_never_skips_a_nonzero_entry(seed, R, C, spread, pbc):
    """Atoms in two contacts whose CB edges spread over `spread` volts around
    0 and -1 V (ctol is 0.01 V): wherever the skip test says True, every
    entry of pair_vals_plain is an exact 0."""
    from devicekmc_tpu_torch.ops.wkb_fly import chunk_skip_plain, pair_vals_plain

    rng = np.random.default_rng(seed)
    _, tenv = _envs(pbc)
    pts = (rng.random((R + C, 3)) * np.array(LATTICE)).astype(np.float32)
    # sorted by contact, as the metal atoms of a device are, with a few strays
    side = np.sort(rng.random(R + C) < 0.5)
    side ^= rng.random(R + C) < 0.02
    cb = ((-1.0 * side + spread * (rng.random(R + C) - 0.5)) * Q).astype(np.float32)
    pr, cr = torch.as_tensor(pts[:R]), torch.as_tensor(cb[:R])
    pc, cc = torch.as_tensor(pts[R:]), torch.as_tensor(cb[R:])
    skip = chunk_skip_plain(cr, cc, tenv["ctol"])
    assert tuple(skip.shape) == (-(-R // 32), -(-C // 32))
    vals = pair_vals_plain(tenv, pr, cr, pc, cc)
    assert not _skipped_entries(skip, vals).any()


def test_chunk_skip_takes_the_contact_interior():
    """One contact whose atoms share their CB edge to within ctol is skipped
    whole against itself and kept against the other contact."""
    from devicekmc_tpu_torch.ops.wkb_fly import chunk_skip_plain

    rng = np.random.default_rng(0)
    _, tenv = _envs(False)
    cb = np.concatenate([rng.random(64) * 0.009, -1.0 + rng.random(64) * 0.009])
    cb = torch.as_tensor((cb * Q).astype(np.float32))
    skip = chunk_skip_plain(cb, cb, tenv["ctol"])
    same = torch.tensor([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 1], [0, 0, 1, 1]],
                        dtype=torch.bool)
    assert torch.equal(skip, same)


@pytest.mark.parametrize("n,col_split,n_split", [
    (1, 4, 1), (129, 4, 2), (3527, 4, 16), (24768, 1, 16), (200_000, 1, 16),
])
def test_fly_grid_rules(n, col_split, n_split):
    """Threads a tile of the matvec are chosen from n: many at the transport
    path's width, few at the reference crossbar's; the matmat never splits
    finer than its column tiles."""
    from devicekmc_tpu_torch.ops.wkb_fly import matmat_split, matvec_col_split

    assert matvec_col_split(n) == col_split
    assert matmat_split(n) == n_split
