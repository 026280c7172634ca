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
    from devicekmc_tpu.ops.banded_pallas import banded_matvec_pallas
    from devicekmc_tpu_torch.ops.banded import banded_matvec

    rng = np.random.default_rng(R * 100 + m_pad)
    C4 = rng.standard_normal((R, m_pad, B, B)).astype(np.float32)
    xp2 = rng.standard_normal((R + m_pad - 1, B)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    ref = np.asarray(banded_matvec_pallas(jnp.asarray(C4, jdt), jnp.asarray(xp2, jdt),
                                          interpret=True))
    got = banded_matvec(torch.as_tensor(C4).to(tdt), torch.as_tensor(xp2).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (R, B)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=atol)


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
    from devicekmc_tpu_torch.ops.banded import banded_matvec
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
        banded_matvec(torch.zeros((1, 1, 128, 128), device="meta"),
                      torch.zeros((1, 128), device="meta"))


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
