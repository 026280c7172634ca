"""The dissipated-power kernel's plain version and the stored-block sweep of
the port against the JAX package: the Pallas ``wkb_fly_pdisp`` in interpret
mode and ``_pdisp_rows_cols``, on the same numpy inputs.

Tolerances: the on-the-fly route is f32 throughout, the stored route
multiplies in f64; the JAX package's own test holds the two together at
atol = 1e-5 * max|ref| (tests/test_wkb_fly.py) and so do these.  The f64
sweep of a stored block is compared at rtol 1e-12 (sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_transport_kernels import _envs, _points

torch.set_num_threads(1)


def _ms(rng, n):
    """Shifted scaled potentials as the transport solve makes them: >= 0."""
    ms = rng.standard_normal(n).astype(np.float32) * 1e-10
    return ms + np.abs(ms.min())


@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("Vd", [2.0, -1.5, 0.0])
def test_pdisp_plain_matches_pallas(pbc, Vd):
    """n = 300 is a multiple of no tile of either implementation; Vd = 0
    gives exact zeros in both."""
    from devicekmc_tpu.ops.wkb_pallas import wkb_fly_pdisp as jpd
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp as tpd

    pos, cb, rng = _points(300)
    ms = _ms(rng, 300)
    jenv, tenv = _envs(pbc)
    ref = np.asarray(jpd(jnp.asarray(pos), jnp.asarray(cb), jnp.asarray(ms),
                         jnp.asarray(Vd), jenv, interpret=True))
    got = tpd(torch.as_tensor(pos), torch.as_tensor(cb), torch.as_tensor(ms), Vd,
              tenv).numpy()
    assert got.dtype == np.float32 and got.shape == (300,)
    if Vd == 0.0:
        assert (got == 0).all() and (ref == 0).all()
        return
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("Vd", [2.0, -1.5])
def test_pdisp_plain_matches_jax_stored_sweep(pbc, Vd):
    """The f32 on-the-fly rows against the JAX sweep of the stored block
    with f64 potentials."""
    from devicekmc_tpu.physics.current import (
        _pdisp_rows_cols as jsweep, tunnel_block as jblock, wkb_single_T as jT,
    )
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp_plain

    n = 257
    pos, cb, rng = _points(n)
    ms = _ms(rng, n)
    jenv, tenv = _envs(pbc)
    ones = jnp.ones(n, bool)
    T = jblock(jenv, jnp.asarray(pos), jnp.asarray(cb), ones,
               jnp.asarray(pos), jnp.asarray(cb), ones, jT)
    ms64 = jnp.asarray(ms, jnp.float64)
    ref, _ = jsweep(T, ms64, ms64, jnp.asarray(Vd))
    ref = np.asarray(ref)
    got = wkb_fly_pdisp_plain(torch.as_tensor(pos), torch.as_tensor(cb),
                              torch.as_tensor(ms), Vd, tenv).numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("Vd", [2.0, -1.5, 0.0])
@pytest.mark.parametrize("shape,chunk", [((37, 53), 2048), ((300, 41), 128)])
def test_pdisp_rows_cols_matches_jax(shape, chunk, Vd):
    """Rows and transposed columns of one stored f32 block with f64
    potentials, one chunk and several ragged chunks: rtol 1e-12."""
    from devicekmc_tpu.physics.current import _pdisp_rows_cols as jsweep
    from devicekmc_tpu_torch.physics.current import _pdisp_rows_cols as tsweep

    rng = np.random.default_rng(shape[0])
    E = -np.abs(rng.standard_normal(shape)).astype(np.float32)
    E[rng.random(shape) < 0.3] = 0.0
    ms_r, ms_c = rng.random(shape[0]), rng.random(shape[1])
    jr, jc = jsweep(jnp.asarray(E), jnp.asarray(ms_r), jnp.asarray(ms_c),
                    jnp.asarray(Vd), chunk=chunk)
    tr, tc = tsweep(torch.as_tensor(E), torch.as_tensor(ms_r), torch.as_tensor(ms_c),
                    Vd, chunk=chunk)
    assert tr.dtype == tc.dtype == torch.float64
    assert tuple(tr.shape) == (shape[0],) and tuple(tc.shape) == (shape[1],)
    if Vd == 0.0:
        assert not tr.any() and not tc.any()
    else:
        assert float(tr.abs().max()) > 0 and float(tc.abs().max()) > 0
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12, atol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-12, atol=0)


def test_pdisp_rows_and_columns_are_transposes():
    """The column sums of a block are the row sums of its transpose."""
    from devicekmc_tpu_torch.physics.current import _pdisp_rows_cols

    rng = np.random.default_rng(4)
    E = torch.as_tensor(-np.abs(rng.standard_normal((19, 31))))
    a, b = torch.as_tensor(rng.random(19)), torch.as_tensor(rng.random(31))
    rows, cols = _pdisp_rows_cols(E, a, b, 1.0)
    rows_t, cols_t = _pdisp_rows_cols(E.T.contiguous(), b, a, 1.0)
    np.testing.assert_allclose(cols.numpy(), rows_t.numpy(), rtol=1e-13)
    np.testing.assert_allclose(rows.numpy(), cols_t.numpy(), rtol=1e-13)


def test_pdisp_wrapper_refuses_what_the_kernel_does_not_take():
    """On a CUDA tensor the wrapper launches or raises; here the check that
    needs no card: a device that is neither CPU nor CUDA."""
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp

    _, tenv = _envs(False)
    m = torch.zeros((4, 3), device="meta")
    v = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        wkb_fly_pdisp(m, v, v, 1.0, tenv)
    assert wkb_fly_pdisp.launches == 0


def _routed_rows(pos, cb, ms, Vd, tenv):
    """The card kernel's upper-triangle form in numpy: each unordered pair
    i < j once, t = I dM with I = T_ij dM and dM = ms_i - ms_j, routed to
    row i when I sign(Vd) < 0 and to row j when I sign(Vd) > 0; summed in
    f64.  Returns (rows, t [n, n] of the plain version's ordered terms
    (-I)(-dM), pair values [n, n])."""
    from devicekmc_tpu_torch.ops.wkb_fly import pair_vals_plain

    p, c = torch.as_tensor(pos), torch.as_tensor(cb)
    vals = pair_vals_plain(tenv, p, c, p, c).numpy()
    dM = ms[:, None] - ms[None, :]
    I = vals * dM
    t_ordered = (-I) * (-dM)
    iu, ju = np.triu_indices(len(ms), k=1)
    t = (I * dM)[iu, ju]
    Is = I[iu, ju] * np.float32(np.sign(Vd))
    n = len(ms)
    rows = (np.bincount(iu, np.where(Is < 0, t, 0).astype(np.float64), minlength=n)
            + np.bincount(ju, np.where(Is > 0, t, 0).astype(np.float64), minlength=n))
    return rows, t_ordered, vals


@pytest.mark.parametrize("n", [1, 127, 300])
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("Vd", [1.0, -1.0, 0.0])
def test_pdisp_upper_triangle_routing_matches_plain(n, pbc, Vd):
    """What the card kernel relies on: the pair values and the ordered terms
    (-I)(-dM) are symmetric bit for bit, so each unordered pair's term,
    routed to the row or the column that carries forward current, gives the
    row sums of wkb_fly_pdisp_plain (within 1e-6 of the largest sum: the
    plain version sums in f32, the routed sums here in f64); Vd = 0 gives
    zeros, one atom only its zero self pair."""
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp_plain

    pos, cb, rng = _points(n)
    ms = _ms(rng, n)
    _, tenv = _envs(pbc)
    rows, t, vals = _routed_rows(pos, cb, ms, Vd, tenv)
    assert np.array_equal(vals, vals.T)
    assert np.array_equal(t, t.T)
    plain = wkb_fly_pdisp_plain(torch.as_tensor(pos), torch.as_tensor(cb),
                                torch.as_tensor(ms), Vd, tenv).numpy()
    if Vd == 0.0 or n == 1:
        assert not rows.any() and not plain.any()
        return
    scale = np.abs(plain).max()
    assert scale > 0
    np.testing.assert_allclose(rows, plain, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("Vd", [1.0, -1.0])
def test_pdisp_upper_triangle_routing_matches_pallas(pbc, Vd):
    """The routed upper-triangle sums against the JAX kernel
    (_pdisp_kernel in interpret mode) at n = 127: atol 1e-5 * max|ref|, the
    tolerance of test_pdisp_plain_matches_pallas (the two packages' pair
    values differ in their last bits)."""
    from devicekmc_tpu.ops.wkb_pallas import wkb_fly_pdisp as jpd

    n = 127
    pos, cb, rng = _points(n)
    ms = _ms(rng, n)
    jenv, tenv = _envs(pbc)
    ref = np.asarray(jpd(jnp.asarray(pos), jnp.asarray(cb), jnp.asarray(ms),
                         jnp.asarray(Vd), jenv, interpret=True))
    rows, _, _ = _routed_rows(pos, cb, ms, Vd, tenv)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(rows, ref, rtol=0, atol=1e-5 * scale)
