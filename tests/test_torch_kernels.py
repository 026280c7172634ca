"""The port's two kernels against the TPU kernels they replace: the plain
versions (what the wrappers run on CPU tensors) against the Pallas kernels
in interpret mode.  tests/test_torch_cuda.py holds the CUDA kernels against
the plain versions on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _random_graph(rng, N, max_nn, bw):
    site = np.arange(N)[:, None]
    nb = np.clip(site + rng.integers(-bw, bw + 1, (N, max_nn)), 0, N - 1)
    nb[rng.random((N, max_nn)) < 0.15] = -1
    return nb


def _gather_inputs(N, max_nn, bw):
    rng = np.random.default_rng(N)
    nb = _random_graph(rng, N, max_nn, bw)
    v = rng.standard_normal(N).astype(np.float32)
    c = rng.integers(0, 1 << 16, N).astype(np.int32)
    return nb, v, c


@pytest.mark.parametrize("N,max_nn,bw", [(1000, 13, 200), (128, 5, 40),
                                         (515, 52, 510)])
def test_gather_matches_pallas(N, max_nn, bw):
    """ell_gather (plain on CPU) == ell_gather_pallas(interpret=True),
    bit-equal on valid slots, f32 and int32 channels in one call."""
    from devicekmc_tpu.ops.ell_gather_pallas import (
        build_ell_gather_plan, ell_gather_pallas,
    )
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather

    nb, v, c = _gather_inputs(N, max_nn, bw)
    ref_v, ref_c = ell_gather_pallas(
        build_ell_gather_plan(nb), [jnp.asarray(v), jnp.asarray(c).astype(jnp.float32)],
        interpret=True,
    )
    got_v, got_c = ell_gather(torch.as_tensor(nb, dtype=torch.int32),
                              [torch.as_tensor(v), torch.as_tensor(c)])
    valid = nb >= 0
    np.testing.assert_array_equal(got_v.numpy()[valid], np.asarray(ref_v)[valid])
    np.testing.assert_array_equal(got_c.numpy()[valid],
                                  np.asarray(ref_c).astype(np.int32)[valid])


@pytest.mark.parametrize("N,max_nn,bw", [(1000, 13, 200), (128, 5, 40),
                                         (515, 52, 510), (7, 3, 7)])
def test_gather_every_slot_matches_jax(N, max_nn, bw):
    """Every slot, pads included, f32 and int32 channels in one call.  The
    plain version (what the card kernel must equal bit for bit) is the JAX
    package's XLA gather ``values[max(idx, 0)]`` (physics/charge.py,
    physics/events.py) on every slot: pads hold site 0's word.  The Pallas
    kernel equals it on the valid slots; its plan points a pad slot at the
    row's own site instead (build_ell_gather_plan: a pad must stay inside
    the row block's page window), so there a pad holds the row's own word.
    Either way pads are masked with neigh_valid downstream."""
    from devicekmc_tpu.ops.ell_gather_pallas import (
        build_ell_gather_plan, ell_gather_pallas,
    )
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather

    nb, v, c = _gather_inputs(N, max_nn, bw)
    pad = nb < 0
    assert pad.any() and (~pad).any()
    safe = jnp.maximum(jnp.asarray(nb), 0)
    xla_v, xla_c = np.asarray(jnp.asarray(v)[safe]), np.asarray(jnp.asarray(c)[safe])
    pal_v, pal_c = ell_gather_pallas(
        build_ell_gather_plan(nb), [jnp.asarray(v), jnp.asarray(c).view(jnp.float32)],
        interpret=True,
    )
    pal_v, pal_c = np.asarray(pal_v), np.asarray(pal_c).view(np.int32)
    got_v, got_c = (g.numpy() for g in ell_gather(
        torch.as_tensor(nb, dtype=torch.int32), [torch.as_tensor(v), torch.as_tensor(c)]))
    assert got_v.dtype == np.float32 and got_c.dtype == np.int32
    # bit for bit: compare the 32-bit words
    np.testing.assert_array_equal(got_v.view(np.int32), xla_v.view(np.int32))
    np.testing.assert_array_equal(got_c, xla_c)
    np.testing.assert_array_equal(got_v.view(np.int32)[~pad], pal_v.view(np.int32)[~pad])
    np.testing.assert_array_equal(got_c[~pad], pal_c[~pad])
    assert (got_v[pad] == v[0]).all() and (got_c[pad] == c[0]).all()
    own = np.broadcast_to(np.arange(N)[:, None], nb.shape)[pad]
    np.testing.assert_array_equal(pal_v[pad], v[own])
    np.testing.assert_array_equal(pal_c[pad], c[own])


@pytest.mark.parametrize("n_pairs,n_sm,per_sm,grid", [
    (108_944 * 51, 132, 2, (4, 264)), (108_944 * 51, 132, 1, (4, 132)),
    (1, 132, 2, (1, 1)), (2048, 132, 2, (1, 64)), (2049, 132, 2, (1, 65)),
    (16 * 128 * 264, 132, 2, (4, 264)), (16 * 128 * 263 + 1, 132, 2, (4, 264)),
    (16 * 128 * 263, 132, 2, (4, 263)), (16 * 128 * 132, 132, 2, (4, 132)),
    (16 * 128 * 132 - 128, 132, 2, (1, 264)), (1024 * 51, 132, 2, (1, 132)),
    (8192 * 51, 132, 2, (4, 204)), (1024 * 51, 132, 1, (1, 132)),
])
def test_gather_grid_rule(n_pairs, n_sm, per_sm, grid):
    """Four slots a lane where 128-slot tiles give every warp of one block
    an SM (16 warps) work, else one; per_sm blocks an SM, fewer where the
    pairs do not give every warp of a block a tile, but one block an SM
    while there are tiles for them: the headline shape (5,556,144 pairs)
    takes four slots a lane and 264 blocks on 132 SMs at 2 an SM, the rate
    table's smallest bucket of rows (1,024 x 51) one slot a lane and one
    block an SM."""
    from devicekmc_tpu_torch.ops.ell_gather import gather_grid

    assert gather_grid(n_pairs, n_sm, per_sm) == grid


def _poisson_inputs():
    rng = np.random.default_rng(0)
    N, cap = 700, 128
    coords = rng.uniform(0, 30, (N, 3)).astype(np.float32)
    charge = np.zeros(N, np.int32)
    charge[rng.choice(N, 40, replace=False)] = rng.choice([-2, 2], 40)
    return coords, charge, cap


@pytest.mark.parametrize("pbc", [False, True])
def test_poisson_matches_pallas(pbc):
    """poisson_pairwise (plain on CPU) == poisson_pairwise_pallas
    (interpret=True) within atol 2e-6 * max|ref|, the tolerance of
    tests/test_fields.py::test_pallas_poisson_interpret_matches_jnp (f32
    sums in another order)."""
    from devicekmc_tpu.ops.pairwise_pallas import poisson_pairwise_pallas
    from devicekmc_tpu_torch.ops.pairwise import kernel_scalars, poisson_pairwise

    coords, charge, cap = _poisson_inputs()
    lattice = np.array([30.0, 30.0, 30.0], np.float32)
    sigma, k = np.float32(3.5e-10), np.float32(8.987552e9 / 23)
    (cidx,) = np.nonzero(charge)
    cidx_cap = np.zeros(cap, np.int32)
    cidx_cap[:len(cidx)] = cidx
    cq_cap = np.zeros(cap, np.float32)
    cq_cap[:len(cidx)] = charge[cidx]
    ref = np.asarray(poisson_pairwise_pallas(
        jnp.asarray(coords), jnp.asarray(cidx_cap), jnp.asarray(cq_cap),
        jnp.float32(sigma), jnp.float32(k), jnp.asarray(lattice), pbc,
        interpret=True,
    ))
    got = poisson_pairwise(
        torch.as_tensor(coords), torch.as_tensor(cidx.astype(np.int32)),
        torch.as_tensor(charge[cidx].astype(np.float32)),
        *kernel_scalars(float(sigma), float(k), lattice, torch.float32), pbc,
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6 * np.abs(ref).max())


def _twin_inputs(pbc):
    """700 sites with 40 charged; two charged sites have a twin at the same
    coordinates (one charged, one not), and under PBC one charged site has
    an image one cell length away in y."""
    coords, charge, _ = _poisson_inputs()
    lattice = np.array([30.0, 30.0, 30.0], np.float32)
    (cidx,) = np.nonzero(charge)
    free = np.nonzero(charge == 0)[0]
    coords[cidx[1]] = coords[cidx[0]]           # charged twin of a charged site
    coords[free[0]] = coords[cidx[2]]           # uncharged twin of a charged site
    if pbc:
        coords[free[1]] = coords[cidx[3]] + np.float32([0.0, 30.0, 0.0])
    return coords, charge, cidx, lattice


def _dead_pairs_d2(coords, cidx, lat_y, lat_z, pbc):
    """[N, C] bool: the pairs csrc/pairwise.cu leaves out, those whose
    squared distance is 0 (below the least normal f32), with its minimum
    image (the quotient as a product with 1/l; the product by l and the
    subtraction rounded apart)."""
    c = torch.as_tensor(coords)
    cc = c[torch.as_tensor(cidx).long()]
    dx = cc[None, :, 0] - c[:, None, 0]
    dy = cc[None, :, 1] - c[:, None, 1]
    dz = cc[None, :, 2] - c[:, None, 2]
    if pbc:
        ily = torch.tensor(1.0, dtype=torch.float32) / lat_y
        ilz = torch.tensor(1.0, dtype=torch.float32) / lat_z
        dy = dy - torch.round(dy * ily) * lat_y
        dz = dz - torch.round(dz * ilz) * lat_z
    return (dx * dx + dy * dy + dz * dz < float(np.finfo(np.float32).tiny)).numpy()


@pytest.mark.parametrize("pbc", [False, True])
def test_poisson_dead_rule_matches_pallas(pbc):
    """The kernel leaves out a pair whose squared distance is 0: on sites
    with twins that is exactly the TPU kernel's (ci == i) | (r <= 0), and
    the plain version still meets poisson_pairwise_pallas there."""
    from devicekmc_tpu.ops.pairwise_pallas import poisson_pairwise_pallas
    from devicekmc_tpu_torch.ops.pairwise import kernel_scalars, poisson_pairwise

    coords, charge, cidx, lattice = _twin_inputs(pbc)
    # the TPU kernel's rule, in its arithmetic (pairwise_pallas.py:_kernel)
    c, ly, lz = jnp.asarray(coords), jnp.float32(lattice[1]), jnp.float32(lattice[2])
    cc = c[jnp.asarray(cidx)]
    dx = cc[None, :, 0] - c[:, None, 0]
    dy = cc[None, :, 1] - c[:, None, 1]
    dz = cc[None, :, 2] - c[:, None, 2]
    if pbc:
        dy = dy - jnp.round(dy / ly) * ly
        dz = dz - jnp.round(dz / lz) * lz
    r = jnp.sqrt(dx * dx + dy * dy + dz * dz) * 1e-10
    ref = np.asarray((jnp.asarray(cidx)[None, :] == jnp.arange(len(coords))[:, None])
                     | (r <= 0.0))
    got = _dead_pairs_d2(coords, cidx, float(lattice[1]), float(lattice[2]), pbc)
    np.testing.assert_array_equal(got, ref)
    # the twins are there: more dead pairs than self pairs
    assert got.sum() == len(cidx) + 3 + int(pbc)

    sigma, k = np.float32(3.5e-10), np.float32(8.987552e9 / 23)
    cap = 128
    cidx_cap = np.zeros(cap, np.int32)
    cidx_cap[:len(cidx)] = cidx
    cq_cap = np.zeros(cap, np.float32)
    cq_cap[:len(cidx)] = charge[cidx]
    vref = np.asarray(poisson_pairwise_pallas(
        jnp.asarray(coords), jnp.asarray(cidx_cap), jnp.asarray(cq_cap),
        jnp.float32(sigma), jnp.float32(k), jnp.asarray(lattice), pbc, interpret=True))
    vgot = poisson_pairwise(
        torch.as_tensor(coords), torch.as_tensor(cidx.astype(np.int32)),
        torch.as_tensor(charge[cidx].astype(np.float32)),
        *kernel_scalars(float(sigma), float(k), lattice, torch.float32), pbc).numpy()
    assert np.isfinite(vgot).all()
    np.testing.assert_allclose(vgot, vref, atol=2e-6 * np.abs(vref).max())


@pytest.mark.parametrize("n,n_c,n_sm,blocks,n_split", [
    (108_944, 502, 132, 426, 8),     # the headline path: rows alone give 3.2 blocks an SM
    (108_944, 8192, 132, 426, 8),
    (108_944, 100, 132, 426, 2),     # at most one split a 64 charged sites
    (108_944, 0, 132, 426, 1),
    (5000, 300, 132, 20, 5),
    (1, 1, 132, 1, 1),
    (1_000_000, 502, 132, 3907, 1),  # rows alone fill the card
    (108_944, 502, 16, 426, 1),
])
def test_poisson_grid_rules(n, n_c, n_sm, blocks, n_split):
    """256 rows a block; the charged set is split only where the rows leave
    the card short of 24 blocks an SM, never finer than 64 charged sites."""
    from devicekmc_tpu_torch.ops.pairwise import poisson_grid

    assert poisson_grid(n, n_c, n_sm) == (blocks, n_split)
