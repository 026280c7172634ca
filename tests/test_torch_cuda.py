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


@pytest.mark.cuda
@pytest.mark.parametrize("pbc", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n", [300, 1153])
def test_cuda_fly_matvec(n, symmetric, pbc):
    """atol 1e-5 * max|plain| (f32 sums in another order, FMA); two launches
    on the same input give the same bits."""
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
    assert float(ref.abs().max()) > 0
    np.testing.assert_allclose(y.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("K,KB", [(12, 8), (24, 8), (24, 24), (5, 4), (5, None), (24, None), (40, None)])
def test_cuda_fly_matmat(K, KB):
    """atol 1e-5 * max|plain|: the K-column contraction is FP32 FMA."""
    _need_card()
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matmat_plain

    n = 1153
    pos, cb, rng = _points(n, 7)
    X = torch.as_tensor(rng.standard_normal((n, K)).astype(np.float32), device="cuda")
    env = _env(True)
    before = wkb_fly_matmat.launches
    Y = wkb_fly_matmat(pos, cb, X, env, KB=KB)
    ref = wkb_fly_matmat_plain(pos, cb, X, env)
    torch.cuda.synchronize()
    assert wkb_fly_matmat.launches == before + 1
    np.testing.assert_allclose(Y.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))


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
