"""``transport_bf16_inner`` in the port: bf16 twins of the stored tunnel
blocks and a bf16 band in the f32 inner iterations of the blocked transport
solve, the tolerance tightened by 1e-2; against the dense direct solve
(the envelope of tests/test_fields.py), against the JAX package's own bf16
inner solve, and the twin product's plain version against f64."""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from torch_parity import configs, to_port

torch.set_num_threads(1)

VD = 2.0


@pytest.fixture(scope="module")
def dev():
    """The device of tests/test_fields.py's ``small_sim`` (8 vacancies, 4
    oxygen ions), after the charge rule and the CB-edge solve at 2 V, in
    both packages."""
    from devicekmc_tpu.physics import charge as jcharge
    from devicekmc_tpu.physics import potential as jpot
    from devicekmc_tpu.state import build_geometry, build_params, init_state
    from devicekmc_tpu.structure import Element, make_test_structure
    from devicekmc_tpu_torch.state import build_params as tbuild_params

    s = make_test_structure(nx_contact=2, nx_oxide=6, ny=3, nz=3, seed=3)
    jcfg, tcfg = configs(s, pbc=False, solve_current=True,
                         solve_heating_global=True, A=6.25e-19)
    elems = s.elements.copy()
    rng = np.random.default_rng(7)
    oxide = np.nonzero(elems == int(Element.O))[0]
    elems[rng.choice(oxide, size=8, replace=False)] = int(Element.VACANCY)
    defects = np.nonzero(elems == int(Element.DEFECT))[0]
    elems[rng.choice(defects, size=4, replace=False)] = int(Element.OXYGEN_DEFECT)
    jg = build_geometry(elems, s.coords, jcfg)
    jp = build_params(jcfg)
    js = init_state(jg, jcfg, elems)
    js, _ = jcharge.update_charge(jg, js)
    js, _ = jpot.solve_cb_edge(jg, jp, js, VD)
    n_vac = int((elems[np.asarray(jg.atom_ind)] == int(Element.VACANCY)).sum())
    kw = dict(transport="blocked", tunnel_vac_cap=max(16, n_vac + 4), mixed=True,
              transport_bf16_inner=True)
    tg, ts = to_port(jg, js)
    return dict(jg=jg, js=js, jp=jp.replace(**kw), tg=tg, ts=ts,
                tp=dataclasses.replace(tbuild_params(tcfg), **kw))


def test_blocked_bf16_inner_matches_dense(dev):
    """Mirror of tests/test_fields.py::test_blocked_bf16_inner_matches_dense:
    I_macro within 2e-4 of the dense direct solve, without and with the
    band, which is stored bf16; fewer than 4,000 iterations."""
    from devicekmc_tpu_torch.physics import current as cur

    g, p, st = dev["tg"], dev["tp"], dev["ts"]
    st_d, _ = cur.update_power(g, p, st, VD, method="direct")
    I_ref = st_d.I_macro
    blk = cur.assemble_X_blocks(g, p, st)
    for name in ("T_cc16", "T_vv16", "T_vm16"):
        assert blk[name].dtype == torch.bfloat16
    st_b, mb = cur.update_power(g, p, st, VD)
    assert mb["transport_converged"]
    assert st_b.I_macro == pytest.approx(I_ref, rel=2e-4)
    assert int(mb["cg_iters_power"]) < 4000
    band = cur.build_banded_nb(g, p, st, block=32)
    assert band["slots"].val.dtype == torch.bfloat16
    st_bb, mbb = cur.update_power(g, p, st, VD, cc={"band": band})
    assert mbb["transport_converged"]
    assert st_bb.I_macro == pytest.approx(I_ref, rel=2e-4)
    assert int(mbb["cg_iters_power"]) < 4000


@pytest.mark.parametrize("with_band", [False, True], ids=["no-band", "band"])
def test_bf16_inner_matches_jax(dev, with_band):
    """The same state through both packages' bf16 inner solve (stored metal
    block): I_macro within 2e-5 relative.  Measured 6.3e-7 without and
    3.1e-6 with the band (the direct solve is 5.7e-6 and 4.7e-8 from the
    port, 5.1e-6 and 3.2e-6 from JAX; 37 and 162 iterations with the band):
    both solves stop at tolerance 1e-10, with their f32 inner sums in
    another order, and with the band the port's inner operator keeps the
    vector f32 and each row's bf16 rounding on the diagonal, where the JAX
    package's rounds the vector and not the diagonal
    (test_bf16_band_keeps_its_row_sums)."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.ops.banded import band_slots
    from devicekmc_tpu_torch.physics import current as tcur

    jcc = tcc = None
    if with_band:
        jband = jcur.build_banded_nb(dev["jg"], dev["jp"], dev["js"], block=32)
        tband = tcur.build_banded_nb(dev["tg"], dev["tp"], dev["ts"], block=32)
        ref = band_slots(np.asarray(jband["C"]))
        assert tband["slots"].val.dtype == ref.val.dtype == torch.bfloat16
        for a, b in zip(tband["slots"][:3], ref[:3]):
            assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
        jcc, tcc = {"band": jband}, {"band": tband}
    jst, jm = jcur.update_power(dev["jg"], dev["jp"], dev["js"], VD, cc=jcc)
    tst, tm = tcur.update_power(dev["tg"], dev["tp"], dev["ts"], VD, cc=tcc)
    assert tm["transport_converged"] and bool(jm["transport_converged"])
    assert tst.I_macro == pytest.approx(float(jst.I_macro), rel=2e-5)


def test_bf16_inner_under_fly_reads_no_twin(dev):
    """Under transport_cc = fly the metal block has no twin, so the inner
    iterations read no twin at all (the JAX package's test at
    devicekmc_tpu/physics/current.py:783) and none is made, of the vacancy
    blocks either: the flag then only tightens the tolerance, and the solve
    equals the f32 inner one at tolerance x 1e-2 bit for bit."""
    from devicekmc_tpu_torch.physics import current as cur

    fly = dataclasses.replace(dev["tp"], transport_cc="fly")
    blk = cur.assemble_X_blocks(dev["tg"], fly, dev["ts"])
    assert not {"T_cc16", "T_vv16", "T_vm16"} & set(blk)
    st_a, ma = cur.update_power(dev["tg"], fly, dev["ts"], VD)
    plain = dataclasses.replace(fly, transport_bf16_inner=False)
    st_b, mb = cur.update_power(dev["tg"], plain, dev["ts"], VD,
                                cg_tol=fly.transport_tol * 1e-2)
    assert ma["cg_iters_power"] == mb["cg_iters_power"]
    assert st_a.I_macro == st_b.I_macro
    assert torch.equal(st_a.virtual_potentials, st_b.virtual_potentials)


def test_bf16_twins_only_in_mixed_mode(dev):
    """No twin and an f32 band without the f64 refinement (pure f64)."""
    from devicekmc_tpu_torch.physics import current as cur

    f64 = dataclasses.replace(dev["tp"], mixed=False)
    assert not cur.bf16_inner(f64)
    blk = cur.assemble_X_blocks(dev["tg"], f64, dev["ts"])
    assert "T_vv16" not in blk
    assert cur.build_banded_nb(dev["tg"], f64, dev["ts"], block=32)["slots"].val.dtype \
        == torch.float32


@pytest.mark.parametrize("shape", [((300, 70), (70,)), ((70,), (70, 300)),
                                   ((300, 70), (70, 5))],
                         ids=["matvec", "vecmat", "matmat"])
def test_twin_matmul_plain_is_f32_exact_products(shape):
    """The plain twin product in small row chunks: within f32 summation
    error (1e-6 of the terms' magnitude) of the f64 product of the same bf16
    values, and far from the bf16-rounded result of torch.matmul."""
    from devicekmc_tpu_torch.physics.current import twin_matmul, twin_matmul_plain

    g = torch.Generator().manual_seed(3)
    a = torch.randn(shape[0], generator=g).to(torch.bfloat16)
    b = torch.randn(shape[1], generator=g).to(torch.bfloat16)
    ref = a.double() @ b.double()
    got = twin_matmul_plain(a, b, max_bytes=1000)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = float((a.double().abs() @ b.double().abs()).max())
    assert float((got.double() - ref).abs().max()) <= 1e-6 * scale
    assert torch.equal(twin_matmul(a, b), twin_matmul_plain(a, b))
    rounded = float(((a @ b).double() - ref).abs().max())
    assert rounded > 10 * float((got.double() - ref).abs().max())


def test_bf16_band_keeps_its_row_sums(dev):
    """The bf16 band's rows plus its ``row_fix`` sum to the exact f64
    band's (within f32 rounding of the sums), so that the inner operator
    stays a conductance Laplacian; an f32 band has no fix."""
    from devicekmc_tpu_torch.ops.banded import band_dense
    from devicekmc_tpu_torch.physics import current as cur

    g, p, st = dev["tg"], dev["tp"], dev["ts"]
    band = cur.build_banded_nb(g, p, st, block=32)
    f32 = cur.build_banded_nb(g, dataclasses.replace(p, transport_bf16_inner=False), st,
                              block=32)
    assert "row_fix" not in f32 and band["row_fix"].dtype == torch.float32
    rows = lambda b: (band_dense(b["slots"]).double().sum(dim=(1, 3)).reshape(-1)
                      [:g.N_atom][band["inv"]])
    exact, rounded = rows(f32), rows(band)
    assert float((rounded - exact).abs().max()) > 100.0   # 1e5 rounds 160 away
    np.testing.assert_allclose((rounded + band["row_fix"].double()).numpy(),
                               exact.numpy(), rtol=1e-7, atol=1e-9)


@pytest.fixture(scope="module")
def crossbar():
    """The synthetic crossbar of the card's smoke run at 3,952 sites (n_mp
    127), stored metal block, after the cold CB-edge and boundary solves at
    1 V."""
    import chip_smoke
    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.physics import current as cur
    from devicekmc_tpu_torch.state import replace

    sim = chip_smoke.synthetic_crossbar(2000, "cpu", tempfile.mkdtemp(), current=True,
                                        transport_bf16_inner=True, transport_cc="stored")
    cold = replace(sim.params, boundary_precond="deflated")
    sim.state, _ = engine._phase_cb_edge(sim.geom, cold, sim.state, 1.0)
    sim._chunked_boundary(1.0, 200, cold)
    cache = cur.assemble_transport_cache(sim.geom, sim.params, sim.state)
    return sim, cache


def test_bf16_band_without_its_row_fix_stalls(crossbar):
    """On the crossbar a bf16 band whose rounded rows meet the exact
    diagonal (the JAX package's, with the vector f32) leaves the cold solve
    unconverged at 400 iterations with the current off by orders of
    magnitude; with the row fix the same solve converges (103 iterations
    measured, against 2,000 unconverged without)."""
    from devicekmc_tpu_torch.physics import current as cur

    sim, cache = crossbar
    g, p, st = sim.geom, sim.params, sim.state
    I_ref = cur.update_power(g, p, st, 1.0, method="direct")[0].I_macro
    jax_form = {k: v for k, v in sim._band.items() if k != "row_fix"}
    s_j, m_j = cur.update_power(g, p, st, 1.0, cc=dict(cache, band=jax_form), cg_maxiter=400)
    assert not m_j["transport_converged"] and abs(s_j.I_macro / I_ref) > 1e3
    s_f, m_f = cur.update_power(g, p, st, 1.0, cc=dict(cache, band=sim._band),
                                cg_maxiter=1000)
    assert m_f["transport_converged"] and 0 < s_f.I_macro < 2 * I_ref


def test_band_takes_an_f32_vector_with_a_bf16_band(dev):
    """The transport path hands the band an f32 vector also when the band
    is bf16; the wrapper's plain version then rounds only the band (its
    result differs from the all-bf16 product)."""
    from devicekmc_tpu_torch.ops.banded import band_dense, banded_matvec
    from devicekmc_tpu_torch.physics import current as cur

    band = cur.build_banded_nb(dev["tg"], dev["tp"], dev["ts"], block=32)
    C = band["slots"]
    R, m_pad, B = C.shape
    x = torch.randn((R + m_pad - 1) * B, generator=torch.Generator().manual_seed(2))
    y = banded_matvec(C, x)
    x2 = x.double().reshape(R + m_pad - 1, B)
    ref = torch.einsum("rkbj,rkj->rb", band_dense(C).double(),
                       torch.stack([x2[k:k + R] for k in range(m_pad)], dim=1)).reshape(-1)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.double().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert not torch.equal(y, banded_matvec(C, x.to(torch.bfloat16)))
