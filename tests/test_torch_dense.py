"""The dense transport path of the port against the JAX package: the matrix
entry by entry, the solve by each method (current, dissipated power), the
dispatcher's ``method`` argument and the bond currents, on the small device
of test_torch_transport.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_transport import VD, dev  # noqa: F401  (dev: a fixture)

torch.set_num_threads(1)

AREA = 6.25e-19


def _params(dev, **kw):
    """(JAX params, port params) of the dense path; 256 integration steps
    cover the 2 V bias (200 needed)."""
    base = dict(transport="dense", tunnel_int_steps=256, mixed=False, tunnel_vac_cap=0)
    base.update(kw)
    return dev["jbase"].replace(**base), dataclasses.replace(dev["tbase"], **base)


@pytest.mark.parametrize("mixed,vcap,tol", [
    (False, 0, 1e-11), (False, 16, 1e-11), (True, 0, 1e-5), (True, 16, 1e-5),
], ids=["f64-all-pairs", "f64-bucket", "mixed-all-pairs", "mixed-bucket"])
def test_assemble_X_matches_jax(dev, mixed, vcap, tol):
    """Entry by entry.  Neighbour, virtual-node and loop entries are exact;
    tunnel entries within ``tol`` of the largest tunnel entry (f64: exp and
    pow differ by an ulp between XLA and PyTorch; mixed: the same in f32);
    the diagonal to the same relative tolerance.  The strict-> ground rule
    attaches one atom fewer than num_ground_ext."""
    from devicekmc_tpu.physics.current import assemble_X as jX
    from devicekmc_tpu_torch.physics.current import assemble_X as tX

    jp, tp = _params(dev, mixed=mixed, tunnel_vac_cap=vcap)
    ref, jloop = jX(dev["jg"], jp, dev["js"], VD)
    got, tloop = tX(dev["tg"], tp, dev["ts"], VD)
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == ref.shape == (dev["tg"].N_atom + 2,) * 2 and got.dtype == ref.dtype
    assert tloop == float(jloop)
    np.testing.assert_array_equal(got != 0, ref != 0)
    np.testing.assert_array_equal(got, got.T)
    off = ~np.eye(ref.shape[0], dtype=bool)
    # conductances (low_G rounded through f32 in mixed mode) and the loop
    low = float(np.float32(tp.low_G)) if mixed else tp.low_G
    exact = np.isin(ref, [-tp.high_G * 1e5, -tp.high_G * 1e7, -low])
    assert (off & exact).sum() > 400
    np.testing.assert_array_equal(got[off & exact], ref[off & exact])
    tunnel = off & ~exact & (ref != 0)
    assert tunnel.sum() > 100
    np.testing.assert_allclose(got[tunnel], ref[tunnel], rtol=0,
                               atol=tol * np.abs(ref[tunnel]).max())
    np.testing.assert_allclose(np.diag(got), np.diag(ref), rtol=max(tol, 1e-12))
    np.testing.assert_allclose(got.sum(axis=1), 0.0, atol=1e-9 * np.abs(np.diag(ref)).max())
    nge = tp.num_ground_ext
    assert (got[0, 2:] != 0).sum() == nge - 1 and (got[1, 2:] != 0).sum() == tp.num_source_inj


def test_bucket_and_all_pairs_assemble_the_same_matrix(dev):
    """The compacted window integral scattered back equals the all-pairs
    integral (the same function on the same entries)."""
    from devicekmc_tpu_torch.physics.current import assemble_X

    _, tp0 = _params(dev, tunnel_vac_cap=0)
    _, tp1 = _params(dev, tunnel_vac_cap=16)
    a, _ = assemble_X(dev["tg"], tp0, dev["ts"], VD)
    b, _ = assemble_X(dev["tg"], tp1, dev["ts"], VD)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-13, atol=0)


@pytest.mark.parametrize("method,mixed,tol", [
    ("direct", False, 1e-12), ("cg", False, 1e-12), ("cg", True, 1e-12),
    ("cg_f32scaled", False, 1e-12),
], ids=["direct", "cg", "mixed", "cg_f32scaled"])
def test_update_power_dense_matches_jax(dev, method, mixed, tol):
    """Heating on, each solver: I_macro within 1e-6 relative, power within
    1e-6 of its largest entry, P_tot 1e-6 relative, the same metric keys;
    both converge."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    kw = dict(mixed=mixed, solve_heating_global=True, transport_tol=tol, A=AREA)
    jp, tp = _params(dev, **kw)
    jst, jm = jcur.update_power(dev["jg"], jp, dev["js"], VD, method=method)
    tst, tm = tcur.update_power(dev["tg"], tp, dev["ts"], VD, method=method)
    print(f"cg_iters_power {method}: jax {int(jm['cg_iters_power'])}, port "
          f"{tm['cg_iters_power']}")
    assert set(tm) == set(jm)
    assert tm["transport_converged"] and bool(jm["transport_converged"])
    assert (tm["cg_iters_power"] == 0) == (method == "direct")
    assert tst.I_macro > 0
    assert tst.I_macro == pytest.approx(float(jst.I_macro), rel=1e-6)
    ref = np.asarray(jst.power)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(tst.power.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    assert tst.P_tot == pytest.approx(float(jst.P_tot), rel=1e-6)
    assert tm["Total dissipated power [mW]"] == tst.P_tot * 1e3
    np.testing.assert_allclose(tst.virtual_potentials.numpy(),
                               np.asarray(jst.virtual_potentials), rtol=0, atol=1e-6 * VD)
    assert tm["contact_potential_drop"] == pytest.approx(
        float(jm["contact_potential_drop"]), abs=1e-6 * VD)


def test_dense_without_heating_has_no_power(dev):
    from devicekmc_tpu_torch.physics import current as tcur

    _, tp = _params(dev)
    st, m = tcur.update_power(dev["tg"], tp, dev["ts"], VD, method="direct")
    assert "Total dissipated power [mW]" not in m
    assert not st.power.any() and st.P_tot == 0.0


def test_dense_and_blocked_agree(dev):
    """The two formulations of the port on one state (f64, tolerance 1e-12):
    I_macro to 1e-7 and power to 1e-6 of its largest entry."""
    from devicekmc_tpu_torch.physics import current as tcur

    kw = dict(solve_heating_global=True, transport_tol=1e-12, A=AREA)
    _, tpd = _params(dev, **kw)
    tpb = dataclasses.replace(tpd, transport="blocked", tunnel_vac_cap=16,
                              transport_cc="stored", transport_precond="jacobi")
    d, _ = tcur.update_power(dev["tg"], tpd, dev["ts"], VD)
    b, _ = tcur.update_power(dev["tg"], tpb, dev["ts"], VD)
    assert b.I_macro == pytest.approx(d.I_macro, rel=1e-7)
    np.testing.assert_allclose(b.power.numpy(), d.power.numpy(), rtol=0,
                               atol=1e-6 * float(d.power.abs().max()))


def test_method_direct_never_skips_and_dense_skip_reports_dense_keys(dev):
    """allow_skip with the dense path: the second call on an unchanged
    network reuses the solution and reports the dense branch's keys (no
    blocked sentinels), as the JAX package does; ``method="direct"`` always
    solves, also with transport="blocked"."""
    from devicekmc_tpu.physics import current as jcur
    from devicekmc_tpu_torch.physics import current as tcur

    jp, tp = _params(dev, solve_heating_global=True, A=AREA)
    tg, ts = dev["tg"], dev["ts"]
    st1, m1 = tcur.update_power(tg, tp, ts, VD, allow_skip=True)
    st2, m2 = tcur.update_power(tg, tp, st1, VD, allow_skip=True)
    assert st2 is st1 and m1["cg_iters_power"] > 0 and m2["cg_iters_power"] == 0
    assert set(m2) == set(m1) and "transport_rel0" not in m2
    assert m2["Total dissipated power [mW]"] == m1["Total dissipated power [mW]"]
    jst1, _ = jcur.update_power(dev["jg"], jp, dev["js"], VD, allow_skip=True)
    _, jm2 = jcur.update_power(dev["jg"], jp, jst1, VD, allow_skip=True)
    assert set(jm2) == set(m2) and int(jm2["cg_iters_power"]) == 0
    st3, m3 = tcur.update_power(tg, tp, st1, VD, method="direct", allow_skip=True)
    assert st3 is not st1 and np.isnan(st3.transport_Vd_prev) == np.isnan(st1.transport_Vd_prev)
    blocked = dataclasses.replace(dev["tbase"], transport="blocked")
    st4, m4 = tcur.update_power(tg, blocked, ts, VD, method="direct", allow_skip=True)
    assert "transport_rel0" not in m4 and m4["cg_iters_power"] == 0
    assert st4.I_macro == pytest.approx(st1.I_macro, rel=1e-5)


@pytest.mark.parametrize("method", ["direct", "cg"])
def test_compute_bond_currents_matches_jax(dev, method):
    """Flow field to 1e-6 of its largest entry (two solves at 1e-10)."""
    from devicekmc_tpu.physics.current import compute_bond_currents as jbond
    from devicekmc_tpu_torch.physics.current import compute_bond_currents as tbond

    jp, tp = _params(dev)
    jvec, jout = jbond(dev["jg"], jp, dev["js"], VD, method=method)
    tvec, tout = tbond(dev["tg"], tp, dev["ts"], VD, method=method)
    jvec, jout = np.asarray(jvec), np.asarray(jout)
    assert tvec.shape == (dev["tg"].N_atom, 3) and tout.shape == (dev["tg"].N_atom,)
    assert np.abs(jvec).max() > 0 and (jout >= 0).all()
    np.testing.assert_allclose(tvec.numpy(), jvec, rtol=0, atol=1e-6 * np.abs(jvec).max())
    np.testing.assert_allclose(tout.numpy(), jout, rtol=0, atol=1e-6 * np.abs(jout).max())


def test_dense_solve_refuses_tf32(dev):
    from devicekmc_tpu_torch.physics import current as tcur

    _, tp = _params(dev, mixed=True)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tcur.update_power(dev["tg"], tp, dev["ts"], VD)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
