"""The port's copies of ``devicekmc_tpu/postprocessing`` and
``devicekmc_tpu/io/matrix_debug.py`` (``devicekmc_tpu_torch.postprocessing``,
``devicekmc_tpu_torch.io``) against the JAX package's: both parsers read the
same output.txt and snapshot of a port run identically, the plots and the
data extraction run on it, and the dense and CSR matrix dumps agree."""

import os

import numpy as np
import pytest
import torch

from torch_parity import configs, small_structure, to_port

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port run on the CPU: the 256-site stack with dense transport and
    global heat, two bias points of 3 supersteps, the modular superstep's
    timing keys in the log."""
    from devicekmc_tpu_torch.engine import Simulation

    out = tmp_path_factory.mktemp("port_run")
    s = small_structure()
    _, tcfg = configs(s, solve_current=True, transport="dense", solve_heating_global=True,
                      A=6.25e-19, pristine=True, initial_vacancy_concentration=0.1,
                      V_switch=[1.5, 3.0], t_switch=[1e30, 1e30], output_dir=str(out))
    sim = Simulation(tcfg, elements=s.elements, coords=s.coords, device="cpu", fused=False)
    for Vd in tcfg.V_switch:
        sim.run_bias_point(Vd, 1e30, max_steps=3)
    return out


def _same_trace(a, b):
    np.testing.assert_array_equal(a.voltages, b.voltages)
    assert len(a.bias_points) == len(b.bias_points)
    for pa, pb in zip(a.bias_points, b.bias_points):
        assert pa.voltage == pb.voltage
        assert pa.kmc_time == pb.kmc_time and pa.step_numbers == pb.step_numbers
        assert pa.series == pb.series
    np.testing.assert_array_equal(a.concat_time(), b.concat_time())


def test_parse_output_matches_jax(port_run):
    from devicekmc_tpu.postprocessing import parse_output as jax_parse
    from devicekmc_tpu_torch.postprocessing import parse_output

    path = os.path.join(port_run, "output.txt")
    tr, jtr = parse_output(path), jax_parse(path)
    _same_trace(tr, jtr)
    assert tr.voltages.tolist() == [1.5, 3.0]
    assert [len(bp.kmc_time) for bp in tr.bias_points] == [3, 3]
    for key in ("Current [uA]", "Global temperature [K]", "n_events",
                "Z - calculation time - kmc events [s]"):
        assert len(tr.concat(key)) == 6, key
        np.testing.assert_array_equal(tr.concat(key), jtr.concat(key))
    np.testing.assert_array_equal(tr.final_per_bias("Current [uA]"),
                                  jtr.final_per_bias("Current [uA]"))


def test_parse_snapshot_matches_jax(port_run):
    from devicekmc_tpu.postprocessing import parse_snapshot as jax_snapshot
    from devicekmc_tpu_torch.postprocessing import parse_snapshot

    folder = os.path.join(port_run, "Results_1.500000")
    names = sorted(os.listdir(folder))
    assert names
    for name in names:
        snap, jsnap = (f(os.path.join(folder, name)) for f in (parse_snapshot, jax_snapshot))
        assert snap.keys() == jsnap.keys()
        for k in snap:
            np.testing.assert_array_equal(snap[k], jsnap[k])
        assert len(snap["elements"]) == 256 and np.isfinite(snap["potential"]).all()


def test_plots_and_extract(port_run, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    from devicekmc_tpu.postprocessing import plots as jax_plots
    from devicekmc_tpu_torch.postprocessing import plots

    path = os.path.join(port_run, "output.txt")
    for name, fn in (("iv", plots.plot_iv), ("current", plots.plot_current),
                     ("temperature", plots.plot_temperature),
                     ("timeline", plots.plot_kmc_timeline), ("timing", plots.plot_timing)):
        out = str(tmp_path / f"{name}.png")
        fn(path, out)
        assert os.path.getsize(out) > 0
    snap = os.path.join(port_run, "Results_1.500000", "snapshot_0.xyz")
    plots.show_device(snap, str(tmp_path / "device.png"))
    got = plots.extract_data(path, str(tmp_path / "port.npz"))
    want = jax_plots.extract_data(path, str(tmp_path / "jax.npz"))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(SystemExit):
        plots.main(["nothing", path])


@pytest.fixture(scope="module")
def charged_state():
    """The 256-site stack after the charge rule, in both packages."""
    from devicekmc_tpu.physics import charge as jax_charge
    from devicekmc_tpu.state import build_simulation
    from devicekmc_tpu_torch.state import build_params

    s = small_structure()
    jcfg, tcfg = configs(s, pristine=True, initial_vacancy_concentration=0.1)
    jgeom, jparams, jstate = build_simulation(jcfg, elements=s.elements, coords=s.coords)
    jstate, _ = jax_charge.update_charge(jgeom, jstate)
    geom, state = to_port(jgeom, jstate)
    return (jgeom, jparams, jstate), (geom, build_params(tcfg), state)


def test_matrix_dense_matches_jax(charged_state):
    from devicekmc_tpu.io import boundary_matrix_dense as jax_boundary
    from devicekmc_tpu.io import cb_matrix_dense as jax_cb
    from devicekmc_tpu_torch.io import boundary_matrix_dense, cb_matrix_dense

    jrec, rec = charged_state
    K = boundary_matrix_dense(*rec)
    np.testing.assert_array_equal(K, jax_boundary(*jrec))
    np.testing.assert_array_equal(cb_matrix_dense(*rec), jax_cb(*jrec))
    assert (np.diag(K) > 0).all() and np.allclose(K, K.T)


def test_csr_dumps_match_jax(charged_state, tmp_path):
    from devicekmc_tpu.io import ell_to_csr as jax_ell_to_csr
    from devicekmc_tpu.io import load_csr_txt as jax_load
    from devicekmc_tpu_torch.io import (boundary_matrix_dense, check_matrix_match,
                                        dump_csr_txt, ell_to_csr, load_csr_txt,
                                        save_csr_format)
    from devicekmc_tpu_torch.physics.potential import _edge_conductance_boundary

    _, (geom, params, state) = charged_state
    edge_g = _edge_conductance_boundary(geom, state, params).numpy()
    nb = geom.neigh_idx.numpy()
    vals, cols, row_ptr = ell_to_csr(nb, -edge_g, edge_g.sum(axis=1))
    for a, b in zip((vals, cols, row_ptr), jax_ell_to_csr(nb, -edge_g, edge_g.sum(axis=1))):
        np.testing.assert_array_equal(a, b)
    dump_csr_txt(row_ptr, cols, vals, step=3, prefix=str(tmp_path))
    for a, b in zip(load_csr_txt(3, prefix=str(tmp_path)),
                    jax_load(3, prefix=str(tmp_path))):
        np.testing.assert_array_equal(a, b)
    rp2, c2, v2 = load_csr_txt(3, prefix=str(tmp_path))
    np.testing.assert_array_equal(rp2, row_ptr)
    assert check_matrix_match(v2, vals) and not check_matrix_match(v2 + 1e-3, vals)
    save_csr_format(boundary_matrix_dense(geom, params, state), 4, 4, str(tmp_path / "K.txt"))
    assert len(open(tmp_path / "K.txt").read().strip().split("\n")) == 3
