"""The port's twins of the JAX package's examples on the CPU at a tiny size:
``examples/iv_sweep_torch.py`` against ``examples/iv_sweep.py`` (2 bias
points, 2 supersteps each: the current at each bias within 1e-5 relative),
and ``examples/checkpoint_resume_torch.py`` (its resumed run bit-equal to
the uninterrupted one)."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IV_ARGS = ["--points", "2", "--steps-per-bias", "2"]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _currents(output_txt):
    from devicekmc_tpu_torch.postprocessing.parse import parse_output

    tr = parse_output(output_txt)
    return tr.voltages, np.asarray(tr.final_per_bias("Current [uA]"), dtype=np.float64)


def test_iv_sweep_matches_jax_example(tmp_path, monkeypatch, capsys):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    v, i = _example("iv_sweep_torch").main(IV_ARGS + ["--device", "cpu", "--outdir", port_dir])
    out = capsys.readouterr().out
    assert "V: [0.0, 6.0]" in out and "I [uA]:" in out
    monkeypatch.setattr(sys, "argv", ["iv_sweep.py", *IV_ARGS, "--cpu", "--outdir", jax_dir])
    _example("iv_sweep").main()
    jv, ji = _currents(os.path.join(jax_dir, "output.txt"))
    pv, pi = _currents(os.path.join(port_dir, "output.txt"))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(np.asarray(v), pv)
    assert len(pi) == 2 and abs(pi[-1]) > 0
    np.testing.assert_allclose(pi, ji, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(i), pi, rtol=0)


def test_checkpoint_resume_example(tmp_path, capsys):
    rc = _example("checkpoint_resume_torch").main(["--device", "cpu", "--outdir",
                                                   str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "checkpointed at bias index 1, step 2" in out
    assert "resumed at bias index 1, step 2" in out
    assert "resumed trajectory bit-equal to uninterrupted run: True" in out
    assert os.path.exists(tmp_path / "mid_bias.npz")


def test_example_flags():
    """--device in place of --cpu; npz only (no --orbax)."""
    for name in ("iv_sweep_torch", "checkpoint_resume_torch"):
        src = open(os.path.join(ROOT, "examples", f"{name}.py")).read()
        assert '"--device"' in src and '"--cpu"' not in src and '"--orbax"' not in src
        assert "import jax" not in src and "devicekmc_tpu." not in src
    with pytest.raises(SystemExit):
        _example("checkpoint_resume_torch").main(["--orbax"])
