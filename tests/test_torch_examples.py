"""The port's twins of the JAX package's examples on the CPU at a tiny size:
``examples/iv_sweep_torch.py`` against ``examples/iv_sweep.py`` (2 bias
points, 2 supersteps each: the current at each bias within 1e-5 relative),
``examples/checkpoint_resume_torch.py`` with npz and with ``--dcp`` (its
resumed run bit-equal to the uninterrupted one), and
``examples/ensemble_torch.py --mesh 2`` over 2 gloo ranks (the lines of one
process)."""

import importlib.util
import os
import socket
import subprocess
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


def test_checkpoint_resume_example_dcp(tmp_path, capsys):
    """--dcp, the counterpart of the JAX example's --orbax: the checkpoint
    is a torch.distributed.checkpoint directory."""
    rc = _example("checkpoint_resume_torch").main(["--device", "cpu", "--dcp", "--outdir",
                                                   str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert f"-> {tmp_path / 'mid_bias'} (dcp)" in out
    assert "resumed trajectory bit-equal to uninterrupted run: True" in out
    assert os.path.isfile(tmp_path / "mid_bias" / ".metadata")


ENSEMBLE_ARGS = ["--device", "cpu", "--batch", "4", "--steps", "2"]


def test_ensemble_example_mesh(tmp_path, capsys):
    """--mesh 2 under 2 gloo ranks (torchrun's environment, each a process):
    rank 0 prints the lines of the one-process ensemble, the other rank
    nothing."""
    _example("ensemble_torch").main(ENSEMBLE_ARGS)
    want = capsys.readouterr().out
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples", "ensemble_torch.py"),
             *ENSEMBLE_ARGS, "--mesh", "2"], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        done = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], done
    outs = [out for out, _ in done]
    assert "ensemble of 4 devices" in want
    assert outs[0] == want and outs[1] == ""


def test_example_flags():
    """--device in place of --cpu; --dcp in place of --orbax."""
    for name in ("iv_sweep_torch", "checkpoint_resume_torch"):
        src = open(os.path.join(ROOT, "examples", f"{name}.py")).read()
        assert '"--device"' in src and '"--cpu"' not in src and '"--orbax"' not in src
        assert "import jax" not in src and "devicekmc_tpu." not in src
    with pytest.raises(SystemExit):
        _example("checkpoint_resume_torch").main(["--orbax"])
