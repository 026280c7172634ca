"""The port's parameters.txt parser and command-line entry point on the CPU."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

from torch_parity import small_structure

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_inputs(tmp_path):
    """The small stack as atom / interstitial xyz files and a parameters.txt
    with its layer table; returns the parameters path and the site count."""
    from devicekmc_tpu_torch.structure import Element, write_xyz

    s = small_structure()
    inter = np.isin(s.elements, [int(Element.DEFECT), int(Element.OXYGEN_DEFECT)])
    write_xyz(str(tmp_path / "atoms.xyz"), s.elements[~inter], s.coords[~inter])
    write_xyz(str(tmp_path / "inter.xyz"), s.elements[inter], s.coords[inter])
    lines = [
        "// small TiN / HfO2 / TiN stack",
        f"atom_xyz_file = {tmp_path / 'atoms.xyz'}",
        f"interstitial_xyz_file = {tmp_path / 'inter.xyz'}",
        f"output_dir = {tmp_path / 'out'}",
        "lattice = " + " ".join(repr(float(x)) for x in s.lattice),
        "nn_dist = 3.0",
        f"num_atoms_first_layer = {s.num_atoms_first_layer}",
        f"num_layers_contact = {s.num_layers_contact}",
        f"num_atoms_contact = {s.num_atoms_contact}",
        "pristine = 1", "initial_vacancy_concentration = 0.08",
        "rnd_seed = 3", "rnd_seed_kmc = 7",
        "solve_potential = 1", "solve_current = 0", "perturb_structure = 1",
        "V_switch = 2.5", "t_switch = 1e30", "precision = mixed",
        f"num_layers = {len(s.layers)}",
    ]
    for i, layer in enumerate(s.layers):
        for k, v in dataclasses.asdict(layer).items():
            lines.append(f"layer_{i}_{k} = {v}")
    path = tmp_path / "parameters.txt"
    path.write_text("\n".join(lines) + "\n")
    return path, len(s.elements)


def test_parse_parameters_matches_jax(tmp_path):
    """Both packages read the same parameters.txt into the same fields
    (tolerance: none)."""
    from devicekmc_tpu.config import parse_parameters as jparse
    from devicekmc_tpu_torch.config import parse_parameters as tparse

    path, _ = _write_inputs(tmp_path)
    j, t = jparse(str(path)), tparse(str(path))
    for f in dataclasses.fields(t):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if f.name == "layers":
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b]
        else:
            assert a == b, f.name


def test_cli_runs_on_cpu(tmp_path):
    """python -m devicekmc_tpu_torch parameters.txt --cpu runs the bias point
    and writes output.txt and the snapshots."""
    path, n = _write_inputs(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "devicekmc_tpu_torch", str(path), "--cpu",
         "--max-steps", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"Loaded {n} sites" in r.stdout
    out = (tmp_path / "out" / "output.txt").read_text()
    assert out.count("KMC step count:") == 2
    assert "n_events" in out
    folder = tmp_path / "out" / "Results_2.500000"
    assert (folder / "snapshot_0.xyz").exists()
    assert (folder / "snapshot_2.xyz").exists()


def _cli(path, *args):
    return subprocess.run(
        [sys.executable, "-m", "devicekmc_tpu_torch", str(path), "--cpu", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )


def test_cli_modular_on_cpu(tmp_path):
    """--modular runs the superstep phase by phase and logs the reference's
    per-module timing keys at every step."""
    path, _ = _write_inputs(tmp_path)
    r = _cli(path, "--max-steps", "2", "--modular")
    assert r.returncode == 0, r.stderr[-2000:]
    out = (tmp_path / "out" / "output.txt").read_text()
    assert out.count("KMC step count:") == 2
    for key in ("charge", "potential from boundaries", "potential from charges",
                "kmc events"):
        assert out.count(f"Z - calculation time - {key} [s]:") == 2, key


def test_cli_checkpoint_and_resume_on_cpu(tmp_path):
    """--checkpoint writes the npz after 2 steps; --resume continues the bias
    point from step 2 in a new process, appending to output.txt, and ends
    in the uninterrupted 4-step run's snapshot byte for byte."""
    path, _ = _write_inputs(tmp_path)
    text = path.read_text()
    ck = tmp_path / "ck.npz"
    r = _cli(path, "--max-steps", "2", "--checkpoint", str(ck))
    assert r.returncode == 0, r.stderr[-2000:]
    with np.load(ck) as data:
        assert int(data["pos_bias_index"]) == 0 and int(data["pos_bias_step"]) == 2
    r = _cli(path, "--max-steps", "4", "--resume", str(ck))
    assert r.returncode == 0, r.stderr[-2000:]
    out = (tmp_path / "out" / "output.txt").read_text()
    assert [int(l.split(": ")[1]) for l in out.splitlines()
            if l.startswith("KMC step count:")] == [0, 1, 2, 3]
    resumed = (tmp_path / "out" / "Results_2.500000" / "snapshot_4.xyz").read_text()

    path.write_text(text.replace(f"output_dir = {tmp_path / 'out'}",
                                 f"output_dir = {tmp_path / 'ref'}"))
    r = _cli(path, "--max-steps", "4")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "ref" / "Results_2.500000" / "snapshot_4.xyz").read_text() == resumed


def test_cli_dcp_async_checkpoint_and_resume_on_cpu(tmp_path):
    """--checkpoint-backend dcp_async: the CLI waits for the background write
    before it exits (the directory holds the position after 2 steps);
    --resume of a path that is not *.npz reads it as a dcp directory and
    ends in the uninterrupted 4-step run's snapshot byte for byte."""
    import torch
    import torch.distributed.checkpoint as dcp

    path, _ = _write_inputs(tmp_path)
    text = path.read_text()
    ck = tmp_path / "ck"
    r = _cli(path, "--max-steps", "2", "--checkpoint", str(ck),
             "--checkpoint-backend", "dcp_async")
    assert r.returncode == 0, r.stderr[-2000:]
    pos = {"pos_bias_index": torch.tensor(-1), "pos_bias_step": torch.tensor(-1)}
    dcp.load(pos, checkpoint_id=str(ck), no_dist=True)
    assert int(pos["pos_bias_index"]) == 0 and int(pos["pos_bias_step"]) == 2
    r = _cli(path, "--max-steps", "4", "--resume", str(ck))
    assert r.returncode == 0, r.stderr[-2000:]
    resumed = (tmp_path / "out" / "Results_2.500000" / "snapshot_4.xyz").read_text()

    path.write_text(text.replace(f"output_dir = {tmp_path / 'out'}",
                                 f"output_dir = {tmp_path / 'ref'}"))
    r = _cli(path, "--max-steps", "4")
    assert r.returncode == 0, r.stderr[-2000:]
    assert (tmp_path / "ref" / "Results_2.500000" / "snapshot_4.xyz").read_text() == resumed
