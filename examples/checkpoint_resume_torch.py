#!/usr/bin/env python
"""Checkpoint / resume demo with the PyTorch port: interrupt a bias sweep
mid-bias-point and resume it bit-exactly in a fresh Simulation.  The
counterpart of examples/checkpoint_resume.py, with --device in place of
--cpu and --dcp in place of --orbax: the checkpoint is an npz file in the
JAX package's layout, which either package reads, or with --dcp a
torch.distributed.checkpoint directory (the counterpart of orbax's).

The checkpoint carries the full simulation state (elements, charges,
fields, RNG key, KMC clock, solver warm starts) plus the driver position
(bias index / step) and any compaction caps the driver grew, so the resumed
trajectory is identical to an uninterrupted run
(tests/test_torch_checkpoint.py).

Usage: python examples/checkpoint_resume_torch.py [--outdir OUT] [--dcp]
                                                 [--device cuda | cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="/tmp/dkmc_ckpt_demo_torch")
    ap.add_argument("--dcp", action="store_true",
                    help="a torch.distributed.checkpoint directory instead of npz")
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.structure import make_test_structure

    os.makedirs(args.outdir, exist_ok=True)
    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=7)

    def mk(sub):
        d = os.path.join(args.outdir, sub)
        os.makedirs(d, exist_ok=True)
        return KMCConfig(
            lattice=list(s.lattice), nn_dist=3.0,
            num_atoms_first_layer=s.num_atoms_first_layer,
            num_layers_contact=s.num_layers_contact,
            num_atoms_contact=s.num_atoms_contact, layers=s.layers,
            solve_potential=True, solve_current=True,
            solve_heating_global=True, perturb_structure=True,
            pristine=True, initial_vacancy_concentration=0.1,
            A=1e-18, V_switch=[2.0, 2.2], t_switch=[1e30, 1e30],
            output_dir=d,
        )

    def sim_of(sub):
        return Simulation(mk(sub), elements=s.elements, coords=s.coords, device=args.device)

    ckpt = os.path.join(args.outdir, "mid_bias" if args.dcp else "mid_bias.npz")
    backend = "dcp" if args.dcp else "npz"

    # ---- phase 1: run 1 step of bias 0 and 2 steps of bias 1, checkpoint
    sim = sim_of("first")
    sim.run_bias_point(2.0, 1e30, max_steps=1)
    sim._pos = (1, 0)
    sim.run_bias_point(2.2, 1e30, max_steps=2)
    sim.save_checkpoint(ckpt, backend=backend)
    print(f"checkpointed at bias index {sim._pos[0]}, step {sim._pos[1]} "
          f"-> {ckpt} ({backend})")

    # ---- phase 2: FRESH simulation, resume and finish bias 1
    sim2 = sim_of("resumed")
    sim2.load_checkpoint(ckpt, backend=backend)
    print(f"resumed at bias index {sim2._pos[0]}, step {sim2._pos[1]}")
    sim2.run_bias_point(2.2, 1e30, max_steps=4, resume_step=sim2._pos[1])

    # ---- uninterrupted control run for comparison
    sim3 = sim_of("control")
    sim3.run_bias_point(2.0, 1e30, max_steps=1)
    sim3._pos = (1, 0)
    sim3.run_bias_point(2.2, 1e30, max_steps=4)

    same = torch.equal(sim2.state.element, sim3.state.element) and \
        np.array_equal(np.asarray(sim2.state.key), np.asarray(sim3.state.key))
    print("resumed trajectory bit-equal to uninterrupted run:", same)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
