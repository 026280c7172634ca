#!/usr/bin/env python
"""Full I-V forming sweep on a synthetic TiN/HfO2/TiN stack with coupled
thermal feedback, with the PyTorch port: the counterpart of
examples/iv_sweep.py (the reference's headline use case; reference driver
src/kmc_main.cpp with the parameters.txt V_switch ramp), with --device in
place of --cpu.

Produces output.txt + Results_<Vd>/ snapshots + iv.png.

Usage: python examples/iv_sweep_torch.py [--outdir OUT] [--points 8] [--vmax 6]
       [--steps-per-bias 10] [--device cuda | cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="iv_out")
    ap.add_argument("--points", type=int, default=8)
    ap.add_argument("--vmax", type=float, default=6.0)
    ap.add_argument("--steps-per-bias", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="the card (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=3, nx_oxide=10, ny=5, nz=5, seed=2)
    ramp = list(np.linspace(0.0, args.vmax, args.points))
    cfg = KMCConfig(
        lattice=list(s.lattice),
        nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact,
        layers=s.layers,
        solve_potential=True,
        solve_current=True,
        solve_heating_global=True,
        perturb_structure=True,
        pristine=True,
        initial_vacancy_concentration=0.05,
        A=float(s.lattice[1] * s.lattice[2]) * 1e-20,
        V_switch=ramp,
        t_switch=[1e-12] * len(ramp),
        Icc=1e4,
        log_freq=5,
        output_dir=args.outdir,
    )
    os.makedirs(args.outdir, exist_ok=True)
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, device=args.device)
    sim.run(max_steps_per_bias=args.steps_per_bias)

    import matplotlib

    matplotlib.use("Agg")
    from devicekmc_tpu_torch.postprocessing.plots import plot_iv

    v, i = plot_iv(
        os.path.join(args.outdir, "output.txt"),
        os.path.join(args.outdir, "iv.png"),
    )
    print("V:", np.round(v, 3).tolist())
    print("I [uA]:", [f"{x:.3g}" for x in i])
    return v, i


if __name__ == "__main__":
    main()
