"""Command-line entry point: the equivalent of the reference's
``./bin/runKMC parameters.txt`` (src/kmc_main.cpp:26) for the ported module
set: charge, boundary potential, gridless Poisson, KMC events, with
``solve_current = 1`` the charge transport (``transport = blocked`` or
``dense``) and with ``solve_heating_global = 1`` or ``solve_heating_local =
1`` (``heat_solver = dense`` or ``cg``) the dissipated power and the
temperature; ``batch_steps > 1`` runs the supersteps in batches.
``transport_bf16_inner = 1`` raises NotImplementedError.

    python -m devicekmc_tpu_torch parameters.txt [--cpu] [--max-steps N]

Runs on the CUDA card unless ``--cpu`` is given.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="devicekmc_tpu_torch",
        description="kinetic Monte Carlo for VCM RRAM devices (PyTorch / CUDA)",
    )
    ap.add_argument("parameters", help="parameters.txt (reference-compatible)")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="cap KMC supersteps per bias point")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    import torch

    from .config import parse_parameters
    from .engine import Simulation

    device = "cpu" if args.cpu else "cuda"
    cfg = parse_parameters(args.parameters)
    name = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    print(f"Device: {device} ({name})")
    print("Constructing device...")
    try:
        sim = Simulation(cfg, device=device)
    except FileNotFoundError as e:
        print(e)
        return 1
    print(
        f"Loaded {sim.geom.N} sites into device : "
        f"{sim.geom.N_atom} atoms and "
        f"{sim.geom.N - sim.geom.N_atom} interstitials"
    )
    sim.run(max_steps_per_bias=args.max_steps)
    print(f"Done. Output in {sim.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
