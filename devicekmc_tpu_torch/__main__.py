"""Command-line entry point: the equivalent of the reference's
``./bin/runKMC parameters.txt`` (src/kmc_main.cpp:26): charge, boundary
potential, gridless Poisson, KMC events, with ``solve_current = 1`` the
charge transport (``transport = blocked`` or ``dense``,
``transport_bf16_inner = 1`` for the bf16 inner operator, which at crossbar
width needs ``transport_tol`` of 1e-6 or looser) and with
``solve_heating_global = 1`` or ``solve_heating_local = 1`` (``heat_solver =
dense`` or ``cg``) the dissipated power and the temperature; ``batch_steps >
1`` runs the supersteps in batches.

    python -m devicekmc_tpu_torch parameters.txt [--cpu] [--max-steps N]
        [--modular] [--resume CK] [--checkpoint CK]
        [--checkpoint-backend npz | dcp | dcp_async]

``--modular`` runs the superstep phase by phase with the reference's
per-module timing keys (and, with ``solver_chunk_iters > 0``, the
in-superstep re-solves in bounded segments); ``--resume`` loads a full-state
checkpoint (an npz of this package or of the JAX package, or a dcp
directory of this package) before the run and ``--checkpoint`` writes one
after it and waits for its write (npz for a ``*.npz`` path, else a
``torch.distributed.checkpoint`` directory; ``--checkpoint-backend``
chooses).  Runs on the CUDA card unless ``--cpu`` is given.
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
    ap.add_argument("--modular", action="store_true",
                    help="per-phase timing (reference-style module timers)")
    ap.add_argument("--checkpoint", default="",
                    help="write a full-state checkpoint here at the end")
    ap.add_argument("--checkpoint-backend", default=None,
                    choices=["npz", "dcp", "dcp_async"],
                    help="checkpoint format (default: npz for *.npz, else dcp)")
    ap.add_argument("--resume", default="",
                    help="load a full-state checkpoint before running")
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
        sim = Simulation(cfg, device=device, fused=not args.modular)
    except FileNotFoundError as e:
        print(e)
        return 1
    print(
        f"Loaded {sim.geom.N} sites into device : "
        f"{sim.geom.N_atom} atoms and "
        f"{sim.geom.N - sim.geom.N_atom} interstitials"
    )
    if args.resume:
        sim.load_checkpoint(args.resume)
    sim.run(max_steps_per_bias=args.max_steps)
    if args.checkpoint:
        sim.save_checkpoint(args.checkpoint, backend=args.checkpoint_backend)
        sim.wait_for_checkpoint()
    print(f"Done. Output in {sim.output_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
