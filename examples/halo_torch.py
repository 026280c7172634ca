#!/usr/bin/env python
"""One structure over several ranks with the PyTorch port's halo
decomposition (devicekmc_tpu_torch.parallel.halo_superstep): the sites are
split into x-slabs, one a rank, and neighbour reads across a slab's edge go
through halo exchanges with the adjacent ranks.  Each rank drives one card
(NCCL), or with --device cpu one CPU process (gloo).

Usage:
    torchrun --nproc-per-node K examples/halo_torch.py [--steps 8] [--vd 4.0]
                                                      [--device cuda | cpu] [--current]
    python examples/halo_torch.py --device cpu       # a world of one rank

Rank 0 writes output.txt and the snapshots under --out and prints the run's
events, the halo width beside the slab and the collectives a superstep.
``--current`` adds the blocked transport and global Joule heating (each rank
stores its rows of the metal block; the CG vectors are whole on every rank)
and prints the current and the temperature.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--vd", type=float, default=4.0)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL, a card a rank) or cpu (gloo)")
    ap.add_argument("--out", default="halo_torch_out")
    ap.add_argument("--current", action="store_true",
                    help="blocked transport and global heat (transport='blocked')")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.parallel import make_mesh, multihost
    from devicekmc_tpu_torch.structure import make_test_structure

    multihost.initialize(device=args.device)       # no-op outside torchrun
    mesh = make_mesh(device=args.device)
    s = make_test_structure(nx_contact=2, nx_oxide=60, ny=4, nz=4, seed=5)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0, pbc=False,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, perturb_structure=True, pristine=True,
        initial_vacancy_concentration=0.15, V_switch=[args.vd], t_switch=[1e30],
        output_dir=args.out, log_freq=1000,
    )
    if args.current:
        cfg.solve_current, cfg.transport = True, "blocked"
        cfg.solve_heating_global, cfg.A = True, 6.25e-19
    if mesh.rank == 0:
        os.makedirs(args.out, exist_ok=True)
    sim = Simulation(cfg, elements=s.elements, coords=s.coords, mesh=mesh,
                     decomposition="halo")
    mesh.comm.reset_counts()
    sim.run_bias_point(args.vd, 1e30, max_steps=args.steps)
    counts = dict(mesh.comm.counts)
    if multihost.is_coordinator():
        steps = len(sim.step_log)
        print(f"{mesh.world} rank(s) on {mesh.device.type}: {sim.geom.N_real} sites "
              f"({sim.geom.N} padded), slab {sim.geom.N // mesh.world}, halo width "
              f"{sim._halo_width}")
        print(f"{steps} supersteps at Vd = {args.vd} V: events "
              f"{[int(r['n_events']) for r in sim.step_log]}, KMC time "
              f"{sim.state.kmc_time:.6g} s")
        if args.current:
            print(f"current {[round(r['Current [uA]'], 9) for r in sim.step_log]} uA, "
                  f"transport CG iterations {[int(r['cg_iters_power']) for r in sim.step_log]}, "
                  f"T_bg {sim.state.T_bg:.9f} K")
        print("collectives a superstep (cold solve and snapshots included): "
              + ", ".join(f"{k} {v / steps:.1f}" for k, v in sorted(counts.items())))
    dist.destroy_process_group()
    return sim


if __name__ == "__main__":
    main()
