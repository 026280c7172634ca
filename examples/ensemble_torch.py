#!/usr/bin/env python
"""Device-ensemble statistics with the PyTorch port: B independent device
instances batched through one superstep with a replica axis
(devicekmc_tpu_torch.parallel.batched) on one card, or split over the ranks
of a mesh along "batch" with --mesh N (one device a rank, started by
torchrun), for crossbar-style arrays of nominally identical cells or
device-to-device variability studies.  The counterpart of
examples/ensemble.py, with --device in place of --cpu; rank 0 prints the
whole ensemble, the same numbers as one process.

Usage: python examples/ensemble_torch.py [--batch 8] [--steps 10] [--vd 3.0]
                                         [--device cuda | cpu]
       torchrun --nproc-per-node N examples/ensemble_torch.py --mesh N [...]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--vd", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu; the replicas share it")
    ap.add_argument("--mesh", type=int, default=0,
                    help="split the batch over this many ranks along 'batch' (one device a "
                         "rank: cuda:LOCAL_RANK or a CPU process each)")
    args = ap.parse_args(argv)

    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.device import resolve_device
    from devicekmc_tpu_torch.parallel import (batch_states, gather_batch,
                                              make_batched_superstep, make_mesh, shard_batch)
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.physics.potential import solve_cb_edge
    from devicekmc_tpu_torch.state import (
        build_geometry, build_params, init_state, make_substoichiometric,
    )
    from devicekmc_tpu_torch.structure import make_test_structure

    mesh = None
    if args.mesh:
        mesh = make_mesh(args.mesh, device=args.device, axis_names=("batch",))
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=5)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact,
        layers=s.layers,
        solve_potential=True, solve_current=True, solve_heating_global=True,
        perturb_structure=True, A=1e-18,
    )
    elems = make_substoichiometric(s.elements, 0.05, seed=1)
    geom = build_geometry(elems, s.coords, cfg, device=dev)
    params = build_params(cfg)
    state = init_state(geom, cfg, elems)
    heat = heat_mod.empty_heat_model(params, dev)
    state, _ = solve_cb_edge(geom, params, state, args.vd)

    states = batch_states(state, args.batch, base_seed=42)
    if mesh is not None:
        states = shard_batch(states, mesh)
    step = make_batched_superstep(geom, params, heat, mesh=mesh)
    for k in range(args.steps):
        states, dts, metrics = step(states, args.vd)

    if mesh is not None:
        # the whole ensemble on every rank (collectives), printed by rank 0
        states = gather_batch(states, mesh)
        metrics = {k: mesh.comm.all_gather(v) for k, v in metrics.items()}
        if mesh.rank:
            return states, metrics
    I = states.I_macro.cpu().numpy() * 1e6
    T = states.T_bg.cpu().numpy()
    n_ev = metrics["n_events"].cpu().numpy()
    print(f"ensemble of {args.batch} devices after {args.steps} supersteps "
          f"at Vd={args.vd} V:")
    print(f"  I [uA]: mean {I.mean():.4g}  std {I.std():.3g}  "
          f"range [{I.min():.4g}, {I.max():.4g}]")
    print(f"  T_bg [K]: mean {T.mean():.6g}  std {T.std():.3g}")
    print(f"  events/superstep (last): {n_ev.tolist()}")
    return states, metrics


if __name__ == "__main__":
    main()
