#!/usr/bin/env python3
"""The halo decomposition of chip_smoke.py's crossbar over K ranks, one card
(or one CPU process) a rank, and the comparison of two such runs.

    torchrun --nproc-per-node K tools/halo_cards.py --out DIR [--device cuda | cpu]
                                                    [--sites 110000] [--steps 3]
                                                    [--current | --replicate | --mesh2d]
    python3 tools/halo_cards.py --compare DIR_A DIR_B

A run builds the crossbar of ``chip_smoke.synthetic_crossbar`` over the
halo decomposition (``Simulation(mesh=make_mesh(), decomposition="halo")``)
in the two configurations of chip_smoke.py's phase 12 (f64 at solver_tol
1e-12, and mixed precision), runs the cold pre-solve and ``--steps``
supersteps at Vd = 1 V, and rank 0 writes to DIR, for each configuration,
the whole structure's elements, charges and boundary potential after every
superstep (``<config>.npz``) and a summary (``summary.json``: the world
size, the card's name and power limit, ms a superstep, the ms of its four
phases, the collectives a superstep by kind, events, boundary CG
iterations, the cold pre-solve, the halo width and the slab).  ``--compare``
prints, for each configuration, whether the two runs' events, elements and
charges are equal step for step, and how far apart their potentials and KMC
clocks are.

``--current`` runs phase 12's transport configurations instead (the
transport settings of PERF.md §4 with global heat, f64 at solver and
transport tolerance 1e-12 and mixed precision: chip_smoke.py's
``HALO_TRANSPORT``), and the summary adds each superstep's current, power,
transport CG iterations (every rank's: they must be equal) and the ms of
the transport and heat phases; ``--compare`` then also prints the two runs'
currents and how far apart they are.

``--replicate`` runs chip_smoke.py's phase 13 instead: the replicated
decomposition (``Simulation(mesh=make_mesh())``, its default) in the
configurations of ``REPLICATE_RUNS`` (the headline in f64 at solver_tol
1e-12 and in mixed precision, the transport configuration with global
heat), the summary with the ms of its six phases (``REPLICATE_PHASES``) and
each run's current; ``--compare`` prints the phase medians of both runs.
Then a checkpoint under the mesh in both decompositions (``checkpoint``):
every rank holds the state bit for bit as it was saved when it loads the
file right after the save returns, and again after CKPT_STEPS more
supersteps.

``--mesh2d`` runs MESH2D_BATCH replicas of the crossbar's headline (after
the cold boundary solve, keys of chip_smoke.ENSEMBLE_SEED) for ``--steps``
supersteps: over K > 1 ranks on a (2, K / 2) ``("batch", "sites")`` mesh
(``make_batched_superstep`` on ``shard_simulation``'s geometry), at K = 1
each replica alone through the single device's eager superstep; rank 0
writes every replica's elements, charges and boundary potential after every
superstep, and ``--compare`` prints whether the events, elements and
charges of every replica are equal step for step.  Then the checkpoints of
``checkpoint`` in each backend (npz, dcp, dcp_async) under both
decompositions over a 1-D mesh of the K ranks.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the two configurations of chip_smoke.py's phase 12
CONFIGS = {"f64": dict(precision="f64", poisson_kernel="jnp", solver_tol=1e-12), "mixed": {}}
#: the replicas of the --mesh2d run
MESH2D_BATCH = 4
#: the checkpoint backends of --mesh2d (--replicate: npz)
BACKENDS = ("npz", "dcp", "dcp_async")


def run(args):
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from devicekmc_tpu_torch.parallel import halo_superstep as hs
    from devicekmc_tpu_torch.parallel import make_mesh, multihost
    from devicekmc_tpu_torch.parallel import sharding as shd

    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    multihost.initialize(device=args.device)
    mesh = make_mesh(device=args.device)
    if args.mesh2d:
        return mesh2d(args, mesh)
    rank0 = mesh.rank == 0
    summary = {"world": mesh.world, "card": cs.gpu_line() if cuda else "cpu",
               "current": args.current}
    if rank0:
        os.makedirs(args.out, exist_ok=True)
    mode = "replicate" if args.replicate else "current" if args.current else "halo"
    summary["mode"] = mode
    phases, module = ((cs.REPLICATE_PHASES, shd) if args.replicate else
                      (cs.HALO_TRANSPORT_PHASES if args.current else cs.HALO_PHASES, hs))
    for tag, over in configs(mode).items():
        sim, steps = cs.halo_sim(os.path.join(args.out, f"run_{tag}"), tag, mesh, args.device,
                                 args.sites, decomposition="replicate" if args.replicate
                                 else "halo", **over)
        timed = {name: cs._counted(module, name, sync) for name in phases}
        try:
            t = time.perf_counter()
            sim.run_bias_point(cs.VD_MAIN, 1e30, max_steps=args.steps)
            sync()
            wall = time.perf_counter() - t
        finally:
            for _, undo in timed.values():
                undo()
        ms = [s["ms"] for s in steps]
        summary[tag] = dict(
            ms=[round(x, 3) for x in ms], ms_median=statistics.median(ms),
            phase_ms={phases[name]: [round(x, 3) for x in rec["ms"][-args.steps:]]
                      for name, (rec, _) in timed.items() if rec["ms"]},
            collectives=[s["counts"] for s in steps], events=[s["events"] for s in steps],
            cg=[s["cg"] for s in steps], presolve=sim.presolve_log[0], wall_s=wall,
            kmc_time=sim.state.kmc_time, halo_width=getattr(sim, "_halo_width", None),
            slab=sim.geom.N // mesh.world, N=sim.geom.N, N_real=sim.geom.N_real)
        if args.replicate:
            summary[tag].update(I_macro=sim.state.I_macro, T_bg=sim.state.T_bg)
        if args.current:
            m = [s["metrics"] for s in steps]
            cg = torch.tensor([int(x["cg_iters_power"]) for x in m], device=mesh.device)
            summary[tag].update(
                current_uA=[x["Current [uA]"] for x in m],
                power_mW=[x["Total dissipated power [mW]"] for x in m],
                converged=[x["transport_converged"] for x in m],
                cg_power_ranks=mesh.comm.all_gather(cg[None]).tolist(),
                I_macro=sim.state.I_macro, P_tot=sim.state.P_tot, T_bg=sim.state.T_bg)
        if rank0:
            np.savez(os.path.join(args.out, f"{tag}.npz"),
                     **{f"{f}_{k}": s[f].numpy() for k, s in enumerate(steps)
                        for f in ("element", "charge", "pb")})
        del sim
    if args.replicate:
        summary["checkpoint"] = {dec: checkpoint(args, mesh, dec, ("npz",))
                                 for dec in ("replicate", "halo")}
    if rank0:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
    dist.destroy_process_group()


def checkpoint(args, mesh, decomposition, backends):
    """Save and load under the mesh, for each of ``backends`` in turn: run A
    takes CKPT_STEPS supersteps and saves; run B, made before any save,
    loads the checkpoint on every rank as soon as the save returns (for
    dcp_async: as soon as A's wait returns, after A took CKPT_STEPS more
    supersteps while the directory was written).  B's position must be the
    save's and its RESUME_FIELDS (a rank's slab under halo) A's at the save
    bit for bit; then both run CKPT_STEPS more and must agree again.  A
    load that did not wait for the write would find no checkpoint, a torn
    one or an older one.  Returns, by backend, whether every rank agreed at
    each check, and rank 0's save, wait and load seconds."""
    import numpy as np
    import torch

    import chip_smoke as cs

    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    a, b = (cs.synthetic_crossbar(args.sites, args.device,
                                  os.path.join(args.out, f"ckpt_{decomposition}_{t}"),
                                  mesh=mesh, decomposition=decomposition) for t in "ab")
    C = cs.CKPT_STEPS

    def same(fa, ok=True):
        fb = cs.state_fields(b)
        ok = ok and all(np.array_equal(fa[f], fb[f]) for f in cs.RESUME_FIELDS)
        return bool(mesh.comm.all_reduce(torch.tensor([float(ok)], device=mesh.device),
                                          op="min").item())

    a.run_bias_point(cs.VD_MAIN, 1e30, max_steps=C)
    out = {}
    for backend in backends:
        k = a._pos[1]
        path = os.path.join(args.out, f"ckpt_{decomposition}" +
                            (".npz" if backend == "npz" else f"_{backend}"))
        sync()
        t0 = time.perf_counter()
        a.save_checkpoint(path, backend=backend)
        save_s = time.perf_counter() - t0
        at_save = cs.state_fields(a)
        wait_s = 0.0
        if backend == "dcp_async":
            a.run_bias_point(cs.VD_MAIN, 1e30, max_steps=k + C, resume_step=k)
            t0 = time.perf_counter()
            a.wait_for_checkpoint()
            wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        b.load_checkpoint(path, backend=backend)
        sync()
        load_s = time.perf_counter() - t0
        loaded = same(at_save, b._pos == (0, k))
        b.run_bias_point(cs.VD_MAIN, 1e30, max_steps=k + C, resume_step=k)
        if backend != "dcp_async":
            a.run_bias_point(cs.VD_MAIN, 1e30, max_steps=k + C, resume_step=k)
        out[backend] = dict(loaded_equal=loaded, resumed_equal=same(cs.state_fields(a)),
                            save_s=save_s, wait_s=wait_s, load_s=load_s, step=k)
    out["events"] = [int(r["n_events"]) for r in a.step_log]
    return out


def mesh2d(args, mesh):
    """The --mesh2d run (the module's docstring); ``mesh``: the 1-D mesh of
    the K ranks, for the checkpoints."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.parallel import make_mesh
    from devicekmc_tpu_torch.parallel.batched import (batch_states, gather_batch,
                                                      make_batched_superstep, shard_batch)
    from devicekmc_tpu_torch.parallel.sharding import shard_simulation
    from devicekmc_tpu_torch.state import replace, stack_states, unbatch_all

    cuda = args.device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    world, rank0 = mesh.world, mesh.rank == 0
    sim = cs.synthetic_crossbar(args.sites, args.device,
                                os.path.join(args.out, f"mesh2d_{mesh.rank}"))
    sim._chunked_boundary(cs.VD_MAIN, sim.params.solver_maxiter,
                          replace(sim.params, boundary_precond="deflated"))
    geom, params, nr = sim.geom, sim.params, sim.geom.N_real
    states0 = batch_states(sim.state, MESH2D_BATCH, base_seed=cs.ENSEMBLE_SEED)
    summary = {"world": world, "card": cs.gpu_line() if cuda else "cpu", "mode": "mesh2d",
               "replicas": MESH2D_BATCH}
    steps, ms = [], []
    if world == 1:
        eager = engine.make_superstep(geom, params, sim.heat)
        singles = unbatch_all(states0)
        step = None
        summary["shape"] = None
    else:
        shape = (2, world // 2)
        m2 = make_mesh(world, device=args.device, axis_names=("batch", "sites"), shape=shape)
        g2, _ = shard_simulation(geom, sim.state, m2)
        step = make_batched_superstep(g2, params, sim.heat, mesh=m2)
        states = shard_batch(states0, m2)
        summary["shape"] = list(shape)
    for _ in range(args.steps):
        sync()
        t = time.perf_counter()
        if step is None:
            outs = [eager(st, cs.VD_MAIN) for st in singles]
            singles = [o[0] for o in outs]
            whole = stack_states(singles)
            events = [int(o[2]["n_events"]) for o in outs]
        else:
            states, _, m = step(states, cs.VD_MAIN)
            whole = gather_batch(states, m2)
            events = [int(x) for x in m2.axis("batch").comm.all_gather(
                m["n_events"]).tolist()]
        sync()
        ms.append((time.perf_counter() - t) * 1e3)
        steps.append(dict(events=events, element=whole.element[:, :nr].cpu().numpy(),
                          charge=whole.charge[:, :nr].cpu().numpy(),
                          pb=whole.potential_boundary[:, :nr].double().cpu().numpy()))
    summary["mesh2d"] = dict(events=[s["events"] for s in steps], ms=[round(x, 3) for x in ms])
    summary["checkpoint"] = {dec: checkpoint(args, mesh, dec, BACKENDS)
                             for dec in ("replicate", "halo")}
    if rank0:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, "mesh2d.npz"),
                 **{f"{f}_{k}": s[f] for k, s in enumerate(steps)
                    for f in ("element", "charge", "pb")})
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
    dist.destroy_process_group()


def compare_mesh2d(a_dir, b_dir, sa, sb):
    """--compare of two --mesh2d runs: per replica, events, elements and
    charges equal step for step; the boundary potentials' largest distance
    over their scale; the checkpoints of both."""
    import numpy as np

    a, b = (np.load(os.path.join(d, "mesh2d.npz")) for d in (a_dir, b_dir))
    n = len(sa["mesh2d"]["events"])
    equal = [[sa["mesh2d"]["events"][k][r] == sb["mesh2d"]["events"][k][r]
              and np.array_equal(a[f"element_{k}"][r], b[f"element_{k}"][r])
              and np.array_equal(a[f"charge_{k}"][r], b[f"charge_{k}"][r])
              for r in range(sa["replicas"])] for k in range(n)]
    pb = max(float(np.abs(a[f"pb_{k}"] - b[f"pb_{k}"]).max() / np.abs(a[f"pb_{k}"]).max())
             for k in range(n))
    out = dict(worlds=(sa["world"], sb["world"]), shapes=(sa["shape"], sb["shape"]),
               steps_equal=equal, potential_boundary_err=pb,
               events=(sa["mesh2d"]["events"], sb["mesh2d"]["events"]),
               ms=(sa["mesh2d"]["ms"], sb["mesh2d"]["ms"]),
               checkpoint=[x["checkpoint"] for x in (sa, sb)])
    print(json.dumps(out), flush=True)
    return out


def configs(mode):
    """The configurations of a run (their chip_smoke.halo_sim overrides):
    phase 12's halo runs ("halo"), its transport runs ("current"), or phase
    13's replicated runs ("replicate")."""
    import chip_smoke as cs

    if mode == "replicate":
        return cs.REPLICATE_RUNS
    if mode == "halo":
        return CONFIGS
    return {tag: dict(cs.HALO_TRANSPORT_COMMON, **over) for tag, over in cs.HALO_TRANSPORT.items()}


def compare(a_dir, b_dir):
    import numpy as np

    sa, sb = (json.load(open(os.path.join(d, "summary.json"))) for d in (a_dir, b_dir))
    out = {}
    mode = sa.get("mode", "current" if sa.get("current") else "halo")
    if mode == "mesh2d":
        return compare_mesh2d(a_dir, b_dir, sa, sb)
    for tag in configs(mode):
        a, b = (np.load(os.path.join(d, f"{tag}.npz")) for d in (a_dir, b_dir))
        n = len(sa[tag]["events"])
        equal = [sa[tag]["events"][k] == sb[tag]["events"][k]
                 and np.array_equal(a[f"element_{k}"], b[f"element_{k}"])
                 and np.array_equal(a[f"charge_{k}"], b[f"charge_{k}"]) for k in range(n)]
        pb = max(float(np.abs(a[f"pb_{k}"] - b[f"pb_{k}"]).max() / np.abs(a[f"pb_{k}"]).max())
                 for k in range(n))
        kmc = abs(sa[tag]["kmc_time"] - sb[tag]["kmc_time"]) / abs(sa[tag]["kmc_time"])
        out[tag] = dict(worlds=(sa["world"], sb["world"]), steps_equal=equal,
                        potential_boundary_err=pb, kmc_time_rel_err=kmc,
                        ms_median=(sa[tag]["ms_median"], sb[tag]["ms_median"]))
        if mode == "replicate":
            I_a, I_b = sa[tag]["I_macro"], sb[tag]["I_macro"]
            out[tag].update(
                I_macro=(I_a, I_b), I_macro_rel=abs(I_a - I_b) / max(abs(I_b), 1e-300),
                phase_ms_median=[{k: statistics.median(v) for k, v in x[tag]["phase_ms"].items()}
                                 for x in (sa, sb)])
        if sa.get("current"):
            I_a, I_b = sa[tag]["I_macro"], sb[tag]["I_macro"]
            out[tag].update(
                I_macro=(I_a, I_b), I_macro_rel=abs(I_a - I_b) / abs(I_b),
                cg_power=(sa[tag]["cg_power_ranks"][0], sb[tag]["cg_power_ranks"][0]),
                cg_equal_across_ranks=[len({tuple(r) for r in x[tag]["cg_power_ranks"]}) == 1
                                       for x in (sa, sb)],
                converged=[all(x[tag]["converged"]) for x in (sa, sb)],
                phase_ms_median=[{k: statistics.median(v) for k, v in x[tag]["phase_ms"].items()}
                                 for x in (sa, sb)])
    if mode == "replicate":
        out["checkpoint"] = [x.get("checkpoint") for x in (sa, sb)]
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "halo_cards"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sites", type=int, default=110_000)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--current", action="store_true",
                    help="the transport runs (chip_smoke.HALO_TRANSPORT)")
    ap.add_argument("--replicate", action="store_true",
                    help="the replicated decomposition's runs (chip_smoke.REPLICATE_RUNS)")
    ap.add_argument("--mesh2d", action="store_true",
                    help="replicas over a (2, K/2) ('batch', 'sites') mesh (K = 1: the single "
                         "device), then checkpoints in every backend")
    ap.add_argument("--compare", nargs=2, metavar="DIR")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
