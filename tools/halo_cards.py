#!/usr/bin/env python3
"""The halo decomposition of chip_smoke.py's crossbar over K ranks, one card
(or one CPU process) a rank, and the comparison of two such runs.

    torchrun --nproc-per-node K tools/halo_cards.py --out DIR [--device cuda | cpu]
                                                    [--sites 110000] [--steps 3]
                                                    [--current | --replicate]
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
    multihost.initialize(device=args.device)
    mesh = make_mesh(device=args.device)
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
        summary["checkpoint"] = {dec: checkpoint(args, mesh, dec)
                                 for dec in ("replicate", "halo")}
    if rank0:
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
    dist.destroy_process_group()


def checkpoint(args, mesh, decomposition):
    """Save and load under the mesh: run A takes CKPT_STEPS supersteps and
    saves, CKPT_STEPS more and saves again to the same path; run B, made
    before either save, loads the file on every rank as soon as the second
    save returns.  B's position must be the second save's and its
    RESUME_FIELDS (a rank's slab under halo) A's bit for bit; then both run
    CKPT_STEPS more and must still agree.  A load that did not wait for the
    write would find no file, a torn one or the first save.  Returns whether
    every rank agreed at each check, and rank 0's save and load seconds."""
    import numpy as np
    import torch

    import chip_smoke as cs

    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    path = os.path.join(args.out, f"ckpt_{decomposition}.npz")
    a, b = (cs.synthetic_crossbar(args.sites, args.device,
                                  os.path.join(args.out, f"ckpt_{decomposition}_{t}"),
                                  mesh=mesh, decomposition=decomposition) for t in "ab")
    C = cs.CKPT_STEPS
    a.run_bias_point(cs.VD_MAIN, 1e30, max_steps=C)
    a.save_checkpoint(path)
    a.run_bias_point(cs.VD_MAIN, 1e30, max_steps=2 * C, resume_step=C)
    sync()
    t0 = time.perf_counter()
    a.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    b.load_checkpoint(path)
    sync()
    load_s = time.perf_counter() - t0 - save_s

    def same(ok=True):
        fa, fb = cs.state_fields(a), cs.state_fields(b)
        ok = ok and all(np.array_equal(fa[f], fb[f]) for f in cs.RESUME_FIELDS)
        return bool(mesh.comm.all_reduce(torch.tensor([float(ok)], device=mesh.device),
                                          op="min").item())

    loaded = same(b._pos == (0, 2 * C))
    for sim in (a, b):
        sim.run_bias_point(cs.VD_MAIN, 1e30, max_steps=3 * C, resume_step=2 * C)
    resumed = same()
    return dict(loaded_equal=loaded, resumed_equal=resumed, save_s=save_s, load_s=load_s,
                events=[int(r["n_events"]) for r in a.step_log])


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
    ap.add_argument("--compare", nargs=2, metavar="DIR")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
    else:
        run(args)


if __name__ == "__main__":
    main()
