#!/usr/bin/env python3
"""Where the time of the port's batched superstep (device ensembles) goes on
one CUDA card.

    python3 tools/profile_torch_ensemble.py [--batch 8] [--sites 110000] [--steps 6]

Builds the headline configuration of chip_smoke.py (synthetic crossbar,
mixed precision, the CUDA kernels, Vd = 1 V), runs the cold deflated
boundary solve once on the single state, makes ``--batch`` replicas of it
(``parallel.batched.batch_states``, base seed 42, chip_smoke.py's ensemble
phase) and runs two warm-up batched supersteps, then:

1. host-clock phase breakdown over ``--steps`` batched supersteps, with a
   device synchronize after each phase: charge rule, boundary solve (with
   its incremental residual of the changed rows), Poisson, rate table, the rest of
   the events phase (the tables' sums and the event loop: the events phase
   minus a separate rate-table build of the same states), and the most
   device memory allocated in each phase (for sums_and_loop: in the whole
   events phase);
2. torch.profiler over ``--steps`` further supersteps: device time by
   kernel, the device's busy share of the wall time, and the device-to-host
   copies a superstep.

Prints plain text; the card's name and power limit come first.
"""

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--sites", type=int, default=110_000)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import ENSEMBLE_SEED, VD_MAIN, gpu_line, synthetic_crossbar
    from devicekmc_tpu_torch.ops import _build, cg
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.physics import charge, events, potential
    from devicekmc_tpu_torch.state import replace

    print(gpu_line(), flush=True)
    _build.build(["ell_gather", "pairwise", "kmc_events"])
    sim = synthetic_crossbar(args.sites, "cuda",
                             os.path.join(ROOT, "build", "profile_ensemble"))
    geom, params, Vd = sim.geom, sim.params, VD_MAIN
    sim._chunked_boundary(Vd, params.solver_maxiter,
                          replace(params, boundary_precond="deflated"))
    step = make_batched_superstep(geom, params, sim.heat)
    states = batch_states(sim.state, args.batch, base_seed=ENSEMBLE_SEED)
    for _ in range(2):
        states, _, m = step(states, Vd)
    print(f"N={geom.N} max_nn={geom.max_nn} B={args.batch}; warm-up done, events "
          f"{m['n_events'].tolist()}")

    peaks = []      # GiB allocated at most since the previous sync

    def sync():
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter()

    phases = {k: [] for k in ("charge", "boundary", "poisson", "rate_table",
                              "sums_and_loop", "superstep")}
    peak = dict.fromkeys(phases, 0.0)
    cg.readbacks = 0
    iters = []
    for _ in range(args.steps):
        t0 = sync()
        states, _ = charge.update_charge_batched(geom, params, states)
        t1 = sync()
        states, mb = potential.solve_boundary_potential_batched(geom, params, states, Vd)
        t2 = sync()
        states, _ = potential.poisson_gridless_compact_batched(
            geom, params, states, cap=params.poisson_compact_cap)
        t3 = sync()
        events.build_rate_table(geom, params, states)
        t4 = sync()
        res = events.execute_superstep_incremental_batched(geom, params, states)
        t5 = sync()
        states = res.state
        iters.append(mb["cg_iters_boundary"].tolist())
        phases["charge"].append(t1 - t0)
        phases["boundary"].append(t2 - t1)
        phases["poisson"].append(t3 - t2)
        phases["rate_table"].append(t4 - t3)
        phases["sums_and_loop"].append((t5 - t4) - (t4 - t3))
        phases["superstep"].append((t3 - t0) + (t5 - t4))
        for k, v in zip(("charge", "boundary", "poisson", "rate_table", "sums_and_loop"),
                        peaks[-5:]):
            peak[k] = max(peak[k], v)
    peak["superstep"] = max(peak.values())
    print(f"host-clock phases over {args.steps} batched supersteps (cg_iters_boundary "
          f"{iters}), median ms and the most device memory allocated in the phase:")
    for k, v in phases.items():
        print(f"  {k:<13} {statistics.median(v) * 1e3:9.3f}   "
              f"(min {min(v) * 1e3:.3f}, max {max(v) * 1e3:.3f})   peak {peak[k]:.3f} GiB")
    print(f"  CG read-backs {cg.readbacks}")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = sync()
        for _ in range(args.steps):
            states, _, _ = step(states, Vd)
        t1 = sync()
    wall_us = (t1 - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels)
    print(f"profiler: {args.steps} batched supersteps in {wall_us / 1e3:.3f} ms wall; "
          f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.2f} % "
          f"(idle {100 - 100 * busy / wall_us:.2f} %)")
    if busy == 0:
        print("profiler recorded no device time: busy share not measured")
    dtoh = sum(e.count for e in kernels if e.key.startswith("Memcpy DtoH"))
    print(f"device-to-host copies: {dtoh} ({dtoh / args.steps:.1f} a superstep)")
    print("device time by kernel (top 20): total ms, calls, name")
    for e in sorted(kernels, key=dev_us, reverse=True)[:20]:
        print(f"  {dev_us(e) / 1e3:9.3f} {e.count:7d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
