#!/usr/bin/env python3
"""Where the time of the port's superstep goes on one CUDA card.

    python3 tools/profile_torch_superstep.py [--sites 110000] [--steps 6]
                                             [--transport [--ell] [--stored]
                                              [--heat [--local]]]
                                             [--plain KERNEL ...] [--chunks 1,2,4]

Builds the headline configuration of chip_smoke.py (synthetic crossbar,
mixed precision, the CUDA kernels, Vd = 1 V), or with ``--transport`` its
transport configuration (blocked transport, on-the-fly metal block, heating
off; ``--ell`` keeps the ELL gather in the f32 inner matvec instead of the
banded operator, ``--stored`` stores the metal block instead of re-deriving
it; ``--heat`` turns Joule heating on: the global model, or with ``--local``
the matrix-free local model with symmetric contact spans; ``--plain``
runs the plain PyTorch version of the named kernels, ``poisson_pairwise``
or ``wkb_window_block``, where the path calls them: what their last bits do
to the trajectory; ``--chunks`` sets the CG iterations between two reads of
the stop condition, ``ops.cg.CHUNKS``, ``1`` reads every iteration), builds
the kernels, runs the cold pre-solves and two warm-up supersteps (printing
each step's events, CG iterations and current, the wall time of the cold
solves and the warm-up, the CG read-backs and the matvec launches), then:

1. host-clock phase breakdown over ``--steps`` supersteps, with a device
   synchronize after each phase: charge rule, boundary solve, Poisson,
   rate table, event loop (the loop's time is the events phase minus a
   separate rate-table build of the same state); with ``--transport`` also
   the transport phase, split into operator assembly (a separate assembly
   of the same state) and the rest (set-up and CG; with ``--heat`` the
   dissipated-power extraction is timed apart, on the solved potentials),
   with the skipped steps listed apart; with ``--heat`` also the heat phase,
   with the local model's branch, substeps and CG iterations;
2. torch.profiler over ``--steps`` further supersteps: device time by
   kernel, the device's busy share of the wall time, and the device-to-host
   copies (the read-backs) a superstep.

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
    ap.add_argument("--sites", type=int, default=110_000)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--transport", action="store_true",
                    help="profile the transport configuration (solve_current on)")
    ap.add_argument("--ell", action="store_true",
                    help="with --transport: transport_banded off")
    ap.add_argument("--stored", action="store_true",
                    help="with --transport: transport_cc stored")
    ap.add_argument("--heat", action="store_true",
                    help="with --transport: solve_heating_global on")
    ap.add_argument("--local", action="store_true",
                    help="with --heat: the local matrix-free model instead")
    ap.add_argument("--plain", nargs="+", default=[],
                    choices=["poisson_pairwise", "wkb_window_block"],
                    help="run these kernels' plain versions on the path")
    ap.add_argument("--chunks", default=None,
                    help="CG stop-check schedule, e.g. 1,2,4,8 (default: ops.cg.CHUNKS)")
    args = ap.parse_args()
    if (args.heat and not args.transport) or (args.local and not args.heat):
        ap.error("--heat needs --transport, --local needs --heat")

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import VD_MAIN, gpu_line, synthetic_crossbar
    from devicekmc_tpu_torch.physics import charge, current, events, heat, potential

    from devicekmc_tpu_torch.ops import _build, cg, pairwise, wkb_window

    print(gpu_line(), flush=True)
    if args.chunks:
        cg.CHUNKS = tuple(int(c) for c in args.chunks.split(","))
    if "poisson_pairwise" in args.plain:
        potential.poisson_pairwise = pairwise.poisson_pairwise_plain
    if "wkb_window_block" in args.plain:
        current.wkb_window_block = wkb_window.wkb_window_block_plain
    _build.build(["ell_gather", "pairwise", "banded", "wkb_fly", "wkb_window",
                  "kmc_events"])
    overrides = {}
    if args.ell:
        overrides["transport_banded"] = False
    if args.stored:
        overrides["transport_cc"] = "stored"
    sim = synthetic_crossbar(args.sites, "cuda",
                             os.path.join(ROOT, "build", "profile_superstep"),
                             current=args.transport,
                             heat=("local" if args.local else "global") if args.heat
                             else None, **overrides)
    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec

    cg.readbacks = banded_matvec.launches = wkb_fly_matvec.launches = 0
    t0 = time.perf_counter()
    sim.run_bias_point(VD_MAIN, 1e30, max_steps=2)
    torch.cuda.synchronize()
    print(f"CG stop checks every {cg.CHUNKS} iterations: cold solves and 2 warm-up steps in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {cg.readbacks} CG read-backs, "
          f"{banded_matvec.launches} banded and {wkb_fly_matvec.launches} fly matvec launches")
    for pre in sim.presolve_log:
        print(f"cold {pre['phase']} solve: {pre['cg_iters']} CG iterations, "
              f"{pre['s'] * 1e3:.1f} ms")
    for s in sim.step_log:
        print(f"warm-up step {s['step']}: events {int(s['n_events'])}"
              + (f", cg_iters_power {int(s['cg_iters_power'])}, Current "
                 f"{s['Current [uA]']:.9g} uA" if args.transport else ""))
    geom, params, Vd = sim.geom, sim.params, VD_MAIN
    print(f"N={geom.N} max_nn={geom.max_nn} active_rows_cap={params.active_rows_cap} "
          f"poisson_cap={params.poisson_compact_cap}")

    def sync():
        torch.cuda.synchronize()
        return time.perf_counter()

    phases = {k: [] for k in ("charge", "boundary", "poisson", "rate_table",
                              "event_loop", "superstep")}
    transport = {k: [] for k in ("assembly", "setup_and_cg", "power_extraction",
                                 "skipped")}
    heat_ms, heat_log = [], []
    cg_iters = []
    n_events = []
    state = sim.state
    cg.readbacks = banded_matvec.launches = wkb_fly_matvec.launches = 0
    for _ in range(args.steps):
        t0 = sync()
        state, _ = charge.update_charge(geom, params, state)
        t1 = sync()
        state, _ = potential.solve_boundary_potential(geom, params, state, Vd)
        t2 = sync()
        state, _ = potential.poisson_gridless_compact(
            geom, params, state, cap=params.poisson_compact_cap)
        t3 = sync()
        events.build_rate_table(geom, params, state)
        t4 = sync()
        res = events.execute_superstep(geom, params, state)
        t5 = sync()
        state = res.state
        n_events.append(res.n_events)
        phases["charge"].append(t1 - t0)
        phases["boundary"].append(t2 - t1)
        phases["poisson"].append(t3 - t2)
        phases["rate_table"].append(t4 - t3)
        phases["event_loop"].append((t5 - t4) - (t4 - t3))
        phases["superstep"].append((t3 - t0) + (t5 - t4))
        if args.transport:
            before = state
            state, m = current.update_power(geom, params, state, Vd, cc=sim._cc,
                                            allow_skip=True)
            t6 = sync()
            phases["superstep"][-1] += t6 - t5
            if m["transport_partial_assembly"] < 0:
                transport["skipped"].append(t6 - t5)
            else:
                current.assemble_X_blocks(geom, params, before, cc=sim._cc["cc"],
                                          band=sim._cc.get("band"))
                t7 = sync()
                transport["assembly"].append(t7 - t6)
                transport["setup_and_cg"].append((t6 - t5) - (t7 - t6))
                cg_iters.append(int(m["cg_iters_power"]))
                if args.heat:
                    # the power block alone, on the potentials just solved
                    blk = current.assemble_X_blocks(geom, params, before, cc=sim._cc["cc"],
                                                    band=sim._cc.get("band"))
                    M = state.virtual_potentials * current.G0
                    t8 = sync()
                    current._site_power(geom, params, state,
                                        current._pdisp_blocked(blk, M[2:], Vd))
                    t9 = sync()
                    transport["power_extraction"].append(t9 - t8)
                    transport["setup_and_cg"][-1] -= t9 - t8
            if args.heat:
                t10 = sync()
                state, _ = heat.update_temperature(geom, params, sim.heat, state,
                                                   res.step_time)
                t11 = sync()
                heat_ms.append(t11 - t10)
                heat_log.append(dict(heat.last_local))
                phases["superstep"][-1] += t11 - t10
    print(f"host-clock phases over {args.steps} supersteps "
          f"(events per step {n_events}), median ms:")
    for k, v in phases.items():
        print(f"  {k:<11} {statistics.median(v) * 1e3:9.3f}   "
              f"(min {min(v) * 1e3:.3f}, max {max(v) * 1e3:.3f})")
    per_event = [p / max(n, 1) for p, n in zip(phases["event_loop"], n_events)]
    print(f"  event loop per event: median {statistics.median(per_event) * 1e3:.3f} ms")
    print(f"  CG read-backs {cg.readbacks}; banded matvec launches "
          f"{banded_matvec.launches}, fly matvec launches {wkb_fly_matvec.launches}")
    if args.transport:
        print(f"transport phase: {len(transport['assembly'])} solved steps "
              f"(cg_iters_power {cg_iters}), {len(transport['skipped'])} skipped; median ms:")
        for k, v in transport.items():
            if v:
                print(f"  {k:<12} {statistics.median(v) * 1e3:9.3f}   "
                      f"(min {min(v) * 1e3:.3f}, max {max(v) * 1e3:.3f})")
    if args.heat:
        print(f"heat phase ({'local cg' if args.local else 'global'} model): median "
              f"{statistics.median(heat_ms) * 1e3:.3f} ms (min {min(heat_ms) * 1e3:.3f}, "
              f"max {max(heat_ms) * 1e3:.3f}); T_bg {state.T_bg:.12g} K, P_tot "
              f"{state.P_tot:.6g} W")
        if args.local:
            for ms, ll in zip(heat_ms, heat_log):
                print(f"  {ms * 1e3:9.3f} ms: {ll.get('branch')} branch, "
                      f"{ll.get('substeps')} substeps, {ll.get('cg_iters')} CG iterations")
    sim.state = state

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = sync()
        for _ in range(args.steps):
            sim.state, _, _ = sim._superstep(sim.state, Vd)
        t1 = sync()
    wall_us = (t1 - t0) * 1e6
    avgs = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0.0)

    # device-side records only (kernels, copies): the aten ops that launch
    # them carry the same time again
    from torch.autograd import DeviceType

    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in kernels)
    print(f"profiler: {args.steps} supersteps in {wall_us / 1e3:.3f} ms wall; "
          f"device busy {busy / 1e3:.3f} ms = {100 * busy / wall_us:.2f} % "
          f"(idle {100 - 100 * busy / wall_us:.2f} %)")
    if busy == 0:
        print("profiler recorded no device time: busy share not measured")
    dtoh = sum(e.count for e in kernels if e.key.startswith("Memcpy DtoH"))
    print(f"device-to-host copies: {dtoh} ({dtoh / args.steps:.1f} a superstep)")
    rows = sorted(kernels, key=dev_us, reverse=True)
    print("device time by kernel (top 15): total ms, calls, name")
    for e in rows[:15]:
        print(f"  {dev_us(e) / 1e3:9.3f} {e.count:7d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
