#!/usr/bin/env python3
"""The default Poisson sweep (``poisson_kernel = "jnp"``, the exact erfc) on
one CUDA card, at the headline configuration of ``chip_smoke.py``.

    python3 tools/probe_poisson.py [--pkg DIR] [--steps 4] [--out FILE]

For mixed precision and f64, builds ``chip_smoke.synthetic_crossbar`` (the
108,944-site synthetic crossbar, Vd = 1 V) with ``poisson_kernel = "jnp"``
and runs ``run_bias_point`` (the cold pre-solve, 2 warm-up and ``--steps``
timed supersteps) on the engine's eager superstep, and, where the engine
takes the captured graph for this configuration, once more on the graph.
Prints for each: the superstep's host-clock ms (the engine's timing key, a
synchronize at its end) step by step and their median, the charged count of
each step, then the Poisson phase alone on the run's last state
(``physics.potential.poisson_gridless_compact`` at the run's bucket, CUDA
events around 5 calls in a row, the median of 5 rounds, and its
device-to-host copies under torch.profiler).

``--pkg DIR`` takes ``devicekmc_tpu_torch`` and ``chip_smoke.py`` from the
checkout at DIR (say, the parent commit unpacked under ``build/``), so that
one chip call measures two versions in turns.  ``--out FILE`` also writes
the results as one JSON object.  The card's name and power limit come
first.
"""

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STEP_KEY = "Z - calculation time - KMC superstep [s]"


def dtoh_copies(fn):
    """Device-to-host copies of one call of ``fn`` as torch.profiler sees
    them (None when the trace holds no CUDA record)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    if not any(e.device_type == DeviceType.CUDA for e in events):
        return None
    return sum("DtoH" in e.name for e in events if e.device_type == DeviceType.CUDA)


def run(cs, precision, steps, out_root, graph):
    """One run_bias_point of the crossbar with the exact sweep: eager
    (``graph`` False) or the engine's own choice."""
    import torch

    from devicekmc_tpu_torch import engine

    sim = cs.synthetic_crossbar(cs.N_SITES, "cuda",
                                os.path.join(out_root, f"{precision}_{int(graph)}"),
                                precision=precision, poisson_kernel="jnp")
    if not graph:
        sim._make = engine.make_superstep
    elif sim._graph_for(sim.params) is None:
        return None
    charged = []
    step = sim._superstep

    def counted(state, Vd, *rest):
        out = step(state, Vd, *rest)
        charged.append(int((out[0].charge != 0).sum()))
        return out

    sim._superstep = counted
    t0 = time.perf_counter()
    sim.run_bias_point(cs.VD_MAIN, 1e30, max_steps=cs.WARMUP_STEPS + steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [s[STEP_KEY] * 1e3 for s in sim.step_log]
    took_graph = sim._graph is not None
    return sim, dict(graph=took_graph, sites=sim.geom.N, ms=ms,
                     median_ms=statistics.median(ms[cs.WARMUP_STEPS:]),
                     events=[int(s["n_events"]) for s in sim.step_log], charged=charged,
                     cap=sim.params.poisson_compact_cap, wall_s=wall)


def poisson_alone(cs, sim):
    """The Poisson phase on the run's last state: ms a call and the
    device-to-host copies of one call."""
    from devicekmc_tpu_torch.physics import potential

    g, p, st = sim.geom, sim.params, sim.state
    fn = lambda: potential.poisson_gridless_compact(g, p, st, p.poisson_compact_cap)  # noqa
    return dict(ms=cs.time_ms(fn, reps=5, rounds=5, warmup=2), dtoh=dtoh_copies(fn),
                charged=int((st.charge != 0).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", help="checkout whose devicekmc_tpu_torch is measured")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", help="file for the results as JSON")
    args = ap.parse_args()
    src = os.path.abspath(args.pkg) if args.pkg else ROOT
    sys.path.insert(0, src)

    import torch

    if not torch.cuda.is_available():
        print("probe_poisson: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import devicekmc_tpu_torch

    print(cs.gpu_line(), flush=True)
    print(f"devicekmc_tpu_torch from {os.path.dirname(devicekmc_tpu_torch.__file__)}",
          flush=True)
    out_root = os.path.join(src, "build", "probe_poisson")
    results = {"source": src, "gpu": cs.gpu_line()}
    for precision in ("mixed", "f64"):
        res = {}
        for graph in (False, True):
            got = run(cs, precision, args.steps, out_root, graph)
            if got is None:
                res["graph"] = "the engine runs this configuration eagerly"
                continue
            sim, rec = got
            tag = "graph" if rec["graph"] else "eager"
            res[tag] = rec
            if not graph:
                res["poisson_phase"] = poisson_alone(cs, sim)
            del sim
            torch.cuda.empty_cache()
        results[precision] = res
        print(f"{precision}: " + json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
