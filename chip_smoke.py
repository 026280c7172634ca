#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):

1. builds the nine CUDA libraries from devicekmc_tpu_torch/csrc (nvcc,
   sm_90a, one nvcc per source, in parallel) and beside them the latency
   probes of the event loop's bound (tools/latency_probe.cu), and prints
   ptxas's registers and shared memory per kernel; holds the event kernel's random stream
   (csrc/threefry.cuh) against rng.py: 10^4 successive key splits and their
   f64 and f32 draws, bit for bit;
2. small-device checks: the 256-site test stack on the card and through the
   port's CPU path, with the headline modules (mixed precision, Vd = 2.5 V,
   4 supersteps: event counts equal, potentials within 1e-5 of their scale),
   with blocked transport on (on-the-fly metal block, chunked cold solves,
   Vd = 10 V: event counts equal, I_macro within 1e-5), and with Joule
   heating in three forms: blocked on-the-fly transport + global heat, dense
   transport + global heat in f64 (the golden trajectory's configuration),
   blocked transport + local heat with the dense propagators (I_macro,
   P_tot, T_bg and the temperature field within stated tolerances); the
   event kernel against its plain version (the host loop, on the card) with
   an f64 table, 6 supersteps from one state (events, elements, charges,
   keys equal, step_time within 1e-9 relative); batch_steps = 4 against the
   per-step driver (events and elements per step, output.txt's numbers); the
   accuracy gate of transport_bf16_inner (Vd = 10 V, 4 supersteps), once with
   the stored metal block (the bf16 twin products run) and once on the fly
   (they do not): card and CPU path with equal events and I_macro within
   1e-5, both within 2e-4 of the dense direct solve;
3. headline path: the synthetic crossbar of 108,944 sites (the composition
   and neighbour statistics of the reference's timing crossbar), neighbour
   list built on the card; the gather and the Poisson kernel are held against
   their plain versions at this path's shapes and timed beside their bounds
   (the gather bit-equal on every slot, pads included, 1 and 2 channels,
   cold L2 and back to back, also with every source local and without the
   gather, beside the x-bandwidth of the neighbour list, and at the rate
   table's smallest bucket of rows taken through active_idx; the Poisson kernel
   PBC off and on, two calls bit-equal, with ptxas's
   registers and shared bytes and the device launches of one call as
   torch.profiler counts them: it must be the one kernel); then
   Simulation.run_bias_point runs the cold pre-solve, 2 warm-up and 4 timed
   supersteps at Vd = 1 V on the captured graph (the main path: a superstep
   one replay and one read), with the launch counters set to 0 just before it
   (the batched gather twice a superstep, the batched pair sweep and event
   loop once, each as the card counts its launches too, the boundary CG
   kernels once an iteration as the card counts them, no plain version); the
   same run eagerly (the engine's superstep
   without a graph), counters set to 0 again: events, elements and
   cg_iters_boundary equal step for step, potentials within 1e-12 of their
   scale; the three batched kernels the graph launches held against their
   plain versions at its shapes (B = 1, the run's last state; bit-equal)
   and timed beside their bounds; both drivers again in turns, timed, one
   superstep of each under torch.profiler (device busy share; device-to-host
   copies: 1 a graph superstep, 0 in a replay alone; each kernel's launches
   in the trace equal to its wrapper's count, on the graph its per-replay
   count, and the batched kernels' counts equal to the launches the card
   counts itself (csrc/launch_count.cuh); each CG kernel in the trace at
   most as often as the card counts iterations and at least once where it
   counts one; a trace may miss launches); then the
   event kernel against its plain version on the crossbar's f32 table (3
   supersteps, step_time within 2 f32 ulps), the loop alone timed both
   ways, at the path's time window and with a cap of 200 events and no
   window, beside its bytes bound and a latency bound (the L2 round trips
   and barriers an event cannot avoid, at the L2 hit and barrier latencies
   measured on the card),
   and batch_steps = 4 over the same 6 steps against the per-step run
   (events, and elements or inside a batch their checksum, step for step;
   one replay a driver call; a batch one replay and one device-to-host copy,
   its launches witnessed by the trace);
4. transport path: the same crossbar with solve_current on (heating off,
   transport blocked, on-the-fly metal block, deflated cold solve with 24
   slabs, chunked cold solves, 256 integration steps, Vd = 1 V), on the
   eager driver, counters set to 0 just before: CB-edge solve, cold deflated
   transport solve, 8 supersteps; every transport solve must converge, I_macro be finite
   and positive, a skipped or an incremental assembly be seen, and the two
   headline and all four transport kernels be launched and the dissipation
   kernel not be (the window block launched twice an assembly, at the
   bucket and at the delta rows; the supersteps' full, partial and skipped
   assemblies counted from their metric), with the
   CG read-backs of the run (stop conditions read once a chunk).  Then
   each transport kernel is held against its plain version at this path's
   shapes (the band, the metal atoms and CB edges, the vacancy bucket of
   the run) and timed beside its bound and a library call; the on-the-fly
   products are also held against them at a ragged width (2,001 atoms of
   both contacts) and measured at the reference crossbar's 24,768
   interior-metal atoms against the stored block, with the share of pairs
   that pass the CB-edge test and of 32 x 32 chunks the kernels do not
   skip; the window block also at 16 of the bucket's live rows (the
   partial assembly's shape) and at the bucket against 24,768 metal atoms,
   with the steps its pairs take and the share of lanes they keep busy;
   per kernel ptxas's registers and shared bytes and the device launches
   of one call as torch.profiler counts them (it must be the one kernel).
   The main path of this configuration: the same run on the captured graph
   (the transport CG's refinement rounds and inner CG two nested WHILE
   nodes, csrc/transport_cg.cu), counters set to 0 just before and read
   just after (the batched kernels and the transport CG's kernels as the
   card counts them, each launched; the f64 pack at the round ends only,
   none in the inner body), held bit for bit step for step
   against the eager run (events, elements, cg_iters_power, I_macro, P_tot,
   T_bg, the virtual potentials, the site power, the tunnel store, every
   metric); both again in turns, timed, one superstep of each under
   torch.profiler (busy share, the union of the device records; 1
   device-to-host copy a graph superstep; in a graph superstep that solves,
   each transport CG kernel of the nested WHILE bodies in the trace at
   least once); the capture seconds at a second
   bias point (Vd = 1.05 V, 2 supersteps); the transport CG's kernels
   (blocks and rows, f32 and f64 builds, the update that packs, the f64
   pack, refine) against their plain versions at the path's shapes, timed
   beside their bytes bounds (the ELL rows' and the bump's valid slots, the
   virtual rows' nonzero ranges), the band's and fly matvec's out= entries
   bit-equal to the allocating ones, the inner body inside a WHILE node
   with and without the branch beside the band and in series, and the warm
   solve captured and from the host loop;
5. heat path: the transport configuration with solve_heating_global on and
   A = ly * lz on the eager driver, counters set to 0 just before: cold
   solves, 8 supersteps, then its captured graph against it as in phase 4;
   every transport solve must converge, the site power be non-zero on
   non-metal atoms only, T_bg be finite and never below background_temp, and
   the dissipation kernel be launched once per transport solve.  Then the
   dissipation kernel is held against its plain version and the stored-block
   sweep, Vd of both signs, PBC off and on, two launches bit-equal, at this
   path's metal set and at the reference crossbar's 24,768, with ptxas's
   registers and shared bytes, the device launches of one call and the
   share of upper-triangle chunks it skips.  Then 3
   supersteps with solve_heating_local on (matrix-free model, symmetric
   contact spans), with the branch taken, the substeps and the CG iterations
   of every step;
6. the transport run again (eager) with the CG stop condition read every iteration:
   the cold solves' iterations and every step's events, cg_iters_boundary
   and cg_iters_power equal to the chunked run's; the log of the event
   kernel's time draws against numpy's (draws that differ, and by how many
   ulps);
7. the modular driver (Simulation(fused=False)): on the small stack with
   transport and the local cg heat model against the fused driver (events
   and elements per step, the module times logged), and its chunked heat
   phase against the single call at 151 substeps (1e-9 relative); then the
   headline crossbar run of phase 3 again with in-superstep segments of 200
   iterations, counters set to 0 just before: events and elements equal to
   phase 3's step for step, the four headline module times at every step,
   their medians printed;
8. checkpoint and resume on the card: on the small stack with transport and
   on the headline crossbar, per step and with batch_steps = 4, 2
   supersteps, a checkpoint, 2 more, against a fresh Simulation that loads
   the file and runs the same 2: element, charge, key, kmc_time, I_macro,
   virtual_potentials and CB_edge bit for bit; the save and load seconds;
9. the transport configuration of phase 4 with transport_bf16_inner and
   transport_tol 1e-6 (the option's 1e-2 tightening makes it phase 4's
   1e-8), counters set to 0 just before: cold solves and 4 supersteps,
   every solve converged, every transport kernel launched and the band
   bf16, the iterations and currents beside phase 4's; then the bf16 band
   kernel (with the f32 vector the path gives it) against its plain
   version on the run's band (within 2e-5 of its largest entry, and the vector
   rounded to bf16 more than 10x further off),
   timed beside its bytes bound and torch.einsum on the bf16 window stack;
10. device ensembles: 8 replicas of the headline crossbar (keys
   fold_in(PRNGKey(42), b)) through parallel.batched.make_batched_superstep
   (a captured graph a call), counters set to 0 just before 2 warm-up and 4
   timed supersteps: the batched gather twice a superstep, the batched pair
   sweep and event loop once (the card's own counts equal), no single
   kernel, no plain version; every
   replica against the single path on the card with its key (elements and
   events equal); the same supersteps of the eager batched superstep
   (elements, events, cg_iters_boundary equal); the device-to-host copies of
   each batched superstep no more than the most that any replica alone
   (B = 1) makes in that superstep, and the batched kernels' launches in
   each such superstep's trace equal to their counts; the graph and the eager batched
   superstep timed at B = 1, 8 and 32 beside the single path; the three
   batched kernels against their batched plain versions and B single
   launches (bit-equal), timed beside their bounds; and
   examples/ensemble_torch.py's configuration (dense transport, global
   heat, B = 2) on the card against the CPU path;
11. the boundary CG kernels of the captured superstep (csrc/boundary_cg.cu)
   at the crossbar's boundary system after phase 3: the device loop captured
   with its WHILE node (right after phase 3; captured anew at phase 11, one
   profiled replay's trace is logged, not checked) against
   cg_solve_batched from the run's potential plus seeded noise (iteration
   counts equal, the iterate within 1e-12 of its scale; the kernels of the
   WHILE node's body in the trace of a replay),
   each of the two kernels (cg_matvec_dot, cg_update_direction) against its
   plain version, timed back to back and with a cold L2 beside its bytes
   bound (the matvec's: the operator's interior nonzeros, value and index,
   the interior rows' diagonal, p, ap and the row lengths, each once; the
   update and direction's: eight vectors; the matvec also beside
   torch.sparse.mm of the operator in CSR), cg_update_direction also at
   B = 8 and 32 beside its bound and the bytes its blocks read again, and
   the boundary work a captured superstep adds where no replica solves,
   captured and timed.

Prints the card's name and power limit, the kernels' JSON line, and last
``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA card.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bandwidth and FP32 outside the
# tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations of one Poisson pair in csrc/pairwise.cu (each add,
# multiply, division, square root, rint and exp counted once): 30, plus
# 8 for the two minimum-image wraps under PBC
POISSON_OPS_PER_PAIR = {False: 30, True: 38}
# FP32 operations of one WKB pair value in csrc/wkb_fly.cu (3 subtractions, 5
# for the squared distance, 2 square roots, |dE|, 2 comparisons, 2 selects,
# 3 for s, 2 for e15, E2, the barrier term's 3, exp, negation and select):
# 30, plus 8 under PBC; every use of the value in a sum adds 2
WKB_OPS_PER_PAIR = {False: 30, True: 38}
# per energy step and pair in csrc/wkb_window.cu: k*dE, comparison, e1, e2,
# sqrt and product (e15), comparison, sqrt, product, subtraction, product,
# exp, accumulate
WINDOW_OPS_PER_STEP = 13

N_SITES = 110_000
VD_MAIN = 1.0
WARMUP_STEPS, TIMED_STEPS = 2, 4
# supersteps of the graph and the eager driver in turns after phase 3's runs
GRAPH_TURNS = 4
TRANSPORT_STEPS = 8
HEAT_STEPS = 8
LOCAL_HEAT_STEPS = 3
# FP32 operations a pair that the dissipation sum adds to the pair value: dM,
# the product, two comparisons, select, two negations, multiply, add
PDISP_EXTRA_OPS = 8
# interior-metal atoms of the reference's timing crossbar
REF_N_MP = 24_768
# the smallest bucket of rate-table rows (the engine's auto rule)
RATE_BUCKET = 1024


#: the latency probes (tools/latency_probe.cu), built beside the package's
#: libraries: {"lib": ctypes library} once built
LATENCY = {}


def start_latency_build():
    """An nvcc of tools/latency_probe.cu as the package's sources are built:
    (process, library path)."""
    from devicekmc_tpu_torch.ops import _build

    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "liblatency_probe.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
           os.path.join(ROOT, "tools", "latency_probe.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), so


def finish_latency_build(job):
    """Wait for start_latency_build's nvcc and load its library."""
    import ctypes

    proc, so = job
    out, _ = proc.communicate()
    check(proc.returncode == 0, f"nvcc failed for tools/latency_probe.cu:\n{out}")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("dkmc_chase", [p, i, p, p]), ("dkmc_barriers", [i, p, p]),
                       ("dkmc_raw_probe", [p, i, p, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    LATENCY["lib"] = lib


def latencies(lines=1 << 16, hops=1 << 16, barriers=1 << 16, seed=0):
    """What one event's chain of dependent steps costs at the least on this
    card: ``(load_ns, barrier_ns)``, the latency of one dependent load (a
    pointer chase over ``lines`` lines of 128 bytes in a seeded random
    cycle, past L1: 8 MiB at the default, inside L2) and of one
    ``__syncthreads`` of the event loop's 512 threads, each the median of
    five launches of ``hops`` or ``barriers`` steps timed between CUDA
    events (tools/latency_probe.cu)."""
    import torch

    lib = LATENCY["lib"]
    gen = torch.Generator().manual_seed(seed)
    order = torch.randperm(lines, generator=gen) * 32
    nxt = torch.zeros(lines * 32, dtype=torch.int32)
    nxt[order] = torch.roll(order, -1).to(torch.int32)
    nxt = nxt.to("cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(launch, n):
        times = []
        for _ in range(6):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            err = launch()
            b.record()
            b.synchronize()
            check(err == 0, f"latency probe launch failed: cudaError {err}")
            times.append(a.elapsed_time(b) * 1e6 / n)
        return statistics.median(times[1:])

    return (timed(lambda: lib.dkmc_chase(nxt.data_ptr(), hops, sink.data_ptr(), stream), hops),
            timed(lambda: lib.dkmc_barriers(barriers, sink.data_ptr(), stream), barriers))


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# GPU clock cycles (several ms) the stream is held busy before a timed
# region, so that the host has queued the timed calls before the start event
# fires and the events time the device alone, not the host's launch overhead
HOLD_CYCLES = 10_000_000


def time_ms(fn, reps=20, rounds=5, warmup=3):
    """Time of one call: CUDA events around ``reps`` calls in a row, divided
    by ``reps``; the median over ``rounds``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def time_ms_cold(fn, reps=20, warmup=3):
    """Time of one call with a cold L2: before each call a 64 MiB buffer
    (more than the 50 MB L2) is written, and CUDA events bracket the call
    alone; the median over ``reps`` calls.  This is how the main path meets
    the gather, once per superstep after other work."""
    import torch

    scrub = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scrub.fill_(1)
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

def small_device(device, out_dir, current=False, heat=None, fused=True, **overrides):
    """The 256-site stack of tests/test_golden_trajectory.py with the
    headline modules; ``current`` adds blocked transport as the transport
    path runs it (transport_tol 1e-11: two solves that meet the default
    1e-8 agree on I_macro only to ~3e-5); ``heat`` adds Joule heating:
    "global-fly" (blocked on-the-fly transport, global model), "global-dense"
    (f64, dense transport, global model: the golden trajectory's
    configuration), "local-dense" (blocked transport, stored metal block,
    local model with the dense propagators); ``fused=False`` selects the
    modular driver; ``overrides`` replace single configuration fields."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.structure import make_test_structure

    s = make_test_structure(nx_contact=2, nx_oxide=8, ny=4, nz=4, seed=11)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.0,
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, perturb_structure=True, pristine=True,
        initial_vacancy_concentration=0.08, rnd_seed=3, rnd_seed_kmc=7,
        precision="mixed", poisson_kernel="pallas",
        V_switch=[2.5], t_switch=[1e30], output_dir=out_dir, log_freq=1000,
    )
    if current:
        cfg = dataclasses.replace(
            cfg, solve_current=True, transport="blocked", transport_cc="fly",
            transport_precond="deflated", coarse_slabs=4, solver_chunk_iters=40,
            transport_tol=1e-11)
    if heat == "global-fly":
        cfg = dataclasses.replace(cfg, solve_heating_global=True, A=1e-18)
    elif heat == "global-dense":
        cfg = dataclasses.replace(
            cfg, solve_current=True, transport="dense", precision="f64",
            poisson_kernel="jnp", solver_chunk_iters=0, solve_heating_global=True,
            A=1e-18)
    elif heat == "local-dense":
        cfg = dataclasses.replace(cfg, transport_cc="stored", solve_heating_local=True,
                                  heat_solver="dense")
    cfg = dataclasses.replace(cfg, **overrides)
    os.makedirs(out_dir, exist_ok=True)
    return Simulation(cfg, elements=s.elements, coords=s.coords, device=device,
                      fused=fused)


def synthetic_crossbar(n_sites, device, out_dir, current=False, heat=None, fused=True,
                       **overrides):
    """The headline configuration on the synthetic crossbar: the structure,
    substoichiometry and solver settings of the JAX package's bench.py
    build_synthetic_crossbar_sim (bench.py:219-297), with site_order "x",
    mixed precision, both kernels, Vd = 1 V.  ``current`` adds that
    function's transport settings (blocked, deflated, 24 slabs) with heating
    off, the on-the-fly metal block, an automatic vacancy bucket, chunked
    cold solves and 256 integration steps; ``heat`` adds to those Joule
    heating as bench.py's build_crossbar_sim_full sets it (bench.py:120-153):
    "global" (the lumped model, A = ly * lz) or "local" (the matrix-free
    site-resolved model with symmetric plate-contact spans, so that interior
    metal stays inside the heat domain); ``fused=False`` selects the modular
    driver; ``overrides`` replace single configuration fields."""
    from devicekmc_tpu_torch.config import KMCConfig
    from devicekmc_tpu_torch.engine import Simulation
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import make_substoichiometric
    from devicekmc_tpu_torch.structure import make_crossbar_structure

    nxc, nxo, f = 10, 24, 0.74
    col = 2 * nxc + nxo * (1 + f)
    ny = nz = max(8, int(round((n_sites / col) ** 0.5)))
    s = make_crossbar_structure(nx_contact=nxc, nx_oxide=nxo, ny=ny, nz=nz, seed=1)
    elems = make_substoichiometric(s.elements, 0.02, seed=5)
    cfg = KMCConfig(
        lattice=list(s.lattice), nn_dist=3.5, pbc=False, site_order="x",
        num_atoms_first_layer=s.num_atoms_first_layer,
        num_layers_contact=s.num_layers_contact,
        num_atoms_contact=s.num_atoms_contact, layers=s.layers,
        solve_potential=True, solve_current=False, perturb_structure=True,
        precision="mixed", poisson_compact_cap=8192, solver_tol=1e-8,
        poisson_kernel="pallas",
        V_switch=[VD_MAIN], t_switch=[1e30], output_dir=out_dir, log_freq=1000,
    )
    if current:
        cfg = dataclasses.replace(
            cfg, solve_current=True, transport="blocked", transport_cc="fly",
            transport_precond="deflated", coarse_slabs=24, tunnel_vac_cap=-1,
            solver_chunk_iters=200, tunnel_int_steps=256)
    if heat == "global":
        cfg = dataclasses.replace(
            cfg, solve_heating_global=True,
            A=s.lattice[1] * 1e-10 * s.lattice[2] * 1e-10)
    elif heat == "local":
        cfg = dataclasses.replace(cfg, solve_heating_local=True, heat_solver="cg")
    cfg = dataclasses.replace(cfg, **overrides)
    os.makedirs(out_dir, exist_ok=True)
    sim = Simulation(cfg, elements=elems, coords=s.coords, device=device, fused=fused)
    if heat == "local":
        e = sim.state.element.cpu().numpy()
        spans = (heat_mod._num_in_contact_left(e, cfg.num_atoms_contact),
                 heat_mod._num_in_contact_left(e[::-1], cfg.num_atoms_contact))
        sim.heat = heat_mod.build_heat_model(
            sim.geom, sim.params, cfg, e, sim.geom.neigh_idx.cpu().numpy(),
            method="cg", contact_spans=spans)
    return sim


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def record_steps(sim):
    """Wrap the superstep so each call's events and potential are kept."""
    recs = []
    step = sim._superstep

    def wrapped(state, Vd):
        out = step(state, Vd)
        phi = (out[0].potential_boundary + out[0].potential_charge).cpu()
        recs.append((int(out[2]["n_events"]), phi.double().numpy(),
                     out[2].get("Current [uA]"),
                     dict(P_tot=out[0].P_tot, T_bg=out[0].T_bg,
                          temperature=out[0].temperature.cpu().double().numpy())))
        return out

    sim._superstep = wrapped
    return recs


def small_device_check(out_dir, steps=4, current=False, Vd=2.5, heat=None):
    """The small device on the card against the port's CPU path.  With
    ``heat``: P_tot within 1e-4 relative (it is quadratic in the potentials
    of two independent solves), T_bg within 1e-7 relative and the
    temperature field within 1e-6 relative."""
    import numpy as np

    current = current or heat is not None
    runs = {}
    for device in ("cuda", "cpu"):
        sim = small_device(device, os.path.join(out_dir, device), current=current,
                           heat=heat)
        recs = record_steps(sim)
        sim.run_bias_point(Vd, 1e30, max_steps=steps)
        runs[device] = recs
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(len(gpu) == len(cpu) >= steps, "small device: step count")
    worst = worst_I = worst_P = worst_T = 0.0
    for k, ((ne_g, phi_g, I_g, h_g), (ne_c, phi_c, I_c, h_c)) in enumerate(zip(gpu, cpu)):
        check(ne_g == ne_c, f"small device step {k}: events {ne_g} vs {ne_c}")
        scale = float(np.abs(phi_c).max())
        err = float(np.abs(phi_g - phi_c).max())
        worst = max(worst, err / scale)
        check(err <= 1e-5 * scale, f"small device step {k}: potential error {err}")
        if current:
            check(I_c > 0 and abs(I_g - I_c) <= 1e-5 * abs(I_c),
                  f"small device step {k}: current {I_g} vs {I_c} uA")
            worst_I = max(worst_I, abs(I_g - I_c) / abs(I_c))
        if heat:
            eP = abs(h_g["P_tot"] - h_c["P_tot"]) / abs(h_c["P_tot"])
            eT = abs(h_g["T_bg"] - h_c["T_bg"]) / h_c["T_bg"]
            eF = float(np.abs(h_g["temperature"] / h_c["temperature"] - 1).max())
            check(h_c["P_tot"] > 0 and eP <= 1e-4,
                  f"small device step {k}: P_tot {h_g['P_tot']} vs {h_c['P_tot']} W")
            check(eT <= 1e-7, f"small device step {k}: T_bg {h_g['T_bg']} vs {h_c['T_bg']} K")
            check(eF <= 1e-6, f"small device step {k}: temperature field error {eF}")
            worst_P, worst_T = max(worst_P, eP), max(worst_T, eT, eF)
    if heat:
        check(gpu[-1][3]["T_bg"] != 300.0, "small device: the temperature never moved")
    tag = f" with heating ({heat})" if heat else " with transport" if current else ""
    log(f"small device{tag}: {steps} supersteps at "
        f"Vd = {Vd} V, events per step {[r[0] for r in gpu]} on both, max potential "
        f"error {worst:.3e} of its scale"
        + (f", max current error {worst_I:.3e} relative" if current else "")
        + (f", max P_tot error {worst_P:.3e} relative, max temperature error "
           f"{worst_T:.3e} relative, T_bg {gpu[-1][3]['T_bg']:.9g} K" if heat else ""))


def kernel_checks(sim):
    """Each kernel against its plain version at the main path's shapes,
    timed beside its bound; returns the kernels' records."""
    import torch

    from devicekmc_tpu_torch.ops.compact import nonzero_fixed
    from devicekmc_tpu_torch.ops.ell_gather import (
        ell_gather, ell_gather_plain, ell_stream_copy, launch_grid,
    )
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_grid, poisson_pairwise, poisson_pairwise_plain,
    )
    from devicekmc_tpu_torch.physics.charge import update_charge
    from devicekmc_tpu_torch.physics.events import pack_site_code
    from devicekmc_tpu_torch.structure import Element

    geom, params = sim.geom, sim.params
    state, _ = update_charge(geom, params, sim.state)
    idx = geom.neigh_idx
    valid = geom.neigh_valid
    idx_long = idx.clamp(min=0).long()
    elem = state.element
    flags = ((geom.metal_mask_table[elem.long()].to(torch.int32) << 1)
             | (elem == 2).to(torch.int32))
    phi = (state.potential_boundary + state.potential_charge).to(torch.float32)
    code = pack_site_code(elem, state.charge, geom.site_layer)
    R, M = idx.shape

    site = torch.arange(R, device="cuda", dtype=torch.int32)[:, None]
    # the x-bandwidth in site-index space, as build_ell_gather_plan of the
    # JAX package computes it (a pad slot counts as the row's own site)
    bw = int((torch.where(idx >= 0, idx, site) - site).abs().max())
    # every source access local: idx[r, s] = r
    idx_local = site.expand(R, M).contiguous()
    gather = {}
    for c, vals in ((1, [flags]), (2, [phi, code])):
        got = ell_gather(idx, vals)
        ref = ell_gather_plain(idx, vals)
        torch.cuda.synchronize()
        err = 0.0
        for g, r in zip(got, ref):
            # every slot, pads included, bit for bit
            check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
                  f"gather C={c} differs")
            err = max(err, float((g[valid].double() - r[valid].double()).abs().max()))
        bytes_ = R * M * 4 + c * geom.N * 4 + c * R * M * 4
        gather[c] = dict(
            err=err, ms=time_ms_cold(lambda: ell_gather(idx, vals)),
            plain_ms=time_ms_cold(lambda: ell_gather_plain(idx, vals)),
            library_ms=time_ms_cold(lambda: [v[idx_long] for v in vals]),
            ms_warm=time_ms(lambda: ell_gather(idx, vals)),
            bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3,
            # what sets the pace: the same kernel with every source local,
            # and its loop with no gather at all (the streams alone)
            ms_local=time_ms_cold(lambda: ell_gather(idx_local, vals)),
            ms_copy=time_ms_cold(lambda: ell_stream_copy(idx, c)),
            ms_copy_warm=time_ms(lambda: ell_stream_copy(idx, c)),
        )
        r = gather[c]
        log(f"ell_gather C={c} [{R}x{M}, x-bandwidth {bw} sites]: bit-equal on every "
            f"slot; cold L2 {r['ms']:.5f} ms (bound {r['bound_ms']:.5f} ms, plain "
            f"{r['plain_ms']:.5f} ms, values[idx] {r['library_ms']:.5f} ms); back to back "
            f"{r['ms_warm']:.5f} ms; idx = row (local sources) {r['ms_local']:.5f} ms; "
            f"the streams alone (no gather) {r['ms_copy']:.5f} ms cold, "
            f"{r['ms_copy_warm']:.5f} ms back to back")
    # the rate table's rows as build_rate_table takes them through
    # active_idx, at the smallest bucket of the engine's auto rule (1,024
    # rows): the candidate source rows {d, Od, V}, padded with row 0
    aidx, _ = nonzero_fixed((elem == int(Element.DEFECT))
                            | (elem == int(Element.OXYGEN_DEFECT))
                            | (elem == int(Element.VACANCY)), RATE_BUCKET)
    idx_a = idx[aidx.long()].contiguous()
    vals = [phi, code]
    got, ref = ell_gather(idx_a, vals), ell_gather_plain(idx_a, vals)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
              f"gather at [{RATE_BUCKET}x{M}] differs")
    gather["bucket"] = dict(
        ms=time_ms_cold(lambda: ell_gather(idx_a, vals)),
        ms_warm=time_ms(lambda: ell_gather(idx_a, vals)),
        plain_ms=time_ms_cold(lambda: ell_gather_plain(idx_a, vals)),
        bound_ms=(RATE_BUCKET * M * 4 * 3 + 2 * geom.N * 4) / PEAK_BYTES_PER_S * 1e3,
        **dict(zip(("slots_per_lane", "blocks"), launch_grid(RATE_BUCKET * M, 2, idx.device))))
    r = gather["bucket"]
    log(f"ell_gather C=2 [{RATE_BUCKET}x{M}, rate-table rows through active_idx, "
        f"{r['slots_per_lane']} slots a lane, {r['blocks']} blocks]: bit-equal on every slot; "
        f"cold L2 {r['ms']:.5f} ms (bound "
        f"{r['bound_ms']:.5f} ms, plain {r['plain_ms']:.5f} ms); back to back "
        f"{r['ms_warm']:.5f} ms")
    gather["bandwidth"] = bw
    gather["grid"] = {c: launch_grid(R * M, c, idx.device) for c in (1, 2)}

    coords32 = geom.coords.to(torch.float32).contiguous()
    cidx = torch.nonzero(state.charge != 0).reshape(-1).to(torch.int32)
    cq = state.charge[cidx.long()].to(torch.float32)
    n_c = int(cidx.numel())
    check(n_c > 0, "main path has charged sites")
    lat = list(geom.lattice_host)
    poisson = {}
    for pbc in (False, True):
        scal = kernel_scalars(params.sigma, params.k, lat, params.dtype)
        args = (coords32, cidx, cq, *scal, pbc)
        got = poisson_pairwise(*args)
        ref = poisson_pairwise_plain(*args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "poisson kernel output finite")
        err = float((got - ref).abs().max())
        tol = 2e-6 * float(ref.abs().max())
        check(err <= tol, f"poisson pbc={pbc}: max error {err} > {tol}")
        check(torch.equal(got, poisson_pairwise(*args)), f"poisson pbc={pbc}: two calls differ")
        ops = geom.N * n_c * POISSON_OPS_PER_PAIR[pbc]
        bytes_ = geom.N * 12 + n_c * 8 + geom.N * 4
        bound = max(ops / PEAK_FP32_PER_S, bytes_ / PEAK_BYTES_PER_S) * 1e3
        poisson[pbc] = dict(
            err=err, ms=time_ms(lambda: poisson_pairwise(*args)),
            plain_ms=time_ms(lambda: poisson_pairwise_plain(*args), reps=5),
            bound_ms=bound,
            bound_by="operations" if ops / PEAK_FP32_PER_S >= bytes_ / PEAK_BYTES_PER_S
            else "bytes",
            n_split=poisson_grid(geom.N, n_c, torch.cuda.get_device_properties(0)
                                 .multi_processor_count)[1],
            **kernel_facts("pairwise", "poisson_pairwise_kernel", (pbc,),
                           lambda: poisson_pairwise(*args)),
        )
        r = poisson[pbc]
        log(f"poisson_pairwise pbc={pbc} [{geom.N} rows x {n_c} charged, {r['n_split']} "
            f"splits of the charged set]: max err {err:.3e} (atol {tol:.3e}); "
            f"{r['ms']:.4f} ms (bound {bound:.4f} ms, plain {r['plain_ms']:.4f} ms; "
            f"{r['kernel']}: {r['registers']} registers, {r['shared_bytes']} bytes shared, "
            f"{r['device_launches']} device launch a call by the profiler); bit-equal calls")
    return gather, poisson


def _bound(ops, bytes_):
    """(bound_ms, bound_by): the larger of operations over the FP32 peak and
    bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_PER_S, bytes_ / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _close(name, got, ref, tol):
    """max|got - ref| <= tol * max|ref| (f32 sums in another order, FMA
    contraction, one-ulp exp and sqrt); returns the absolute error."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: output finite")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(scale > 0, f"{name}: the plain version is all zero")
    check(err <= tol * scale, f"{name}: max error {err} > {tol} * {scale}")
    return err


# FP32 operations of the CB-edge part of the eligibility test (difference,
# absolute value, comparison): what a pair needs when it fails that test
WKB_OPS_DE_TEST = 3


def device_launches(fn):
    """How many device kernels one call of ``fn`` launches, as torch.profiler
    sees it: the call's kernel-launch records of the CUDA runtime
    (``cudaLaunchKernel`` and its kin; copies and memsets are other calls),
    and the names of the kernels on the device side where their records came
    back with the trace (they can arrive after it ends).  The call is made
    once before, so that nothing is built or allocated for the first time
    under the profiler.  (None, []) if the trace holds no CUDA call at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    if not any(e.name.startswith("cuda") for e in events):
        return None, []
    names = [e.name for e in events if e.device_type == DeviceType.CUDA
             and not e.name.startswith(("Memcpy", "Memset"))]
    return sum(e.name.startswith(("cudaLaunch", "cuLaunch")) for e in events), names


def kernel_facts(lib, kernel, targs, fn):
    """What the build and one profiled call say of the kernel
    ``kernel<targs>`` of ``csrc/<lib>.cu``: ptxas's registers and static
    shared bytes of that entry (found by its mangled template arguments, bool
    then int), and the device kernels one call of ``fn`` launches, which must
    be that kernel alone (partial sums are added inside it)."""
    from devicekmc_tpu_torch.ops import _build

    mangled = kernel + ("I" + "".join(
        f"L{'b' if isinstance(a, bool) else 'i'}{int(a)}E" for a in targs) + "E"
        if targs else "")
    found = [v for k, v in _build.kernel_resources(lib).items() if mangled in k]
    regs, smem = found[0] if len(found) == 1 else (None, None)
    count, names = device_launches(fn)
    if count is not None:
        check(count == 1 and all(kernel in nm for nm in names),
              f"{kernel}: one call made {count} launches, of {names}")
    label = kernel + (f"<{','.join(str(int(a)) for a in targs)}>" if targs else "")
    return dict(kernel=label, registers=regs, shared_bytes=smem, device_launches=count)


def fly_pair_stats(cb, ctol):
    """What this data asks of the fly kernels: ordered pairs, those that pass
    the CB-edge test |dE| > ctol (the others are exact zeros whatever their
    distance), and the 32 x 32 chunks the kernels do not skip (all of them
    for the row form and the matmat, the upper triangle for the symmetric
    form)."""
    import torch

    from devicekmc_tpu_torch.ops.wkb_fly import chunk_skip_plain

    n = cb.shape[0]
    ok = 0
    for r0 in range(0, n, 4096):
        ok += int(((cb[r0:r0 + 4096, None] - cb[None, :]).abs() > ctol).sum())
    live = ~chunk_skip_plain(cb, cb, ctol)
    return dict(pairs=n * n, ok=ok, chunks=live.numel(), live=int(live.sum()),
                live_sym=int(torch.triu(live).sum()))


def _wkb_ops(pairs, ok_pairs, ops_ok):
    """FP32 operations this data needs: the CB-edge test for every pair, the
    rest of the pair value and its uses only where the test passes."""
    return pairs * WKB_OPS_DE_TEST + ok_pairs * (ops_ok - WKB_OPS_DE_TEST)


def fly_checks(pos, cb, env, K, tag, plain_reps=5):
    """The on-the-fly matvec (both forms) and matmat against their plain
    versions and the stored block, timed beside their bounds: the data-sheet
    bound of the operations this data needs (bound_ms; bound_all_pairs_ms
    counts every pair in full, as the table did before the kernels skipped
    any), with ptxas's registers and shared bytes and the profiler's count
    of device launches a call.  The plain version is also held against the
    stored product, to show how much of the kernels' distance to it is the
    stored block's own (its pow form, cuBLAS's order of summation)."""
    import torch

    from devicekmc_tpu_torch.ops.wkb_fly import (
        matmat_split, matvec_col_split, wkb_fly_matmat, wkb_fly_matmat_plain,
        wkb_fly_matvec, wkb_fly_matvec_plain,
    )
    from devicekmc_tpu_torch.physics.current import tunnel_block, wkb_single_T

    n = pos.shape[0]
    st = fly_pair_stats(cb, env["ctol"])
    S = matvec_col_split(n, torch.cuda.get_device_properties(0).multi_processor_count)
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, generator=g, device="cuda")
    X = torch.randn((n, K), generator=g, device="cuda")
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    T = tunnel_block(env, pos, cb, ones, pos, cb, ones, wkb_single_T)
    check(not torch.backends.cuda.matmul.allow_tf32, "f32 matmul is IEEE f32")
    ops1 = WKB_OPS_PER_PAIR[bool(env["pbc"])]
    io = n * 20 + n * 4
    rec = {}
    ref = wkb_fly_matvec_plain(pos, cb, x, env)
    for sym in (True, False):
        y = wkb_fly_matvec(pos, cb, x, env, symmetric=sym)
        err = _close(f"fly matvec {tag} sym={sym}", y, ref, 1e-5)
        err_T = _close(f"fly matvec {tag} sym={sym} vs stored", y, T @ x, 1e-5)
        check(torch.equal(y, wkb_fly_matvec(pos, cb, x, env, symmetric=sym)),
              f"fly matvec {tag} sym={sym}: two launches differ")
        pairs = n * (n + 1) // 2 if sym else n * n
        ok_pairs = st["ok"] // 2 if sym else st["ok"]
        uses = 4 if sym else 2
        bound, by = _bound(_wkb_ops(pairs, ok_pairs, ops1 + uses), io)
        rec[sym] = dict(
            err=max(err, err_T), bound_ms=bound, bound_by=by,
            bound_all_pairs_ms=_bound(pairs * (ops1 + uses), io)[0],
            ms=time_ms(lambda: wkb_fly_matvec(pos, cb, x, env, symmetric=sym)),
            **kernel_facts("wkb_fly", "fly_matvec_tiles", (sym, S),
                               lambda: wkb_fly_matvec(pos, cb, x, env, symmetric=sym)))
    rec["plain_ms"] = time_ms(lambda: wkb_fly_matvec_plain(pos, cb, x, env),
                              reps=plain_reps, rounds=3, warmup=1)
    rec["library_ms"] = time_ms(lambda: T @ x)
    Y = wkb_fly_matmat(pos, cb, X, env)
    Yref = wkb_fly_matmat_plain(pos, cb, X, env)
    err_plain = _close(f"fly matmat {tag}", Y, Yref, 1e-5)
    err_stored = _close(f"fly matmat {tag} vs stored", Y, T @ X, 1e-5)
    err = max(err_plain, err_stored)
    plain_vs_stored = float((Yref - T @ X).abs().max())
    check(torch.equal(Y, wkb_fly_matmat(pos, cb, X, env)),
          f"fly matmat {tag}: two launches differ")
    err = max(err, _close(f"fly matmat {tag} KB=8", wkb_fly_matmat(pos, cb, X, env, KB=8),
                          Yref, 1e-5))
    # what Y = T X needs: one pair value and K multiply-adds a pair, however
    # the kernel groups the columns
    io_mm = n * 16 + 2 * n * K * 4
    bound, by = _bound(_wkb_ops(n * n, st["ok"], ops1 + 2 * K), io_mm)
    rec["mm"] = dict(
        err=err, bound_ms=bound, bound_by=by,
        bound_all_pairs_ms=_bound(n * n * (ops1 + 2 * K), io_mm)[0],
        err_plain=err_plain, err_stored=err_stored, plain_vs_stored=plain_vs_stored,
        n_split=matmat_split(n),
        **kernel_facts("wkb_fly", "fly_matmat_tiles", (24,),
                           lambda: wkb_fly_matmat(pos, cb, X, env)),
        ms=time_ms(lambda: wkb_fly_matmat(pos, cb, X, env)),
        ms_kb8=time_ms(lambda: wkb_fly_matmat(pos, cb, X, env, KB=8)),
        plain_ms=time_ms(lambda: wkb_fly_matmat_plain(pos, cb, X, env),
                         reps=plain_reps, rounds=3, warmup=1),
        library_ms=time_ms(lambda: T @ X))
    rec["stats"] = dict(
        st, ok_share=st["ok"] / st["pairs"], live_share=st["live"] / st["chunks"])
    scale = float(ref.abs().max())

    def line(r):
        return (f"{r['ms']:.4f} ms (data-sheet bound {r['bound_ms']:.4f}, with every pair "
                f"in full {r['bound_all_pairs_ms']:.4f}; {r['kernel']}: {r['registers']} "
                f"registers, {r['shared_bytes']} bytes shared, {r['device_launches']} "
                f"device launch a call by the profiler)")

    log(f"wkb_fly {tag} [n_mp={n}, stored block {T.numel() * 4 / 2**30:.2f} GiB; "
        f"{100 * rec['stats']['ok_share']:.2f} % of the pairs pass |dE| > ctol, "
        f"{100 * rec['stats']['live_share']:.2f} % of the 32 x 32 chunks are not "
        f"skipped]: matvec symmetric {line(rec[True])}, row form {line(rec[False])}, "
        f"plain {rec['plain_ms']:.4f} ms, stored T @ x {rec['library_ms']:.4f} ms, "
        f"max err {max(rec[True]['err'], rec[False]['err']):.3e} = "
        f"{max(rec[True]['err'], rec[False]['err']) / scale:.3e} of the largest entry; "
        f"matmat K={K} in one sweep, {rec['mm']['n_split']} blocks a row tile, "
        f"{line(rec['mm'])} (in groups of 8 columns {rec['mm']['ms_kb8']:.4f} ms), plain "
        f"{rec['mm']['plain_ms']:.4f} ms, stored T @ X {rec['mm']['library_ms']:.4f} ms, "
        f"max err {rec['mm']['err']:.3e} = {rec['mm']['err'] / float(Yref.abs().max()):.3e} "
        f"of the largest entry ({err_plain / float(Yref.abs().max()):.3e} against the plain "
        f"version, {err_stored / float(Yref.abs().max()):.3e} against the stored product, "
        f"from which the plain version itself is "
        f"{plain_vs_stored / float(Yref.abs().max()):.3e}); bit-equal launches")
    return rec


def band_checks(band, n_atoms, ell=None):
    """The band kernel at ``band`` (``build_banded_nb``'s, f32 or bf16
    values) on a seeded window: bit-equal to its plain version (the same
    sums in the same order), timed back to back and with a cold L2 beside
    its bytes bound over the nonzeros (each slot's value and offset, the
    slice starts, the window once, the output), the plain version and
    torch.sparse.mm of the same operator in CSR (f32 values: those of a bf16
    band widened); ``ell`` (nb_vals, nb_safe): also the ELL form of the
    whole neighbour product in f32.  The slots' bytes, the longest row and
    the padding share logged."""
    import torch

    from devicekmc_tpu_torch.ops import banded as bd

    slots = band["slots"]
    R, m_pad, B = slots.shape
    g = torch.Generator(device="cuda").manual_seed(1)
    xa = torch.randn(n_atoms, generator=g, device="cuda")
    xw = torch.zeros((R + m_pad - 1) * B, device="cuda")
    xw[band["front"]:band["front"] + n_atoms] = xa[band["pi"]]
    y = bd.banded_matvec(slots, xw)
    ref = bd.banded_matvec_plain(slots, xw)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y).all()), "banded_matvec: output finite")
    check(torch.equal(y, ref), f"banded_matvec: not bit-equal to its plain version (max "
          f"difference {float((y - ref).abs().max())})")
    # the operator's nonzeros: each row's valid slots, in order, as CSR
    pos, held = bd._rows(slots)
    ok = held & (slots.val[pos] != 0)
    per_row = ok.sum(dim=1)
    nnz = int(per_row.sum())
    rows = torch.arange(R * B, device="cuda")[:, None].expand_as(pos)[ok]
    cols = (rows // B) * B + (slots.off[pos[ok]].long() & 0xFFFF)
    crow = torch.zeros(R * B + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(per_row, 0)
    vals = slots.val[pos[ok]].float()
    csr = torch.sparse_csr_tensor(crow, cols, vals, (R * B, xw.numel()))
    x2 = xw[:, None]
    lib = torch.sparse.mm(csr, x2)[:, 0]
    # f32 sums in another order: within 1e-5 of the largest sum of |terms|
    scale = float(torch.sparse.mm(torch.sparse_csr_tensor(crow, cols, vals.abs(),
                                                          (R * B, xw.numel())),
                                  x2.abs()).max())
    lib_err = float((lib - y).abs().max())
    check(lib_err <= 1e-5 * scale, f"torch.sparse.mm differs from the kernel by {lib_err} "
          f"(scale {scale})")
    vb = slots.val.element_size()
    n_el = slots.off.numel()
    slot_bytes = n_el * (2 + vb) + slots.start.numel() * 4
    bytes_ = nnz * (2 + vb) + slots.start.numel() * 4 + xw.numel() * 4 + R * B * 4
    bound, by = _bound(2 * nnz, bytes_)
    out = dict(
        err=0.0, bound_ms=bound, bound_by=by,
        ms=time_ms(lambda: bd.banded_matvec(slots, xw)),
        cold_ms=time_ms_cold(lambda: bd.banded_matvec(slots, xw)),
        plain_ms=time_ms(lambda: bd.banded_matvec_plain(slots, xw), reps=5, rounds=3),
        library_ms=time_ms(lambda: torch.sparse.mm(csr, x2)),
        library_cold_ms=time_ms_cold(lambda: torch.sparse.mm(csr, x2)),
        library_err=lib_err, nnz=nnz, elements=n_el, slot_bytes=slot_bytes,
        bound_bytes=bytes_, longest_row=int(per_row.max()), pad_share=1 - nnz / max(n_el, 1),
        dense_bytes=R * m_pad * B * B * vb,
        shape=(f"band [{R}, {m_pad}, {B}] {str(slots.val.dtype)[6:]}: {nnz} nonzeros in "
               f"{n_el} slots ({slot_bytes / 2**20:.2f} MiB), f32 vector"))
    if ell is not None:
        nb32, nb_safe = ell
        out["ell_ms"] = time_ms(lambda: (nb32 * xa[nb_safe]).sum(dim=1))
        out["ell_bytes"] = nb32.numel() * 4 + nb_safe.numel() * 8
    if slots.val.dtype == torch.bfloat16:
        # the vector rounded to bf16 (the JAX package's form, which stalls
        # the inner CG) gives another product
        rounded = bd.banded_matvec_plain(slots, xw.to(torch.bfloat16))
        out["err_rounded"] = float((rounded - ref).abs().max())
        check(out["err_rounded"] > 0, "bf16 band: the bf16-rounded vector gives the same "
              "product")
    log(f"banded_matvec {out['shape']}; longest row {out['longest_row']} slots, padding "
        f"{100 * out['pad_share']:.2f} % of the slots (the dense blocks: "
        f"{out['dense_bytes'] / 2**30:.2f} GiB): {out['ms']:.5f} ms back to back, "
        f"{out['cold_ms']:.5f} ms cold L2 (bound {bound:.5f} ms by {by}, "
        f"{bytes_ / 2**20:.2f} MiB), bit-equal to the plain version ({out['plain_ms']:.4f} "
        f"ms); torch.sparse.mm in CSR {out['library_ms']:.5f} ms, cold "
        f"{out['library_cold_ms']:.5f} ms (max difference {lib_err:.3e} of scale "
        f"{scale:.3e})"
        + (f"; the ELL form nb_vals * xa[nb_safe] in f32 ({out['ell_bytes'] / 2**20:.1f} "
           f"MiB): {out['ell_ms']:.4f} ms" if ell is not None else "")
        + (f"; the bf16-rounded vector {out['err_rounded']:.3e} from it"
           if "err_rounded" in out else ""))
    return out


def transport_kernel_checks(sim):
    """The four transport kernels against their plain versions at the
    transport path's shapes: the band built for this structure, the run's
    metal atoms and CB edges, its vacancy bucket."""
    import torch

    from devicekmc_tpu_torch.ops.wkb_window import (
        wkb_window_block, wkb_window_block_plain,
    )
    from devicekmc_tpu_torch.physics import current as cur

    geom, params, state = sim.geom, sim.params, sim.state
    blk = cur.assemble_X_blocks(geom, params, state, band=sim._band)
    env = blk["fly"]["env"]
    out = {}
    out["banded"] = band_checks(sim._band, geom.N_atom,
                                (blk["nb_vals"].float(), blk["nb_safe"]))

    # ---- on-the-fly products at this path's metal set ----
    K = params.coarse_slabs * max(1, params.coarse_yz) ** 2
    mpos, mcb = blk["fly"]["mpos"], blk["fly"]["mcb"]
    out["fly"] = fly_checks(mpos, mcb, env, K, "transport path")
    # a width that is no multiple of the tile, the chunk or the warp, with
    # atoms of both contacts: the first 1,000 and the last 1,001
    rag = torch.cat([torch.arange(1000, device="cuda"),
                     torch.arange(mpos.shape[0] - 1001, mpos.shape[0], device="cuda")])
    out["fly_ragged"] = fly_checks(mpos[rag].contiguous(), mcb[rag].contiguous(), env, K,
                                   "ragged width")

    # ---- window-integral block: the run's vacancy bucket (full assembly),
    # 16 of its live rows (the partial assembly's shape), the bucket against
    # the reference crossbar's metal count ----
    ai = geom.atom_ind.long()
    apos = geom.coords[ai].float()
    acb = state.CB_edge[ai].float()
    vpos, vcb, v_ok = apos[blk["vidx"]].contiguous(), acb[blk["vidx"]].contiguous(), blk["v_ok"]
    live = torch.nonzero(v_ok).reshape(-1)[:16]
    ones = torch.ones(live.numel(), dtype=torch.bool, device="cuda")
    rpos, rcb = reference_metal_set(sim)
    out["window"] = window_checks(vpos, vcb, v_ok, mpos, mcb, env, "run's bucket",
                                  T_vm=blk["T_vm"])
    out["window_partial"] = window_checks(vpos[live].contiguous(), vcb[live].contiguous(),
                                          ones, mpos, mcb, env, "partial assembly's shape")
    out["window_ref"] = window_checks(vpos, vcb, v_ok, rpos, rcb, env, "reference width",
                                      plain_reps=1)
    return out


def window_f64(vpos, vcb, mpos, mcb, env, steps, rows=64):
    """The window block in f64 over the pairs and steps ``steps`` (of
    ``window_steps_plain``) selects: what the f32 versions approximate."""
    import torch

    out = torch.zeros(steps.shape, dtype=torch.float64, device=vpos.device)
    p64, c64 = mpos.double(), mcb.double()
    for r0 in range(0, steps.shape[0], rows):
        nk = steps[r0:r0 + rows]
        d = vpos[r0:r0 + rows, None, :].double() - p64[None]
        if env["pbc"]:
            for a in (1, 2):
                d[..., a] -= torch.round(d[..., a] / env["lattice"][a]) * env["lattice"][a]
        safe = torch.where(nk > 0, (vcb[r0:r0 + rows, None].double() - c64[None]).abs(), 1.0)
        s = env["prefac"] * (d.norm(dim=-1) * 1e-10) / safe
        T = torch.zeros_like(s)
        for k in range(int(nk.max()) if nk.numel() else 0):
            e1 = env["qV0"] + k * env["dE_step"]
            e2p = (e1 - safe).clamp(min=0)
            term = torch.where(e1 - safe == 0, 0.0, torch.exp(s * (e1 ** 1.5 - e2p ** 1.5)))
            T += torch.where(k < nk, term, 0.0)
        out[r0:r0 + rows] = -T
    return out


def window_checks(vpos, vcb, v_ok, mpos, mcb, env, tag, T_vm=None, plain_reps=2):
    """The window block against its plain version (1e-5 of the largest
    entry), rows with v_ok False exact zeros, two calls bit-equal, and with
    ``T_vm`` equal to the block the run assembled; timed beside its
    data-sheet bound, with ptxas's registers and shared bytes, the
    profiler's count of device launches a call, the steps the pairs take and
    the share of the lanes those steps keep busy; and the kernel's and the
    plain version's distance from an f64 evaluation (largest error over the
    largest entry, and the Frobenius norms' ratio)."""
    import torch

    from devicekmc_tpu_torch.ops.wkb_window import (
        window_lane_share, window_steps_plain, wkb_window_block, wkb_window_block_plain,
    )

    T = wkb_window_block(vpos, vcb, v_ok, mpos, mcb, env)
    plain = wkb_window_block_plain(vpos, vcb, v_ok, mpos, mcb, env)
    err = _close(f"window block, {tag}", T, plain, 1e-5)
    check(bool((T[~v_ok] == 0).all()), f"window block, {tag}: v_ok False rows are zero")
    check(torch.equal(T, wkb_window_block(vpos, vcb, v_ok, mpos, mcb, env)),
          f"window block, {tag}: two calls differ")
    if T_vm is not None:
        check(torch.equal(T, T_vm), "window block: differs from the assembled T_vm")
    # the work this data needs: per eligible pair the steps with k*dE < |dE|
    # (every eligible pair takes step 0, since |dE| > ctol >= 0)
    exact = window_steps_plain(vpos, vcb, v_ok, mpos, mcb, env)
    n_steps, n_elig = int(exact.sum()), int((exact > 0).sum())
    n_pairs = T.numel()
    bound, by = _bound(n_steps * WINDOW_OPS_PER_STEP + n_pairs * 25,
                       n_pairs * 4 + (vpos.shape[0] + mpos.shape[0]) * 16)
    t64 = window_f64(vpos, vcb, mpos, mcb, env, exact)
    f64 = {name: (float((X.double() - t64).abs().max() / t64.abs().max()),
                  float((X.double() - t64).norm() / t64.norm()))
           for name, X in (("kernel", T), ("plain", plain))}
    del t64, plain
    rec = dict(
        err=err, rel_err=err / float(T.abs().max()), bound_ms=bound, bound_by=by,
        ms=time_ms(lambda: wkb_window_block(vpos, vcb, v_ok, mpos, mcb, env)),
        plain_ms=time_ms(lambda: wkb_window_block_plain(vpos, vcb, v_ok, mpos, mcb, env),
                         reps=plain_reps, rounds=3, warmup=1),
        steps=n_steps, lane_share=window_lane_share(exact),
        err_f64=f64["kernel"], plain_err_f64=f64["plain"],
        shape=f"[{vpos.shape[0]} ({int(v_ok.sum())} live) x {mpos.shape[0]}], "
              f"{n_elig} eligible pairs, {n_steps} steps in all",
        **kernel_facts("wkb_window", "window_block_kernel", (),
                       lambda: wkb_window_block(vpos, vcb, v_ok, mpos, mcb, env)))
    log(f"wkb_window_block, {tag} {rec['shape']}: {rec['ms']:.4f} ms (data-sheet bound "
        f"{bound:.4f} ms by {by}), plain {rec['plain_ms']:.4f} ms, max err {err:.3e} = "
        f"{rec['rel_err']:.3e} of the largest entry; against f64 the kernel "
        f"{f64['kernel'][0]:.3e} of the largest entry ({f64['kernel'][1]:.3e} in Frobenius "
        f"norm), the plain version {f64['plain'][0]:.3e} ({f64['plain'][1]:.3e}); "
        f"{100 * rec['lane_share']:.2f} % of the issued lane-steps busy; "
        f"{rec['kernel']}: {rec['registers']} registers, {rec['shared_bytes']} bytes "
        f"shared, {rec['device_launches']} device launch a call by the profiler; "
        f"bit-equal calls")
    del exact, T
    torch.cuda.empty_cache()
    return rec


def pdisp_checks(pos, cb, env, tag, plain_reps=5):
    """The dissipation kernel against its plain version and against the
    sweep of the stored block (f64 potentials, as the stored route of the
    main path multiplies), Vd of both signs and 0, PBC off and on, two
    launches bit-equal; timed with this geometry's own PBC flag."""
    import torch

    from devicekmc_tpu_torch.ops.wkb_fly import (
        matvec_col_split, wkb_fly_pdisp, wkb_fly_pdisp_plain,
    )
    from devicekmc_tpu_torch.physics.current import (
        _pdisp_rows_cols, tunnel_block, wkb_single_T,
    )

    n = pos.shape[0]
    g = torch.Generator(device="cuda").manual_seed(n + 1)
    # shifted scaled potentials as the solve makes them: G0 * volts, >= 0
    ms = torch.rand(n, generator=g, device="cuda") * 7.7e-10
    ms64 = ms.double()
    ones = torch.ones(n, dtype=torch.bool, device="cuda")
    own_pbc = bool(env["pbc"])
    rec = dict(err=0.0, rel_err=0.0, n=n)
    for pbc in (own_pbc, not own_pbc):
        e = dict(env, pbc=pbc)
        T = tunnel_block(e, pos, cb, ones, pos, cb, ones, wkb_single_T)
        for Vd in (1.0, -1.0):
            row = wkb_fly_pdisp(pos, cb, ms, Vd, e)
            name = f"fly pdisp {tag} pbc={pbc} Vd={Vd:+.0f}"
            plain = wkb_fly_pdisp_plain(pos, cb, ms, Vd, e)
            err = _close(name, row, plain, 1e-5)
            stored, _ = _pdisp_rows_cols(T, ms64, ms64, Vd)
            err = max(err, _close(name + " vs stored", row.double(), stored, 1e-5))
            check(torch.equal(row, wkb_fly_pdisp(pos, cb, ms, Vd, e)),
                  name + ": two launches differ")
            rec["err"] = max(rec["err"], err)
            # the sums are of order G0^2 * volts^2: the error beside their scale
            rec["rel_err"] = max(rec["rel_err"], err / float(plain.abs().max()))
        zero = wkb_fly_pdisp(pos, cb, ms, 0.0, e)
        torch.cuda.synchronize()
        check(not bool(zero.any()), f"fly pdisp {tag} pbc={pbc}: Vd = 0 is not all zero")
        if pbc == own_pbc:
            rec["stored_sweep_ms"] = time_ms(
                lambda: _pdisp_rows_cols(T, ms64, ms64, 1.0), reps=plain_reps, rounds=3,
                warmup=1)
        del T
    st = fly_pair_stats(cb, env["ctol"])
    # the data-sheet bound counts the work of all n^2 ordered terms, however
    # the kernel computes them
    ops_pair = WKB_OPS_PER_PAIR[own_pbc] + PDISP_EXTRA_OPS
    bound, by = _bound(_wkb_ops(n * n, st["ok"], ops_pair), n * 20 + n * 4)
    S = matvec_col_split(n, torch.cuda.get_device_properties(0).multi_processor_count)
    nc = -(-n // 32)
    rec.update(
        bound_ms=bound, bound_by=by,
        bound_all_pairs_ms=_bound(n * n * ops_pair, n * 20 + n * 4)[0],
        # the upper-triangle 32 x 32 chunks the kernel visits, and the share
        # of them that it skips
        chunks_upper=nc * (nc + 1) // 2,
        skipped_chunk_share=1 - st["live_sym"] / (nc * (nc + 1) // 2),
        **kernel_facts("wkb_fly", "fly_pdisp_tiles", (S,),
                       lambda: wkb_fly_pdisp(pos, cb, ms, 1.0, env)),
        ms=time_ms(lambda: wkb_fly_pdisp(pos, cb, ms, 1.0, env)),
        plain_ms=time_ms(lambda: wkb_fly_pdisp_plain(pos, cb, ms, 1.0, env),
                         reps=plain_reps, rounds=3, warmup=1))
    log(f"wkb_fly_pdisp {tag} [n_mp={n}]: {rec['ms']:.5f} ms (data-sheet bound "
        f"{bound:.5f} ms by {by}, with every pair in full {rec['bound_all_pairs_ms']:.5f}; "
        f"{rec['kernel']}: {rec['registers']} registers, {rec['shared_bytes']} bytes shared, "
        f"{rec['device_launches']} device launch a call by the profiler; "
        f"{100 * rec['skipped_chunk_share']:.2f} % of the {rec['chunks_upper']} "
        f"upper-triangle chunks skipped), plain "
        f"{rec['plain_ms']:.4f} ms, sweep of the stored block "
        f"{rec['stored_sweep_ms']:.4f} ms, max err {rec['err']:.3e} = {rec['rel_err']:.3e} "
        f"of the largest sum (both signs, PBC off "
        f"and on, against the plain version and the stored sweep); bit-equal launches")
    torch.cuda.empty_cache()
    return rec


def reference_metal_set(sim):
    """Positions and CB edges of REF_N_MP of this structure's metal atoms
    (both plate contacts): the reference crossbar's interior-metal count."""
    import torch

    geom = sim.geom
    ai = geom.atom_ind.long()
    metal = geom.metal_mask_table[sim.state.element[ai].long()]
    sel = torch.nonzero(metal).reshape(-1)
    check(sel.numel() >= REF_N_MP, "not enough metal atoms for the reference width")
    # evenly spaced over the metal atoms, so that both contacts take part
    sel = sel[torch.linspace(0, sel.numel() - 1, REF_N_MP, device="cuda").long()]
    pos = geom.coords[ai][sel].float().contiguous()
    cb = sim.state.CB_edge[ai][sel].float().contiguous()
    return pos, cb


def reference_width_fly(sim):
    """The on-the-fly products at the reference crossbar's interior-metal
    count: this structure's metal atoms (both plate contacts) with their CB
    edges, against the 2.45 GB stored block."""
    import torch

    from devicekmc_tpu_torch.physics import current as cur

    geom, params = sim.geom, sim.params
    pos, cb = reference_metal_set(sim)
    K = params.coarse_slabs * max(1, params.coarse_yz) ** 2
    rec = fly_checks(pos, cb, cur.wkb_env(geom, params), K, "reference width",
                     plain_reps=1)
    torch.cuda.empty_cache()
    return rec


def conserved_counts(state):
    """(O + V, d + Od): every event conserves the lattice-oxygen sites and
    the interstitial sites."""
    e = state.element
    return int(((e == 3) | (e == 2)).sum()), int(((e == 0) | (e == 1)).sum())


def headline_path(out_root):
    """Phase 3: kernel checks; the headline run on the captured graph (the
    main path: every superstep one replay and one read) and the same run
    eagerly (the superstep's operations one by one, as every configuration
    outside the graph runs), step for step; both again in turns, timed and
    profiled; then the event kernel against its plain version on the
    crossbar.  Returns the run's records (record_run) and output.txt lines,
    the event phase's time draws, the single kernels' records and the
    graph's numbers (with ``kernel_checks``, ensemble_kernel_checks of the
    batched kernels at the graph's shapes, B = 1)."""
    import torch

    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.state import stack_states

    t0 = time.perf_counter()
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "crossbar"))
    torch.cuda.synchronize()
    g = sim.geom
    log(f"crossbar: N={g.N} sites, max_nn={g.max_nn}, mean_nn="
        f"{float(g.neigh_valid.sum()) / g.N:.2f}, {g.N_atom} atoms; built in "
        f"{time.perf_counter() - t0:.1f} s (neighbour list on the card); "
        f"poisson cap {sim.params.poisson_compact_cap}, active rows cap "
        f"{sim.params.active_rows_cap}")

    gather, poisson = kernel_checks(sim)
    counts0 = conserved_counts(sim.state)
    graph = sim._graph_for(sim.params)
    check(graph is not None, "the headline configuration does not run the captured graph")
    n_steps = WARMUP_STEPS + TIMED_STEPS
    singles = {"ell_gather": eg.ell_gather, "poisson_pairwise": pw.poisson_pairwise,
               "kmc_event_loop": kmc_events.kmc_event_loop}
    batched = {"ell_gather_batched": eg.ell_gather_batched,
               "poisson_pairwise_batched": pw.poisson_pairwise_batched,
               "kmc_event_loop_batched": kmc_events.kmc_event_loop_batched}

    def drive(s, tag):
        """Counters to 0, run_bias_point, read: (records, launches, wall
        s); no plain version may run."""
        for w in (*singles.values(), *batched.values()):
            w.launches = 0
        graph.ws.total.zero_()
        _build.launch_counts("cuda").zero_()
        plains = [_counted(kmc_events, "kmc_event_loop_plain"),
                  _counted(kmc_events, "kmc_event_loop_batched_plain"),
                  _counted(pw, "poisson_pairwise_batched_plain"),
                  _counted(eg, "ell_gather_batched_plain")]
        recs = record_run(s)
        try:
            t = time.perf_counter()
            s.run_bias_point(VD_MAIN, 1e30, max_steps=n_steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        finally:
            stop_recording(s)
            for _, restore in plains:
                restore()
        launches = {name: w.launches for name, w in (*singles.items(), *batched.items())}
        launches["boundary_cg"] = bcg.device_iterations(graph.ws)
        card = card_counts()
        check(all(card[name] == launches[name] for name in batched),
              f"{tag}: launches counted on the host {launches}, on the card {card}")
        check(len(s.step_log) == n_steps, f"{tag}: ran {len(s.step_log)} supersteps")
        check(all(rec["calls"] == 0 for rec, _ in plains), f"{tag}: a plain version ran")
        return recs, launches, wall

    # ---- the main path: the captured graph ----
    recs, launches, wall = drive(sim, "headline graph run")
    steps = sim.step_log
    cg_iters = [int(s["cg_iters_boundary"]) for s in steps]
    check(launches["ell_gather_batched"] == 2 * n_steps
          and launches["poisson_pairwise_batched"] == n_steps
          and launches["kmc_event_loop_batched"] == n_steps,
          f"headline graph run: batched launches {launches} in {n_steps} supersteps")
    check(launches["poisson_pairwise"] == 0 and launches["kmc_event_loop"] == 0,
          f"headline graph run: a single kernel launched in a superstep: {launches}")
    check(launches["boundary_cg"] == sum(cg_iters) > 0,
          f"headline graph run: {launches['boundary_cg']} CG iterations on the card, "
          f"cg_iters_boundary {cg_iters}")
    check(graph.replays == n_steps, f"headline graph run: {graph.replays} replays")

    # ---- the same run eagerly (the eager superstep, make_superstep without a graph) ----
    sim_e = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "crossbar_eager"))
    sim_e._make = engine.make_superstep
    recs_e, launches_e, wall_e = drive(sim_e, "headline eager run")
    check(sim_e._graph is None, "the eager run took the graph")
    check(launches_e["kmc_event_loop"] == n_steps and launches_e["poisson_pairwise"] == n_steps
          and launches_e["ell_gather"] > 0,
          f"headline eager run: single launches {launches_e} in {n_steps} supersteps")
    check(sum(launches_e[k] for k in batched) == 0, "headline eager run: a batched launch")
    same_runs("headline graph against eager", (recs_e, physics_lines(sim_e.cfg.output_dir)),
              (recs, physics_lines(sim.cfg.output_dir)), lines=False)
    cg_e = [int(s["cg_iters_boundary"]) for s in sim_e.step_log]
    check(cg_iters == cg_e, f"cg_iters_boundary {cg_iters} on the graph, {cg_e} eagerly")
    phi_err = max(rel_err(a, b) for a, b in zip(recs.phi, recs_e.phi))
    check(phi_err <= 1e-12, f"headline graph against eager: potentials {phi_err:.3e} of "
          "their scale apart")

    # the batched kernels the graph launches, at its shapes (B = 1, the
    # run's last state), against their plain versions and timed
    b1 = ensemble_kernel_checks(g, sim.params, stack_states([sim.state]))

    st = sim.state
    phi_b, phi_c = st.potential_boundary, st.potential_charge
    check(bool(torch.isfinite(phi_b).all() and torch.isfinite(phi_c).all()),
          "potentials finite")
    check(phi_b.shape == (g.N,) and phi_c.shape == (g.N,), "potential shapes")
    check(float(phi_b.abs().max()) <= VD_MAIN / 2 * (1 + 1e-6),
          "boundary potential within the contact voltages")
    check(conserved_counts(st) == counts0, "O+V and d+Od counts conserved")

    pre = sim.presolve_log[-1]
    log(f"cold deflated boundary pre-solve: {pre['cg_iters']} CG iterations, "
        f"{pre['s'] * 1e3:.1f} ms")
    key = "Z - calculation time - KMC superstep [s]"
    ms = [s[key] * 1e3 for s in steps[WARMUP_STEPS:]]
    ms_e = [s[key] * 1e3 for s in sim_e.step_log[WARMUP_STEPS:]]
    log(f"headline path on the captured graph: run_bias_point (cold deflated pre-solve + "
        f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed supersteps) in {wall:.2f} s "
        f"({graph.captures} captures); eagerly in {wall_e:.2f} s")
    for s, se in zip(steps, sim_e.step_log):
        log(f"  step {s['step']}: graph {s[key] * 1e3:.2f} ms, eager {se[key] * 1e3:.2f} ms, "
            f"events {int(s['n_events'])}, cg_iters_boundary {int(s['cg_iters_boundary'])}, "
            f"n_charged_sites {int(s['n_charged_sites'])}, n_active_rows "
            f"{int(s['n_active_rows'])}, step_time {s['step_time']:.4g} s")
    log(f"timed supersteps: graph median {statistics.median(ms):.2f} ms (min {min(ms):.2f}, "
        f"max {max(ms):.2f}), eager median {statistics.median(ms_e):.2f} ms; events, "
        f"elements and cg_iters_boundary equal step for step, potentials within "
        f"{phi_err:.3e} of their scale; launches, graph run {launches}, eager run "
        f"{launches_e}; kmc_time {sim.state.kmc_time:.4g} s")
    turns = graph_turns(sim, sim_e, {**singles, **batched})

    ev, draws = event_phase(sim.geom, sim.params, sim.state, EVENT_STEPS_CROSSBAR,
                            "crossbar")
    loop = event_loop_timing(sim)
    run = (recs, physics_lines(sim.cfg.output_dir))
    summary = dict(launches_graph=launches, launches_eager=launches_e, median_ms=
                   statistics.median(ms), median_ms_eager=statistics.median(ms_e),
                   phi_err=phi_err, cg_iters=cg_iters, captures=graph.captures,
                   kernel_checks=b1, **turns)
    event_record = {
        "name": "kmc_event_loop", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/kmc_events.cu",
        "replaces": "devicekmc_tpu/physics/events.py:609",
        "launches": launches_e["kmc_event_loop"], "path": "headline, eager superstep",
        "max_abs_err": ev["max_abs_err"],
        "max_rel_err": ev["max_rel_err"], "ms": loop["ms"], "plain_ms": loop["plain_ms"],
        "ms_per_event": loop["ms_per_event"],
        "plain_ms_per_event": loop["plain_ms_per_event"], "bound_ms": loop["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape": loop["shape"],
        "bound_note": "the bytes the events touch, each once; a chain of dependent "
                      "per-event steps bounds the loop, not bytes: latency_bound_ms",
        **{key: loop[key] for key in (
            "latency_bound_ms", "latency_bound_ms_per_event", "l2_ns", "barrier_ns",
            "cap_events", "cap_ms", "cap_ms_per_event")},
        "events_phase_crossbar": {key: ev[key] for key in (
            "table", "events", "ms_per_superstep", "plain_ms_per_superstep",
            "ms_per_event", "plain_ms_per_event", "step_time_bit_equal", "steps")},
    }
    return run, draws, event_record, [
        {
            "name": "ell_gather", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/ell_gather.cu",
            "replaces": "devicekmc_tpu/ops/ell_gather_pallas.py:184",
            "launches": launches_e["ell_gather"], "path": "headline, eager superstep",
            "launches_graph_path": launches["ell_gather"],
            "max_abs_err": max(gather[1]["err"], gather[2]["err"]),
            "ms": gather[2]["ms"], "plain_ms": gather[2]["plain_ms"],
            "bound_ms": gather[2]["bound_ms"], "bound_by": "bytes",
            "library_ms": gather[2]["library_ms"],
            "shape": f"{g.N}x{g.max_nn}, 2 channels",
            "ms_warm": gather[2]["ms_warm"], "ms_warm_1ch": gather[1]["ms_warm"],
            "ms_1ch": gather[1]["ms"], "plain_ms_1ch": gather[1]["plain_ms"],
            "bound_ms_1ch": gather[1]["bound_ms"],
            "library_ms_1ch": gather[1]["library_ms"],
            "x_bandwidth": gather["bandwidth"],
            "slots_per_lane": gather["grid"][2][0], "blocks": gather["grid"][2][1],
            "slots_per_lane_1ch": gather["grid"][1][0], "blocks_1ch": gather["grid"][1][1],
            **{f"{key}{sfx}": gather[c][key] for c, sfx in ((2, ""), (1, "_1ch"))
               for key in ("ms_local", "ms_copy", "ms_copy_warm")},
            "rate_bucket": {"shape": f"{RATE_BUCKET}x{g.max_nn}, 2 channels",
                            **gather["bucket"]},
        },
        {
            "name": "poisson_pairwise", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/pairwise.cu",
            "replaces": "devicekmc_tpu/ops/pairwise_pallas.py:88",
            "launches": launches_e["poisson_pairwise"], "path": "headline, eager superstep",
            "max_abs_err": max(poisson[False]["err"], poisson[True]["err"]),
            "ms": poisson[False]["ms"], "plain_ms": poisson[False]["plain_ms"],
            "bound_ms": poisson[False]["bound_ms"],
            "bound_by": poisson[False]["bound_by"], "library_ms": None,
            "ms_pbc": poisson[True]["ms"], "bound_ms_pbc": poisson[True]["bound_ms"],
            "n_split": poisson[False]["n_split"],
            **{key: poisson[False][key] for key in KERNEL_FACTS},
            "pbc": {key: poisson[True][key] for key in KERNEL_FACTS},
        },
    ], (sim, summary)


def rel_err(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


#: the kernels of the headline paths and of the transport CG by their
#: wrappers' names, and a stem of the name each has in a profiler trace (a
#: record is the kernel's whose stem is the longest it holds: the transport
#: build of cg_update_direction is the pack's)
TRACE_NAMES = {name: f"{name}_kernel" for name in (
    "ell_gather", "ell_gather_batched", "poisson_pairwise", "poisson_pairwise_batched",
    "kmc_event_loop", "kmc_event_loop_batched", "cg_matvec_dot", "cg_update_direction",
    "transport_blocks", "transport_rows", "transport_pack", "transport_refine")}
TRACE_NAMES["cg_update_direction_pack"] = "cg_update_direction_kernel<float, true>"
CG_KERNELS = ("cg_matvec_dot", "cg_update_direction")
#: the transport CG's kernels, each in the trace of a graph superstep that
#: solves
TRANSPORT_TRACED = ("transport_blocks", "transport_rows", "cg_update_direction_pack",
                    "transport_pack", "transport_refine")


def trace_counts(prof):
    """Launches of each kernel of TRACE_NAMES among the device records of a
    torch.profiler trace."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(TRACE_NAMES, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            held = [k for k, stem in TRACE_NAMES.items() if stem in e.name]
            if held:
                out[max(held, key=lambda k: len(TRACE_NAMES[k]))] += 1
    return out


#: profiler sessions a profiled call may take: torch.profiler now and then
#: returns a trace without a single device record, and the call is then
#: profiled again
PROFILE_ATTEMPTS = 3
#: the profiled calls whose trace came back empty and were taken again
empty_traces = []
#: each kernel's launches in the traces of the profiled calls and as counted
#: (witness_launches)
traced = {}


def profile_calls(fn, n, reset=None, before=None):
    """``n`` calls of ``fn`` under torch.profiler: (wall ms, device busy ms,
    device-to-host copies, trace_counts) in all.  ``before()`` runs just
    before the profiler starts; a trace without device records is taken
    again, after ``reset()`` undoes what the calls changed, in at most
    PROFILE_ATTEMPTS sessions; busy, copies and counts None when every one
    came back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(PROFILE_ATTEMPTS):
        if attempt:
            empty_traces.append(getattr(fn, "__name__", "call"))
            if reset is not None:
                reset()
        if before is not None:
            before()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            busy = busy_ms([e for e in dev if not e.name.startswith("Memcpy DtoH")])
            return (wall, busy, sum(e.name.startswith("Memcpy DtoH") for e in dev),
                    trace_counts(prof))
    return wall, None, None, None


def busy_ms(events):
    """The time some device record of ``events`` runs (the union of their
    intervals: kernels on two branches overlap), ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def card_counts():
    """The launches the card has counted of each kernel of
    ``_build.COUNTED_ON_CARD`` (csrc/launch_count.cuh), read."""
    from devicekmc_tpu_torch.ops import _build

    return dict(zip(_build.COUNTED_ON_CARD, _build.launch_counts("cuda").tolist()))


def witness_launches(tag, wrappers, counted, seen, iters=None, card=None):
    """The launches the wrappers counted in a profiled call (``counted``: for
    a replay, its graph's per_replay) against what the card counted in it
    (``card``: equal, for each kernel that counts itself) and the kernels of
    its trace (``seen``, trace_counts: never more often than counted; a trace
    may miss launches, see cg_seen, and traced_totals checks that each kernel
    shows in some); with
    ``iters``, the boundary CG iterations the device counted in it, witnessed
    by the CG kernels in the trace (cg_seen)."""
    check(seen is not None, f"{tag}: a profiler trace came back without device records")
    for name in wrappers:
        if card is not None and name in card:
            check(card[name] == counted[name], f"{tag}: {name} counted {counted[name]} "
                  f"launches on the host, {card[name]} on the card")
        check(seen[name] <= counted[name], f"{tag}: {name} counted {counted[name]} launches, "
              f"the trace shows {seen[name]} (counted {counted}, trace {seen})")
        total = traced.setdefault(name, [0, 0])
        total[0] += seen[name]
        total[1] += counted[name]
    if iters is not None:
        cg_seen(tag, seen, iters)


def traced_totals():
    """Every kernel counted in the profiled calls also seen in their traces
    (traced: launches seen, launches counted); returns the totals."""
    for name, (seen, counted) in traced.items():
        check(seen > 0 or counted == 0, f"{name}: {counted} launches in the profiled calls, "
              "none in their traces")
    return {name: tuple(t) for name, t in traced.items()}


def cg_seen(tag, seen, iters):
    """The two CG kernels in a trace (``seen``) of a call in which the device
    counted ``iters`` iterations: each launched at least once when ``iters``
    > 0, never when it is 0, and at most ``iters`` times.  The trace misses
    some launches: of a captured loop of 46 iterations on an H100 it showed
    43 or 44 of each kernel, in different numbers for each, and of a
    replay of the ensemble's superstep one of its two batched gathers, so
    the device's count stands for the launches.
    Returns each kernel's launches in the trace."""
    n = {k: seen[k] for k in CG_KERNELS}
    check(all((0 < c <= iters) if iters else c == 0 for c in n.values()),
          f"{tag}: {iters} CG iterations on the device, the trace shows {n}")
    return n


def profile_witnessed(tag, fn, wrappers, ws=None, reset=None):
    """One call of ``fn`` under torch.profiler (profile_calls, ``reset`` its
    undo), its kernel launches witnessed by its trace (witness_launches;
    ``ws``: the CG workspace of the graph it replays, captured before the
    profiler started).  Returns profile_calls' tuple and the CG iterations
    the device counted (None without ``ws``)."""
    snap = {}

    def before():
        snap.update({name: w.launches for name, w in wrappers.items()}, card=card_counts())
        if ws is not None:
            ws.total.zero_()

    out = profile_calls(fn, 1, reset=reset, before=before)
    counted = {name: w.launches - snap[name] for name, w in wrappers.items()}
    card = {name: n - snap["card"][name] for name, n in card_counts().items()}
    iters = None if ws is None else int(ws.total)
    witness_launches(tag, wrappers, counted, out[3], iters, card)
    return (*out, iters)


def graph_turns(sim, sim_e, wrappers, turns=GRAPH_TURNS):
    """Phase 3's graph and eager drivers again, superstep by superstep in
    turns from where their runs ended: wall ms of each, events equal; one
    superstep of each under torch.profiler (device busy share, device-to-host
    copies), and one replay of the graph alone (its copies: none); in each
    profiled call the launches the kernel ``wrappers`` count (on the graph:
    its per_replay) equal to the kernels of the trace, and the CG
    iterations the device counts witnessed by it (witness_launches)."""
    import torch

    def step(s):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.state, _, m = s._superstep(s.state, VD_MAIN)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, m

    ms_g, ms_e, prof = [], [], {}
    for _ in range(turns):
        (tg, mg), (te, me) = step(sim), step(sim_e)
        check(mg["n_events"] == me["n_events"] and torch.equal(sim.state.element,
                                                               sim_e.state.element),
              "graph and eager supersteps in turns differ")
        ms_g.append(tg)
        ms_e.append(te)
    graph = sim._graph
    for tag, s in (("graph", sim), ("eager", sim_e), ("graph2", sim), ("eager2", sim_e)):
        prev = s.state
        prof[tag] = profile_witnessed(f"{tag} superstep", lambda: step(s), wrappers,
                                      graph.ws if s is sim else None,
                                      reset=lambda: setattr(s, "state", prev))
    i = graph.load_single(sim.state)
    replay = graph._graph("step", i, VD_MAIN)
    per_replay = {name: replay.per_replay.get(w, 0) for name, w in wrappers.items()}
    card0 = {}
    prof["replay"] = profile_calls(replay, 1, before=lambda: (graph.ws.total.zero_(),
                                                              card0.update(card_counts())))
    iters = int(graph.ws.total)
    witness_launches("a replay alone", wrappers, per_replay, prof["replay"][3], iters,
                     {name: n - card0[name] for name, n in card_counts().items()})
    out = {"trace_per_replay": {name: prof["replay"][3][name] for name in
                                (*wrappers, *CG_KERNELS)},
           "graph_per_replay": per_replay, "cg_iters_traced_replay": iters,
           "cg_iters_traced_supersteps": [prof["graph"][4], prof["graph2"][4]]}
    for tag in ("graph", "eager"):
        runs = [prof[tag], prof[f"{tag}2"]]
        check(all(p[1] is not None for p in runs),
              f"{tag}: a profiler trace came back without device records")
        out[f"busy_{tag}"] = [100 * p[1] / p[0] for p in runs]
        out[f"dtoh_{tag}"] = [p[2] for p in runs]
    out["dtoh_replay"] = prof["replay"][2]
    check(out["dtoh_graph"] == [1, 1], f"graph superstep: {out['dtoh_graph']} device-to-host "
          "copies, not 1")
    check(out["dtoh_replay"] == 0, f"a replay alone: {out['dtoh_replay']} device-to-host "
          "copies")
    out.update(ms_turns_graph=ms_g, ms_turns_eager=ms_e,
               median_turns_graph=statistics.median(ms_g),
               median_turns_eager=statistics.median(ms_e))
    log(f"in turns, {turns} supersteps each: graph median {out['median_turns_graph']:.2f} ms "
        f"({[round(x, 2) for x in ms_g]}), eager median {out['median_turns_eager']:.2f} ms "
        f"({[round(x, 2) for x in ms_e]}); device busy (one profiled superstep each, twice) "
        f"graph {[round(x, 1) for x in out['busy_graph']]} %, eager "
        f"{[round(x, 1) for x in out['busy_eager']]} %; device-to-host copies a superstep "
        f"graph {out['dtoh_graph']}, eager {out['dtoh_eager']}, a replay alone "
        f"{out['dtoh_replay']}; kernels in the trace of a replay alone "
        f"{out['trace_per_replay']} (its graph's per_replay {per_replay}, {iters} CG "
        f"iterations on the device); in each profiled call the card's own launch counts "
        f"equal to the wrappers' (CG iterations of the profiled graph supersteps: "
        f"{out['cg_iters_traced_supersteps']})")
    return out


# ---------------------------------------------------------------------------
# the transport and heat supersteps as captured graphs
# ---------------------------------------------------------------------------

# supersteps of the transport graph and the eager driver in turns after the
# runs
TRANSPORT_TURNS = 3
# the second bias point the transport graph is captured at
VD_SECOND = 1.05
#: the transport CG's kernels that count their launches on the card
TRANSPORT_CARD = ("banded_matvec_out", "wkb_fly_matvec_out", "transport_pack",
                  "transport_blocks", "transport_rows", "transport_refine",
                  "cg_update_direction_pack")


def transport_record(sim):
    """Wrap ``sim``'s superstep: per step the fields the transport and heat
    phases write (device copies) and the metrics.  Returns the list."""
    recs = []
    step = sim._superstep

    def wrapped(state, Vd, *rest):
        out = step(state, Vd, *rest)
        st, m = out[0], out[2]
        recs.append(dict(
            element=st.element.clone(), vp=st.virtual_potentials.clone(),
            tt=(st.tt_slot_atom.clone(), st.tt_vm.clone(), st.tt_vv.clone()),
            power=st.power.clone(), step_time=out[1],
            scalars=(st.I_macro, st.P_tot, st.T_bg, bool(st.tt_valid)),
            metrics={k: float(v) for k, v in m.items() if not k.startswith("Z - ")}))
        return out

    sim._superstep = wrapped
    return recs


def same_transport_steps(tag, ref, got):
    """Two transport runs (transport_record) bit for bit, step for step: the
    events, elements, cg_iters_power, I_macro, P_tot, T_bg, the virtual
    potentials, the site power and the tunnel store, every metric."""
    import torch

    check(len(ref) == len(got), f"{tag}: {len(ref)} and {len(got)} supersteps")
    for k, (a, b) in enumerate(zip(ref, got)):
        diff = [key for key in ("element", "vp", "power") if not torch.equal(a[key], b[key])]
        if not all(torch.equal(u, v) for u, v in zip(a["tt"], b["tt"])):
            diff.append("the tunnel store")
        if a["scalars"] != b["scalars"] or a["step_time"] != b["step_time"]:
            diff.append(f"scalars {a['scalars']} against {b['scalars']}")
        metrics = {key: (v, b["metrics"].get(key)) for key, v in a["metrics"].items()
                   if v != b["metrics"].get(key)}
        check(not diff and not metrics, f"{tag}: step {k}: {diff} differ; metrics {metrics}")


def transport_graph_run(sim, tag, n_steps=TRANSPORT_STEPS, wrappers=None):
    """Counters to 0, ``sim.run_bias_point`` (cold solves + ``n_steps``),
    read: (records, card counts, wrapper counts, wall s).  No plain version
    of a transport CG kernel may run."""
    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    wrappers = wrappers or {}
    for w in wrappers.values():
        w.launches = 0
    _build.launch_counts("cuda").zero_()
    plains = [_counted(tcg, name) for name in ("pack_plain", "blocks_plain", "rows_plain",
                                               "update_pack_plain", "refine_plain")]
    recs = transport_record(sim)
    try:
        t = time.perf_counter()
        sim.run_bias_point(VD_MAIN, 1e30, max_steps=n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sim.__dict__.pop("_superstep", None)
        for _, restore in plains:
            restore()
    check(all(rec["calls"] == 0 for rec, _ in plains), f"{tag}: a plain version ran")
    check(len(recs) == n_steps, f"{tag}: ran {len(recs)} supersteps")
    return recs, card_counts(), {name: w.launches for name, w in wrappers.items()}, wall


def transport_turns(sim, sim_e, tag, turns=TRANSPORT_TURNS):
    """The graph and the eager driver again, superstep by superstep in turns
    (elements, I_macro and the virtual potentials equal): wall ms of each;
    one superstep of each under torch.profiler (device busy share,
    device-to-host copies: 1 a graph superstep)."""
    import torch

    def step(s):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.state, _, m = s._superstep(s.state, VD_MAIN)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, m

    ms_g, ms_e = [], []
    for _ in range(turns):
        (tg, mg), (te, me) = step(sim), step(sim_e)
        check(torch.equal(sim.state.element, sim_e.state.element)
              and sim.state.I_macro == sim_e.state.I_macro
              and torch.equal(sim.state.virtual_potentials, sim_e.state.virtual_potentials)
              and mg["cg_iters_power"] == me["cg_iters_power"],
              f"{tag}: graph and eager supersteps in turns differ")
        ms_g.append(tg)
        ms_e.append(te)
    prof, inner = {}, {}
    for name, s in (("graph", sim), ("eager", sim_e)):
        prev = s.state
        prof[name] = profile_calls(lambda: inner.__setitem__(name, step(s)[1]), 1,
                                   reset=lambda: setattr(s, "state", prev))
        check(prof[name][1] is not None, f"{tag} {name}: a trace without device records")
        inner[name] = int(inner[name]["cg_iters_power"])
    check(prof["graph"][2] == 1, f"{tag}: {prof['graph'][2]} device-to-host copies a graph "
          "superstep, not 1")
    # the kernels of the graph's nested WHILE bodies in its trace
    seen = {k: prof["graph"][3][k] for k in TRANSPORT_TRACED}
    check(inner["graph"] == 0 or all(seen.values()), f"{tag}: the trace of a graph "
          f"superstep of {inner['graph']} inner iterations shows {seen}")
    out = dict(ms_turns_graph=ms_g, ms_turns_eager=ms_e,
               median_turns_graph=statistics.median(ms_g),
               median_turns_eager=statistics.median(ms_e),
               busy_graph=100 * prof["graph"][1] / prof["graph"][0],
               busy_eager=100 * prof["eager"][1] / prof["eager"][0],
               dtoh_graph=prof["graph"][2], dtoh_eager=prof["eager"][2],
               traced_graph=dict(seen, inner_iterations=inner["graph"]))
    log(f"{tag} in turns, {turns} supersteps each: graph median "
        f"{out['median_turns_graph']:.2f} ms ({[round(x, 2) for x in ms_g]}), eager median "
        f"{out['median_turns_eager']:.2f} ms ({[round(x, 2) for x in ms_e]}); one profiled "
        f"superstep each: device busy graph {out['busy_graph']:.1f} %, eager "
        f"{out['busy_eager']:.1f} %; device-to-host copies graph {out['dtoh_graph']}, eager "
        f"{out['dtoh_eager']}; the transport CG's kernels in the graph superstep's trace "
        f"{out['traced_graph']}")
    return out


def transport_graph_phase(out_root, heat, eager_run, second_point=True):
    """The main path of the transport (``heat`` False) or heat (global)
    configuration: the captured graph, counters set to 0 just before cold
    solves + TRANSPORT_STEPS supersteps and read just after, then held bit
    for bit step for step against ``eager_run`` (``(sim_e, records)``, the
    eager driver's run of the same configuration), the two in turns, and
    with ``second_point`` the graph captured at a second bias point.  Returns
    (sim, summary)."""
    import torch

    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.ops import pairwise as pw

    tag = "heat (global) graph" if heat else "transport graph"
    # the memory this run holds once built and the most it allocates while
    # it runs, beyond what was live before it (the eager run's)
    before = torch.cuda.memory_allocated()
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(
        out_root, "heat_graph" if heat else "transport_graph"), current=True,
        heat="global" if heat else None)
    built_gib = (torch.cuda.memory_allocated() - before) / 2**30
    torch.cuda.reset_peak_memory_stats()
    check(sim._graph_for(sim.params) is not None,
          f"{tag}: the configuration does not run the captured graph")
    batched = {"ell_gather_batched": eg.ell_gather_batched,
               "poisson_pairwise_batched": pw.poisson_pairwise_batched,
               "kmc_event_loop_batched": kmc_events.kmc_event_loop_batched}
    recs, card, host, wall = transport_graph_run(sim, tag, wrappers=batched)
    peak_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    graph = sim._graph
    n = TRANSPORT_STEPS
    check(graph.replays == n and graph.captures == 2,
          f"{tag}: {graph.replays} replays, {graph.captures} captures")
    check(card["ell_gather_batched"] == 2 * n and card["poisson_pairwise_batched"] == n
          and card["kmc_event_loop_batched"] == n, f"{tag}: batched launches {card}")
    for name in TRANSPORT_CARD:
        check(card[name] > 0, f"{tag}: {name} was not launched on the card ({card})")
    steps = sim.step_log
    inner = sum(int(s["cg_iters_power"]) for s in steps)
    # the inner body launches no pack: the f64 pack, the fly matvec's extra
    # launches and the rows' and blocks' come from the round ends (one a
    # refine), the update and the band from the inner iterations
    ends = card["transport_refine"]
    check(card["transport_pack"] == ends and card["cg_update_direction_pack"] == inner
          and card["banded_matvec_out"] == inner
          and card["transport_blocks"] == card["transport_rows"] == inner + ends
          and card["wkb_fly_matvec_out"] == inner + ends,
          f"{tag}: launches on the card {card} against {inner} inner iterations and {ends} "
          "round ends")
    rounds = sum(int(s["cg_iters_power"] > 0) for s in steps)
    check(all(s["transport_converged"] == 1.0 for s in steps), f"{tag}: a solve did not "
          "converge")
    sim_e, recs_e = eager_run
    same_transport_steps(f"{tag} against eager", recs_e, recs)
    turns = transport_turns(sim, sim_e, tag)
    first = list(graph.capture_s)
    t = time.perf_counter()
    if second_point:
        sim.run_bias_point(VD_SECOND, 1e30, max_steps=2)
        torch.cuda.synchronize()
    second = graph.capture_s[len(first):]
    check(len(second) == (2 if second_point else 0),
          f"{tag}: {len(second)} captures at the second bias point")
    key = "Z - calculation time - KMC superstep [s]"
    ms = [s[key] * 1e3 for s in steps[2:]]
    ms_e = [s[key] * 1e3 for s in sim_e.step_log[2:n]]
    log(f"{tag}: run_bias_point (cold solves + {n} supersteps) in {wall:.2f} s on the graph "
        f"({graph.captures} captures of {[round(x, 3) for x in first]} s; at {VD_SECOND} V "
        f"{[round(x, 3) for x in second]} s, that bias point in {time.perf_counter() - t:.2f} "
        f"s); launches on the card {card}; {inner} inner CG iterations in {n} supersteps; "
        f"memory held once built {built_gib:.3f} GiB, the most while it ran {peak_gib:.3f} "
        f"GiB; "
        f"events, elements, cg_iters_power, I_macro, P_tot, T_bg, the virtual potentials, "
        f"the site power and the tunnel store equal to the eager run step for step")
    log(f"{tag} supersteps after 2: graph median {statistics.median(ms):.2f} ms (min "
        f"{min(ms):.2f}, max {max(ms):.2f}), eager median {statistics.median(ms_e):.2f} ms; "
        "step by step (graph / eager ms, inner iterations): "
        + ", ".join(f"{a[key] * 1e3:.1f} / {b[key] * 1e3:.1f} ({int(a['cg_iters_power'])})"
                    for a, b in zip(steps, sim_e.step_log[:n])))
    return sim, dict(wall_s=wall, captures_first_s=first, captures_second_s=second,
                     launches_card=card, launches_host=host, inner_iterations=inner,
                     solving_steps=rounds, built_gib=built_gib, peak_gib=peak_gib,
                     median_ms=statistics.median(ms),
                     median_ms_eager=statistics.median(ms_e), **turns)


def transport_operator(sim, seed=13):
    """The transport CG's workspace and operator of ``sim``'s state (the
    solve of a changed bias: no unchanged-network skip), a seeded inner
    direction and correction set in the workspace: (tws, op, the solve's
    warm start, the generator after those draws)."""
    import torch

    from devicekmc_tpu_torch.physics import current as cur

    cap = {}
    solve = cur.transport_cg.solve

    def grab(tws, op, x0, go, tol, maxiter, max_outer=40):
        cap.update(tws=tws, op=op, x0=x0.clone())
        return solve(tws, op, x0, go, tol, maxiter, max_outer)

    cur.transport_cg.solve = grab
    try:
        st = dataclasses.replace(sim.state, transport_Vd_prev=float("nan"))
        cur.update_power(sim.geom, sim.params, st, VD_MAIN, cc=dict(sim._cc), allow_skip=True)
    finally:
        cur.transport_cg.solve = solve
    tws, op = cap["tws"], cap["op"]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nsub = tws.x.shape[0]
    tws.cg.p[0].copy_(torch.randn(nsub, generator=gen).float())
    tws.cg.x[0].copy_(torch.randn(nsub, generator=gen).float())
    tws.cg.act.fill_(True)
    tws.x.copy_(cap["x0"])
    tws.scale.fill_(1e-3)
    tws.go.fill_(True)
    tws.thresh.fill_(1e-30)
    return tws, op, cap["x0"], gen


def transport_cg_checks(sim, band):
    """The transport CG's kernels at the path's shapes (``sim``'s operator
    after its run, a seeded inner direction and correction) against their
    plain versions (PyTorch operations on the same tensors), timed beside
    their bytes bounds; the update and pack against the boundary build of
    cg_update_direction (bit-equal) and its pack against pack_plain of the
    new direction (bit-equal); the band's and the fly matvec's out= entries
    against their allocating entries (bit-equal); the band alone against the
    band with its branch (fly, transport_blocks) and whole inner iterations,
    captured; the warm solve captured and from the host loop."""
    import torch

    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.banded import banded_matvec, banded_matvec_out
    from devicekmc_tpu_torch.ops.graph import Graph, device_while
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec, wkb_fly_matvec_out

    tws, op, x0_solve, gen = transport_operator(sim)
    nsub = tws.x.shape[0]
    na, max_nn = op.anb.shape
    vcap, n_mp = op.T_vm.shape
    nv = int(op.n_vac)
    R, m_pad, B = tws.shape
    nfull = nsub + 1
    # what the functions must read of the sparse inputs: the virtual rows'
    # nonzero ranges (gnd on atoms gnd_lo .. na - 1, src on 0 .. nsi - 1), the
    # valid slots of the atom graph (ELL rows of max_nn slots, pad -1) and of
    # the live vacancies' rows (the bump)
    dots_terms = (na - op.gnd_lo) + op.nsi
    nnz = int((op.anb >= 0).sum())
    nnz_vac = int((op.anb[op.vidx[:nv].long()] >= 0).sum())
    f4, f8, i4 = 4, 8, 4

    def clone(ws):
        kw = {}
        for f in dataclasses.fields(ws):
            v = getattr(ws, f.name)
            if f.name == "cg":
                v = dataclasses.replace(v, **{g.name: getattr(v, g.name).clone() for g in
                                              dataclasses.fields(v)
                                              if torch.is_tensor(getattr(v, g.name))})
            elif f.name == "fly":
                v = tuple(t.clone() for t in v)
            elif torch.is_tensor(v):
                v = v.clone()
            kw[f.name] = v
        return type(ws)(**kw)

    def err(a, b):
        return float((a.double() - b.double()).abs().max())

    def timed(name, fn, plain, bound_bytes, e, **extra):
        out[name] = dict(err=e, ms=time_ms(fn), plain_ms=time_ms(plain, reps=5, rounds=3),
                         bound_ms=bound_bytes / PEAK_BYTES_PER_S * 1e3, **extra)

    out = {}
    # the f64 pack: the warm start, and the iterate with the round's
    # correction
    for first in (True, False):
        k, p = clone(tws), clone(tws)
        tcg.pack(k, op, first)
        tcg.pack_plain(p, op, True, first)
        e = max(err(getattr(k, f), getattr(p, f)) for f in ("xs64", "xm", "x"))
        check(e == 0, f"transport_pack (first={first}): {e} from its plain version")
    # timed on the warm start (first: no inner x read, x not written)
    timed("pack", lambda: tcg.pack(k, op, True), lambda: tcg.pack_plain(p, op, True, True),
          f8 * 2 * nsub + f8 * nfull + i4 * na + f4 * n_mp, 0.0)
    # the band's and the fly matvec's out= entries, at the path's shapes
    k = clone(tws)
    tcg.pack_plain(k, op, False)
    y = torch.empty(R * B, dtype=torch.float32, device="cuda")
    banded_matvec_out(band["slots"], k.xw, y)
    check(torch.equal(y, banded_matvec(band["slots"], k.xw)),
          "banded_matvec_out differs from banded_matvec")
    yc = torch.empty(n_mp, dtype=torch.float32, device="cuda")
    wkb_fly_matvec_out(op.mpos, op.mcb, k.xm, op.env, yc, k.fly)
    check(torch.equal(yc, wkb_fly_matvec(op.mpos, op.mcb, k.xm, op.env)),
          "wkb_fly_matvec_out differs from wkb_fly_matvec")
    out["band_out_ms"] = time_ms(lambda: tcg.band(k, op))
    out["fly_out_ms"] = time_ms(lambda: tcg.fly(k, op))

    # a round's set-up (refine packs its direction) and one inner product
    base = clone(tws)
    tcg.pack(base, op, True)
    tcg.fly(base, op)
    tcg.blocks(base, op, True)
    tcg.rows(base, op, True)
    base.thresh.fill_(float(base.rsum) ** 0.5 * 1e-3)
    k, p = clone(base), clone(base)
    tcg.refine(k, op, True, tcg.MAX_OUTER, 20000)
    tcg.refine_plain(p, op, True, tcg.MAX_OUTER, 20000)
    for f in ("x", "r", "p", "act", "iters", "ctl", "cond"):
        check(torch.equal(getattr(k.cg, f), getattr(p.cg, f)), f"transport_refine: {f} "
              "differs from its plain version")
    for f in ("rnorm", "cond", "xs32", "xw", "xm"):
        check(torch.equal(getattr(k, f), getattr(p, f)),
              f"transport_refine: {f} differs from its plain version")
    e = abs(float(k.cg.rz) - float(p.cg.rz)) / abs(float(p.cg.rz))
    check(e <= 1e-5, f"transport_refine: b_in.b_in {e} relative from its plain version")
    timed("refine", lambda: tcg.refine(k, op, True, tcg.MAX_OUTER, 20000),
          lambda: tcg.refine_plain(p, op, True, tcg.MAX_OUTER, 20000),
          f8 * nsub + 3 * f4 * nsub + f4 * nsub + f4 * nfull + (f4 + 2 * i4) * na + f4 * n_mp, e)
    tcg.refine(base, op, True, tcg.MAX_OUTER, 20000)

    # transport_blocks of the direction (lo) and of the iterate (hi)
    for hi in (False, True):
        k = clone(base)
        if hi:
            tcg.pack(k, op, True)
        p = clone(k)
        tcg.blocks(k, op, hi)
        tcg.blocks_plain(p, op, hi)
        fields = ("mv", "y_vm", "y_vv") + (() if hi else ("y_bump",))
        e = max(err(getattr(k, f)[:nv if f != "mv" else n_mp],
                    getattr(p, f)[:nv if f != "mv" else n_mp]) for f in fields)
        scale = max(float(getattr(p, f).abs().max()) for f in fields)
        dk, dp = (k.dots64, p.dots64) if hi else (k.dots32, p.dots32)
        e_dot = err(dk, dp) / max(float(dp.abs().max()), 1e-300)
        check(e <= 1e-5 * scale and e_dot <= (1e-9 if hi else 1e-5),
              f"transport_blocks ({'hi' if hi else 'lo'}): {e} from its plain version "
              f"(scale {scale}), dots {e_dot} relative")
        w = f8 if hi else f4
        bytes_ = (f4 * nv * n_mp + f4 * nv * nv + f4 * n_mp + (i4 + w) * nv
                  + (0 if hi else (f4 + i4 + w) * nnz_vac) + 2 * w * dots_terms
                  + f4 * (n_mp + 3 * nv) + 2 * w)
        timed(f"blocks_{'hi' if hi else 'lo'}", lambda: tcg.blocks(k, op, hi),
              lambda: tcg.blocks_plain(p, op, hi), bytes_, e, rel_err=e / scale,
              dots_rel_err=e_dot)
    # transport_rows: ap and alpha (lo), r and r.r (hi)
    for hi in (False, True):
        k = clone(base)
        if hi:
            tcg.pack(k, op, True)
        else:
            tcg.band(k, op)
        tcg.fly(k, op)
        tcg.blocks(k, op, hi)
        p = clone(k)
        tcg.rows(k, op, hi)
        tcg.rows_plain(p, op, hi)
        got, ref = (k.r, p.r) if hi else (k.cg.ap[0], p.cg.ap[0])
        scale = float((op.b - ref).abs().max()) if hi else float(ref.abs().max())
        e = err(got, ref)
        check(e <= (1e-9 if hi else 2e-6) * scale,
              f"transport_rows ({'hi' if hi else 'lo'}): {e} from its plain version "
              f"(scale {scale})")
        common = i4 * na * 2 + f4 * n_mp * 2 + f4 * nv * 2
        if hi:
            bytes_ = (common + (f8 + i4) * nnz + f8 * (dots_terms + 2 + 4 * nsub)
                      + f8 * nsub)
        else:
            bytes_ = (common + i4 * na + f4 * na + f4 * nv
                      + f4 * (dots_terms + 2 + 4 * nsub) + f4 * nsub)
        timed(f"rows_{'hi' if hi else 'lo'}", lambda: tcg.rows(k, op, hi),
              lambda: tcg.rows_plain(p, op, hi), bytes_, e, rel_err=e / scale)
    # the update and pack: the boundary build's update bit for bit, and the
    # new direction packed as pack_plain packs it
    tcg.products(base, op)
    tcg.rows(base, op, False)
    k, b, p = clone(base), clone(base), clone(base)
    tcg.update_pack(k, op)
    bcg.cg_update_direction(b.cg, tcg.INNER_MAXITER)
    tcg.update_pack_plain(p, op)
    for f in ("x", "r", "p", "rz", "rr", "beta", "act", "iters", "ctl", "cond"):
        check(torch.equal(getattr(k.cg, f), getattr(b.cg, f)),
              f"cg_update_direction_pack: {f} differs from the boundary build's")
    ref = clone(k)
    tcg.pack_plain(ref, op, False)
    check(all(torch.equal(getattr(k, f), getattr(ref, f)) for f in ("xs32", "xw", "xm")),
          "cg_update_direction_pack: the packed direction differs from pack_plain's")
    e = max(err(getattr(k, f), getattr(p, f)) for f in ("xs32", "xm"))
    scale = float(p.xs32.abs().max())
    check(e <= 1e-5 * scale, f"cg_update_direction_pack: {e} from its plain version "
          f"(scale {scale})")
    k.cg.thresh2.zero_()
    p.cg.thresh2.zero_()
    timed("update_pack", lambda: tcg.update_pack(k, op), lambda: tcg.update_pack_plain(p, op),
          f4 * 8 * nsub + f4 * nsub + f4 * nfull + (f4 + 2 * i4) * na + f4 * n_mp, e,
          rel_err=e / scale, boundary_ms=time_ms(
              lambda: bcg.cg_update_direction(b.cg, tcg.INNER_MAXITER)))

    # the inner body inside a WHILE node, as the solve runs it, from a CG
    # start whose threshold is 0 (INNER_MAXITER iterations a replay): the
    # package's body, the body without the branch (the band, the rows, the
    # update) and every kernel in series
    it = clone(base)
    tcg.refine(it, op, True, tcg.MAX_OUTER, 20000)
    it.cg.thresh2.zero_()
    it.cg.act.fill_(True)
    it.cg.cond.fill_(1)
    start = clone(it)
    bodies = {
        "inner iteration": lambda h, s_: tcg.inner_iteration(it, op, h, s_),
        "without the branch": lambda h, s_: (tcg.band(it, op, s_), tcg.rows(it, op, False, s_),
                                             tcg.update_pack(it, op, h, s_)),
        "in series": lambda h, s_: (tcg.band(it, op, s_), tcg.fly(it, op, s_),
                                    tcg.blocks(it, op, False, s_), tcg.rows(it, op, False, s_),
                                    tcg.update_pack(it, op, h, s_)),
    }

    def loop(body):
        for f in ("x", "r", "p", "rz", "rr", "act", "iters", "ctl", "cond"):
            getattr(it.cg, f).copy_(getattr(start.cg, f))
        for f in ("xs32", "xw", "xm"):
            getattr(it, f).copy_(getattr(start, f))
        device_while(it.cg.cond, body)

    out["body_ms_each"] = {}
    for name, body in bodies.items():
        g = Graph(lambda: loop(body), "cuda")
        it.cg.total.zero_()
        g()
        n_it = int(it.cg.total)
        check(n_it == tcg.INNER_MAXITER, f"the inner body's loop ran {n_it} iterations")
        out["body_ms_each"][name] = time_ms(g, reps=1, rounds=3, warmup=1) / n_it
        del g
    # the whole solve from a perturbed warm start: captured (two nested WHILE
    # nodes) and from the host loop, a replay and a call timed with CUDA
    # events, over the inner iterations the card counted
    x0 = x0_solve * (1 + 1e-3 * torch.randn(x0_solve.shape, generator=gen,
                                            dtype=torch.float64).cuda())
    go = torch.ones(1, dtype=torch.bool, device="cuda")
    tol = sim.params.transport_tol
    solve_g = Graph(lambda: tcg.solve(tws, op, x0, go, tol, 20000), "cuda")

    def timed_solve(fn):
        tws.cg.total.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), int(tws.cg.total), int(tws.it_in), int(tws.it_out)

    runs = {"graph": [timed_solve(solve_g) for _ in range(3)],
            "eager": [timed_solve(lambda: tcg.solve(tws, op, x0, go, tol, 20000))
                      for _ in range(3)]}
    iters = {r[2] for rs in runs.values() for r in rs}
    check(len(iters) == 1, f"the solve's inner iterations differ between runs: {runs}")
    # both divided by the solve's inner iterations; the host loop's chunks
    # also launch iterations past convergence (``overshoot``, run on the
    # card as no-ops)
    out["solve"] = {name: dict(ms=statistics.median(r[0] for r in rs), inner=rs[0][2],
                               rounds=rs[0][3], run_on_card=rs[0][1],
                               overshoot=rs[0][1] - rs[0][2],
                               ms_per_inner=statistics.median(r[0] / r[2] for r in rs))
                    for name, rs in runs.items()}
    sg, se = out["solve"]["graph"], out["solve"]["eager"]
    ce = out["body_ms_each"]
    log(f"the transport solve from a perturbed warm start: {sg['inner']} inner iterations in "
        f"{sg['rounds']} rounds; captured {sg['ms']:.3f} ms ({sg['ms_per_inner']:.4f} ms an "
        f"inner iteration, {sg['overshoot']} launched past convergence), from the host loop "
        f"{se['ms']:.3f} ms ({se['ms_per_inner']:.4f} ms an inner iteration, "
        f"{se['ms'] / sg['ms']:.4f}x the captured solve; {se['overshoot']} iterations launched "
        f"past convergence); an inner iteration inside a WHILE node "
        f"{ce['inner iteration']:.5f} ms, without the branch (fly, transport_blocks) "
        f"{ce['without the branch']:.5f} ms, every kernel in series {ce['in series']:.5f} ms: "
        f"the branch beside the band costs "
        f"{(ce['inner iteration'] - ce['without the branch']) * 1e3:.2f} us, in series "
        f"{(ce['in series'] - ce['without the branch']) * 1e3:.2f} us")
    shape = (f"Nsub={nsub}, n_mp={n_mp}, vacancy bucket {vcap} ({nv} live), "
             f"max_nn={max_nn}, {nnz} valid ELL slots ({nnz / na:.2f} a row; {nnz_vac} on "
             f"the live vacancies' rows), dots of {na - op.gnd_lo} and {op.nsi} terms")
    log(f"transport CG kernels at the path's shapes ({shape}): "
        + "; ".join(f"{name} {r['ms']:.5f} ms (bound {r['bound_ms']:.5f}, plain "
                    f"{r['plain_ms']:.4f}, err {r['err']:.3g})"
                    for name, r in out.items() if isinstance(r, dict) and "bound_ms" in r)
        + f"; the boundary build of cg_update_direction on the same state "
        f"{out['update_pack']['boundary_ms']:.5f} ms; band out= {out['band_out_ms']:.5f} ms, "
        f"fly out= {out['fly_out_ms']:.5f} ms, both bit-equal to their allocating entries")
    out["shape"] = shape
    return out


def transport_cg_records(k, launches):
    """The kernels JSON records of the transport CG's kernels (``k``:
    transport_cg_checks; ``launches``: the card's counts on the main
    path)."""
    src = "devicekmc_tpu_torch/csrc/transport_cg.cu"
    none = "no one PyTorch call computes it"
    recs = []
    for name, key, source, replaces, note in (
            ("transport_blocks", "blocks_lo", src, "devicekmc_tpu/ops/cg.py:112",
             "the products that read the inner direction alone: T_vm x_m, T_vv x_v, "
             "T_vm^T x_v, the bump, the virtual-node dots (f32), beside the band"),
            ("transport_rows", "rows_lo", src, "devicekmc_tpu/ops/cg.py:112",
             "every row of A p after the band, the fly matvec and transport_blocks, p.ap "
             "and alpha (f32)"),
            ("cg_update_direction_pack", "update_pack", "devicekmc_tpu_torch/csrc/boundary_cg.cu",
             "devicekmc_tpu/ops/cg.py:112",
             "the inner CG's update and direction (the transport build of "
             "cg_update_direction), the new direction packed into the band's window and the "
             "metal vector"),
            ("transport_pack", "pack", src, "devicekmc_tpu/ops/cg.py:225",
             "the round's correction of the iterate and its f64 scaled vector"),
            ("transport_refine", "refine", src, "devicekmc_tpu/ops/cg.py:225",
             "the end of a refinement round and the inner set-up, its direction packed")):
        r = k[key]
        rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": "bytes",
               "library_ms": None, "library_none": none, "shape": k["shape"],
               "computes": note}
        hi = {"blocks_lo": "blocks_hi", "rows_lo": "rows_hi"}.get(key)
        if hi:
            rec["f64_build"] = {f: k[hi][f] for f in ("err", "ms", "plain_ms", "bound_ms")}
        if key == "update_pack":
            rec["boundary_build_ms"] = r["boundary_ms"]
        recs.append(rec)
    recs[0]["body_ms_each"] = k["body_ms_each"]
    recs[0]["solve"] = k["solve"]
    return recs


def transport_path(out_root):
    """Phase 4: the transport run, then its kernels' checks; returns the
    four transport kernels' records and every kernel's launches on the
    run."""
    import math

    import torch

    from devicekmc_tpu_torch.ops import cg
    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise
    from devicekmc_tpu_torch.ops.wkb_fly import (
        wkb_fly_matmat, wkb_fly_matvec, wkb_fly_pdisp,
    )
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block
    from devicekmc_tpu_torch.physics import current as cur

    from devicekmc_tpu_torch import engine

    t0 = time.perf_counter()
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "transport"),
                             current=True)
    # the eager driver (the engine's superstep without a graph); the graph
    # run of this configuration, the main path, is transport_graph_phase's
    sim._make = engine.make_superstep
    torch.cuda.synchronize()
    g, p = sim.geom, sim.params
    check(sim._band is not None, "the banded operator was not built")
    log(f"transport crossbar: N={g.N} sites, {g.N_atom} atoms, n_mp="
        f"{g.atom_metalp_idx.shape[0]}, tunnel_vac_cap {p.tunnel_vac_cap}, "
        f"transport_cc {p.transport_cc}, incremental {p.transport_incremental}, band "
        f"{sim._band['slots'].shape}; built in {time.perf_counter() - t0:.1f} s")
    check(p.transport_cc == "fly" and p.transport_incremental, "transport options")
    counts0 = conserved_counts(sim.state)

    # ---- counters to 0, drive, read ----
    wrappers = {"ell_gather": ell_gather, "poisson_pairwise": poisson_pairwise,
                "banded_matvec": banded_matvec, "wkb_fly_matvec": wkb_fly_matvec,
                "wkb_fly_matmat": wkb_fly_matmat, "wkb_window_block": wkb_window_block,
                "wkb_fly_pdisp": wkb_fly_pdisp, "kmc_event_loop": kmc_event_loop}
    # the window block's launches, by shape: an assembly with the store on
    # launches it at the whole bucket and at the transport_delta_cap rows of
    # the atoms that entered it, and selects on the device
    vm_rows = []
    vm_block = cur._vm_block

    def counted_vm_block(env, vpos, *a):
        vm_rows.append(vpos.shape[0])
        return vm_block(env, vpos, *a)

    cur._vm_block = counted_vm_block
    for w in wrappers.values():
        w.launches = 0
    cg.readbacks = 0
    recs_e = transport_record(sim)
    t0 = time.perf_counter()
    try:
        summary = sim.run_bias_point(VD_MAIN, 1e30, max_steps=TRANSPORT_STEPS)
        torch.cuda.synchronize()
    finally:
        cur._vm_block = vm_block
        sim.__dict__.pop("_superstep", None)
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    check(vm_rows == [sim.params.tunnel_vac_cap, p.transport_delta_cap] * (len(vm_rows) // 2)
          and len(vm_rows) == launches["wkb_window_block"],
          f"window block shapes {vm_rows} for {launches['wkb_window_block']} launches: "
          "not the bucket and the delta rows an assembly")
    for name, n in launches.items():
        if name == "wkb_fly_pdisp":
            # the run has no heating: no dissipation sweep
            check(n == 0, f"{name} was launched {n} times on the transport path")
        else:
            check(n > 0, f"{name} was not launched on the transport path")

    steps = sim.step_log
    check(len(steps) == TRANSPORT_STEPS, f"ran {len(steps)} transport supersteps")
    for s in steps:
        check(s["transport_converged"] == 1.0, f"step {s['step']}: transport not converged")
        check(s["tunnel_int_steps_needed"] <= p.tunnel_int_steps,
              f"step {s['step']}: integration steps truncated")
    I = sim.state.I_macro
    check(math.isfinite(I) and I > 0, f"I_macro {I}")
    check(bool(torch.isfinite(sim.state.virtual_potentials).all()), "virtual potentials")
    assembly = [int(s["transport_partial_assembly"]) for s in steps]
    check(any(a != 0 for a in assembly), "no skipped and no incremental assembly seen")
    # which branch each superstep's assembly took (the step's metric)
    assemblies = {name: assembly.count(a) for a, name in ((0, "full"), (1, "partial"),
                                                           (-1, "skipped"))}
    check(conserved_counts(sim.state) == counts0, "O+V and d+Od counts conserved")

    for pre in sim.presolve_log:
        log(f"cold {pre['phase']} solve: {pre['cg_iters']} CG iterations, "
            f"{pre['s'] * 1e3:.1f} ms")
    check(launches["kmc_event_loop"] == len(steps), "kmc_event_loop: one launch a superstep")
    readbacks = cg.readbacks
    log(f"transport path: run_bias_point (CB edge, boundary and deflated transport "
        f"cold solves + {TRANSPORT_STEPS} supersteps) in {wall:.2f} s; "
        f"{readbacks} CG read-backs (stop conditions read in chunks {cg.CHUNKS}; the run "
        f"that reads every iteration is phase 6); launches {launches}; window block: 2 launches "
        f"an assembly (rows {vm_rows[:2]}), {len(vm_rows) // 2} assemblies; supersteps "
        f"{assemblies['full']} full, {assemblies['partial']} partial, {assemblies['skipped']} "
        "skipped")
    for s in steps:
        log(f"  step {s['step']}: {s['Z - calculation time - KMC superstep [s]'] * 1e3:.2f} ms, "
            f"events {int(s['n_events'])}, cg_iters_power {int(s['cg_iters_power'])}, "
            f"rel0 {s['transport_rel0']:.3e}, assembly "
            f"{ {1: 'partial', 0: 'full', -1: 'skipped'}[int(s['transport_partial_assembly'])] }, "
            f"n_vac_atoms {int(s['n_vac_atoms'])}, int steps needed "
            f"{int(s['tunnel_int_steps_needed'])}, Current {s['Current [uA]']:.6g} uA")
    ms = [s["Z - calculation time - KMC superstep [s]"] * 1e3 for s in steps[2:]]
    log(f"transport supersteps after 2: median {statistics.median(ms):.2f} ms, "
        f"min {min(ms):.2f} ms, max {max(ms):.2f} ms; kmc_time {summary['kmc_time']:.4g} s")

    _, graph_summary = transport_graph_phase(out_root, False, (sim, recs_e))
    del recs_e
    torch.cuda.empty_cache()
    tcg_checks = transport_cg_checks(sim, sim._band)
    k = transport_kernel_checks(sim)
    ref = reference_width_fly(sim)
    fly, mm, ref_mm = k["fly"], k["fly"]["mm"], ref["mm"]
    n_mp = int(g.atom_metalp_idx.shape[0])
    facts = ("bound_all_pairs_ms", "kernel", "registers", "shared_bytes", "device_launches")
    pick = lambda r: {key: r[key] for key in facts}
    logs = (sim.presolve_log, sim.step_log[:TRANSPORT_STEPS], readbacks)
    graph_summary["kernel_checks"] = tcg_checks
    return launches, logs, graph_summary, [
        {
            "name": "banded_matvec", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/banded.cu",
            "replaces": "devicekmc_tpu/ops/banded_pallas.py:74",
            "launches": launches["banded_matvec"], "max_abs_err": k["banded"]["err"],
            "ms": k["banded"]["ms"], "plain_ms": k["banded"]["plain_ms"],
            "bound_ms": k["banded"]["bound_ms"], "bound_by": k["banded"]["bound_by"],
            "library_ms": k["banded"]["library_ms"], "library": "torch.sparse.mm (CSR)",
            "shape": k["banded"]["shape"], "ell_form_ms": k["banded"]["ell_ms"],
            **{key: k["banded"][key] for key in (
                "cold_ms", "library_cold_ms", "nnz", "elements", "slot_bytes", "longest_row",
                "pad_share", "dense_bytes")},
            "out_entry": {"launches_graph_run_card": graph_summary["launches_card"][
                "banded_matvec_out"], "ms": tcg_checks["band_out_ms"],
                "bit_equal_to_allocating_entry": True},
        },
        {
            "name": "wkb_fly_matvec", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/wkb_fly.cu",
            "replaces": "devicekmc_tpu/ops/wkb_pallas.py:288",
            "launches": launches["wkb_fly_matvec"],
            "max_abs_err": max(fly[True]["err"], fly[False]["err"]),
            "ms": fly[True]["ms"], "plain_ms": fly["plain_ms"],
            "bound_ms": fly[True]["bound_ms"], "bound_by": fly[True]["bound_by"],
            "library_ms": fly["library_ms"],
            "shape": f"n_mp={n_mp}, symmetric form (the default)",
            "ms_row_form": fly[False]["ms"], "bound_ms_row_form": fly[False]["bound_ms"],
            **pick(fly[True]), "row_form": pick(fly[False]), "pair_stats": fly["stats"],
            "out_entry": {"launches_graph_run_card": graph_summary["launches_card"][
                "wkb_fly_matvec_out"], "ms": tcg_checks["fly_out_ms"],
                "bit_equal_to_allocating_entry": True},
            "ragged_width": {"n_mp": 2001,
                             "max_abs_err": max(k["fly_ragged"][True]["err"],
                                                k["fly_ragged"][False]["err"],
                                                k["fly_ragged"]["mm"]["err"])},
            "ref_width": {
                "n_mp": REF_N_MP, "ms": ref[True]["ms"], "bound_ms": ref[True]["bound_ms"],
                **pick(ref[True]), "row_form": pick(ref[False]), "pair_stats": ref["stats"],
                "ms_row_form": ref[False]["ms"],
                "bound_ms_row_form": ref[False]["bound_ms"],
                "plain_ms": ref["plain_ms"], "library_ms": ref["library_ms"],
                "max_abs_err": max(ref[True]["err"], ref[False]["err"]),
            },
        },
        {
            "name": "wkb_fly_matmat", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/wkb_fly.cu",
            "replaces": "devicekmc_tpu/ops/wkb_pallas.py:345",
            "launches": launches["wkb_fly_matmat"], "max_abs_err": mm["err"],
            "ms": mm["ms"], "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
            "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
            "shape": f"n_mp={n_mp}, K={p.coarse_slabs * max(1, p.coarse_yz) ** 2}, one sweep",
            "ms_kb8": mm["ms_kb8"], "n_split": mm["n_split"], **pick(mm),
            "err_vs_plain": mm["err_plain"], "err_vs_stored": mm["err_stored"],
            "plain_vs_stored": mm["plain_vs_stored"],
            "ref_width": {
                "n_mp": REF_N_MP, "ms": ref_mm["ms"], "ms_kb8": ref_mm["ms_kb8"],
                "n_split": ref_mm["n_split"], **pick(ref_mm),
                "bound_ms": ref_mm["bound_ms"],
                "plain_ms": ref_mm["plain_ms"], "library_ms": ref_mm["library_ms"],
                "max_abs_err": ref_mm["err"], "err_vs_plain": ref_mm["err_plain"],
                "err_vs_stored": ref_mm["err_stored"],
                "plain_vs_stored": ref_mm["plain_vs_stored"],
            },
        },
        {
            "name": "wkb_window_block", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/wkb_window.cu",
            "replaces": "devicekmc_tpu/ops/wkb_pallas.py:482",
            "launches": launches["wkb_window_block"], "max_abs_err": k["window"]["err"],
            "ms": k["window"]["ms"], "plain_ms": k["window"]["plain_ms"],
            "bound_ms": k["window"]["bound_ms"], "bound_by": k["window"]["bound_by"],
            "library_ms": None, "shape": k["window"]["shape"],
            "steps_by_assembly": assemblies,
            **{key: k["window"][key] for key in WINDOW_FACTS},
            "partial": {key: k["window_partial"][key] for key in WINDOW_FACTS + WINDOW_TIMES},
            "ref_width": {"n_mp": REF_N_MP,
                          **{key: k["window_ref"][key] for key in WINDOW_FACTS + WINDOW_TIMES}},
        },
    ]


KERNEL_FACTS = ("kernel", "registers", "shared_bytes", "device_launches")
WINDOW_FACTS = KERNEL_FACTS + ("steps", "lane_share", "rel_err", "err_f64", "plain_err_f64")
WINDOW_TIMES = ("ms", "plain_ms", "bound_ms", "bound_by", "shape")


def _counted(module, name, sync=None):
    """Replace ``module.name`` by a wrapper that counts its calls and, with
    ``sync``, times each between two device synchronizations.  Returns
    ``(record, restore)``."""
    fn = getattr(module, name)
    rec = {"calls": 0, "ms": []}

    def wrapped(*a, **kw):
        rec["calls"] += 1
        if sync is None:
            return fn(*a, **kw)
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(module, name, wrapped)
    return rec, lambda: setattr(module, name, fn)


def heat_run(out_root, model, n_steps, wrappers, device="cuda", n_sites=N_SITES):
    """One run of the heat path on the eager driver: the transport
    configuration with the ``model`` ("global" | "local") heat solver on,
    counters set to 0 just before run_bias_point and read just after.
    Returns the simulation, the launch counts and the steps' records
    (transport_record).  ``device="cpu"`` with a small ``n_sites`` rehearses
    the run without a card (no kernel is launched then, so pass no
    wrappers)."""
    import math

    import torch

    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.physics import current as cur
    from devicekmc_tpu_torch.physics import heat as heat_mod

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    sim = synthetic_crossbar(n_sites, device, os.path.join(out_root, "heat_" + model),
                             current=True, heat=model)
    sim._make = engine.make_superstep
    sync()
    g, p = sim.geom, sim.params
    check(p.transport_cc == "fly" and (p.solve_heating_global if model == "global"
                                       else p.solve_heating_local), "heat options")
    log(f"heat crossbar ({model} model): N={g.N} sites, {g.N_atom} atoms, n_mp="
        f"{g.atom_metalp_idx.shape[0]}, A = {p.A:.6g} m^2"
        + (f", {sim.heat.n_interface} interface sites (spans {sim.heat.n_left}, "
           f"{sim.heat.n_right}), heat_solver {sim.heat.method}" if model == "local" else "")
        + f"; built in {time.perf_counter() - t0:.1f} s")
    counts0 = conserved_counts(sim.state)
    T0 = p.background_temp

    # the transport solves: the cold ones and the warm re-solves' device form
    solves, restore_solves = _counted(cur, "update_power_blocked")
    warm, restore_warm = _counted(cur, "_update_power_warm_device")
    phase, restore_phase = _counted(heat_mod, "update_temperature", sync)
    local_log = []
    recs = transport_record(sim)
    step = sim._superstep

    def stepped(state, Vd):
        out = step(state, Vd)
        local_log.append(dict(heat_mod.last_local))
        return out

    sim._superstep = stepped
    # ---- counters to 0, drive, read ----
    for w in wrappers.values():
        w.launches = 0
    try:
        t0 = time.perf_counter()
        sim.run_bias_point(VD_MAIN, 1e30, max_steps=n_steps)
        sync()
        wall = time.perf_counter() - t0
    finally:
        restore_solves()
        restore_warm()
        restore_phase()
        sim.__dict__.pop("_superstep", None)
    launches = {name: w.launches for name, w in wrappers.items()}
    solves["calls"] += warm["calls"]

    steps = sim.step_log
    check(len(steps) == n_steps == phase["calls"], f"ran {len(steps)} heat supersteps")
    T_prev = T0
    for s in steps:
        check(s["transport_converged"] == 1.0, f"step {s['step']}: transport not converged")
        T = s["Global temperature [K]"]
        check(math.isfinite(T), f"step {s['step']}: T_bg {T}")
        if model == "global":
            check(T >= T_prev >= T0, f"step {s['step']}: T_bg {T} fell under power")
            T_prev = T
        check(math.isfinite(s["Total dissipated power [mW]"]), "P_tot finite")
    st = sim.state
    check(math.isfinite(st.I_macro) and st.I_macro > 0, f"I_macro {st.I_macro}")
    check(math.isfinite(st.P_tot) and st.P_tot > 0, f"P_tot {st.P_tot}")
    check(st.T_bg == steps[-1]["Global temperature [K]"], "T_bg of the state is the logged one")
    # the site power: on non-metal atoms only, and some of them dissipate
    power = st.power
    check(bool(torch.isfinite(power).all()), "site power finite")
    is_atom = torch.zeros(g.N, dtype=torch.bool, device=power.device)
    is_atom[g.atom_ind.long()] = True
    metal = g.metal_mask_table[st.element.long()]
    check(not bool(power[~is_atom | metal].any()),
          "site power is non-zero off the non-metal atoms")
    n_hot = int((power != 0).sum())
    check(n_hot > 0, "site power is zero everywhere")
    check(abs(float(power.sum()) - st.P_tot) <= 1e-9 * abs(st.P_tot), "P_tot is the sum")
    check(bool(torch.isfinite(st.temperature).all()), "temperature field finite")
    check(conserved_counts(st) == counts0, "O+V and d+Od counts conserved")
    # one dissipation launch per transport solve (cold segments included),
    # none on a skipped step
    check(solves["calls"] > 0, "no transport solve ran")
    if wrappers:
        check(launches["wkb_fly_pdisp"] == solves["calls"],
              f"{launches['wkb_fly_pdisp']} dissipation launches for {solves['calls']} solves")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the heat path ({model})")

    for pre in sim.presolve_log:
        log(f"cold {pre['phase']} solve: {pre['cg_iters']} CG iterations, "
            f"{pre['s'] * 1e3:.1f} ms")
    log(f"heat path ({model} model): run_bias_point (cold solves + {n_steps} supersteps) "
        f"in {wall:.2f} s; {solves['calls']} transport solves, launches {launches}; "
        f"{n_hot} sites dissipate")
    for s, ms, ll in zip(steps, phase["ms"], local_log):
        log(f"  step {s['step']}: {s['Z - calculation time - KMC superstep [s]'] * 1e3:.2f} ms "
            f"(heat phase {ms:.3f} ms"
            + (f", {ll['branch']} branch, {ll['substeps']} substeps, {ll['cg_iters']} CG "
               f"iterations" if model == "local" else "")
            + f"), events {int(s['n_events'])}, cg_iters_power {int(s['cg_iters_power'])}, "
            f"step_time {s['step_time']:.4g} s, Current {s['Current [uA]']:.6g} uA, P_tot "
            f"{s['Total dissipated power [mW]']:.6g} mW, T_bg "
            f"{s['Global temperature [K]']:.12g} K")
    if model == "local":
        check(all(ll.get("branch") in ("steady", "transient") for ll in local_log),
              "the local model ran no branch")
        T = st.temperature[sim.heat.interface_idx]
        log(f"  local temperature over the interface sites: min {float(T.min()):.6f} K, "
            f"max {float(T.max()):.6f} K")
    ms = [s["Z - calculation time - KMC superstep [s]"] * 1e3 for s in steps[2:]]
    if ms:
        log(f"heat supersteps ({model}) after 2: median {statistics.median(ms):.2f} ms, "
            f"min {min(ms):.2f} ms, max {max(ms):.2f} ms; heat phase median "
            f"{statistics.median(phase['ms']):.3f} ms")
    return sim, launches, recs


PDISP_FACTS = ("bound_all_pairs_ms", "kernel", "registers", "shared_bytes",
               "device_launches", "chunks_upper", "skipped_chunk_share")


def heat_path(out_root):
    """Phase 5: the heat runs (global, then local), then the dissipation
    kernel's checks; returns every kernel's launches on the global run and
    the new kernel's record."""
    import torch

    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise
    from devicekmc_tpu_torch.ops.wkb_fly import (
        wkb_fly_matmat, wkb_fly_matvec, wkb_fly_pdisp,
    )
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block
    from devicekmc_tpu_torch.physics import current as cur

    wrappers = {"ell_gather": ell_gather, "poisson_pairwise": poisson_pairwise,
                "banded_matvec": banded_matvec, "wkb_fly_matvec": wkb_fly_matvec,
                "wkb_fly_matmat": wkb_fly_matmat, "wkb_window_block": wkb_window_block,
                "wkb_fly_pdisp": wkb_fly_pdisp, "kmc_event_loop": kmc_event_loop}
    sim, launches, recs = heat_run(out_root, "global", HEAT_STEPS, wrappers)
    # the second bias point's captures are phase 4's
    _, graph_summary = transport_graph_phase(out_root, True, (sim, recs),
                                             second_point=False)
    del recs
    torch.cuda.empty_cache()
    blk = cur.assemble_X_blocks(sim.geom, sim.params, sim.state, band=sim._band)
    f = blk["fly"]
    rec = pdisp_checks(f["mpos"], f["mcb"], f["env"], "heat path")
    pos, cb = reference_metal_set(sim)
    ref = pdisp_checks(pos, cb, f["env"], "reference width", plain_reps=1)
    del sim, blk, f
    torch.cuda.empty_cache()

    _, local_launches, _ = heat_run(out_root, "local", LOCAL_HEAT_STEPS, wrappers)
    torch.cuda.empty_cache()
    n_mp = rec["n"]
    return launches, graph_summary, {
        "name": "wkb_fly_pdisp", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/wkb_fly.cu",
        "replaces": "devicekmc_tpu/ops/wkb_pallas.py:383",
        "launches": launches["wkb_fly_pdisp"], "max_abs_err": rec["err"],
        "max_err_of_largest_sum": rec["rel_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "shape": f"n_mp={n_mp}, upper-triangle tiles",
        "stored_sweep_ms": rec["stored_sweep_ms"],
        "launches_local_heat_run": local_launches["wkb_fly_pdisp"],
        **{key: rec[key] for key in PDISP_FACTS},
        "ref_width": {
            "n_mp": REF_N_MP, "ms": ref["ms"], "bound_ms": ref["bound_ms"],
            **{key: ref[key] for key in PDISP_FACTS},
            "plain_ms": ref["plain_ms"], "stored_sweep_ms": ref["stored_sweep_ms"],
            "max_abs_err": ref["err"], "max_err_of_largest_sum": ref["rel_err"],
        },
    }


# ---------------------------------------------------------------------------
# the event loop, the CG stop checks and batched supersteps
# ---------------------------------------------------------------------------

#: successive key splits of the threefry check
THREEFRY_DRAWS = 10_000
#: step_time of the event kernel against its plain version on the same state:
#: an f64 table to 1e-9 relative (CUDA's log and the sums' order move the last
#: bits), an f32 table to 2 f32 ulps (its log in f32, psum in another order)
EVENT_TOL = {"f64": 1e-9, "f32": 2.4e-7}
#: supersteps of the event-kernel phase on the small stack and the crossbar
EVENT_STEPS_SMALL, EVENT_STEPS_CROSSBAR = 6, 3
#: batch of the batched runs
BATCH_STEPS = 4


def threefry_check():
    """The kernel's random stream (csrc/threefry.cuh) against rng.py:
    THREEFRY_DRAWS successive ``split(key, 3)`` and the f64 and f32 draws of
    k_sel and k_time, bit for bit.  Returns the time draws (f32, f64) for
    the log check."""
    import numpy as np

    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import threefry_draws

    t0 = time.perf_counter()
    key = rng.prng_key(7)
    keys, u64, u32 = threefry_draws(key, THREEFRY_DRAWS)
    keys, u64, u32 = keys.tolist(), u64.tolist(), u32.tolist()
    for e in range(THREEFRY_DRAWS):
        key, k_sel, k_time = rng.split(key, 3)
        check(tuple(keys[e]) == key, f"threefry: key {e} differs")
        check(u64[e] == [rng.uniform(k_sel, np.float64), rng.uniform(k_time, np.float64)],
              f"threefry: f64 draws {e} differ")
        check(u32[e] == [rng.uniform(k_sel, np.float32), rng.uniform(k_time, np.float32)],
              f"threefry: f32 draws {e} differ")
    log(f"threefry: {THREEFRY_DRAWS} successive splits and the f64 and f32 draws of "
        f"k_sel and k_time bit-equal to rng.py ({time.perf_counter() - t0:.1f} s)")
    return [r[1] for r in u32], [r[1] for r in u64]


def time_log_check(u32, u64):
    """The kernel takes the log of the time draw as (float)log((double)u)
    for an f32 table and log(u) for an f64 one, with CUDA's log (the one
    torch.log calls on the card); the plain version takes numpy's f64 log,
    rounded to f32 for an f32 table (``ops.kmc_events.time_draw``).  Returns
    {table type: (draws whose logs differ, draws, the largest difference in
    ulps)}, and under "f32 numpy" the same for numpy's own f32 log, which
    the plain version avoids."""
    import numpy as np
    import torch

    from devicekmc_tpu_torch.ops.kmc_events import time_draw

    a32, a64 = np.asarray(u32, np.float32), np.asarray(u64, np.float64)
    card32 = torch.log(torch.as_tensor(a32, dtype=torch.float64, device="cuda")
                       ).float().cpu().numpy()
    card64 = torch.log(torch.as_tensor(a64, device="cuda")).cpu().numpy()
    with np.errstate(divide="ignore"):
        # -log(u) / 1 in the table's type is the plain version's log, negated
        plain = lambda a, dt: -np.array([time_draw(dt, dt, u, 1.0) for u in a],
                                        dtype=a.dtype)
        host32 = plain(a32, torch.float32)
        host64 = plain(a64, torch.float64)
        numpy32 = np.log(a32)

    def diff(a, b):
        # logs of draws in (0, 1) are negative: as integers, their bits are
        # ordered, and the distance counts ulps (-inf of a zero draw: 0)
        ints = np.int32 if a.dtype == np.float32 else np.int64
        d = np.abs(a.view(ints).astype(np.int64) - b.view(ints).astype(np.int64))
        return int((d != 0).sum()), a.size, int(d.max(initial=0))

    return {"f32": diff(card32, host32), "f64": diff(card64, host64),
            "f32 numpy": diff(card32, numpy32)}


def event_phase(geom, params, state, n_steps, tag):
    """The event loop on the card against its plain version (the host loop,
    on the card too): ``n_steps`` supersteps in a row from ``state``, each
    from the kernel's result, both ways from the same state: events,
    elements, charges, keys and n_active equal, step_time within EVENT_TOL.
    Times each way the whole events phase (rate table, sums, loop, the
    read-back) with the host clock between device synchronizations.  Returns
    the record and the time draws of the events, for the log check."""
    import math

    import numpy as np
    import torch

    from devicekmc_tpu_torch import rng
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop_plain
    from devicekmc_tpu_torch.physics.events import execute_superstep_incremental

    kind = "f32" if params.mixed or params.dtype == torch.float32 else "f64"

    def timed(**kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = execute_superstep_incremental(geom, params, state, **kw)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    rec = dict(table=kind, steps=n_steps, events=[], ms=[], plain_ms=[], max_rel_err=0.0,
               max_abs_err=0.0, step_time_bit_equal=0)
    draws = []
    for k in range(n_steps):
        got, ms = timed()
        ref, plain_ms = timed(event_loop=kmc_event_loop_plain)
        what = f"{tag} superstep {k}"
        check(got.n_events == ref.n_events, f"{what}: events {got.n_events} vs {ref.n_events}")
        check(torch.equal(got.state.element, ref.state.element), f"{what}: elements differ")
        check(torch.equal(got.state.charge, ref.state.charge), f"{what}: charges differ")
        check(got.state.key == ref.state.key, f"{what}: keys differ")
        check(got.n_active == ref.n_active, f"{what}: n_active differs")
        if math.isinf(ref.step_time):
            check(got.step_time == ref.step_time, f"{what}: step_time {got.step_time}")
        else:
            err = abs(got.step_time - ref.step_time)
            rel = err / abs(ref.step_time)
            check(rel <= EVENT_TOL[kind], f"{what}: step_time {got.step_time} vs "
                  f"{ref.step_time} ({rel:.3e} relative)")
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["max_rel_err"] = max(rec["max_rel_err"], rel)
        rec["step_time_bit_equal"] += got.step_time == ref.step_time
        key = state.key
        for _ in range(got.n_events):
            key, _, k_time = rng.split(key, 3)
            draws.append(rng.uniform(k_time, np.float32 if kind == "f32" else np.float64))
        rec["events"].append(got.n_events)
        rec["ms"].append(ms)
        rec["plain_ms"].append(plain_ms)
        state = got.state
    n_ev = max(sum(rec["events"]), 1)
    rec.update(ms_per_superstep=statistics.median(rec["ms"]),
               plain_ms_per_superstep=statistics.median(rec["plain_ms"]),
               ms_per_event=sum(rec["ms"]) / n_ev, plain_ms_per_event=sum(rec["plain_ms"]) / n_ev)
    log(f"event kernel ({tag}, {kind} table, {n_steps} supersteps from one state): events "
        f"{rec['events']} equal both ways, elements, charges, keys equal; step_time max "
        f"{rec['max_rel_err']:.3e} relative ({rec['step_time_bit_equal']} of {n_steps} "
        f"bit-equal); events phase {rec['ms_per_superstep']:.3f} ms a superstep, "
        f"{rec['ms_per_event']:.4f} ms an event (plain host loop "
        f"{rec['plain_ms_per_superstep']:.3f} ms, {rec['plain_ms_per_event']:.4f} ms)")
    return rec, draws


def event_loop_bytes(events, n_blocks, m, table_bytes):
    """Bytes the events of one superstep must move, each once: per event
    the block sums the selection scans (n_blocks f64), one block's row sums
    (128 f64) and the chosen row (m entries); the neighbour and reverse-slot
    rows of i and j (4m int32); the 2m+2 touched rows of m entries, read for
    their sums; their row and block sums written (2 (2m+2) f64)."""
    per = (8 * n_blocks + 8 * 128 + m * table_bytes + 16 * m
           + (2 * m + 2) * m * table_bytes + 16 * (2 * m + 2))
    return events * per


#: dependent round trips to L2 and barriers that one event of the loop cannot
#: avoid: the chosen block's row sums, the chosen row (with its site), the
#: site's neighbour row (j), j's neighbour row, the rows of those neighbours,
#: the touched rows' entries for their new sums; a barrier after the
#: selection and one before the next (csrc/kmc_events.cu)
EVENT_ROUND_TRIPS, EVENT_BARRIERS = 6, 2
#: the cap of the loop's timed launch with no time window
EVENT_CAP = 200


def event_latency_bound_ms(events, l2_ns, barrier_ns):
    """The least time of ``events`` events as a chain: each its
    EVENT_ROUND_TRIPS L2 round trips and EVENT_BARRIERS barriers at the
    latencies measured on this card (latencies)."""
    return events * (EVENT_ROUND_TRIPS * l2_ns + EVENT_BARRIERS * barrier_ns) * 1e-6


def event_loop_timing(sim, reps=20, plain_reps=3):
    """The loop alone on the table of ``sim``'s state: the kernel between
    CUDA events (the stream held busy first, the scratch inputs cloned
    before, outside the events), at the path's time window and with
    EVENT_CAP events and no window; the plain version with the host clock
    between synchronizations; the bytes bound from event_loop_bytes and the
    latency bound from the load and barrier latencies measured here
    (latencies)."""
    import torch

    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop, kmc_event_loop_plain
    from devicekmc_tpu_torch.physics.events import incremental_tables

    geom, params, state = sim.geom, sim.params, sim.state
    prob, row_sums, block_sums, aidx, inv, _ = incremental_tables(geom, params, state)
    n_rows, m = prob.shape
    n_blocks = block_sums.shape[0]

    def args(window=1.0 / params.freq, cap=params.max_events_per_superstep):
        return (prob.clone(), row_sums.clone(), block_sums.clone(), aidx, inv,
                geom.neigh_idx, geom.rev_slot, state.element, state.charge, state.key,
                window, cap, params.dtype)

    def timed(make, n):
        times = []
        for _ in range(n):
            a = make()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            e0.record()
            kmc_event_loop(*a)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    count = int(kmc_event_loop(*args())[2].tolist()[1])
    cap_args = lambda: args(float("inf"), EVENT_CAP)
    cap_count = int(kmc_event_loop(*cap_args())[2].tolist()[1])
    ms, cap_ms = timed(args, reps), timed(cap_args, reps // 2)
    plain = []
    for _ in range(plain_reps):
        a = args()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = kmc_event_loop_plain(*a)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
        check(int(out[2].tolist()[1]) == count, "plain loop: another event count")
    l2_ns, barrier_ns = latencies()
    bytes_ = event_loop_bytes(count, n_blocks, m, prob.element_size())
    rec = dict(events=count, ms=ms, plain_ms=statistics.median(plain),
               bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3, bytes=bytes_,
               latency_bound_ms=event_latency_bound_ms(count, l2_ns, barrier_ns),
               l2_ns=l2_ns, barrier_ns=barrier_ns, cap_events=cap_count, cap_ms=cap_ms,
               shape=f"{n_rows}x{m} {str(prob.dtype)[6:]} table, "
                     f"{n_blocks} blocks of sums, {count} events")
    rec["ms_per_event"] = rec["ms"] / max(count, 1)
    rec["plain_ms_per_event"] = rec["plain_ms"] / max(count, 1)
    rec["cap_ms_per_event"] = rec["cap_ms"] / max(cap_count, 1)
    rec["latency_bound_ms_per_event"] = event_latency_bound_ms(1, l2_ns, barrier_ns)
    log(f"kmc_event_loop [{rec['shape']}]: {rec['ms']:.4f} ms a superstep, "
        f"{rec['ms_per_event']:.5f} ms an event; {cap_count} events with no window "
        f"{rec['cap_ms']:.4f} ms ({rec['cap_ms_per_event'] * 1e3:.3f} us an event); latency "
        f"bound {rec['latency_bound_ms_per_event'] * 1e3:.3f} us an event ({EVENT_ROUND_TRIPS} "
        f"L2 round trips of {l2_ns:.1f} ns, {EVENT_BARRIERS} barriers of {barrier_ns:.1f} ns); "
        f"plain host loop {rec['plain_ms']:.3f} ms ({rec['plain_ms_per_event']:.4f} ms an "
        f"event); bytes bound {rec['bound_ms']:.6f} ms for {bytes_} bytes")
    return rec


class RunRecord(list):
    """``(elements, events, checksum)`` of every superstep of a run: the
    elements a device copy, or None for the steps inside a batch, whose
    states the batch does not return, and for those the batch's checksum of
    them (superstep.element_checksum); and ``phi``, the potentials after
    every single superstep."""

    def __init__(self):
        super().__init__()
        self.phi = []


def record_run(sim):
    """Record every superstep of ``sim`` where its driver calls one
    (``sim._superstep``) and a batch (``sim._msuperstep``, its captured
    graph: the events and element checksum of each step that ran, the
    elements after the last).  Returns the RunRecord."""
    recs = RunRecord()
    step, multi = sim._superstep, sim._msuperstep

    def one(state, Vd, *rest):
        out = step(state, Vd, *rest)
        recs.append((out[0].element.clone(), int(out[2].get("n_events", -1)), None))
        recs.phi.append(out[0].potential_boundary + out[0].potential_charge)
        return out

    def many(state, Vd, *rest):
        out = multi(state, Vd, *rest)
        check(sim._graph is not None, "a batch ran without its captured graph")
        n = int(out[2]["active"].sum())
        for r in range(n):
            recs.append((out[0].element.clone() if r == n - 1 else None,
                         int(out[2]["n_events"][r]), float(sim._graph.checksums[r])))
        return out

    sim._superstep, sim._msuperstep = one, many
    return recs


def stop_recording(sim):
    """Undo record_run: the driver's own superstep and batch again."""
    for name in ("_superstep", "_msuperstep"):
        sim.__dict__.pop(name, None)


def physics_lines(out_dir):
    """output.txt of a run without the wall-clock timing lines and the
    separators."""
    with open(os.path.join(out_dir, "output.txt")) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith(("Z - calculation time", "-", "Created folder"))]


def same_runs(tag, ref, got, lines=True):
    """Two runs' records (record_run) equal: the events and the elements of
    every step (same_steps); with ``lines`` also output.txt's lines
    (physics_lines)."""
    (recs_a, lines_a), (recs_b, lines_b) = ref, got
    same_steps(tag, recs_a, recs_b)
    if lines:
        check(lines_a == lines_b, f"{tag}: output.txt numbers differ")


def small_batched_check(out_root, steps=8):
    """The small stack on the card with batch_steps = BATCH_STEPS against
    the per-step driver (log_freq 3: snapshot steps run alone between the
    batches): events and elements (inside a batch, their checksum) per step
    and output.txt's numbers equal."""
    runs = {}
    for bs in (1, BATCH_STEPS):
        sim = small_device("cuda", os.path.join(out_root, f"small_batch{bs}"),
                           batch_steps=bs, log_freq=3)
        recs = record_run(sim)
        sim.run_bias_point(2.5, 1e30, max_steps=steps)
        runs[bs] = (recs, physics_lines(sim.cfg.output_dir))
    same_runs("small stack batched", runs[1], runs[BATCH_STEPS])
    log(f"small stack, batch_steps = {BATCH_STEPS}: {steps} supersteps, events per step "
        f"{[r[1] for r in runs[1][0]]} and elements equal to the per-step driver's, "
        "output.txt numbers equal")


def crossbar_batched_check(out_root, ref):
    """The headline configuration with batch_steps = BATCH_STEPS over the
    headline run's steps (step 0 alone, a snapshot step, then batches, the
    last with a limit of 1): events and elements (inside a batch, their
    checksum) per step and output.txt's numbers equal to the per-step run's
    ``ref``, one replay of the captured graph a driver call; then one more
    batch under torch.profiler: one replay, one device-to-host copy, its
    kernels' launches witnessed by the trace.  Returns the batched run's
    step times and the batch's copies and wall ms."""
    import torch

    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.ops import pairwise as pw

    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "crossbar_batched"),
                             batch_steps=BATCH_STEPS)
    recs = record_run(sim)
    calls = []
    multi = sim._msuperstep
    sim._msuperstep = lambda *a: calls.append(1) or multi(*a)
    t0 = time.perf_counter()
    sim.run_bias_point(VD_MAIN, 1e30, max_steps=WARMUP_STEPS + TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same_runs("crossbar batched", ref, (recs, physics_lines(sim.cfg.output_dir)))
    graph = sim._graph
    check(graph.replays == len(recs.phi) + len(calls),
          f"crossbar batched: {graph.replays} replays for {len(recs.phi)} single steps and "
          f"{len(calls)} batches")
    ms = [s["Z - calculation time - KMC superstep [s]"] * 1e3 for s in sim.step_log]
    replays0, n_steps = graph.replays, len(recs)

    def batch():
        sim.state, _, _ = multi(sim.state, VD_MAIN, float("inf"), 1e30, BATCH_STEPS)

    prev = sim.state

    wall_b, busy_b, dtoh_b, seen_b, iters_b = profile_witnessed(
        f"a batch of {BATCH_STEPS}", batch, {"ell_gather_batched": eg.ell_gather_batched,
                                             "poisson_pairwise_batched":
                                                 pw.poisson_pairwise_batched,
                                             "kmc_event_loop_batched":
                                                 kmc_events.kmc_event_loop_batched}, graph.ws,
        reset=lambda: setattr(sim, "state", prev))
    check(graph.replays - replays0 == 1 and dtoh_b == 1,
          f"a batch of {BATCH_STEPS}: {graph.replays - replays0} replays, {dtoh_b} "
          "device-to-host copies")
    ms_b = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch()
        torch.cuda.synchronize()
        ms_b.append((time.perf_counter() - t) * 1e3 / BATCH_STEPS)
    log(f"crossbar, batch_steps = {BATCH_STEPS}: {n_steps} supersteps in {wall:.2f} s "
        f"({len(recs.phi)} alone, {len(calls)} batches, {replays0} replays), events "
        f"and elements (inside a batch their checksum) per step and output.txt numbers "
        f"equal to the per-step "
        f"run; superstep wall ms {[round(x, 2) for x in ms]} (a batch step: its batch's "
        f"time over its steps, the first two batches with their captures); one more "
        f"batch under the profiler: 1 replay, {dtoh_b} device-to-host copy, {wall_b:.2f} ms "
        f"wall" + (f", device busy {100 * busy_b / wall_b:.1f} %" if busy_b else "")
        + f", kernels in its trace {seen_b} ({iters_b} CG iterations on the device); 3 more "
        f"batches: {[round(x, 3) for x in ms_b]} ms a superstep")
    return dict(ms=ms, batch_dtoh=dtoh_b, batch_wall_ms=wall_b, ms_per_step=ms_b,
                batch_trace=seen_b, batch_cg_iters=iters_b,
                batch_busy=None if busy_b is None else 100 * busy_b / wall_b)


def cg_reference_run(out_root, chunked):
    """The transport run again with the CG stop condition read every
    iteration (cg.CHUNKS = (1,)): the cold solves' iterations and every
    step's events, cg_iters_boundary and cg_iters_power equal to the
    chunked run ``chunked`` (its presolve and step logs).  Returns the
    reference run's read-backs."""
    import torch

    from devicekmc_tpu_torch.ops import cg

    from devicekmc_tpu_torch import engine

    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "transport_chunk1"),
                             current=True)
    sim._make = engine.make_superstep      # the eager driver, as the chunked run
    chunks = cg.CHUNKS
    cg.CHUNKS = (1,)
    cg.readbacks = 0
    try:
        sim.run_bias_point(VD_MAIN, 1e30, max_steps=TRANSPORT_STEPS)
        torch.cuda.synchronize()
    finally:
        cg.CHUNKS = chunks
    reads = cg.readbacks
    presolve, steps = chunked
    check([p["cg_iters"] for p in sim.presolve_log] == [p["cg_iters"] for p in presolve],
          f"cold solves: {[p['cg_iters'] for p in sim.presolve_log]} iterations read "
          f"every iteration, {[p['cg_iters'] for p in presolve]} in chunks")
    keys = ("n_events", "cg_iters_boundary", "cg_iters_power")
    for a, b in zip(sim.step_log, steps):
        for key in keys:
            check(a[key] == b[key], f"step {a['step']}: {key} {a[key]} read every "
                  f"iteration, {b[key]} in chunks")
    check(len(sim.step_log) == len(steps), "CG reference run: step count")
    log(f"CG stop checks in chunks {chunks}: cold solves {[p['cg_iters'] for p in presolve]} "
        f"iterations, cg_iters_power {[int(s['cg_iters_power']) for s in steps]}, "
        f"cg_iters_boundary {[int(s['cg_iters_boundary']) for s in steps]}, equal to the run "
        f"that reads every iteration ({reads} CG read-backs there)")
    return reads



# ---------------------------------------------------------------------------
# the modular driver, checkpoint and resume, the bf16 inner transport
# ---------------------------------------------------------------------------

#: the reference's per-module timing keys every modular headline superstep logs
MODULAR_KEYS = ("charge", "potential from boundaries", "potential from charges",
                "kmc events")
#: segment length of the modular driver's in-superstep re-solves on the crossbar
MODULAR_CHUNK = 200
#: transient substeps of the chunked local heat check: segments of 64, 64, 23
HEAT_CHECK_SUBSTEPS = 150.5
#: supersteps before and after the checkpoint in the resume checks
CKPT_STEPS = 2
#: the fields a resume must reproduce bit for bit
RESUME_FIELDS = ("element", "charge", "key", "kmc_time", "I_macro",
                 "virtual_potentials", "CB_edge")
#: the bf16 inner I_macro against the dense direct solve on the small stack
BF16_DIRECT_RTOL = 2e-4
#: supersteps of the bf16 transport run on the crossbar
BF16_STEPS = 4
#: transport_tol of the bf16 transport run: the option tightens it by 1e-2 to
#: phase 4's 1e-8.  At its default (1e-10 after the tightening) no cold solve
#: converges at this width, with the f32 inner operator either: the mixed
#: refinement's floor lies above 1e-10 here (ROADMAP section 3, item 1)
BF16_TRANSPORT_TOL = 1e-6


def record_elements(sim):
    """Keep a device copy of the elements and the event count of every
    ``sim._superstep`` call of one Simulation; the records of
    record_run."""
    recs = []
    step = sim._superstep

    def wrapped(state, Vd):
        out = step(state, Vd)
        recs.append((out[0].element.clone(), int(out[2].get("n_events", -1)), None))
        return out

    sim._superstep = wrapped
    return recs


def same_steps(tag, ref, got):
    """Two runs' records (record_run, record_elements): events equal step for
    step, and the elements of every step: equal where both runs recorded
    them, else their checksums."""
    import torch

    from devicekmc_tpu_torch.superstep import element_checksum

    def checksum(rec):
        return rec[2] if rec[0] is None else float(element_checksum(rec[0][None])[0])

    check(len(ref) == len(got), f"{tag}: {len(ref)} vs {len(got)} supersteps")
    for k, (a, b) in enumerate(zip(ref, got)):
        check(a[1] == b[1], f"{tag}: step {k} events {a[1]} vs {b[1]}")
        if a[0] is not None and b[0] is not None:
            check(torch.equal(a[0], b[0]), f"{tag}: step {k} elements differ")
        else:
            check(checksum(a) == checksum(b), f"{tag}: step {k} element checksums "
                  f"{checksum(a)} vs {checksum(b)}")


def small_modular_check(out_root, steps=4):
    """Phase 7, first part: the small stack with blocked transport and the
    local cg heat model, the modular driver (segments of 40 iterations)
    against the fused one on the card: events and elements per step equal,
    every step with the six timing keys; then the chunked heat phase against
    the single call at 151 transient substeps (segments of 64, 64, 23): the
    temperature field within 1e-9 relative."""
    from devicekmc_tpu_torch import engine

    runs = {}
    for fused in (True, False):
        sim = small_device("cuda", os.path.join(out_root, f"small_modular_{fused}"),
                           current=True, fused=fused, solve_heating_local=True,
                           heat_solver="cg")
        recs = record_elements(sim)
        sim.run_bias_point(10.0, 1e30, max_steps=steps)
        runs[fused] = (recs, sim)
    same_steps("small stack modular", runs[True][0], runs[False][0])
    sim = runs[False][1]
    keys = MODULAR_KEYS + ("dissipated power", "temperature")
    for s in sim.step_log:
        for key in keys:
            check(f"Z - calculation time - {key} [s]" in s, f"step {s['step']}: no {key} time")
    p = sim.params
    step_time = HEAT_CHECK_SUBSTEPS * p.delta_t
    st_c, _ = engine.run_heat_phase_chunked(sim.geom, p, sim.heat, sim.state, step_time)
    st_s, _ = engine._phase_heat(sim.geom, p, sim.heat, sim.state, step_time)
    err = float((st_c.temperature / st_s.temperature - 1).abs().max())
    moved = float((st_s.temperature - p.background_temp).abs().max())
    check(err <= 1e-9, f"chunked heat phase: temperature error {err}")
    check(moved > 0, "the local heat model left the background temperature everywhere")
    log(f"small stack, modular driver (segments of {sim.cfg.solver_chunk_iters}) with "
        f"transport and the local cg heat model: {steps} supersteps, events per step "
        f"{[r[1] for r in runs[False][0]]} and elements equal to the fused driver's; every "
        f"step logs {len(keys)} module times; the chunked heat phase at "
        f"{int(HEAT_CHECK_SUBSTEPS) + 1} substeps against the single call: max temperature "
        f"error {err:.3e} relative (up to {moved:.3e} K above the background)")


def small_bf16_check(out_root, steps=4, Vd=10.0):
    """Phase 2, the bf16 accuracy gate: the small stack with
    transport_bf16_inner, once with the stored metal block (the bf16 twin
    products run) and once on the fly (they do not): events per step equal
    on the card and on the CPU, I_macro within 1e-5, and on both the final
    I_macro within BF16_DIRECT_RTOL of the dense direct solve of the final
    state."""
    import torch

    from devicekmc_tpu_torch.physics import current as cur

    for cc in ("stored", "fly"):
        runs = {}
        for device in ("cuda", "cpu"):
            sim = small_device(device, os.path.join(out_root, f"small_bf16_{cc}_{device}"),
                               current=True, transport_cc=cc, transport_bf16_inner=True)
            twins, restore = _counted(cur, "twin_matmul")
            try:
                sim.run_bias_point(Vd, 1e30, max_steps=steps)
            finally:
                restore()
            check(sim._band is not None and sim._band["slots"].val.dtype == torch.bfloat16,
                  f"{cc}: the band is not bf16")
            st_d, _ = cur.update_power(sim.geom, sim.params, sim.state, Vd, method="direct")
            runs[device] = (sim, st_d.I_macro, twins["calls"])
        (g, Ig, tg), (c, Ic, tc) = runs["cuda"], runs["cpu"]
        check([int(s["n_events"]) for s in g.step_log] == [int(s["n_events"]) for s in c.step_log],
              f"bf16 {cc}: events differ between the card and the CPU")
        for a, b in zip(g.step_log, c.step_log):
            check(a["transport_converged"] == b["transport_converged"] == 1.0,
                  f"bf16 {cc}: step {a['step']} not converged")
            check(abs(a["Current [uA]"] / b["Current [uA]"] - 1) <= 1e-5,
                  f"bf16 {cc}: step {a['step']} current {a['Current [uA]']} vs "
                  f"{b['Current [uA]']} uA")
        eg, ec = abs(g.state.I_macro / Ig - 1), abs(c.state.I_macro / Ic - 1)
        check(eg <= BF16_DIRECT_RTOL and ec <= BF16_DIRECT_RTOL,
              f"bf16 {cc}: I_macro {eg:.3e} (card) and {ec:.3e} (CPU) from the direct solve")
        check((tg > 0) == (tc > 0) == (cc == "stored"),
              f"bf16 {cc}: twin products {tg} (card), {tc} (CPU)")
        log(f"small stack, transport_bf16_inner, metal block {cc}: {steps} supersteps at "
            f"Vd = {Vd} V, events {[int(s['n_events']) for s in g.step_log]} on both, "
            f"cg_iters_power {[int(s['cg_iters_power']) for s in g.step_log]} (card), "
            f"{[int(s['cg_iters_power']) for s in c.step_log]} (CPU); twin products "
            f"{tg} (card), {tc} (CPU); final I_macro {g.state.I_macro:.9e} A (card), "
            f"{c.state.I_macro:.9e} A (CPU), from the direct solve {eg:.3e} and {ec:.3e}")


def state_fields(sim):
    """RESUME_FIELDS of the state as numpy (host scalars and the key as arrays)."""
    import numpy as np
    import torch

    out = {}
    for f in RESUME_FIELDS:
        v = getattr(sim.state, f)
        out[f] = v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return out


def resume_check(tag, make, Vd, out_root):
    """Run A: CKPT_STEPS supersteps, a checkpoint, CKPT_STEPS more; run B: a
    fresh Simulation loads the file and runs the same steps.  RESUME_FIELDS
    equal bit for bit; the save and load seconds are printed."""
    import numpy as np
    import torch

    path = os.path.join(out_root, f"ckpt_{tag}.npz")
    a = make("a")
    a.run_bias_point(Vd, 1e30, max_steps=CKPT_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    a.run_bias_point(Vd, 1e30, max_steps=2 * CKPT_STEPS, resume_step=CKPT_STEPS)
    b = make("b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.load_checkpoint(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(b._pos == (0, CKPT_STEPS), f"{tag}: position {b._pos}")
    b.run_bias_point(Vd, 1e30, max_steps=2 * CKPT_STEPS, resume_step=CKPT_STEPS)
    fa, fb = state_fields(a), state_fields(b)
    for f in RESUME_FIELDS:
        check(np.array_equal(fa[f], fb[f]), f"{tag}: resumed {f} differs")
    check([s["step"] for s in b.step_log] == list(range(CKPT_STEPS, 2 * CKPT_STEPS)),
          f"{tag}: resumed steps {[s['step'] for s in b.step_log]}")
    log(f"checkpoint and resume, {tag}: {CKPT_STEPS} supersteps, save, {CKPT_STEPS} more, "
        f"against a fresh Simulation that loads the file and runs the same: "
        f"{', '.join(RESUME_FIELDS)} equal bit for bit; events "
        f"{[int(s['n_events']) for s in a.step_log]}; save {save_s:.3f} s, load "
        f"{load_s:.3f} s ({os.path.getsize(path) / 2**20:.1f} MiB)")


def small_resume_checks(out_root):
    """Phase 8, first part: resume_check on the small stack with transport,
    per step and with batch_steps = BATCH_STEPS."""
    for bs in (1, BATCH_STEPS):
        resume_check(f"small stack with transport, batch_steps {bs}",
                     lambda tag: small_device(
                         "cuda", os.path.join(out_root, f"small_ckpt{bs}_{tag}"),
                         current=True, batch_steps=bs),
                     10.0, out_root)


def crossbar_resume_checks(out_root):
    """Phase 8, second part: resume_check on the headline crossbar, per step
    and with batch_steps = BATCH_STEPS."""
    for bs in (1, BATCH_STEPS):
        resume_check(
            f"crossbar headline, batch_steps {bs}",
            lambda tag: synthetic_crossbar(N_SITES, "cuda",
                                           os.path.join(out_root, f"crossbar_ckpt{bs}_{tag}"),
                                           batch_steps=bs),
            VD_MAIN, out_root)


def modular_path(out_root, ref):
    """Phase 7, second part: the headline configuration under the modular
    driver with in-superstep segments of MODULAR_CHUNK iterations, counters set to
    0 just before run_bias_point and read just after: the same cold
    pre-solve, warm-up and timed supersteps as phase 3; events and elements
    equal to the fused run ``ref`` (record_run) step for step, every
    step with the four headline module times, their medians over the timed
    steps printed.  Returns the launches."""
    import torch

    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise

    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "crossbar_modular"),
                             fused=False, solver_chunk_iters=MODULAR_CHUNK)
    recs = record_elements(sim)
    wrappers = {"ell_gather": ell_gather, "poisson_pairwise": poisson_pairwise,
                "kmc_event_loop": kmc_event_loop}
    # ---- counters to 0, drive, read ----
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    sim.run_bias_point(VD_MAIN, 1e30, max_steps=WARMUP_STEPS + TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the modular path")
    same_steps("crossbar modular", ref, recs)
    steps = sim.step_log
    for s in steps:
        for key in MODULAR_KEYS:
            check(f"Z - calculation time - {key} [s]" in s, f"step {s['step']}: no {key} time")
    keys = ("KMC superstep",) + MODULAR_KEYS
    med = {key: statistics.median(s[f"Z - calculation time - {key} [s]"] * 1e3
                                  for s in steps[WARMUP_STEPS:]) for key in keys}
    log(f"modular driver (segments of {MODULAR_CHUNK}) on the crossbar: run_bias_point "
        f"(cold pre-solve + {WARMUP_STEPS} warm-up + {TIMED_STEPS} timed supersteps) in "
        f"{wall:.2f} s; events and elements equal to the fused run's step for step; "
        f"launches {launches}; cg_iters_boundary "
        f"{[int(s['cg_iters_boundary']) for s in steps]}")
    log("  medians over the timed supersteps (ms): "
        + ", ".join(f"{key} {med[key]:.3f}" for key in keys))
    return launches


def bf16_transport_path(out_root, f32_steps):
    """Phase 9: the transport configuration with transport_bf16_inner (at
    transport_tol BF16_TRANSPORT_TOL, so that it stops where phase 4 does),
    counters set to 0 just before run_bias_point and read just after: the
    cold solves and BF16_STEPS supersteps; every solve converged, I_macro
    finite and positive, every transport kernel launched, the band bf16.
    cg_iters_power and I_macro beside the f32 inner run's (``f32_steps``,
    phase 4).  Then the bf16 band kernel against its plain version on the
    run's band (``band_checks``).  Returns its record and the run's
    launches."""
    import math

    import torch

    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matvec, wkb_fly_pdisp
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block

    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "transport_bf16"),
                             current=True, transport_bf16_inner=True,
                             transport_tol=BF16_TRANSPORT_TOL)
    vdt = sim._band["slots"].val.dtype
    check(vdt == torch.bfloat16, f"the band is {vdt}, not bf16")
    wrappers = {"ell_gather": ell_gather, "poisson_pairwise": poisson_pairwise,
                "banded_matvec": banded_matvec, "wkb_fly_matvec": wkb_fly_matvec,
                "wkb_fly_matmat": wkb_fly_matmat, "wkb_window_block": wkb_window_block,
                "wkb_fly_pdisp": wkb_fly_pdisp, "kmc_event_loop": kmc_event_loop}
    # ---- counters to 0, drive, read ----
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    sim.run_bias_point(VD_MAIN, 1e30, max_steps=BF16_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    for name, n in launches.items():
        if name == "wkb_fly_pdisp":
            check(n == 0, f"{name} was launched {n} times on the bf16 transport path")
        else:
            check(n > 0, f"{name} was not launched on the bf16 transport path")
    steps = sim.step_log
    check(len(steps) == BF16_STEPS, f"ran {len(steps)} bf16 transport supersteps")
    for s in steps:
        check(s["transport_converged"] == 1.0, f"bf16 step {s['step']}: not converged")
    I = sim.state.I_macro
    check(math.isfinite(I) and I > 0, f"bf16 I_macro {I}")
    for pre in sim.presolve_log:
        log(f"cold {pre['phase']} solve (bf16 inner): {pre['cg_iters']} CG iterations, "
            f"{pre['s'] * 1e3:.1f} ms")
    log(f"bf16 transport path: run_bias_point (cold solves + {BF16_STEPS} supersteps) in "
        f"{wall:.2f} s; launches {launches} (every band launch bf16)")
    for a, b in zip(steps, f32_steps):
        log(f"  step {a['step']}: {a['Z - calculation time - KMC superstep [s]'] * 1e3:.2f} ms, "
            f"events {int(a['n_events'])} (f32 inner {int(b['n_events'])}), cg_iters_power "
            f"{int(a['cg_iters_power'])} (f32 inner {int(b['cg_iters_power'])}), Current "
            f"{a['Current [uA]']:.9g} uA (f32 inner {b['Current [uA]']:.9g})")

    # ---- the bf16 band kernel at the run's band ----
    rec = band_checks(sim._band, sim.geom.N_atom)
    record = {
        "name": "banded_matvec_bf16", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/banded.cu",
        "replaces": "devicekmc_tpu/ops/banded_pallas.py:74",
        "launches": launches["banded_matvec"], "max_abs_err": rec["err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "library": "torch.sparse.mm (CSR, the bf16 values widened to f32)",
        "shape": rec["shape"],
        **{key: rec[key] for key in ("cold_ms", "library_cold_ms", "nnz", "elements",
                                     "slot_bytes", "longest_row", "pad_share",
                                     "err_rounded")},
        "path": "transport with transport_bf16_inner (cold solves + "
                f"{BF16_STEPS} supersteps)",
        "cg_iters_power": [int(s["cg_iters_power"]) for s in steps],
        "cg_iters_power_f32_inner": [int(s["cg_iters_power"]) for s in f32_steps[:BF16_STEPS]],
        "cold_cg_iters": [p["cg_iters"] for p in sim.presolve_log],
        "current_uA": [s["Current [uA]"] for s in steps],
        "current_uA_f32_inner": [s["Current [uA]"] for s in f32_steps[:BF16_STEPS]],
    }
    return record, launches


# ---------------------------------------------------------------------------
# device ensembles: B replicas of the crossbar through one superstep
# ---------------------------------------------------------------------------

#: replicas of the ensemble phase's main run, the batch sizes it times, and
#: the base seed of the replicas' keys (examples/ensemble.py's)
ENSEMBLE_B = 8
ENSEMBLE_SIZES = (1, ENSEMBLE_B, 32)
ENSEMBLE_SEED = 42


def dtoh_per_step(step, states, n, wrappers):
    """Device-to-host copies of each of ``n`` supersteps of ``step`` from
    ``states``, as the device records of torch.profiler count them ("Memcpy
    DtoH"), one profiled superstep at a time, each superstep's kernel
    launches (the counts of ``wrappers``) witnessed by its trace
    (profile_witnessed)."""
    counts = []
    for k in range(n):
        out = []
        prof = profile_witnessed(f"ensemble superstep {k} at B = {states.element.shape[0]}",
                                 lambda: out.append(step(states, VD_MAIN)), wrappers,
                                 reset=out.clear)
        states = out[-1][0]
        counts.append(prof[2])
    return counts


def ensemble_kernel_checks(geom, params, states):
    """The three batched kernels at the ensemble's shapes (B replicas of the
    crossbar, each in its own state), held against their batched plain
    versions and against B single launches, and timed beside their bounds;
    returns their records (without the launches of the run)."""
    import torch

    from devicekmc_tpu_torch.ops.compact import nonzero_fixed_batched
    from devicekmc_tpu_torch.ops.ell_gather import (
        ell_gather, ell_gather_batched, ell_gather_batched_plain,
    )
    from devicekmc_tpu_torch.ops.kmc_events import (
        kmc_event_loop, kmc_event_loop_batched, kmc_event_loop_batched_plain,
    )
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_pairwise, poisson_pairwise_batched,
        poisson_pairwise_batched_plain,
    )
    from devicekmc_tpu_torch.physics.charge import _flags
    from devicekmc_tpu_torch.physics.events import incremental_tables, pack_site_code

    B, N = states.element.shape
    idx = geom.neigh_idx
    R, M = idx.shape
    idx_long = idx.clamp(min=0).long()
    flags = _flags(geom, states.element)[1]
    phi = (states.potential_boundary + states.potential_charge).to(torch.float32)
    code = pack_site_code(states.element, states.charge, geom.site_layer)
    records = {}
    for c, vals in ((1, [flags]), (2, [phi, code])):
        got = ell_gather_batched(idx, vals)
        ref = ell_gather_batched_plain(idx, vals)
        one = [ell_gather(idx, [v[b] for v in vals]) for b in range(B)]
        torch.cuda.synchronize()
        for k, (g, r) in enumerate(zip(got, ref)):
            check(torch.equal(g.view(torch.int32), r.view(torch.int32)),
                  f"batched gather C={c}: differs from its plain version")
            for b in range(B):
                check(torch.equal(g[b].view(torch.int32), one[b][k].view(torch.int32)),
                      f"batched gather C={c}: replica {b} differs from its single launch")
        del got, ref, one
        rec = dict(
            max_abs_err=0.0, shape=f"{B} x [{R}x{M}], {c} channel{'s' * (c > 1)}",
            ms=time_ms_cold(lambda: ell_gather_batched(idx, vals)),
            ms_singles=time_ms_cold(lambda: [ell_gather(idx, [v[b] for v in vals])
                                             for b in range(B)]),
            plain_ms=time_ms_cold(lambda: ell_gather_batched_plain(idx, vals), reps=5),
            library_ms=time_ms_cold(lambda: [v[:, idx_long] for v in vals]),
            bound_ms=(R * M * 4 + B * c * (N * 4 + R * M * 4)) / PEAK_BYTES_PER_S * 1e3,
            bound_by="bytes")
        records[f"gather{c}"] = rec
        log(f"ell_gather_batched C={c} [{rec['shape']}]: bit-equal to its plain version and "
            f"to {B} single launches; cold L2 {rec['ms']:.5f} ms (bound {rec['bound_ms']:.5f} "
            f"ms: the index stream once, {B} x {c} sources and outputs; {B} single launches "
            f"{rec['ms_singles']:.5f} ms, plain {rec['plain_ms']:.5f} ms, v[:, idx] "
            f"{rec['library_ms']:.5f} ms)")

    cap = -(-params.poisson_compact_cap // 8) * 8
    cidx, n_c = nonzero_fixed_batched(states.charge != 0, cap)
    cq = torch.gather(states.charge, 1, cidx.long()).to(torch.float32)
    coords32 = geom.coords.to(torch.float32).contiguous()
    scal = kernel_scalars(params.sigma, params.k, geom.lattice_host, params.dtype)
    counts = [min(n, cap) for n in n_c.tolist()]
    args = (coords32, cidx, cq, n_c, *scal, geom.pbc)
    got = poisson_pairwise_batched(*args)
    ref = poisson_pairwise_batched_plain(*args)
    err = _close("poisson_pairwise_batched", got, ref, 2e-6)
    parts = [(cidx[b, :n], cq[b, :n]) for b, n in enumerate(counts)]
    for b, (ci, q) in enumerate(parts):
        check(torch.equal(got[b], poisson_pairwise(coords32, ci, q, *scal, geom.pbc)),
              f"batched pair sweep: replica {b} differs from its single launch")
    check(torch.equal(got, poisson_pairwise_batched(*args)), "batched pair sweep: two calls "
          "differ")
    ops = N * sum(counts) * POISSON_OPS_PER_PAIR[geom.pbc]
    bound, by = _bound(ops, N * 12 + sum(counts) * 8 + B * N * 4)
    rec = dict(max_abs_err=err, bound_ms=bound, bound_by=by, library_ms=None,
               shape=f"{B} x [{N} rows x {counts} charged]",
               ms=time_ms(lambda: poisson_pairwise_batched(*args)),
               ms_singles=time_ms(lambda: [poisson_pairwise(coords32, ci, q, *scal, geom.pbc)
                                           for ci, q in parts]),
               plain_ms=time_ms(lambda: poisson_pairwise_batched_plain(*args), reps=1,
                                rounds=3, warmup=1))
    records["poisson"] = rec
    log(f"poisson_pairwise_batched [{rec['shape']}]: bit-equal to {B} single launches, "
        f"max err {err:.3e} against its plain version; {rec['ms']:.4f} ms (bound "
        f"{bound:.4f} ms by {by}; {B} single launches {rec['ms_singles']:.4f} ms, plain "
        f"{rec['plain_ms']:.3f} ms)")

    prob, row_sums, block_sums, aidx, inv, _ = incremental_tables(geom, params, states)
    tail = (geom.neigh_idx, geom.rev_slot, states.element, states.charge, states.key,
            1.0 / params.freq, params.max_events_per_superstep, params.dtype)

    def fresh():
        return (prob.clone(), row_sums.clone(), block_sums.clone(), aidx, inv)

    got = kmc_event_loop_batched(*fresh(), *tail)
    ref = kmc_event_loop_batched_plain(*fresh(), *tail)
    torch.cuda.synchronize()
    res_g, res_r = got[3].tolist(), ref[3].tolist()
    check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
          and torch.equal(got[2], ref[2]), "batched event loop: elements, charges or keys "
          "differ from its plain version")
    max_abs = max_rel = 0.0
    for b, (g, r) in enumerate(zip(res_g, res_r)):
        check(g[1:] == r[1:], f"batched event loop replica {b}: {g} vs {r}")
        rel = abs(g[0] - r[0]) / abs(r[0])
        check(rel <= EVENT_TOL["f32"], f"batched event loop replica {b}: step_time {g[0]} vs "
              f"{r[0]}")
        max_abs, max_rel = max(max_abs, abs(g[0] - r[0])), max(max_rel, rel)

    def singles(tabs):
        return [kmc_event_loop(*t, geom.neigh_idx, geom.rev_slot, states.element[b],
                               states.charge[b], tuple(states.key[b].tolist()), *tail[5:])
                for b, t in enumerate(tabs)]

    def single_tabs():
        return [(prob[b].clone(), row_sums[b].clone(), block_sums[b].clone(), aidx, inv)
                for b in range(B)]

    for b, (e, q, r) in enumerate(singles(single_tabs())):
        check(torch.equal(e, got[0][b]) and torch.equal(q, got[1][b])
              and torch.equal(r, got[3][b]), f"batched event loop: replica {b} differs from "
              "its single launch")
    keys = [tuple(k) for k in states.key.tolist()]

    def timed(call, make, reps):
        times = []
        for _ in range(reps):
            a = make()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            e0.record()
            call(a)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    ms = timed(lambda a: kmc_event_loop_batched(*a, *tail), fresh, 20)
    ms_singles = timed(lambda tabs: [
        kmc_event_loop(*t, geom.neigh_idx, geom.rev_slot, states.element[b], states.charge[b],
                       keys[b], *tail[5:]) for b, t in enumerate(tabs)], single_tabs, 10)
    plain = []
    for _ in range(2):
        a = fresh()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kmc_event_loop_batched_plain(*a, *tail)
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    events = [int(g[1]) for g in res_g]
    bytes_ = sum(event_loop_bytes(n, block_sums.shape[1], M, prob.element_size())
                 for n in events)
    # the replicas' chains run side by side, a block each: the longest bounds
    l2_ns, barrier_ns = latencies()
    rec = dict(max_abs_err=max_abs, max_rel_err=max_rel, ms=ms, ms_singles=ms_singles,
               plain_ms=statistics.median(plain), bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3,
               latency_bound_ms=event_latency_bound_ms(max(events), l2_ns, barrier_ns),
               bound_by="bytes", library_ms=None, events=events,
               shape=f"{B} x [{prob.shape[1]}x{M} f32 table, {block_sums.shape[1]} blocks of "
                     f"sums], events {events}")
    records["events"] = rec
    log(f"kmc_event_loop_batched [{rec['shape']}]: events, elements, charges and keys equal "
        f"to its plain version (step_time max {max_rel:.3e} relative) and bit-equal to {B} "
        f"single launches; {ms:.4f} ms a launch ({B} single launches {ms_singles:.4f} ms, "
        f"plain host loop {rec['plain_ms']:.2f} ms; bytes bound {rec['bound_ms']:.6f} ms, "
        f"latency bound {rec['latency_bound_ms']:.6f} ms)")
    return records


def ensemble_example_check():
    """examples/ensemble_torch.py's configuration (the small stack with dense
    transport and the global heat model, f64) at B = 2, 3 supersteps, on the
    card and through the CPU path: elements and events equal, I_macro within
    1e-5 and T_bg within 1e-7 relative (phase 2's tolerances for this
    configuration)."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import ensemble_torch
    finally:
        sys.path.pop(0)
    runs = {dev: ensemble_torch.main(["--batch", "2", "--steps", "3", "--device", dev])
            for dev in ("cuda", "cpu")}
    (sg, mg), (sc, mc) = runs["cuda"], runs["cpu"]
    check(np.array_equal(sg.element.cpu().numpy(), sc.element.numpy()),
          "ensemble example: elements differ between card and CPU")
    check(mg["n_events"].tolist() == mc["n_events"].tolist(), "ensemble example: events")
    eI = float((sg.I_macro.cpu() - sc.I_macro).abs().max() / sc.I_macro.abs().max())
    eT = float(((sg.T_bg.cpu() - sc.T_bg) / sc.T_bg).abs().max())
    check(eI <= 1e-5 and eT <= 1e-7, f"ensemble example: I_macro {eI:.3e}, T_bg {eT:.3e} "
          "relative")
    check(float(sc.T_bg.max()) > 300.0, "ensemble example: the temperature never moved")
    log(f"ensemble example (small stack, dense transport + global heat, B = 2, 3 "
        f"supersteps): card against CPU, elements and events equal, I_macro {eI:.3e} and "
        f"T_bg {eT:.3e} relative")
    return dict(I_rel=eI, T_bg_rel=eT)


def ensemble_path(out_root):
    """Phase 10: B = ENSEMBLE_B replicas of the crossbar's headline
    configuration through make_batched_superstep.  The cold deflated
    boundary solve runs once, on the single state; the replicas get the keys
    fold_in(PRNGKey(42), b).  Counters set to 0 just before the main run (2
    warm-up + 4 timed supersteps): the batched gather launched twice a
    superstep, the batched pair sweep and event loop once, no single kernel
    and no plain version.  Each replica against the single path on the card
    with its key (superstep_impl, the same supersteps: elements and events
    equal, step times and the final potentials within 1e-12 relative);
    device-to-host copies of each superstep at B = 8 no more than the most
    any replica alone makes in it at B = 1; the same supersteps of the eager
    batched superstep (superstep_batched, no graph) against the graph's
    (elements, events and cg_iters_boundary equal, potentials and step times
    within 1e-12 relative); timings at B = 1, 8, 32, graph and eager in
    turns, beside the single path; the batched kernels against their plain
    versions and B single launches; the example's configuration card against
    CPU.  Returns the kernels' checks (ensemble_kernel_checks) with their
    launches in the main run, and the phase's numbers."""
    import torch

    from devicekmc_tpu_torch.ops import _build, cg, kmc_events
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.state import replace, stack_states, unbatch
    from devicekmc_tpu_torch.superstep import superstep_batched, superstep_impl

    t_phase = time.perf_counter()
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "ensemble"))
    geom, params = sim.geom, sim.params
    t0 = time.perf_counter()
    cold_iters = sim._chunked_boundary(VD_MAIN, params.solver_maxiter,
                                       replace(params, boundary_precond="deflated"))
    torch.cuda.synchronize()
    log(f"ensemble: crossbar of {geom.N} sites, cold deflated boundary solve {cold_iters} "
        f"CG iterations ({(time.perf_counter() - t0) * 1e3:.1f} ms), once for all replicas")
    base = sim.state
    step = make_batched_superstep(geom, params, sim.heat)
    n_steps = WARMUP_STEPS + TIMED_STEPS

    def eager(states, Vd):
        return superstep_batched(geom, params, states, Vd)

    def drive(states, n, record=None, fn=step):
        ms = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            states, dts, m = fn(states, VD_MAIN)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            if record is not None:
                record.append((states.element.clone(), m, dts))
        return states, ms

    states0 = batch_states(base, ENSEMBLE_B, base_seed=ENSEMBLE_SEED)
    batched = {"ell_gather_batched": eg.ell_gather_batched,
               "poisson_pairwise_batched": pw.poisson_pairwise_batched,
               "kmc_event_loop_batched": kmc_events.kmc_event_loop_batched}
    single = (eg.ell_gather, pw.poisson_pairwise, kmc_events.kmc_event_loop)
    # ---- counters to 0, drive, read ----
    for fn in (*batched.values(), *single):
        fn.launches = 0
    _build.launch_counts("cuda").zero_()
    plains = [_counted(eg, "ell_gather_batched_plain"),
              _counted(pw, "poisson_pairwise_batched_plain"),
              _counted(kmc_events, "kmc_event_loop_batched_plain")]
    recs = []
    reads0 = cg.readbacks
    try:
        states, ms = drive(states0, n_steps, recs)
    finally:
        for _, restore in plains:
            restore()
    launches = {name: fn.launches for name, fn in batched.items()}
    cg_card = bcg.device_iterations(step.graphs[ENSEMBLE_B].ws)
    reads = cg.readbacks - reads0
    card = {name: n for name, n in card_counts().items() if name in batched}
    check(launches == {"ell_gather_batched": 2 * n_steps, "poisson_pairwise_batched": n_steps,
                       "kmc_event_loop_batched": n_steps} == card,
          f"ensemble: batched launches {launches} in {n_steps} supersteps, on the card "
          f"{card_counts()}")
    check(all(fn.launches == 0 for fn in single), "ensemble: a single kernel was launched")
    check(all(rec["calls"] == 0 for rec, _ in plains), "ensemble: a plain version ran")

    events = [m["n_events"].tolist() for _, m, _ in recs]
    cg_iters = [m["cg_iters_boundary"].tolist() for _, m, _ in recs]
    n_charged = [m["n_charged_sites"].tolist() for _, m, _ in recs]
    check(cg_card == sum(max(c) for c in cg_iters),
          f"ensemble: {cg_card} CG iterations on the card, cg_iters_boundary {cg_iters}")
    check(all(all(m["boundary_converged"].tolist()) for _, m, _ in recs),
          "ensemble: a boundary solve did not converge")
    check(all(max(n) <= params.poisson_compact_cap for n in n_charged),
          "ensemble: a replica overflowed the Poisson bucket")
    check(bool(torch.isfinite(states.potential_boundary).all()
               and torch.isfinite(states.potential_charge).all()), "ensemble: potentials")
    check(len({tuple(k) for k in states.key.tolist()}) == ENSEMBLE_B, "ensemble: keys")
    check(any(not torch.equal(states.element[0], states.element[b])
              for b in range(1, ENSEMBLE_B)), "ensemble: every replica has one trajectory")
    for k in range(n_steps):
        log(f"  ensemble step {k}: {ms[k]:.2f} ms, events {events[k]}, cg_iters_boundary "
            f"{cg_iters[k]}, n_charged_sites {n_charged[k]}")

    # the eager batched superstep (no graph) from the same states
    recs_e = []
    states_e, ms_e = drive(states0, n_steps, recs_e, fn=eager)
    for k, ((el, m, dts), (el_e, m_e, dts_e)) in enumerate(zip(recs, recs_e)):
        check(torch.equal(el, el_e), f"ensemble step {k}: graph and eager elements differ")
        for key in ("n_events", "cg_iters_boundary"):
            check(m[key].tolist() == m_e[key].tolist(),
                  f"ensemble step {k}: {key} {m[key].tolist()} on the graph, "
                  f"{m_e[key].tolist()} eagerly")
        check(rel_err(dts, dts_e) <= 1e-12, f"ensemble step {k}: step times differ")
    phi_ge = rel_err(states.potential_boundary + states.potential_charge,
                     states_e.potential_boundary + states_e.potential_charge)
    check(phi_ge <= 1e-12, f"ensemble: potentials {phi_ge:.3e} of their scale from the "
          "eager batched superstep's")
    log(f"ensemble: the captured graph equal to the eager batched superstep over {n_steps} "
        f"supersteps (elements, events, cg_iters_boundary; step times and potentials within "
        f"{phi_ge:.3e} of their scale); eager ms {[round(x, 2) for x in ms_e]}")

    # each replica against the single path with its key
    single_ms, phi_err, dt_err = [], 0.0, 0.0
    for b in range(ENSEMBLE_B):
        st = unbatch(states0, b)
        for k in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, dt, m1 = superstep_impl(geom, params, st, VD_MAIN)
            torch.cuda.synchronize()
            if k >= WARMUP_STEPS:
                single_ms.append((time.perf_counter() - t) * 1e3)
            check(torch.equal(st.element, recs[k][0][b]),
                  f"ensemble replica {b} step {k}: elements differ from the single path")
            check(int(m1["n_events"]) == events[k][b],
                  f"ensemble replica {b} step {k}: events {m1['n_events']} vs {events[k][b]}")
            dt_b = float(recs[k][2][b])
            dt_err = max(dt_err, 0.0 if dt == dt_b else abs(dt - dt_b) / abs(dt))
        phi = st.potential_boundary + st.potential_charge
        phi_b = states.potential_boundary[b] + states.potential_charge[b]
        phi_err = max(phi_err, float((phi - phi_b).abs().max() / phi.abs().max()))
    # not bit-equal on the card: the batched CG's row sums reduce in another
    # order than torch.dot, so the potentials and step times may differ in
    # their last bits
    check(phi_err <= 1e-12, f"ensemble: potentials {phi_err:.3e} of their scale from the "
          "single path's")
    check(dt_err <= 1e-12, f"ensemble: step times {dt_err:.3e} from the single path's")
    log(f"ensemble: each of the {ENSEMBLE_B} replicas equal to the single path with its key "
        f"over {n_steps} supersteps (elements and events); step times within {dt_err:.3e}, "
        f"potentials at the end within {phi_err:.3e} of their scale")

    # device-to-host copies, superstep by superstep: the batch against the
    # most that any replica alone (B = 1, its own key) makes in that step
    dtoh_b = dtoh_per_step(step, states0, n_steps, batched)
    dtoh_1 = [dtoh_per_step(step, stack_states([unbatch(states0, b)]), n_steps, batched)
              for b in range(ENSEMBLE_B)]
    check(None not in dtoh_b and all(None not in d for d in dtoh_1),
          "ensemble: a profiler trace came back without device records")
    dtoh_max1 = [max(d[k] for d in dtoh_1) for k in range(n_steps)]
    check(all(a <= b for a, b in zip(dtoh_b, dtoh_max1)),
          f"ensemble: device-to-host copies a superstep {dtoh_b} at B = {ENSEMBLE_B}, more "
          f"than the most of any replica alone {dtoh_max1}")
    log(f"ensemble: device-to-host copies a superstep {dtoh_b} at B = {ENSEMBLE_B}, the most "
        f"of any replica alone at B = 1 {dtoh_max1} (each replica: {dtoh_1}; CG chunk reads "
        f"of the main run: {reads}); in each profiled superstep the batched kernels' "
        f"launches counted on the card equal to their wrappers' counts")

    # timings at B = 1, 8, 32: the graph and the eager batched superstep in turns
    sizes = {}
    for nb in ENSEMBLE_SIZES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st_n = batch_states(base, nb, base_seed=ENSEMBLE_SEED)
        _, ms_n = drive(st_n, n_steps)
        peak = torch.cuda.max_memory_allocated() / 2**30
        _, ms_ne = drive(st_n, n_steps, fn=eager)
        sizes[nb] = dict(ms=ms_n[WARMUP_STEPS:], ms_eager=ms_ne[WARMUP_STEPS:], peak_gib=peak)
        torch.cuda.empty_cache()
    single_med = statistics.median(single_ms)
    for nb in sorted(sizes):
        r = sizes[nb]
        r["median_ms"] = statistics.median(r["ms"])
        r["median_ms_eager"] = statistics.median(r["ms_eager"])
        r["ms_per_replica"] = r["median_ms"] / nb
        log(f"ensemble B = {nb}: captured graph median {r['median_ms']:.2f} ms (timed "
            f"{[round(x, 2) for x in r['ms']]}), eager batched superstep median "
            f"{r['median_ms_eager']:.2f} ms, {r['ms_per_replica']:.3f} ms a replica-superstep "
            f"against the single path's median {single_med:.2f} ms; peak memory "
            f"{r['peak_gib']:.2f} GiB (graph run)")

    kchecks = ensemble_kernel_checks(geom, params, states)
    example = ensemble_example_check()
    log(f"ensemble phase in {time.perf_counter() - t_phase:.1f} s")
    summary = dict(
        sizes={nb: {k: v for k, v in r.items()} for nb, r in sizes.items()},
        single_median_ms=single_med, dtoh_batch=dtoh_b, dtoh_single=dtoh_1,
        eager_ms=ms_e, phi_err_eager=phi_ge,
        cg_reads=reads, events=events, cg_iters_boundary=cg_iters, n_charged=n_charged,
        cg_iterations_card=cg_card,
        phi_err=phi_err, dt_err=dt_err, cold_iters=cold_iters, example=example)
    return (kchecks, launches), summary


#: the batched kernels: wrapper, source, the TPU kernel it replaces, and its
#: record in ensemble_kernel_checks
BATCHED_KERNELS = (
    ("ell_gather_batched", "ell_gather.cu", "devicekmc_tpu/ops/ell_gather_pallas.py:184",
     "gather2"),
    ("poisson_pairwise_batched", "pairwise.cu", "devicekmc_tpu/ops/pairwise_pallas.py:88",
     "poisson"),
    ("kmc_event_loop_batched", "kmc_events.cu", "devicekmc_tpu/physics/events.py:609",
     "events"))


def batched_records(headline, ensemble):
    """The batched kernels' records: those of the main path (the headline
    graph run, B = 1: its launches, the kernels held against their plain
    versions and timed at its shapes) with the ensemble's (B = ENSEMBLE_B)
    beside them.  ``headline`` and ``ensemble``: (ensemble_kernel_checks,
    launches) of each."""
    def fields(checks, key):
        rec = dict(checks[key])
        if key == "gather2":
            rec.update({f"{k}_1ch": checks["gather1"][k] for k in (
                "ms", "ms_singles", "plain_ms", "bound_ms", "library_ms", "shape")})
        return rec

    (b1, launches_1), (bn, launches_n) = headline, ensemble
    return [{"name": name, "route": "cuda", "source": f"devicekmc_tpu_torch/csrc/{src}",
             "replaces": replaces, "launches": launches_1[name],
             "path": "headline, captured graph (B = 1)", **fields(b1, key),
             "ensemble": {"launches": launches_n[name], "batch": ENSEMBLE_B,
                          "path": f"ensemble of {ENSEMBLE_B} crossbar replicas "
                                  f"({WARMUP_STEPS + TIMED_STEPS} supersteps)",
                          **fields(bn, key)}}
            for name, src, replaces, key in BATCHED_KERNELS]


# ---------------------------------------------------------------------------
# the boundary CG kernels of the captured superstep
# ---------------------------------------------------------------------------

#: the warm start of phase 11's solve: the run's potential plus seeded noise
#: of this amplitude [V] on the interior sites, and its iteration cap
CG_NOISE, CG_MAXITER = 1e-4, 5000


#: the replica counts at which phase 11 also times cg_update_direction
CG_BATCHES = (8, 32)
#: the per-replica fields of a CG workspace, copied into a larger batch
CG_REPLICA_FIELDS = ("x", "r", "p", "ap", "minv", "rz", "rr", "thresh2", "alpha", "beta",
                     "act0", "act", "iters")


def update_direction_bytes(bcg, N, nb, per, itemsize=8):
    """The bytes cg_update_direction must move for ``nb`` replicas of ``N``
    rows (x, r, ap, minv and p read, x, r and p written: 8 vectors), and
    those it reads again: r, minv and p of every tile but a block's first
    (``per`` tiles a block)."""
    tiles = bcg.n_tiles(N)
    again = sum(min(bcg.TILE, N - (w % tiles) * bcg.TILE)
                for w in range(nb * tiles) if w % per)
    return 8 * itemsize * nb * N, 3 * itemsize * again


def boundary_cg_system(sim):
    """Phase 11's boundary system: the crossbar's (B = 1, the state after
    phase 3's runs) and a warm start with seeded noise, and its boundary CG
    captured now (``captured``: boundary_cg_capture's): torch.profiler
    records the WHILE body's kernels of a graph captured right after phase
    3, and of one captured after the later phases as a rule none (PERF.md
    §7).  Returns its inputs."""
    import numpy as np
    import torch

    from devicekmc_tpu_torch.physics import potential as pot
    from devicekmc_tpu_torch.state import stack_states

    geom, params = sim.geom, sim.params
    states = stack_states([sim.state])
    interior = geom.bp_interior_mask
    masks = (geom.bp_left_mask, geom.bp_right_mask, interior)
    edge_g = pot._edge_conductance_boundary(geom, states, params)
    b, matvec, diag, vals, pre = pot._dirichlet_system(geom, edge_g, -VD_MAIN / 2,
                                                       VD_MAIN / 2, masks)
    op = (diag, vals, geom.neigh_idx, interior)
    rng = np.random.default_rng(7)
    noise = torch.as_tensor(CG_NOISE * rng.standard_normal(geom.N), device="cuda")
    x0 = torch.where(interior, states.potential_boundary + noise, 0.0)
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    cg = dict(states=states, b=b, matvec=matvec, pre=pre, op=op, x0=x0, active=active,
              tol=params.solver_tol)
    cg["captured"] = boundary_cg_capture(cg)
    return cg


def boundary_cg_capture(cg):
    """The boundary CG of ``cg`` (boundary_cg_system's) captured with its
    WHILE node: (workspace, graph)."""
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops.graph import Graph

    op = cg["op"]
    ws = bcg.workspace(1, op[2], op[3], cg["b"].dtype, "cuda")
    return ws, Graph(lambda: bcg.cg_solve_device(op, cg["b"], cg["x0"], cg["pre"], cg["tol"],
                                                 CG_MAXITER, cg["active"], ws), "cuda")


def boundary_cg_path(sim, cg, cg_launches, cg_launches_ensemble):
    """Phase 11: the two boundary CG kernels at the crossbar's boundary
    system (B = 1, the state after phase 3's runs).  The device loop,
    captured with its WHILE node, against cg_solve_batched from the run's
    potential plus seeded noise: iteration counts equal, the iterate within
    1e-12 of its scale, both timed; each kernel against its plain version on
    the same workspace (cg_update_direction: each field within 1e-12 of
    its scale), timed alone
    back to back and with a cold L2 beside its bytes bound and its plain
    version, the matvec also beside torch.sparse.mm of the same operator in
    CSR; cg_update_direction also at B = 8 and 32 (the replica copied),
    beside its bound and the bytes its blocks read again; the work a
    captured superstep adds in a step where no replica solves (assembly, CG
    setup, residual) captured and timed.  ``cg``: boundary_cg_system's.
    Returns the kernels' records (``cg_launches``, ``cg_launches_ensemble``:
    the device's iteration count in phase 3's graph run and phase 10's main
    run)."""
    import dataclasses

    import torch

    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops.cg import cg_solve_batched
    from devicekmc_tpu_torch.ops.graph import Graph
    from devicekmc_tpu_torch.physics import potential as pot

    t_phase = time.perf_counter()
    geom, params = sim.geom, sim.params
    states, b, matvec, pre, op = cg["states"], cg["b"], cg["matvec"], cg["pre"], cg["op"]
    diag, vals = op[0], op[1]
    x0, active, tol = cg["x0"], cg["active"], cg["tol"]
    interior = geom.bp_interior_mask
    masks = (geom.bp_left_mask, geom.bp_right_mask, interior)
    vl, vr = -VD_MAIN / 2, VD_MAIN / 2

    ref = cg_solve_batched(matvec, b, x0, pre, tol=tol, maxiter=CG_MAXITER, active=active)
    ws, solve = cg["captured"]
    res = solve()
    iters, iters_ref = int(res.iters[0]), int(ref.iters[0])
    x_err = rel_err(res.x, ref.x)
    check(iters == iters_ref and 0 < iters < CG_MAXITER,
          f"boundary CG: {iters} iterations in the graph, {iters_ref} by cg_solve_batched")
    check(x_err <= 1e-12, f"boundary CG: iterate {x_err:.3e} of its scale apart")
    seen = profile_calls(solve, 1, before=ws.total.zero_)[3]
    check(seen is not None and int(ws.total) == iters,
          f"boundary CG: {int(ws.total)} iterations on the card in a profiled replay")
    n_seen = cg_seen("boundary CG", seen, iters)
    # the same solve captured now, one replay profiled: logged, not checked
    ws_late, late = boundary_cg_capture(cg)
    seen = profile_calls(late, 1, before=ws_late.total.zero_)[3]
    n_seen_late = seen and {k: seen[k] for k in CG_KERNELS}
    del late
    solve_ms = time_ms(solve, reps=3, rounds=3, warmup=1)
    eager_ms = time_ms(lambda: cg_solve_batched(matvec, b, x0, pre, tol=tol,
                                                maxiter=CG_MAXITER, active=active),
                       reps=1, rounds=3, warmup=1)

    # each kernel alone, on a workspace that never stops (threshold 0)
    def fresh(nb=1):
        w = bcg.workspace(nb, geom.neigh_idx, interior, b.dtype, "cuda")
        if nb == 1:
            bcg.cg_setup(op, b, x0, pre, 0.0, CG_MAXITER, active, w)
        return w

    def clone(w):
        return dataclasses.replace(w, **{f.name: getattr(w, f.name).clone()
                                         for f in dataclasses.fields(w)
                                         if isinstance(getattr(w, f.name), torch.Tensor)})

    kernels = {
        "cg_matvec_dot": (lambda w: bcg.cg_matvec_dot(w, op),
                          lambda w: bcg.cg_matvec_dot_plain(w, op), ("ap", "alpha")),
        "cg_update_direction": (lambda w: bcg.cg_update_direction(w, CG_MAXITER),
                                lambda w: bcg.cg_update_direction_plain(w, CG_MAXITER),
                                ("x", "r", "p", "rz", "rr", "beta", "iters", "act", "cond")),
    }
    N, M = geom.N, geom.max_nn
    vec = 8 * N
    # the operator's interior-to-interior nonzeros (value and index each), the
    # interior rows' diagonal, p, ap and the row lengths
    nb = geom.neigh_idx.long()
    keep = (nb >= 0) & interior[:, None] & interior[nb.clamp(min=0)]
    nnz, n_int = int(keep.sum()), int(interior.sum())
    nbytes = {"cg_matvec_dot": 12 * nnz + 8 * n_int + 2 * vec + 4 * N,
              "cg_update_direction": 8 * vec}
    w0 = fresh()
    for _ in range(3):      # a few iterations in, as inside a solve
        bcg.cg_iteration(w0, op, CG_MAXITER)
    out = {}
    for name, (kern, plain, fields) in kernels.items():
        wk, wp = clone(w0), clone(w0)
        kern(wk)
        plain(wp)
        err = 0.0
        for f in fields:
            a, c = getattr(wk, f), getattr(wp, f)
            if a.dtype.is_floating_point:
                e = float((a - c).abs().max())
                check(name != "cg_update_direction" or e <= 1e-12 * float(c.abs().max()),
                      f"{name}: {f} {e:.3e} from its plain version")
                err = max(err, e)
            else:
                check(torch.equal(a, c), f"{name}: {f} differs from the plain version")
        wt, wq, wc = clone(w0), clone(w0), clone(w0)
        out[name] = dict(max_abs_err=err, ms=time_ms(lambda: kern(wt)),
                         plain_ms=time_ms(lambda: plain(wq), reps=5),
                         ms_cold=time_ms_cold(lambda: kern(wc)),
                         bound_ms=nbytes[name] / PEAK_BYTES_PER_S * 1e3)
        check(err <= 1e-12 * max(1.0, float(getattr(wp, fields[0]).abs().max())),
              f"{name}: {err:.3e} from its plain version")
    # cg_update_direction at B = 8 and 32: the replica copied, timed beside
    # the bytes it must move and those its blocks read again
    ud = out["cg_update_direction"]
    ud["grid"], ud["tiles_per_block"] = bcg.update_direction_grid(w0)
    ud["batches"] = {}
    for nbat in CG_BATCHES:
        wb = fresh(nbat)
        for f in CG_REPLICA_FIELDS:
            getattr(wb, f).copy_(getattr(w0, f).expand_as(getattr(wb, f)))
        grid, per = bcg.update_direction_grid(wb)
        must, again = update_direction_bytes(bcg, N, nbat, per)
        ud["batches"][nbat] = dict(
            ms=time_ms(lambda: bcg.cg_update_direction(wb, CG_MAXITER)),
            bound_ms=must / PEAK_BYTES_PER_S * 1e3, grid=grid, tiles_per_block=per,
            bytes_read_again=again,
            bound_ms_with_read_again=(must + again) / PEAK_BYTES_PER_S * 1e3)
        del wb
    # the operator as one CSR matrix: the library's sparse product
    rows = torch.arange(N, device="cuda")
    r_idx = torch.cat([rows[interior], rows[:, None].expand(N, M)[keep]])
    c_idx = torch.cat([rows[interior], nb[keep]])
    v = torch.cat([diag[0][interior], vals[0][keep]])
    order = torch.argsort(r_idx * N + c_idx)
    csr = torch.sparse_coo_tensor(torch.stack([r_idx[order], c_idx[order]]), v[order],
                                  (N, N)).coalesce().to_sparse_csr()
    p = w0.p[0][:, None].contiguous()
    lib_err = float((torch.sparse.mm(csr, p)[:, 0] - bcg.apply_operator(op, w0.p)[0])
                    .abs().max())
    check(lib_err <= 1e-9 * float(w0.ap.abs().max() + 1), f"CSR operator: {lib_err:.3e} off")
    library = lambda: torch.sparse.mm(csr, p)
    out["cg_matvec_dot"]["library_ms"] = time_ms(library)
    # no one PyTorch call updates, reduces and sets the direction
    ud["library_ms"] = None
    out["cg_matvec_dot"].update(
        library_ms_cold=time_ms_cold(library), nnz=nnz,
        bound_note="the operator's interior-to-interior nonzeros (8 + 4 bytes each), the "
                   "interior rows' diagonal, p, ap and the row lengths, each once")

    # what a captured superstep adds where no replica solves
    none = torch.zeros(1, dtype=torch.bool, device="cuda")
    wa = bcg.workspace(1, geom.neigh_idx, interior, b.dtype, "cuda")

    def assembly():
        eg = pot._edge_conductance_boundary(geom, states, params)
        b2, mv, d2, v2, p2 = pot._dirichlet_system(geom, eg, vl, vr, masks)
        x = torch.where(interior, states.potential_boundary, 0.0)
        bcg.cg_setup((d2, v2, geom.neigh_idx, interior), b2, x, p2, tol, CG_MAXITER, none, wa)
        return torch.where(interior, b2 - mv(wa.x), 0.0)

    assembly_ms = time_ms(Graph(assembly, "cuda"))
    log(f"boundary CG at the crossbar's system (noise {CG_NOISE} V on the warm start): "
        f"{iters} iterations in the captured device loop and by cg_solve_batched, iterate "
        f"within {x_err:.3e} of its scale; the trace of a profiled replay shows the CG "
        f"kernels {n_seen} times for its {iters} iterations (captured after phase 3; "
        f"captured now, {n_seen_late}); the captured solve "
        f"{solve_ms:.3f} ms "
        f"({solve_ms / iters * 1e3:.2f} us an iteration), cg_solve_batched {eager_ms:.3f} ms "
        f"({eager_ms / iters * 1e3:.2f} us an iteration)")
    for name, r in out.items():
        log(f"  {name}: {r['ms'] * 1e3:.2f} us, with a cold L2 {r['ms_cold'] * 1e3:.2f} us, "
            f"bound {r['bound_ms'] * 1e3:.2f} us (bytes, "
            f"{100 * r['bound_ms'] / r['ms']:.0f} %), plain {r['plain_ms'] * 1e3:.2f} us"
            + (f", torch.sparse.mm {r['library_ms'] * 1e3:.2f} us" if r["library_ms"] else "")
            + f"; max abs error {r['max_abs_err']:.3e}")
    mv = out["cg_matvec_dot"]
    log(f"  cg_matvec_dot: {nnz} interior nonzeros off the diagonal, bound "
        f"{mv['bound_ms'] * 1e3:.2f} us; torch.sparse.mm with a cold L2 "
        f"{mv['library_ms_cold'] * 1e3:.2f} us")
    log(f"  cg_update_direction: {ud['grid']} blocks of {ud['tiles_per_block']} tiles at "
        f"B = 1; " + "; ".join(
            f"B = {nbat}: {r['ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({100 * r['bound_ms'] / r['ms']:.0f} %), {r['grid']} blocks of "
            f"{r['tiles_per_block']} tiles, {r['bytes_read_again']} bytes read again "
            f"(bound with them {r['bound_ms_with_read_again'] * 1e3:.2f} us)"
            for nbat, r in ud["batches"].items()))
    log(f"a captured superstep's boundary work where no replica solves (assembly, CG setup, "
        f"residual), as a graph: {assembly_ms:.4f} ms; phase 11 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    records = [dict(name=name, route="cuda", source="devicekmc_tpu_torch/csrc/boundary_cg.cu",
                    replaces="devicekmc_tpu/ops/cg.py:112", launches=cg_launches,
                    launches_ensemble_path=cg_launches_ensemble,
                    bound_by="bytes", shape=f"1x{N}x{M} f64",
                    path="headline, captured graph (WHILE node body)", **r)
               for name, r in out.items()]
    summary = dict(iters=iters, x_err=x_err, solve_ms=solve_ms, eager_ms=eager_ms,
                   assembly_ms=assembly_ms, cg_launches_traced=n_seen,
                   cg_launches_traced_late_capture=n_seen_late)
    return records, summary


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from devicekmc_tpu_torch.ops import _build

    t_start = time.perf_counter()
    libs = ["ell_gather", "pairwise", "banded", "wkb_fly", "wkb_window", "kmc_events",
            "graph", "boundary_cg", "transport_cg"]
    latency_job = start_latency_build()
    _build.build(libs)
    finish_latency_build(latency_job)
    log(f"built kernels in {time.perf_counter() - t_start:.1f} s")
    for name in libs:
        regs = [l.strip() for l in _build.build_log(name).splitlines() if "registers" in l]
        log(f"  {name}: {regs}")
    u32, u64 = threefry_check()

    out_root = os.path.join(ROOT, "build", "chip_smoke")
    t0 = time.perf_counter()
    small_device_check(os.path.join(out_root, "small"))
    small_device_check(os.path.join(out_root, "small_current"), current=True, Vd=10.0)
    small_device_check(os.path.join(out_root, "small_heat_fly"), Vd=10.0, heat="global-fly")
    small_device_check(os.path.join(out_root, "small_heat_dense"), heat="global-dense")
    small_device_check(os.path.join(out_root, "small_heat_local"), Vd=10.0,
                       heat="local-dense")
    small_bf16_check(out_root)
    sim = small_device("cuda", os.path.join(out_root, "small_events"), precision="f64",
                       poisson_kernel="jnp")
    sim.run_bias_point(2.5, 1e30, max_steps=2)
    ev_small, draws_small = event_phase(sim.geom, sim.params, sim.state,
                                        EVENT_STEPS_SMALL, "small stack")
    small_batched_check(out_root)
    log(f"small-device checks in {time.perf_counter() - t0:.1f} s")

    run, draws_crossbar, event_record, kernels, (xsim, headline) = headline_path(out_root)
    torch.cuda.empty_cache()
    boundary_cg = boundary_cg_system(xsim)
    batched = crossbar_batched_check(out_root, run)
    torch.cuda.empty_cache()
    transport_launches, (presolve, steps, readbacks), tgraph, records = transport_path(
        out_root)
    kernels += records
    torch.cuda.empty_cache()
    heat_launches, hgraph, pdisp = heat_path(out_root)
    torch.cuda.empty_cache()
    readbacks_ref = cg_reference_run(out_root, (presolve, steps))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    small_modular_check(out_root)
    modular_launches = modular_path(out_root, run[0])
    torch.cuda.empty_cache()
    small_resume_checks(out_root)
    crossbar_resume_checks(out_root)
    torch.cuda.empty_cache()
    bf16_record, bf16_launches = bf16_transport_path(out_root, steps)
    torch.cuda.empty_cache()
    log(f"modular, checkpoint and bf16 phases in {time.perf_counter() - t0:.1f} s")
    ensemble_checks, ensemble = ensemble_path(out_root)
    torch.cuda.empty_cache()
    log("ensemble summary: " + json.dumps(ensemble))
    pdisp.update(launches_transport_path=transport_launches["wkb_fly_pdisp"],
                 launches_heat_path=pdisp["launches"])
    for k in kernels:
        k["launches_transport_path"] = transport_launches[k["name"]]
        k["launches_heat_path"] = heat_launches[k["name"]]
    # table order: the dissipation kernel stands before the window block
    kernels.insert(len(kernels) - 1, pdisp)
    for k in kernels + [event_record]:
        k["launches_bf16_transport_path"] = bf16_launches[k["name"]]
        if k["name"] in modular_launches:
            k["launches_modular_path"] = modular_launches[k["name"]]
    # the bf16 band stands beside the f32 one
    kernels.insert([k["name"] for k in kernels].index("banded_matvec") + 1, bf16_record)

    logs = time_log_check(u32 + draws_crossbar, u64 + draws_small)
    log("log of the time draw, kernel (CUDA's log) against the plain version (numpy's f64 "
        "log, rounded to the table's type): "
        + ", ".join(f"{kind} {n} of {total} draws differ, by at most {ulps} ulp"
                    for kind, (n, total, ulps) in logs.items()))
    event_record.update(
        launches_transport_path=transport_launches["kmc_event_loop"],
        launches_heat_path=heat_launches["kmc_event_loop"],
        max_abs_err=max(event_record["max_abs_err"], ev_small["max_abs_err"]),
        max_rel_err=max(event_record["max_rel_err"], ev_small["max_rel_err"]),
        events_phase_small={key: ev_small[key] for key in (
            "table", "events", "ms_per_superstep", "plain_ms_per_superstep",
            "ms_per_event", "plain_ms_per_event", "step_time_bit_equal", "steps")},
        time_log_differs={kind: {"draws": n, "of": total, "max_ulps": ulps}
                          for kind, (n, total, ulps) in logs.items()},
        batched_crossbar=batched,
        cg_readbacks_transport_run=readbacks, cg_readbacks_read_every_iteration=readbacks_ref)
    kernels.append(event_record)
    kernels += batched_records((headline.pop("kernel_checks"), headline["launches_graph"]),
                               ensemble_checks)
    cg_records, cg_summary = boundary_cg_path(xsim, boundary_cg,
                                              headline["launches_graph"]["boundary_cg"],
                                              ensemble["cg_iterations_card"])
    del xsim
    torch.cuda.empty_cache()
    kernels += cg_records
    tcg_records = transport_cg_records(tgraph.pop("kernel_checks"), tgraph["launches_card"])
    for rec in tcg_records:
        rec["launches_heat_graph_run"] = hgraph["launches_card"][rec["name"]]
    kernels += tcg_records
    log("headline graph summary: " + json.dumps({**headline, **cg_summary}))
    log("transport graph summary: " + json.dumps(tgraph))
    log("heat (global) graph summary: " + json.dumps(hgraph))
    log(f"profiled calls taken again after a trace without device records: "
        f"{len(empty_traces)} {empty_traces}; launches in the traces of the profiled calls "
        f"against their counts: {traced_totals()}")
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
