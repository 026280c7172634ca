#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):

1. builds the eleven CUDA libraries from devicekmc_tpu_torch/csrc (nvcc,
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
   counts itself (csrc/launch_count.cuh); cg_matvec_dot's launches on the
   card equal to the iterations the device counts, each CG kernel in the
   trace at most as often and never where it counts none; a trace may miss
   launches, so each kernel counted need show only in some trace of the
   run); then the
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
   each transport CG kernel of the nested WHILE bodies launched on the card
   as it counts them, in the trace at most that often and, over the run,
   in some trace); the capture seconds at a second
   bias point (Vd = 1.05 V, 2 supersteps); the transport CG's kernels
   (blocks, f32 and f64 builds; transport_rows_update, the inner tail of
   rows, update and direction that packs, warm and cold L2, a stopped
   iterate's launch left as it was; the f64 rows, the f64 pack, refine)
   against their plain versions at the path's shapes, timed
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
   contact spans) on the eager driver, with the branch taken, the substeps
   and the CG iterations of every step, and the same on the captured graph
   (the main path of this configuration: the local model's substeps a WHILE
   node with the CG's nested in it, csrc/heat.cu; counters to 0 around it,
   the heat kernels' launches and CG iterations as the card counts them)
   held bit for bit step for step against the eager run (the temperature
   field, T_bg and the loops' logs too), both in turns with one profiled
   superstep each (1 device-to-host copy a graph superstep); heat_cg_begin
   and heat_cg_end against their plain versions at this model, timed beside
   their bytes bounds; the heat phase alone, captured and from the host loop
   of the same kernels; then the small stack with transport on the fly and
   the dense local model, 4 supersteps eager and on the graph, bit for bit,
   in turns, and heat_dense_substep against its plain version at the run's
   interface and at 192, 512, 2,048 and 8,192 sites in f32 and f64, timed
   beside its bytes bound, the plain version and torch.mv, with the form it
   took (heat_cg_begin also with a cold L2);
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
   supersteps, a checkpoint in each backend (npz, the dcp directory, the
   dcp_async background write), 2 more before the wait for that write,
   against a fresh Simulation that loads each in turn (the state at the
   save) and runs the same 2: element, charge, key, kmc_time, I_macro,
   virtual_potentials and CB_edge bit for bit; each backend's save, load
   and host-blocked seconds and MiB; the kernels' launches in these runs
   (counters to 0 just before, read just after);
9. the transport configuration of phase 4 with transport_bf16_inner and
   transport_tol 1e-6 (the option's 1e-2 tightening makes it phase 4's
   1e-8) on the eager driver, counters set to 0 just before: cold solves
   and 4 supersteps, every solve converged, every transport kernel launched
   and the band bf16, the iterations and currents beside phase 4's; the
   same run on the captured graph (the main path: the bf16 band and its
   row_fix in the inner body) bit for bit step for step against it, in
   turns, 1 device-to-host copy a graph superstep; then the bf16 band
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
   WHILE node's body in a profiled replay as the card counts them, and in
   its trace at most that often),
   each of the two kernels (cg_matvec_dot, cg_update_direction) against its
   plain version, timed back to back and with a cold L2 beside its bytes
   bound (the matvec's: the operator's interior nonzeros, value and index,
   the interior rows' diagonal, p, ap and the row lengths, each once; the
   update and direction's: eight vectors; the matvec also beside
   torch.sparse.mm of the operator in CSR), cg_update_direction also at
   B = 8 and 32 beside its bound and the bytes its blocks read again, and
   the boundary work a captured superstep adds where no replica solves,
   captured and timed;
12. the halo decomposition (parallel.halo_superstep) at world size 1
   through NCCL (an in-process store, cuda:0): the crossbar in f64 (solver_tol
   1e-12, the JAX package's halo test's) over the
   halo path and on the single-device eager superstep, each its cold pre-solve
   and 3 supersteps at Vd = 1 V, the halo run driven with the wrappers'
   counts set to 0 just before and read just after (the gather launched,
   its plain version never, the pair sweep and event kernels not): events,
   elements and charges equal step for step, potential_boundary within
   1e-8 of its scale, kmc_time within 1e-6 relative; the ms a superstep of
   both, the collectives a superstep by kind, the boundary CG iterations;
   the ms of the halo superstep's four phases; the same in mixed
   precision, timed, its events printed and not gated;
   the halo width beside the slab at 2, 4 and 8 cards; then the transport
   runs (halo_transport_path): the transport settings of PERF.md §4 with
   global heat, f64 (solver and transport tolerance 1e-12) and mixed,
   against the single device's eager run, counters to 0 around the halo
   run: the window kernel once an assembly in mixed precision (its plain
   version never), the pair-sweep, band, on-the-fly and event kernels
   never; events, elements, charges equal step for step and every solve
   converged; at the first superstep's state the halo operator against
   assemble_X_blocks's on a seeded vector (1e-12 of its scale in f64, 1e-6
   mixed) and the tunnel rows alone, in f64 the power extraction of one
   potential vector (1e-12) and the local cg heat model on a seeded power
   that moves T by 10 K (1e-8 K); I_macro and P_tot printed, the ms of the
   six phases, the collectives, the CG iterations, an operator
   application's and a collective's ms, the application's device busy
   share, copies and launches under torch.profiler; the group destroyed at
   the end;
13. the replicated decomposition at world size 1 through NCCL
   (replicate_path): the crossbar's headline in f64 and mixed and the
   transport configuration with global heat against the single device's
   eager run bit for bit, the pair sweep over a row range, the replica
   axis along "batch", the 2-D ("batch", "sites") mesh (mesh2d_check: a
   (1, 1) mesh, each replica bit-equal to the single device's eager
   superstep with its key, the gather, pair-sweep and event-loop launches
   counted), and checkpoints in every backend under both decompositions;
14. the stored metal block (what transport_cc = "auto" picks) and f64 in the
   captured transport superstep (stored_path, after phase 6): the crossbar
   with transport_cc = "stored", heating off and global (cold solves + 8
   supersteps), and in f64 (cold solves in one call + 4), each eagerly and
   on the captured graph, the main path of these configurations (counters
   to 0 just before and read just after: the stored block's product
   launched, the fly matvec never; in f64 the f64 solve's set-up and
   iterations counted on the card), bit for bit step for step, in turns
   with one profiled superstep each (1 device-to-host copy a graph
   superstep); the fly transport graph against the stored one in turns
   (what "auto" costs); stored_matvec against its plain version at the
   crossbar's blocks (f32, f64) and at the reference crossbar's 24,768
   metal atoms (f32, f64), warm and with a cold L2, beside its bytes bound,
   torch.mv and the fly matvec; the f64 solve's kernels (transport_blocks'
   f64-storage build, transport_tail64: the rows of A p, the update and the
   direction in one launch) against their plain versions and timed, warm
   and with a cold L2, and the f64 solve captured
   against its host loop, bit for bit.  The f64 runs take the exact-erfc
   Poisson sweep (poisson_kernel "jnp", the exact kernel once a superstep,
   the pair sweep never): with the stored block, the JAX package's full
   default;
15. the default Poisson sweep (poisson_kernel "jnp", default_path): the
   headline crossbar with "jnp" on its captured graph (the main path) and
   on its eager superstep, counters set to 0 just before each run and read
   just after (the exact kernel, csrc/pairwise_exact.cu, once a superstep
   as the card counts it, the pair sweep and every plain version never),
   events, elements, charges and potential_charge bit for bit step for
   step, potential_boundary within 1e-12 of its scale; both again in turns,
   one profiled superstep each (1 device-to-host copy a graph superstep);
   its ensemble at B = 8 on the graph against the eager batched superstep,
   superstep by superstep, bit for bit the same way; then the exact kernel
   against its plain version at the crossbar's rows over the run's charged
   sites, over a full bucket of 8,192 sources and over more (the bucket's
   bits), over none, B = 1 and 8 (each replica its own launch's bits), a
   quarter of the rows bit-equal to the whole sweep's, f32 within 1e-5 and
   f64 within 1e-12 of the scale, PBC on at the small stack, two calls
   bit-equal; timed beside its bound and the plain version.  Phase 12's
   halo runs sweep with the same kernel (their Poisson phase timed).

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


def time_ms_clean(fn, reps=20, warmup=3):
    """Time of one call after a 64 MiB buffer (more than the 50 MB L2) was
    read, not written: time_ms_cold with the L2 full of clean lines, as a
    solve's iteration leaves it (its static operator read, few stores)."""
    import torch

    scrub = torch.ones(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        scrub.sum()
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

def small_device(device, out_dir, current=False, heat=None, fused=True, mesh=None,
                 decomposition="replicate", **overrides):
    """The 256-site stack of tests/test_golden_trajectory.py with the
    headline modules; ``current`` adds blocked transport as the transport
    path runs it (transport_tol 1e-11: two solves that meet the default
    1e-8 agree on I_macro only to ~3e-5); ``heat`` adds Joule heating:
    "global-fly" (blocked on-the-fly transport, global model), "global-dense"
    (f64, dense transport, global model: the golden trajectory's
    configuration), "local-dense" (blocked transport, stored metal block,
    local model with the dense propagators); ``fused=False`` selects the
    modular driver; ``mesh`` runs it over ``decomposition``; ``overrides``
    replace single configuration fields."""
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
                      fused=fused, mesh=mesh, decomposition=decomposition)


def synthetic_crossbar(n_sites, device, out_dir, current=False, heat=None, fused=True,
                       mesh=None, decomposition="halo", **overrides):
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
    superstep; ``mesh`` (parallel.make_mesh) runs it over ``decomposition``
    (the halo decomposition, or "replicate"); ``overrides`` replace single
    configuration fields."""
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
    sim = Simulation(cfg, elements=elems, coords=s.coords, device=device, fused=fused,
                     mesh=mesh, decomposition=decomposition)
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


def _close(name, got, ref, tol, atol=0.0):
    """max|got - ref| <= tol * max|ref| + atol (f32 sums in another order,
    FMA contraction, one-ulp exp and sqrt); returns the absolute error."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: output finite")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    check(scale > 0, f"{name}: the plain version is all zero")
    check(err <= tol * scale + atol, f"{name}: max error {err} > {tol} * {scale} + {atol}")
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
    shared bytes of that entry (found by its mangled template arguments: a
    bool or an int, or a type by its mangled letter, "f" or "d"), and the
    device kernels one call of ``fn`` launches, which must
    be that kernel alone (partial sums are added inside it)."""
    from devicekmc_tpu_torch.ops import _build

    mangled = kernel + ("I" + "".join(
        a if isinstance(a, str) else f"L{'b' if isinstance(a, bool) else 'i'}{int(a)}E"
        for a in targs) + "E" if targs else "")
    found = [v for k, v in _build.kernel_resources(lib).items() if mangled in k]
    regs, smem = found[0] if len(found) == 1 else (None, None)
    count, names = device_launches(fn)
    if count is not None:
        check(count == 1 and all(kernel in nm for nm in names),
              f"{kernel}: one call made {count} launches, of {names}")
    label = kernel + (f"<{','.join(a if isinstance(a, str) else str(int(a)) for a in targs)}>"
                      if targs else "")
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
#: record is the kernel's whose stem is the longest it holds)
TRACE_NAMES = {name: f"{name}_kernel" for name in (
    "ell_gather", "ell_gather_batched", "poisson_pairwise", "poisson_pairwise_batched",
    "kmc_event_loop", "kmc_event_loop_batched", "cg_matvec_dot", "cg_update_direction",
    "transport_blocks", "transport_rows", "transport_rows_update", "transport_pack",
    "transport_refine", "stored_matvec", "transport_tail64")}
TRACE_NAMES["poisson_exact_batched"] = "poisson_exact_kernel"
CG_KERNELS = ("cg_matvec_dot", "cg_update_direction")
#: the transport CG's kernels, each in the trace of a graph superstep that
#: solves
TRANSPORT_TRACED = ("transport_blocks", "transport_rows_update", "transport_rows",
                    "transport_pack", "transport_refine")
#: those of the f64 solve (phase 14)
TRANSPORT_TRACED_F64 = ("stored_matvec", "transport_blocks", "transport_rows",
                        "transport_tail64")


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
    by the card's count of the CG kernels and their trace (cg_seen)."""
    check(seen is not None, f"{tag}: a profiler trace came back without device records")
    for name in wrappers:
        if card is not None and name in card:
            check(card[name] == counted[name], f"{tag}: {name} counted {counted[name]} "
                  f"launches on the host, {card[name]} on the card")
    trace_at_most(tag, seen, {name: counted[name] for name in wrappers})
    if iters is not None:
        cg_seen(tag, seen, iters, card)


def trace_at_most(tag, seen, counted):
    """Each kernel of ``counted`` (its launches in a profiled call, as the
    card or a wrapper counts them) in that call's trace (``seen``) at most
    as often, none where it counts none; added to the run's totals
    (traced), which traced_totals checks."""
    for name, n in counted.items():
        check(seen[name] <= n, f"{tag}: {name} launched {n} times, the trace shows "
              f"{seen[name]} (counted {counted}, trace {seen})")
        total = traced.setdefault(name, [0, 0])
        total[0] += seen[name]
        total[1] += n


def traced_totals():
    """Every kernel counted in the profiled calls also seen in their traces
    (traced: launches seen, launches counted); returns the totals."""
    for name, (seen, counted) in traced.items():
        check(seen > 0 or counted == 0, f"{name}: {counted} launches in the profiled calls, "
              "none in their traces")
    return {name: tuple(t) for name, t in traced.items()}


def cg_seen(tag, seen, iters, card):
    """The two CG kernels of a call in which the device counted ``iters``
    iterations (cg_update_direction's own count): cg_matvec_dot launched
    ``iters`` times as the card counts it (``card``: its counts in the
    call), and each kernel in the call's trace (``seen``) at most ``iters``
    times (trace_at_most).  The trace misses some launches: of a captured
    loop of 46 iterations on an H100 it showed 43 or 44 of each kernel, in
    different numbers for each, of a replay of the ensemble's superstep one
    of its two batched gathers, and of a superstep of one iteration no
    cg_update_direction, so the card's counts stand for the launches.
    Returns each kernel's launches in the trace."""
    check(card["cg_matvec_dot"] == iters, f"{tag}: {iters} CG iterations on the device, "
          f"{card['cg_matvec_dot']} launches of cg_matvec_dot on the card")
    trace_at_most(tag, seen, dict.fromkeys(CG_KERNELS, iters))
    return {k: seen[k] for k in CG_KERNELS}


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
                  "transport_rows_update")


def transport_record(sim):
    """Wrap ``sim``'s superstep: per step the fields the transport and heat
    phases write (device copies), the metrics and, with the local heat model,
    its branch, substeps and CG iterations (``heat.last_local``).  Returns
    the list."""
    from devicekmc_tpu_torch.physics import heat as heat_mod

    recs = []
    step = sim._superstep
    local = sim.params.solve_heating_local and not sim.params.solve_heating_global

    def wrapped(state, Vd, *rest):
        out = step(state, Vd, *rest)
        st, m = out[0], out[2]
        recs.append(dict(
            element=st.element.clone(), vp=st.virtual_potentials.clone(),
            tt=(st.tt_slot_atom.clone(), st.tt_vm.clone(), st.tt_vv.clone()),
            power=st.power.clone(), temperature=st.temperature.clone(), step_time=out[1],
            scalars=(st.I_macro, st.P_tot, st.T_bg, bool(st.tt_valid)),
            local=dict(heat_mod.last_local) if local else None,
            metrics={k: float(v) for k, v in m.items() if not k.startswith("Z - ")}))
        return out

    sim._superstep = wrapped
    return recs


def same_transport_steps(tag, ref, got):
    """Two transport runs (transport_record) bit for bit, step for step: the
    events, elements, cg_iters_power, I_macro, P_tot, T_bg, the virtual
    potentials, the site power, the temperature field and the tunnel store,
    every metric, and the local heat model's branch, substeps and CG
    iterations."""
    import torch

    check(len(ref) == len(got), f"{tag}: {len(ref)} and {len(got)} supersteps")
    for k, (a, b) in enumerate(zip(ref, got)):
        diff = [key for key in ("element", "vp", "power", "temperature")
                if not torch.equal(a[key], b[key])]
        if a["local"] != b["local"]:
            diff.append(f"the local heat model's loops {a['local']} against {b['local']}")
        if not all(torch.equal(u, v) for u, v in zip(a["tt"], b["tt"])):
            diff.append("the tunnel store")
        if a["scalars"] != b["scalars"] or a["step_time"] != b["step_time"]:
            diff.append(f"scalars {a['scalars']} against {b['scalars']}")
        # (a NaN equals a NaN: the f64 solve's transport_rel0, as eagerly)
        metrics = {key: (v, b["metrics"].get(key)) for key, v in a["metrics"].items()
                   if v != b["metrics"].get(key) and not (v != v and b["metrics"].get(key)
                                                          != b["metrics"].get(key))}
        check(not diff and not metrics, f"{tag}: step {k}: {diff} differ; metrics {metrics}")


def transport_graph_run(sim, tag, n_steps=TRANSPORT_STEPS, wrappers=None, Vd=VD_MAIN):
    """Counters to 0, ``sim.run_bias_point`` (cold solves + ``n_steps`` at
    ``Vd``), read: (records, card counts, wrapper counts, wall s).  No plain
    version of a transport CG or heat kernel may run."""
    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import heat as heat_ops
    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.ops import transport_cg as tcg

    wrappers = wrappers or {}
    for w in wrappers.values():
        w.launches = 0
    _build.launch_counts("cuda").zero_()
    plains = [_counted(tcg, name) for name in ("pack_plain", "blocks_plain", "rows_plain",
                                               "update_pack_plain", "rows_update_plain",
                                               "refine_plain", "stored_matvec_plain",
                                               "rows_ap_plain", "update_f64_plain")]
    plains += [_counted(heat_ops, name) for name in ("dense_substep_plain", "cg_begin_plain",
                                                     "cg_end_plain")]
    plains += [_counted(pw, name) for name in ("poisson_exact_batched_plain",
                                               "poisson_pairwise_batched_plain")]
    recs = transport_record(sim)
    try:
        t = time.perf_counter()
        sim.run_bias_point(Vd, 1e30, max_steps=n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        sim.__dict__.pop("_superstep", None)
        for _, restore in plains:
            restore()
    check(all(rec["calls"] == 0 for rec, _ in plains), f"{tag}: a plain version ran")
    check(len(recs) == n_steps, f"{tag}: ran {len(recs)} supersteps")
    return recs, card_counts(), {name: w.launches for name, w in wrappers.items()}, wall


def transport_turns(sim, sim_e, tag, turns=TRANSPORT_TURNS, Vd=VD_MAIN,
                    kernels=TRANSPORT_TRACED):
    """The graph and the eager driver again, superstep by superstep in turns
    (elements, I_macro and the virtual potentials equal): wall ms of each;
    one superstep of each under torch.profiler (device busy share,
    device-to-host copies: 1 a graph superstep; in a graph superstep that
    solves, each of ``kernels`` launched as the card counts it, and in the
    trace at most that often, trace_at_most)."""
    import torch

    def step(s):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.state, _, m = s._superstep(s.state, Vd)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, m

    ms_g, ms_e = [], []
    for _ in range(turns):
        (tg, mg), (te, me) = step(sim), step(sim_e)
        check(torch.equal(sim.state.element, sim_e.state.element)
              and sim.state.I_macro == sim_e.state.I_macro
              and torch.equal(sim.state.virtual_potentials, sim_e.state.virtual_potentials)
              and torch.equal(sim.state.temperature, sim_e.state.temperature)
              and mg["cg_iters_power"] == me["cg_iters_power"],
              f"{tag}: graph and eager supersteps in turns differ")
        ms_g.append(tg)
        ms_e.append(te)
    prof, inner, card0 = {}, {}, {}
    for name, s in (("graph", sim), ("eager", sim_e)):
        prev = s.state
        prof[name] = profile_calls(lambda: inner.__setitem__(name, step(s)[1]), 1,
                                   reset=lambda: setattr(s, "state", prev),
                                   before=lambda: card0.update(card_counts()))
        check(prof[name][1] is not None, f"{tag} {name}: a trace without device records")
        inner[name] = int(inner[name]["cg_iters_power"])
        if name == "graph":
            now = card_counts()
            card = {k: now[k] - card0[k] for k in kernels}
    check(prof["graph"][2] == 1, f"{tag}: {prof['graph'][2]} device-to-host copies a graph "
          "superstep, not 1")
    # the kernels of the graph's nested WHILE bodies: on the card, and in its trace
    check(inner["graph"] == 0 or all(card.values()), f"{tag}: a graph superstep of "
          f"{inner['graph']} inner iterations launched {card} on the card")
    trace_at_most(f"{tag} graph superstep", prof["graph"][3], card)
    seen = {k: prof["graph"][3][k] for k in kernels}
    out = dict(ms_turns_graph=ms_g, ms_turns_eager=ms_e,
               median_turns_graph=statistics.median(ms_g),
               median_turns_eager=statistics.median(ms_e),
               busy_graph=100 * prof["graph"][1] / prof["graph"][0],
               busy_eager=100 * prof["eager"][1] / prof["eager"][0],
               dtoh_graph=prof["graph"][2], dtoh_eager=prof["eager"][2],
               traced_graph=dict(seen, inner_iterations=inner["graph"]), card_graph=card)
    log(f"{tag} in turns, {turns} supersteps each: graph median "
        f"{out['median_turns_graph']:.2f} ms ({[round(x, 2) for x in ms_g]}), eager median "
        f"{out['median_turns_eager']:.2f} ms ({[round(x, 2) for x in ms_e]}); one profiled "
        f"superstep each: device busy graph {out['busy_graph']:.1f} %, eager "
        f"{out['busy_eager']:.1f} %; device-to-host copies graph {out['dtoh_graph']}, eager "
        f"{out['dtoh_eager']}; the transport CG's kernels in the graph superstep's trace "
        f"{out['traced_graph']}, on the card {card}")
    return out


#: the wrappers (beside the batched ones) whose launches a transport graph
#: run reports, by name: the cold solves' allocating band and fly matvec, the
#: window block and the dissipation kernel (the graph counts these last two
#: at each replay)
GRAPH_RUN_WRAPPERS = (("banded", "banded_matvec"), ("wkb_fly", "wkb_fly_matvec"),
                      ("wkb_window", "wkb_window_block"), ("wkb_fly", "wkb_fly_pdisp"))


def transport_graph_phase(out_root, heat, eager_run, second_point=True, n_steps=TRANSPORT_STEPS,
                          tag=None, make=None, Vd=VD_MAIN, **overrides):
    """The main path of the transport (``heat`` None or False), heat (True
    or "global": the global model; "local": the matrix-free local model) or
    another configuration of the crossbar (``overrides`` of
    synthetic_crossbar's fields; ``make(dir)``: the simulation itself): the
    captured graph, counters set to 0 just before cold solves + ``n_steps``
    supersteps and read just after, then held bit for bit step for step
    against ``eager_run`` (``(sim_e, records)``, the eager driver's run of
    the same configuration), the two in turns, and with ``second_point`` the
    graph captured at a second bias point; ``Vd`` the bias.  With the local
    model its
    kernels' launches on the card and the CG iterations counted there
    (``heat.ws.cg.total``) against the steps' logs.  Returns (sim,
    summary)."""
    import importlib

    import torch

    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.ops import pairwise as pw

    heat = "global" if heat is True else (heat or None)
    tag = tag or {"global": "heat (global) graph", "local": "heat (local) graph",
                  None: "transport graph"}[heat]
    # the memory this run holds once built and the most it allocates while
    # it runs, beyond what was live before it (the eager run's)
    before = torch.cuda.memory_allocated()
    out_dir = os.path.join(out_root, tag.replace(" ", "_").replace("(", "").replace(")", ""))
    sim = make(out_dir) if make is not None else synthetic_crossbar(
        N_SITES, "cuda", out_dir, current=True, heat=heat, **overrides)
    built_gib = (torch.cuda.memory_allocated() - before) / 2**30
    torch.cuda.reset_peak_memory_stats()
    check(sim._graph_for(sim.params) is not None,
          f"{tag}: the configuration does not run the captured graph")
    local = sim.params.solve_heating_local and not sim.params.solve_heating_global
    batched = {"ell_gather_batched": eg.ell_gather_batched,
               "poisson_pairwise_batched": pw.poisson_pairwise_batched,
               "kmc_event_loop_batched": kmc_events.kmc_event_loop_batched}
    others = {name: getattr(importlib.import_module(f"devicekmc_tpu_torch.ops.{mod}"), name)
              for mod, name in GRAPH_RUN_WRAPPERS}
    heat_cg = local and sim.heat.method == "cg"
    if heat_cg:
        sim.heat.ws.cg.total.zero_()
    recs, card, host, wall = transport_graph_run(sim, tag, n_steps=n_steps,
                                                 wrappers={**batched, **others}, Vd=Vd)
    peak_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    graph = sim._graph
    n = n_steps
    check(graph.replays == n and graph.captures == 2,
          f"{tag}: {graph.replays} replays, {graph.captures} captures")
    # the gather: the charge rule's flags, in mixed precision the rate
    # table's rows too
    gathers = 2 * n if sim.params.mixed else n
    # the Poisson sweep: the exact kernel (poisson_kernel "jnp") or the pair
    # sweep, once a superstep, the other never
    sweep, no_sweep = ("poisson_exact_batched", "poisson_pairwise_batched")[
        ::1 if sim.params.poisson_kernel == "jnp" else -1]
    check(card["ell_gather_batched"] == gathers and card[sweep] == n and card[no_sweep] == 0
          and card["kmc_event_loop_batched"] == n, f"{tag}: batched launches {card}")
    steps = sim.step_log
    inner = sum(int(s["cg_iters_power"]) for s in steps)
    p = sim.params
    metal = "wkb_fly_matvec_out" if p.transport_cc == "fly" else "stored_matvec"
    if p.mixed:
        for name in TRANSPORT_CARD + (metal,):
            check(card[name] > 0 or name == "wkb_fly_matvec_out" and metal != name,
                  f"{tag}: {name} was not launched on the card ({card})")
        # the inner body launches no pack: the f64 pack and rows, the metal
        # block's and blocks' extra launches come from the round ends (one a
        # refine), the fused tail and the band from the inner iterations
        ends = card["transport_refine"]
        other = "stored_matvec" if metal == "wkb_fly_matvec_out" else "wkb_fly_matvec_out"
        check(card["transport_pack"] == card["transport_rows"] == ends
              and card["transport_rows_update"] == card["banded_matvec_out"] == inner
              and card["transport_blocks"] == card[metal] == inner + ends
              and card[other] == card["transport_tail64"] == 0,
              f"{tag}: launches on the card {card} against {inner} inner iterations and "
              f"{ends} round ends")
    else:
        # the f64 solve: a set-up a graph superstep (the stored product,
        # blocks and the residual form of the rows), then an iteration's
        # product, blocks and tail (the rows of A p, update, direction)
        check(card["transport_tail64"] == inner and card["transport_rows"] == n
              and card["stored_matvec"] == card["transport_blocks"] == inner + n
              and all(card[k] == 0 for k in ("wkb_fly_matvec_out", "banded_matvec_out",
                                             "transport_pack", "transport_refine",
                                             "transport_rows_update")),
              f"{tag}: launches on the card {card} against {inner} iterations and {n} "
              "set-ups")
    rounds = sum(int(s["cg_iters_power"] > 0) for s in steps)
    check(all(s["transport_converged"] == 1.0 for s in steps), f"{tag}: a solve did not "
          "converge")
    heat_log = {}
    if local:
        logs = [r["local"] for r in recs]
        passes = sum(ll["substeps"] if ll["branch"] == "transient" else 1 for ll in logs)
        cg_iters = sum(ll["cg_iters"] for ll in logs)
        heat_log = dict(branches=[ll["branch"] for ll in logs],
                        substeps=[ll["substeps"] for ll in logs],
                        cg_iters=[ll["cg_iters"] for ll in logs],
                        cg_iters_card=int(sim.heat.ws.cg.total) if heat_cg else 0)
        counted = ("heat_cg_begin", "heat_cg_end") if sim.heat.method == "cg" \
            else ("heat_dense_substep",)
        check(all(card[name] == passes > 0 for name in counted),
              f"{tag}: heat launches on the card {card} against {passes} passes of the loops")
        check(not heat_cg or heat_log["cg_iters_card"] == cg_iters > 0,
              f"{tag}: {heat_log['cg_iters_card']} heat CG iterations on the card against "
              f"the steps' {cg_iters}")
    sim_e, recs_e = eager_run
    same_transport_steps(f"{tag} against eager", recs_e, recs)
    turns = transport_turns(sim, sim_e, tag, Vd=Vd,
                            kernels=TRANSPORT_TRACED if sim.params.mixed
                            else TRANSPORT_TRACED_F64)
    first = list(graph.capture_s)
    t = time.perf_counter()
    if second_point:
        sim.run_bias_point(VD_SECOND, 1e30, max_steps=2)
        torch.cuda.synchronize()
    second = graph.capture_s[len(first):]
    check(len(second) == (2 if second_point else 0),
          f"{tag}: {len(second)} captures at the second bias point")
    key = "Z - calculation time - KMC superstep [s]"
    later = steps[2:] or steps
    ms = [s[key] * 1e3 for s in later]
    ms_e = [s[key] * 1e3 for s in sim_e.step_log[len(steps) - len(later):n]]
    log(f"{tag}: run_bias_point (cold solves + {n} supersteps) in {wall:.2f} s on the graph "
        f"({graph.captures} captures of {[round(x, 3) for x in first]} s; at {VD_SECOND} V "
        f"{[round(x, 3) for x in second]} s, that bias point in {time.perf_counter() - t:.2f} "
        f"s); launches on the card {card}; wrappers {host}; {inner} inner CG iterations in "
        f"{n} supersteps; memory held once built {built_gib:.3f} GiB, the most while it ran "
        f"{peak_gib:.3f} GiB; "
        f"events, elements, cg_iters_power, I_macro, P_tot, T_bg, the virtual potentials, "
        f"the site power, the temperature field and the tunnel store equal to the eager "
        f"run step for step" + (f"; local heat model {heat_log}" if local else ""))
    log(f"{tag} supersteps{' after 2' if len(later) < len(steps) else ''}: graph median "
        f"{statistics.median(ms):.2f} ms (min "
        f"{min(ms):.2f}, max {max(ms):.2f}), eager median {statistics.median(ms_e):.2f} ms; "
        "step by step (graph / eager ms, inner iterations): "
        + ", ".join(f"{a[key] * 1e3:.1f} / {b[key] * 1e3:.1f} ({int(a['cg_iters_power'])})"
                    for a, b in zip(steps, sim_e.step_log[:n])))
    return sim, dict(wall_s=wall, captures_first_s=first, captures_second_s=second,
                     launches_card=card, launches_host=host, inner_iterations=inner,
                     solving_steps=rounds, built_gib=built_gib, peak_gib=peak_gib,
                     median_ms=statistics.median(ms),
                     median_ms_eager=statistics.median(ms_e), local_heat=heat_log, **turns)


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
    their bytes bounds; transport_rows_update's update against the boundary
    build of cg_update_direction from its own ap and alpha (bit-equal), its
    pack against pack_plain of its new direction (bit-equal), a stopped
    iterate's launch (nothing moves); the band's and the fly matvec's out= entries
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
        return _map_ws(ws, lambda t: t.clone())

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
              dots_rel_err=e_dot, cold_ms=time_ms_cold(lambda: tcg.blocks(k, op, hi)))
        r = out[f"blocks_{'hi' if hi else 'lo'}"]
        log(f"transport_blocks <{'double' if hi else 'float'},float>: {r['ms']:.5f} ms, cold "
            f"{r['cold_ms']:.5f}; bound {r['bound_ms']:.5f} ms "
            f"({100 * r['bound_ms'] / r['ms']:.0f} %)")
    # transport_rows (f64): r and r.r
    k = clone(base)
    tcg.pack(k, op, True)
    tcg.fly(k, op)
    tcg.blocks(k, op, True)
    p = clone(k)
    tcg.rows(k, op)
    tcg.rows_plain(p, op, True)
    scale = float((op.b - p.r).abs().max())
    e = err(k.r, p.r)
    check(e <= 1e-9 * scale, f"transport_rows (f64): {e} from its plain version (scale {scale})")
    # the bound of the kernel's own inputs (a valid slot's int32 index, a
    # class byte an atom, the slice starts; the rows' vectors), and of the
    # inputs of the row-major ELL it replaced (a valid slot's f64
    # conductance and int32 index)
    common = i4 * na * 2 + f4 * n_mp * 2 + f4 * nv * 2 + f8 * (dots_terms + 2 + 4 * nsub) \
        + f8 * nsub
    timed("rows_hi", lambda: tcg.rows(k, op), lambda: tcg.rows_plain(p, op, True),
          common + i4 * nnz + na + i4 * op.nb_start.numel(), e, rel_err=e / scale,
          bound_parent_inputs_ms=(common + (f8 + i4) * nnz) / PEAK_BYTES_PER_S * 1e3,
          cold_ms=time_ms_cold(lambda: tcg.rows(k, op)))
    r = out["rows_hi"]
    log(f"transport_rows (f64, residual form): {r['ms']:.5f} ms, cold {r['cold_ms']:.5f}; bound "
        f"{r['bound_ms']:.5f} ms ({100 * r['bound_ms'] / r['ms']:.0f} %), of the row-major "
        f"ELL's inputs {r['bound_parent_inputs_ms']:.5f}")

    # transport_rows_update: the rows, the update and the direction packed,
    # from one iteration's products, against rows_plain then
    # update_pack_plain; its update bit-equal to the boundary build of
    # cg_update_direction from the kernel's own ap and alpha, its packed
    # direction to pack_plain of its own p; a stopped iterate left as it was
    tcg.products(base, op)
    k, b, p = clone(base), clone(base), clone(base)
    tcg.rows_update(k, op)
    tcg.rows_update_plain(p, op)
    scale_ap = float(p.cg.ap.abs().max())
    e_ap = err(k.cg.ap, p.cg.ap)
    terms = float((base.cg.p * p.cg.ap).abs().sum())
    rz0 = float(base.cg.rz)
    e_pap = abs(rz0 / float(k.cg.alpha) - rz0 / float(p.cg.alpha)) / terms
    e_vec = {f: err(getattr(k.cg, f), getattr(p.cg, f)) / float(getattr(p.cg, f).abs().max())
             for f in ("x", "r", "p")}
    e_vec.update({f: err(getattr(k, f), getattr(p, f)) / float(getattr(p, f).abs().max())
                  for f in ("xs32", "xw", "xm")})
    e_sc = {f: abs(float(getattr(k.cg, f)) / float(getattr(p.cg, f)) - 1)
            for f in ("rz", "rr", "beta")}
    check(e_ap <= 2e-6 * scale_ap and e_pap <= 1e-6 and max(e_vec.values()) <= 1e-5
          and max(e_sc.values()) <= 1e-4,
          f"transport_rows_update: ap {e_ap} (scale {scale_ap}), p.ap {e_pap} of its terms, "
          f"vectors {e_vec} and scalars {e_sc} relative from its plain version")
    for f in ("act", "iters", "ctl", "cond", "total"):
        check(torch.equal(getattr(k.cg, f), getattr(p.cg, f)),
              f"transport_rows_update: {f} differs from its plain version")
    b.cg.ap.copy_(k.cg.ap)
    b.cg.alpha.copy_(k.cg.alpha)
    bcg.cg_update_direction(b.cg, tcg.INNER_MAXITER)
    for f in ("x", "r", "act", "iters", "ctl", "cond"):
        check(torch.equal(getattr(k.cg, f), getattr(b.cg, f)),
              f"transport_rows_update: {f} differs from the boundary build's update")
    ref = clone(k)
    tcg.pack_plain(ref, op, False)
    check(all(torch.equal(getattr(k, f), getattr(ref, f)) for f in ("xs32", "xw", "xm")),
          "transport_rows_update: the packed direction differs from pack_plain's")
    st = clone(base)
    # (a converged iterate: r.r at its threshold, the flag down)
    st.cg.act.fill_(False)
    st.cg.thresh2.copy_(st.cg.rr)
    before = clone(st)
    tcg.rows_update(st, op)
    moved = [f for f in ("x", "r", "p", "ap", "rz", "rr", "alpha", "beta", "iters", "act")
             if not torch.equal(getattr(st.cg, f), getattr(before.cg, f))]
    moved += [f for f in ("xs32", "xw", "xm") if not torch.equal(getattr(st, f),
                                                                 getattr(before, f))]
    check(not moved and int(st.cg.cond) == 0
          and int(st.cg.total) == int(before.cg.total) + 1,
          f"transport_rows_update: a stopped iterate's launch moved {moved}")
    # timed from an iterating state that stays iterating (threshold 0)
    k.cg.thresh2.zero_()
    p.cg.thresh2.zero_()
    k.cg.act.fill_(True)
    p.cg.act.fill_(True)
    e = max(e_ap / scale_ap, max(e_vec.values()))
    facts = kernel_facts("transport_cg", "transport_rows_update_kernel", (),
                         lambda: tcg.rows_update(k, op))
    rows_bytes = (common + i4 * na + f4 * na + f4 * nv + f4 * (dots_terms + 2 + 4 * nsub)
                  + f4 * nsub + (f4 * na if op.row_fix is not None else 0))
    timed("rows_update", lambda: tcg.rows_update(k, op), lambda: tcg.rows_update_plain(p, op),
          rows_bytes + f4 * (4 * nsub + nsub + nfull + na + n_mp), e_ap,
          rel_err=e, ap_rel_err=e_ap / scale_ap, p_ap_rel_err=e_pap, vector_rel_err=e_vec,
          scalar_rel_err=e_sc, cold_ms=time_ms_cold(lambda: tcg.rows_update(k, op)),
          boundary_ms=time_ms(lambda: bcg.cg_update_direction(b.cg, tcg.INNER_MAXITER)),
          stopped_ms=time_ms(lambda: tcg.rows_update(st, op)), **facts)

    # the inner body inside a WHILE node, as the solve runs it, from a CG
    # start whose threshold is 0 (INNER_MAXITER iterations a replay): the
    # package's body, the body without the branch (the band, the fused
    # tail) and every kernel in series
    it = clone(base)
    tcg.refine(it, op, True, tcg.MAX_OUTER, 20000)
    it.cg.thresh2.zero_()
    it.cg.act.fill_(True)
    it.cg.cond.fill_(1)
    start = clone(it)
    bodies = {
        "inner iteration": lambda h, s_: tcg.inner_iteration(it, op, h, s_),
        "without the branch": lambda h, s_: (tcg.band(it, op, s_),
                                             tcg.rows_update(it, op, h, s_)),
        "in series": lambda h, s_: (tcg.band(it, op, s_), tcg.fly(it, op, s_),
                                    tcg.blocks(it, op, False, s_),
                                    tcg.rows_update(it, op, h, s_)),
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
        + f"; transport_rows_update cold L2 {out['rows_update']['cold_ms']:.5f} ms, a stopped "
        f"iterate's launch {out['rows_update']['stopped_ms']:.5f} ms, "
        f"{out['rows_update']['registers']} registers; the boundary build of "
        f"cg_update_direction on the same state {out['rows_update']['boundary_ms']:.5f} ms; "
        f"band out= {out['band_out_ms']:.5f} ms, "
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
            ("transport_rows_update", "rows_update", src, "devicekmc_tpu/ops/cg.py:112",
             "the inner iteration's tail in one cooperative launch: every row of A p after "
             "the band, the fly matvec and transport_blocks, p.ap and alpha, the update "
             "and direction (minv 1), the new direction packed into the band's window and "
             "the metal vector, the flag, counts and predicate (f32)"),
            ("transport_rows", "rows_hi", src, "devicekmc_tpu/ops/cg.py:225",
             "the refinement's residual r = b - A x and r.r (f64)"),
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
        if key == "blocks_lo":
            rec["cold_ms"] = r["cold_ms"]
            rec["f64_build"] = {f: k["blocks_hi"][f] for f in ("err", "ms", "cold_ms",
                                                               "plain_ms", "bound_ms")}
        if key == "rows_hi":
            rec.update({f: r[f] for f in ("cold_ms", "bound_parent_inputs_ms")})
        if key == "rows_update":
            rec.update({f: r[f] for f in ("cold_ms", "stopped_ms", "boundary_ms", "kernel",
                                          "registers", "shared_bytes", "device_launches",
                                          "ap_rel_err", "p_ap_rel_err", "vector_rel_err",
                                          "scalar_rel_err")})
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


#: supersteps of the dense local model's runs on the small stack; the
#: interface sizes at which the dense substep kernel is timed (f32 and f64),
#: and the one of them whose f64 timing is the "ref" record
SMALL_HEAT_STEPS = 4
DENSE_SIZES = (192, 512, 2048, 8192)
DENSE_REF_NI = 8192


def _heat_ws_copy(ws):
    """A copy of a heat workspace (``ops.heat.Workspace``) on its device."""
    import torch

    copy = lambda v: v.clone() if torch.is_tensor(v) else v  # noqa: E731
    kw = {}
    for f in dataclasses.fields(ws):
        v = getattr(ws, f.name)
        if f.name == "cg" and v is not None:
            v = dataclasses.replace(v, **{g.name: copy(getattr(v, g.name))
                                          for g in dataclasses.fields(v)})
        elif isinstance(v, tuple) and f.name.startswith("op"):
            v = tuple(copy(t) for t in v)
        else:
            v = copy(v)
        kw[f.name] = v
    return type(ws)(**kw)


def dense_substep_checks(heat, sizes=DENSE_SIZES):
    """Kernel 1 (heat_dense_substep) against its plain version on the card's
    tensors, at the run's interface (``heat``'s L_inv) and at each ni of
    ``sizes`` in f32 and f64 (a seeded propagator; ni 8,192 of f64 is the
    "ref" record): the field and the next right-hand side within 1e-5 of
    their scale (products summed in another order; in f32 plus an ulp of
    the field, rounded next to T0), the counter and
    predicate equal; timed beside its bytes bound (the propagator once, ni^2
    entries, and the [ni] vectors), the plain version and torch.mv of the
    propagator (the product alone), with the form the kernel took
    (``ops.heat.dense_plan``)."""
    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import heat as heat_ops

    out = {"sizes": []}
    gen = torch.Generator().manual_seed(17)
    cases = [("run", heat.n_interface, heat.L_inv.dtype)]
    cases += [(f"{ni} {str(dt)[6:]}", ni, dt) for ni in sizes
              for dt in (torch.float32, torch.float64)]
    for tag, ni, dt in cases:
        if tag == "run":
            M = heat.L_inv
        else:
            M = (torch.rand((ni, ni), generator=gen) * (2.0 / ni)).to(dt).cuda()
        isz = M.element_size()
        ws = heat_ops.workspace("dense", dt, "cuda", torch.arange(ni, device="cuda"))
        ws.u[0].copy_((torch.rand(ni, generator=gen) * 1e-3).to(dt))
        ws.src.copy_((torch.rand(ni, generator=gen) * 1e-4).to(dt))
        heat_ops.prepare(ws, False, 1 << 30)
        k, q = _heat_ws_copy(ws), _heat_ws_copy(ws)
        tk = torch.full((ni,), 300.0, dtype=dt, device="cuda")
        tq = tk.clone()
        heat_ops.dense_substep(k, M, tk, 300.0, 1000.0, False, 0)
        heat_ops.dense_substep_plain(q, M, tq, 300.0, 1000.0, False, 0)
        # f32: also an ulp of the field, whose rounding next to T0 the two
        # versions' sums may tip apart (over the scale in the right-hand side)
        ulp = torch.finfo(dt).eps * float(tq.abs().max()) if dt == torch.float32 else 0.0
        err = max(_close(f"heat_dense_substep ({tag}) field", tk - 300.0, tq - 300.0, 1e-5,
                         ulp),
                  _close(f"heat_dense_substep ({tag}) right-hand side", k.u, q.u, 1e-5,
                         ulp / 1000.0))
        check(k.k.tolist() == q.k.tolist() and k.cond.tolist() == q.cond.tolist(),
              f"heat_dense_substep ({tag}): counter or predicate differ")
        ms = time_ms(lambda: heat_ops.dense_substep(k, M, tk, 300.0, 1000.0, False, 0))
        plain_ms = time_ms(lambda: heat_ops.dense_substep_plain(q, M, tq, 300.0, 1000.0,
                                                                 False, 0), reps=5, rounds=3)
        u0 = ws.u[0].clone()
        lib_ms = time_ms(lambda: torch.mv(M, u0))
        bound_ms, by = _bound(2 * ni * ni, ni * ni * isz + 4 * ni * isz + 4 * ni)
        plan = heat_ops.dense_plan(ni, isz, M.data_ptr() % 16 == 0 and k.u.data_ptr() % 16 == 0,
                                   _build.sm_count(M.device))
        rec = dict(ni=ni, err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=bound_ms, bound_by=by, dtype=str(dt),
                   form=dict(dataclasses.asdict(plan)))
        if tag == "run":
            out["run"] = rec
        else:
            out["sizes"].append(rec)
            if ni == DENSE_REF_NI and dt == torch.float64:
                out["ref"] = rec
        log(f"heat_dense_substep at ni = {ni} ({tag}, {dt}, {plan.form} form, {plan.grid} "
            f"blocks, {plan.rows} rows a warp): {ms:.5f} ms, bound {bound_ms:.5f} ms ({by}, "
            f"{100 * bound_ms / ms:.1f} %), plain {plain_ms:.5f} ms, torch.mv {lib_ms:.5f} ms, "
            f"max error {err:.3e}")
        del M, ws, k, q, tk, tq, u0
    return out


def heat_cg_checks(sim):
    """heat_cg_begin and heat_cg_end against their plain versions on the
    card's tensors, at the crossbar's local model after its graph run: the
    warm set-up of a transient substep (x0 within 1e-6 of its scale: the
    plain version on the card divides by the scale as PyTorch's CUDA rule
    has it, through the reciprocal; r and p within 1e-5 of the scale of b,
    r.r and the threshold within 1e-4, flags, counts and
    the predicate equal) and the end from its iterate (the field bit-equal,
    counter and predicate equal); each timed beside its bytes bound (the
    set-up: the interface rows' valid slots, value and index, and each
    [N] input and output once; the end: the interface's iterate and field
    and the mask) and its plain version; the set-up with a cold L2 too (a
    64 MiB buffer written before each launch)."""
    import torch

    from devicekmc_tpu_torch.ops import heat as heat_ops
    from devicekmc_tpu_torch.physics import heat as heat_mod

    h, p, st = sim.heat, sim.params, sim.state
    T0, scale, src_t, _ = heat_mod._local_cg_sources(p, h, st)
    temp = st.temperature.to(p.dtype).clone()
    k, q = _heat_ws_copy(h.ws), _heat_ws_copy(h.ws)
    for ws in (k, q):
        ws.src.copy_(src_t)
        heat_ops.prepare(ws, False, 1)
    tk, tq = temp.clone(), temp.clone()
    heat_ops.cg_begin(k, k.op_t, True, tk, T0, scale, 1e-10, 1000)
    heat_ops.cg_begin_plain(q, q.op_t, True, tq, T0, scale, 1e-10, 1000)
    # PyTorch's CUDA division by a scalar multiplies by its reciprocal, the
    # kernel divides (as the plain version does on the CPU): an ulp apart
    x_sc = float(q.cg.x.abs().max())
    x_err = float((k.cg.x - q.cg.x).abs().max())
    check(x_err <= 1e-6 * x_sc, f"heat_cg_begin: x0 error {x_err} of {x_sc}")
    b = torch.where(q.op_t[3], q.cg.x[0] + q.src, 0.0)
    sc = float(b.abs().max())
    err = max(float((getattr(k.cg, f) - getattr(q.cg, f)).abs().max()) for f in ("r", "p"))
    err = max(err, x_err)
    check(sc > 0 and err <= 1e-5 * sc, f"heat_cg_begin: r, p error {err} of {sc}")
    for f in ("rr", "rz", "thresh2"):
        a_, b_ = float(getattr(k.cg, f)), float(getattr(q.cg, f))
        check(abs(a_ - b_) <= 1e-4 * abs(b_), f"heat_cg_begin: {f} {a_} against {b_}")
    for f in ("act", "iters", "ctl", "cond"):
        check(torch.equal(getattr(k.cg, f), getattr(q.cg, f)), f"heat_cg_begin: {f} differs")
    q.cg.x.copy_(k.cg.x + 1e-4 * torch.rand(k.cg.x.shape, generator=torch.Generator(
        ).manual_seed(2)).to(k.cg.x))
    k.cg.x.copy_(q.cg.x)
    heat_ops.cg_end(k, tk, T0, scale, False, 0)
    heat_ops.cg_end_plain(q, tq, T0, scale, False, 0)
    check(torch.equal(tk, tq), "heat_cg_end: the field differs from the plain version's")
    check(k.log.tolist() == q.log.tolist() and k.k.tolist() == q.k.tolist()
          and k.cond.tolist() == q.cond.tolist(), "heat_cg_end: counters differ")
    ms_b = time_ms(lambda: heat_ops.cg_begin(k, k.op_t, True, tk, T0, scale, 1e-10, 1000))
    cold_b = time_ms_cold(lambda: heat_ops.cg_begin(k, k.op_t, True, tk, T0, scale, 1e-10,
                                                    1000))
    plain_b = time_ms(lambda: heat_ops.cg_begin_plain(q, q.op_t, True, tq, T0, scale, 1e-10,
                                                      1000), reps=5, rounds=3)
    ms_e = time_ms(lambda: heat_ops.cg_end(k, tk, T0, scale, False, 0))
    plain_e = time_ms(lambda: heat_ops.cg_end_plain(q, tq, T0, scale, False, 0), reps=5,
                      rounds=3)
    mask = h.interface_mask
    n, n_i = int(mask.shape[0]), int(mask.sum())
    slots = int(k.cg.row_len[mask].clamp(min=0).sum())
    isz = temp.element_size()
    bytes_b = slots * (isz + 4) + n_i * isz + n * (2 * isz + 1 + 4) + 3 * n * isz
    bytes_e = n_i * 2 * isz + n
    bound_b, by_b = _bound(2 * slots + 10 * n_i, bytes_b)
    bound_e, by_e = _bound(2 * n_i, bytes_e)
    out = dict(n=n, interface=n_i, slots=slots,
               begin=dict(err=err, ms=ms_b, cold_ms=cold_b, plain_ms=plain_b, bound_ms=bound_b,
                          bound_by=by_b),
               end=dict(err=0.0, ms=ms_e, plain_ms=plain_e, bound_ms=bound_e, bound_by=by_e))
    log(f"heat CG kernels at the crossbar's local model ({n} sites, {n_i} on the interface, "
        f"{slots} valid slots): heat_cg_begin {ms_b:.5f} ms, cold L2 {cold_b:.5f} ms (bound "
        f"{bound_b:.5f}, {by_b}, {100 * bound_b / ms_b:.1f} %; "
        f"plain {plain_b:.5f}; r, p error {err:.3e} of {sc:.3e}), heat_cg_end {ms_e:.5f} ms "
        f"(bound {bound_e:.5f}, {by_e}; plain {plain_e:.5f}; bit-equal)")
    return out


def heat_phase_timing(sim, extra=(), reps=5):
    """The local heat phase alone at the run's last state, at its last step
    time and at ``extra`` step times (in units of delta_t): captured once
    (a graph of the update in its device form: each branch a WHILE node,
    the CG's nested in the substep's; the step time a device input; CUDA
    events around its replays) and from the host loop of the same kernels
    (wall ms between synchronizations, the median of ``reps``), with the
    branch, substeps and CG iterations; the two results bit-equal."""
    import torch

    from devicekmc_tpu_torch.ops.graph import Graph
    from devicekmc_tpu_torch.physics import heat as heat_mod

    g, p, h = sim.geom, sim.params, sim.heat
    upd = heat_mod.update_temperature_local if h.method == "dense" \
        else heat_mod.update_temperature_local_cg
    times = [float(sim.step_log[-1]["step_time"])] + [m * p.delta_t for m in extra]
    state = dataclasses.replace(sim.state, temperature=sim.state.temperature.clone(),
                                power=sim.state.power.clone(),
                                element=sim.state.element.clone())
    dstate = dataclasses.replace(state, T_bg=torch.tensor(float(state.T_bg),
                                                          dtype=torch.float64, device="cuda"))
    st_t = torch.tensor(times[0], dtype=torch.float64, device="cuda")
    graph = Graph(lambda: upd(g, p, h, dstate, st_t), "cuda")
    out = []
    for step_time in times:
        st_t.fill_(step_time)
        temp = graph()[0].temperature.clone()
        log_g = h.ws.log.tolist()
        ms_graph = time_ms(graph, reps=reps, rounds=3, warmup=1)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            host, _ = upd(g, p, h, state, step_time)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(host.temperature, temp) and h.ws.log.tolist() == log_g,
              "local heat phase: captured and host loop differ")
        res = dict(method=h.method, step_time=step_time,
                   branch=("transient", "steady")[log_g[0]], substeps=log_g[1],
                   cg_iters=log_g[2], ms_graph=ms_graph, ms_host_loop=statistics.median(walls),
                   ms_per_cg_iteration_graph=ms_graph / log_g[2] if log_g[2] else None)
        log(f"local heat phase ({h.method}) alone at step time {step_time:.4g} s: "
            f"{res['branch']} branch, {log_g[1]} substeps, {log_g[2]} CG iterations; captured "
            f"{ms_graph:.4f} ms, host loop of the same kernels {res['ms_host_loop']:.4f} ms "
            f"(median of {reps}), bit-equal")
        out.append(res)
    return out


def dense_heat_path(out_root, n_steps=SMALL_HEAT_STEPS, Vd=10.0):
    """Phase 5, the dense local model: the small stack with blocked
    transport on the fly and the dense propagators, eager (counters to 0 and
    read) then on the captured graph, bit for bit step for step (the
    temperature field, T_bg and the loops' log too), in turns; then kernel 1
    against its plain version (dense_substep_checks) and the heat phase
    alone, captured and from the host loop.  Returns (graph summary, kernel
    record, phase timing)."""
    import torch

    from devicekmc_tpu_torch import engine

    def make(d):
        return small_device("cuda", d, current=True, solve_heating_local=True,
                            heat_solver="dense")

    sim_e = make(os.path.join(out_root, "small_heat_dense_eager"))
    sim_e._make = engine.make_superstep
    check(sim_e.heat.method == "dense" and sim_e.params.transport_cc == "fly",
          "small stack dense heat: options")
    recs_e = transport_record(sim_e)
    sim_e.run_bias_point(Vd, 1e30, max_steps=n_steps)
    sim_e.__dict__.pop("_superstep", None)
    sim, summary = transport_graph_phase(
        out_root, "local", (sim_e, recs_e), second_point=False, n_steps=n_steps,
        tag="small stack local heat (dense) graph", make=make, Vd=Vd)
    rec = dense_substep_checks(sim.heat)
    # the run's steps take the steady branch: the transient loop at 151
    # substeps too
    timing = heat_phase_timing(sim, extra=(150.5,))
    del sim, sim_e
    torch.cuda.empty_cache()
    return summary, rec, timing


def heat_records(dense, dgraph, cg, lgraph):
    """The kernels JSON records of csrc/heat.cu's three kernels (``dense``:
    dense_substep_checks, ``cg``: heat_cg_checks; the graph runs' summaries
    ``dgraph`` (the small stack, dense) and ``lgraph`` (the crossbar,
    matrix-free), whose counts on the card are their launches)."""
    src = "devicekmc_tpu_torch/csrc/heat.cu"
    run = dense["run"]
    recs = [{
        "name": "heat_dense_substep", "route": "cuda", "source": src,
        "replaces": "devicekmc_tpu/physics/heat.py:271",
        "launches": dgraph["launches_card"]["heat_dense_substep"], "max_abs_err": run["err"],
        "ms": run["ms"], "plain_ms": run["plain_ms"], "bound_ms": run["bound_ms"],
        "bound_by": run["bound_by"], "library_ms": run["library_ms"],
        "library": "torch.mv(L_inv, u), the product alone",
        "shape": f"ni={run['ni']} ({run['dtype']}), the small stack's interface",
        "path": "the small stack with transport on the fly and the dense local model, "
                "captured graph", "ref_ni": dense["ref"], "sizes": dense["sizes"],
        "computes": "one substep of the dense local model (the steady pass with L_ss_inv): "
                    "the propagator's row products, the field and the next right-hand side, "
                    "the counter and the WHILE predicate"}]
    for name, key, note in (
            ("heat_cg_begin", "begin", "the set-up of one CG solve of the matrix-free local "
             "model: x0 from the field, b, r = p = b - A x0, r.r, the threshold, the inner "
             "predicate"),
            ("heat_cg_end", "end", "the end of one CG solve: the field written back, the "
             "iterations summed, the substep counter and the outer predicate")):
        r = cg[key]
        recs.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": "devicekmc_tpu/physics/heat.py:351",
            "launches": lgraph["launches_card"][name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            **({"cold_ms": r["cold_ms"]} if "cold_ms" in r else {}),
            "library_none": "no one PyTorch call computes it",
            "shape": f"N={cg['n']}, {cg['interface']} interface sites, {cg['slots']} slots",
            "path": "the crossbar's heat path with the matrix-free local model, captured "
                    "graph", "computes": note})
    return recs


def heat_path(out_root):
    """Phase 5: the heat runs (global, then local), then the dissipation
    kernel's checks; the local runs (the crossbar's matrix-free model and the
    small stack's dense one) each on the captured graph against the eager
    driver, the heat kernels against their plain versions and the local heat
    phase alone.  Returns every kernel's launches on the global run, the
    global graph's summary, the dissipation kernel's record and the local
    model's (summaries, kernel records, phase timings)."""
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

    sim_l, local_launches, recs_l = heat_run(out_root, "local", LOCAL_HEAT_STEPS, wrappers)
    lsim, lgraph = transport_graph_phase(out_root, "local", (sim_l, recs_l),
                                         second_point=False, n_steps=LOCAL_HEAT_STEPS)
    del recs_l, sim_l
    torch.cuda.empty_cache()
    cg_rec = heat_cg_checks(lsim)
    ltiming = heat_phase_timing(lsim)
    del lsim
    torch.cuda.empty_cache()
    dgraph, dense_rec, dtiming = dense_heat_path(out_root)
    n_mp = rec["n"]
    local = dict(lgraph=lgraph, dgraph=dgraph, records=heat_records(dense_rec, dgraph, cg_rec,
                                                                      lgraph),
                 timing={"crossbar_cg": ltiming, "small_stack_dense": dtiming})
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
    }, local


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
    # the kernel (one thread: a check of the stream, on no path) timed
    ms = time_ms(lambda: threefry_draws(rng.prng_key(7), THREEFRY_DRAWS), reps=5, rounds=3)
    log(f"threefry: {THREEFRY_DRAWS} successive splits and the f64 and f32 draws of "
        f"k_sel and k_time bit-equal to rng.py ({time.perf_counter() - t0:.1f} s); "
        f"threefry_draws_kernel {ms:.5f} ms for the {THREEFRY_DRAWS} (one thread)")
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
#: the checkpoint backends phase 8 saves at the same step and resumes from
CKPT_BACKENDS = ("npz", "dcp", "dcp_async")
#: the wrappers whose launches phase 8 counts over its resume runs (by the
#: ops module that holds each)
CKPT_COUNTED = {"ell_gather": "ell_gather", "ell_gather_batched": "ell_gather",
                "poisson_pairwise": "pairwise", "poisson_pairwise_batched": "pairwise",
                "kmc_event_loop": "kmc_events", "kmc_event_loop_batched": "kmc_events",
                "wkb_fly_matvec": "wkb_fly", "wkb_fly_matmat": "wkb_fly",
                "wkb_fly_pdisp": "wkb_fly", "wkb_window_block": "wkb_window",
                "banded_matvec": "banded"}
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
    """RESUME_FIELDS of the state as numpy copies (host scalars and the key as
    arrays; in graph mode the state is a view of the graph's buffers, which
    the next replay overwrites)."""
    import numpy as np
    import torch

    out = {}
    for f in RESUME_FIELDS:
        v = getattr(sim.state, f)
        out[f] = np.array(v.cpu().numpy() if torch.is_tensor(v) else v)
    return out


def ckpt_mib(path):
    """MiB of a checkpoint: an npz file, or every file of a dcp directory."""
    if os.path.isfile(path):
        return os.path.getsize(path) / 2**20
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 2**20


def resume_check(tag, make, Vd, out_root, backends=CKPT_BACKENDS):
    """Run A: CKPT_STEPS supersteps, a checkpoint in each of ``backends`` at
    that step, CKPT_STEPS more, then the wait for the dcp_async write (its
    directory written while those supersteps ran).  Run B, a fresh
    Simulation, loads each checkpoint in turn: its RESUME_FIELDS are A's at
    the save, bit for bit, and after the same CKPT_STEPS from there A's at
    the end.  Prints and returns each backend's save, load and host-blocked
    seconds (a save's call, and for dcp_async also the wait after the
    supersteps) and its MiB."""
    import numpy as np
    import torch

    slug = "".join(c if c.isalnum() else "_" for c in tag)
    path = {b: os.path.join(out_root, f"ckpt_{slug}" + (".npz" if b == "npz" else f"_{b}"))
            for b in backends}
    a = make("a")
    sync = torch.cuda.synchronize if a.device.type == "cuda" else (lambda: None)
    a.run_bias_point(Vd, 1e30, max_steps=CKPT_STEPS)
    at_save = state_fields(a)
    rec = {}
    for b in backends:
        sync()
        t0 = time.perf_counter()
        a.save_checkpoint(path[b], backend=b)
        rec[b] = dict(save_s=time.perf_counter() - t0)
    a.run_bias_point(Vd, 1e30, max_steps=2 * CKPT_STEPS, resume_step=CKPT_STEPS)
    t0 = time.perf_counter()
    a.wait_for_checkpoint()
    wait_s = time.perf_counter() - t0
    fa = state_fields(a)
    b_sim = make("b")
    for b in backends:
        r = rec[b]
        r.update(blocked_s=r["save_s"] + (wait_s if b == "dcp_async" else 0.0),
                 mib=ckpt_mib(path[b]))
        sync()
        t0 = time.perf_counter()
        b_sim.load_checkpoint(path[b], backend=b)
        sync()
        r["load_s"] = time.perf_counter() - t0
        check(b_sim._pos == (0, CKPT_STEPS), f"{tag}, {b}: position {b_sim._pos}")
        fl = state_fields(b_sim)
        for f in RESUME_FIELDS:
            check(np.array_equal(fl[f], at_save[f]), f"{tag}, {b}: loaded {f} is not the "
                                                     "state at the save")
        n_log = len(b_sim.step_log)
        b_sim.run_bias_point(Vd, 1e30, max_steps=2 * CKPT_STEPS, resume_step=CKPT_STEPS)
        fb = state_fields(b_sim)
        for f in RESUME_FIELDS:
            check(np.array_equal(fa[f], fb[f]), f"{tag}, {b}: resumed {f} differs")
        steps = [s["step"] for s in b_sim.step_log[n_log:]]
        check(steps == list(range(CKPT_STEPS, 2 * CKPT_STEPS)),
              f"{tag}, {b}: resumed steps {steps}")
    log(f"checkpoint and resume, {tag}: {CKPT_STEPS} supersteps, a save in each of "
        f"{', '.join(backends)}, {CKPT_STEPS} more, then the wait; a fresh Simulation loads "
        f"each in turn (the state at the save) and runs the same: {', '.join(RESUME_FIELDS)} "
        f"equal bit for bit; events {[int(s['n_events']) for s in a.step_log]}; "
        + "; ".join(f"{b}: save {r['save_s']:.4f} s, load {r['load_s']:.4f} s, host blocked "
                    f"{r['blocked_s']:.4f} s, {r['mib']:.2f} MiB" for b, r in rec.items()))
    return rec


def counted_launches(fn):
    """``fn()`` with the launch counters of CKPT_COUNTED's wrappers set to 0
    just before it and read just after, beside the launches the card counted
    of its COUNTED_ON_CARD kernels in it (the batched kernels' equal to their
    wrappers', which count a graph's launches a replay; the kernels inside a
    WHILE node only the card counts).  Returns ``fn``'s result and the counts
    by kernel."""
    from devicekmc_tpu_torch.ops import _build

    wrappers = {n: getattr(_ops_module(m), n) for n, m in CKPT_COUNTED.items()}
    for w in wrappers.values():
        w.launches = 0
    card0 = card_counts()
    out = fn()
    card1 = card_counts()
    counts = {n: w.launches for n, w in wrappers.items()}
    for n in _build.COUNTED_ON_CARD:
        c = card1[n] - card0[n]
        if n in counts:
            check(counts[n] == c, f"{n}: {counts[n]} launches counted, {c} on the card")
        counts[n] = c
    return out, counts


def small_resume_checks(out_root):
    """Phase 8, first part: resume_check on the small stack with transport,
    per step and with batch_steps = BATCH_STEPS, each backend.  Returns the
    records and the launches of the resume runs."""
    def runs():
        return {bs: resume_check(f"small stack with transport, batch_steps {bs}",
                                 lambda tag: small_device(
                                     "cuda", os.path.join(out_root, f"small_ckpt{bs}_{tag}"),
                                     current=True, batch_steps=bs),
                                 10.0, out_root)
                for bs in (1, BATCH_STEPS)}

    return counted_launches(runs)


def crossbar_resume_checks(out_root):
    """Phase 8, second part: resume_check on the headline crossbar, per step
    and with batch_steps = BATCH_STEPS, each backend.  Returns the records
    and the launches of the resume runs."""
    def runs():
        return {bs: resume_check(
            f"crossbar headline, batch_steps {bs}",
            lambda tag: synthetic_crossbar(N_SITES, "cuda",
                                           os.path.join(out_root, f"crossbar_ckpt{bs}_{tag}"),
                                           batch_steps=bs),
            VD_MAIN, out_root) for bs in (1, BATCH_STEPS)}

    return counted_launches(runs)


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
    on the eager driver, counters set to 0 just before run_bias_point and
    read just after: the cold solves and BF16_STEPS supersteps; every solve
    converged, I_macro finite and positive, every transport kernel launched,
    the band bf16.  cg_iters_power and I_macro beside the f32 inner run's
    (``f32_steps``, phase 4).  Then the main path: the same run on the
    captured graph (transport_graph_phase: counters to 0 around it, bit for
    bit step for step against the eager run, in turns, 1 device-to-host copy
    a graph superstep).  Then the bf16 band kernel against its plain version
    on the run's band (``band_checks``).  Returns its record, the eager run's
    launches and the graph's summary."""
    import math

    import torch

    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matvec, wkb_fly_pdisp
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block

    bf16 = dict(transport_bf16_inner=True, transport_tol=BF16_TRANSPORT_TOL)
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "transport_bf16"),
                             current=True, **bf16)
    sim._make = engine.make_superstep
    recs = transport_record(sim)
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
    sim.__dict__.pop("_superstep", None)
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
    log(f"bf16 transport path, eager: run_bias_point (cold solves + {BF16_STEPS} supersteps) "
        f"in {wall:.2f} s; launches {launches} (every band launch bf16)")
    for a, b in zip(steps, f32_steps):
        log(f"  step {a['step']}: {a['Z - calculation time - KMC superstep [s]'] * 1e3:.2f} ms, "
            f"events {int(a['n_events'])} (f32 inner {int(b['n_events'])}), cg_iters_power "
            f"{int(a['cg_iters_power'])} (f32 inner {int(b['cg_iters_power'])}), Current "
            f"{a['Current [uA]']:.9g} uA (f32 inner {b['Current [uA]']:.9g})")

    # ---- the main path: the same run on the captured graph ----
    gsim, graph = transport_graph_phase(out_root, None, (sim, recs), second_point=False,
                                        n_steps=BF16_STEPS, tag="bf16 transport graph", **bf16)
    check(gsim._band["slots"].val.dtype == torch.bfloat16, "bf16 graph: the band is not bf16")
    del gsim, recs
    torch.cuda.empty_cache()

    # ---- the bf16 band kernel at the run's band ----
    rec = band_checks(sim._band, sim.geom.N_atom)
    record = {
        "name": "banded_matvec_bf16", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/banded.cu",
        "replaces": "devicekmc_tpu/ops/banded_pallas.py:74",
        "launches": graph["launches_card"]["banded_matvec_out"],
        "launches_eager_run": launches["banded_matvec"],
        "launches_graph_run_cold_solves": graph["launches_host"]["banded_matvec"],
        "max_abs_err": rec["err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        "library": "torch.sparse.mm (CSR, the bf16 values widened to f32)",
        "shape": rec["shape"],
        **{key: rec[key] for key in ("cold_ms", "library_cold_ms", "nnz", "elements",
                                     "slot_bytes", "longest_row", "pad_share",
                                     "err_rounded")},
        "path": "transport with transport_bf16_inner (cold solves + "
                f"{BF16_STEPS} supersteps), captured graph: the out= entry's launches on the "
                "card",
        "cg_iters_power": [int(s["cg_iters_power"]) for s in steps],
        "cg_iters_power_f32_inner": [int(s["cg_iters_power"]) for s in f32_steps[:BF16_STEPS]],
        "cold_cg_iters": [p["cg_iters"] for p in sim.presolve_log],
        "current_uA": [s["Current [uA]"] for s in steps],
        "current_uA_f32_inner": [s["Current [uA]"] for s in f32_steps[:BF16_STEPS]],
    }
    return record, launches, graph


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
    card0 = {}
    seen = profile_calls(solve, 1, before=lambda: (ws.total.zero_(),
                                                   card0.update(card_counts())))[3]
    check(seen is not None and int(ws.total) == iters,
          f"boundary CG: {int(ws.total)} iterations on the card in a profiled replay")
    n_seen = cg_seen("boundary CG", seen, iters,
                     {name: n - card0[name] for name, n in card_counts().items()})
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


# ---------------------------------------------------------------------------
# the halo decomposition
# ---------------------------------------------------------------------------

#: supersteps of each halo-phase run
HALO_STEPS = 3
#: card counts at which the phase sets the crossbar's halo width beside its slab
HALO_CARDS = (2, 4, 8)
#: the halo superstep's phases, timed in phase 12 (function: name)
HALO_PHASES = {"halo_charge": "charge", "halo_boundary": "boundary potential",
               "halo_poisson": "Poisson", "_halo_event_loop": "events"}
#: and with transport and heat
HALO_TRANSPORT_PHASES = dict(HALO_PHASES, halo_power="transport and power", halo_heat="heat")
#: the transport run's configurations: the transport settings of PERF.md §4
#: with global heat, in f64 at solver and transport tolerance 1e-12 (the
#: stored metal block: the on-the-fly kernels are f32) and in mixed
#: precision; both with the exact-erfc Poisson sweep of the halo path, and
#: the single device's warm solves with the halo path's (cold, deflated)
#: preconditioner
HALO_TRANSPORT = {
    "f64": dict(precision="f64", solver_tol=1e-12, transport_tol=1e-12, transport_cc="auto"),
    "mixed": {}}
HALO_TRANSPORT_COMMON = dict(current=True, heat="global", poisson_kernel="jnp",
                             transport_warm_precond="deflated")


def halo_sim(out_root, tag, mesh, device="cuda", n_sites=N_SITES, decomposition="halo",
             **overrides):
    """The crossbar over the halo decomposition (``mesh``; or over
    ``decomposition``), or without a mesh through the single-device eager
    superstep (the engine's superstep without a graph), with each superstep
    recorded: its ms between two synchronizations, events, CG iterations,
    step time, the whole structure's elements, charges and boundary
    potential, and under the mesh its collectives by kind."""
    import torch

    from devicekmc_tpu_torch import engine

    sim = synthetic_crossbar(n_sites, device, os.path.join(out_root, tag), mesh=mesh,
                             decomposition=decomposition, **overrides)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if mesh is None:
        sim._make = engine.make_superstep
    steps, inner = [], sim._superstep
    nr = sim.geom.N_real

    def wrapped(state, Vd):
        if mesh is not None:
            mesh.comm.reset_counts()
        sync()
        t = time.perf_counter()
        out = inner(state, Vd)
        sync()
        ms = (time.perf_counter() - t) * 1e3
        st, m = out[0], out[2]
        counts = dict(mesh.comm.counts) if mesh is not None else None
        # the whole structure's fields (gathered from the ranks' slabs)
        whole = (lambda x: x) if sim.decomposition != "halo" else mesh.comm.all_gather
        steps.append(dict(
            ms=ms, events=int(m["n_events"]), cg=int(m["cg_iters_boundary"]),
            step_time=float(out[1]), element=whole(st.element)[:nr].cpu(),
            charge=whole(st.charge)[:nr].cpu(),
            pb=whole(st.potential_boundary)[:nr].double().cpu(), counts=counts,
            metrics={k: float(v) for k, v in m.items()}, state=st))
        return out

    sim._superstep = wrapped
    return sim, steps


def halo_path(out_root, device="cuda", n_sites=N_SITES):
    """Phase 12: the halo decomposition at world size 1 through NCCL (an
    in-process store, cuda:0) on the crossbar, in f64 at solver_tol 1e-12
    (the JAX package's halo test's; the supersteps' boundary solves then
    iterate) and in the headline's mixed precision,
    each against the single-device eager superstep from the same state: the
    cold pre-solve and HALO_STEPS supersteps.  In f64, events, elements and
    charges equal step for step, potential_boundary within 1e-8 of its
    scale, kmc_time within 1e-6 relative; mixed is timed and its events
    printed, not gated (its single-device Poisson sweep is the f32 pair
    kernel, the halo path's the exact erfc).  The halo run is driven with
    the wrappers' counts set to 0 just before and read just after: the
    gather and the exact-erfc sweep (the rank's rows over the gathered
    charged slots, once a superstep) launched on the card, their plain
    versions never, the pair sweep and event kernels not (the halo path
    selects events in PyTorch, as the JAX package's does in jnp); the
    phases' ms (the Poisson phase's among them).  ``device="cpu"`` (with a smaller
    ``n_sites``) rehearses the phase on the CPU through gloo.  Returns the
    phase's summary."""
    import torch
    import torch.distributed as dist

    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.parallel import halo_superstep as hs
    from devicekmc_tpu_torch.parallel import make_mesh
    from devicekmc_tpu_torch.physics.events import _BLOCK

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    card = gpu_line() if cuda else "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    backend = "NCCL" if cuda else "gloo"
    check(not dist.is_initialized(), "a process group runs before the halo phase")
    dist.init_process_group(backend.lower(), store=dist.HashStore(), rank=0, world_size=1)
    summary = {}
    try:
        mesh = make_mesh(1, device=device)
        wrappers = {"ell_gather": eg.ell_gather, "poisson_pairwise": pw.poisson_pairwise,
                    "kmc_event_loop": kmc_events.kmc_event_loop,
                    "poisson_exact_batched": pw.poisson_exact_batched}
        for prec, over in (("f64", dict(precision="f64", poisson_kernel="jnp",
                                        solver_tol=1e-12)),
                           ("mixed", {})):
            single, s_steps = halo_sim(out_root, f"halo_single_{prec}", None, device,
                                       n_sites, **over)
            single.run_bias_point(VD_MAIN, 1e30, max_steps=HALO_STEPS)
            s_pre = single.presolve_log[0]
            s_kmc = single.state.kmc_time
            del single
            halo, h_steps = halo_sim(out_root, f"halo_{prec}", mesh, device, n_sites, **over)
            width, n_real = halo._halo_width, halo.geom.N_real
            # ---- counters to 0, drive, read ----
            for w in wrappers.values():
                w.launches = 0
            plain, restore = _counted(eg, "ell_gather_plain")
            exact_plain, restore_exact = _counted(pw, "poisson_exact_batched_plain")
            timed = {name: _counted(hs, name, sync) for name in HALO_PHASES}
            mesh.comm.reset_counts()
            try:
                t = time.perf_counter()
                halo.run_bias_point(VD_MAIN, 1e30, max_steps=HALO_STEPS)
                sync()
                wall = time.perf_counter() - t
            finally:
                restore()
                restore_exact()
                for _, undo in timed.values():
                    undo()
            # the supersteps' phases (the cold pre-solve's charge and boundary
            # calls come first)
            phase_ms = {HALO_PHASES[name]: [round(x, 3) for x in rec["ms"][-HALO_STEPS:]]
                        for name, (rec, _) in timed.items()}
            launches = {name: w.launches for name, w in wrappers.items()}
            check(len(h_steps) == len(s_steps) == HALO_STEPS,
                  f"halo {prec}: ran {len(h_steps)} and {len(s_steps)} supersteps")
            if cuda:
                check(launches["ell_gather"] > 0, f"halo {prec}: the gather was never launched")
                check(plain["calls"] == exact_plain["calls"] == 0,
                      f"halo {prec}: the gather's or the exact sweep's plain version ran")
                # the exact-erfc sweep of the rank's rows: once a superstep
                check(launches["poisson_exact_batched"] == HALO_STEPS,
                      f"halo {prec}: launches {launches}")
            else:
                check(plain["calls"] > 0, f"halo {prec}: no gather ran")
            check(launches["poisson_pairwise"] == launches["kmc_event_loop"] == 0,
                  f"halo {prec}: launches {launches}")
            h_pre = halo.presolve_log[0]
            h_kmc = halo.state.kmc_time
            del halo
            if cuda:
                torch.cuda.empty_cache()

            pb_err = max(float((h["pb"] - s["pb"]).abs().max() / s["pb"].abs().max())
                         for h, s in zip(h_steps, s_steps))
            same = [h["events"] == s["events"] and torch.equal(h["element"], s["element"])
                    and torch.equal(h["charge"], s["charge"])
                    for h, s in zip(h_steps, s_steps)]
            kmc_rel = abs(h_kmc - s_kmc) / abs(s_kmc)
            slabs = {K: -(-n_real // (K * _BLOCK)) * _BLOCK for K in HALO_CARDS}
            rec = dict(
                ms_halo=[round(h["ms"], 3) for h in h_steps],
                ms_single=[round(s["ms"], 3) for s in s_steps],
                events_halo=[h["events"] for h in h_steps],
                events_single=[s["events"] for s in s_steps],
                cg_halo=[h["cg"] for h in h_steps], cg_single=[s["cg"] for s in s_steps],
                steps_equal=same, potential_boundary_err=pb_err, kmc_time_rel_err=kmc_rel,
                collectives=[h["counts"] for h in h_steps], launches=launches,
                phase_ms=phase_ms,
                presolve_halo=h_pre, presolve_single=s_pre, wall_s=wall,
                halo_width=width, slabs=slabs)
            summary[prec] = rec
            med = lambda xs: statistics.median(xs)
            log(f"halo phase, {prec} ({card}), world 1 through {backend}: {HALO_STEPS} supersteps "
                f"{med(rec['ms_halo']):.2f} ms median {rec['ms_halo']} against the single "
                f"device's eager {med(rec['ms_single']):.2f} ms {rec['ms_single']}; events "
                f"{rec['events_halo']} (single {rec['events_single']}), equal step for step "
                f"{same}; potential_boundary within {pb_err:.2e} of its scale, kmc_time "
                f"{kmc_rel:.2e} relative; boundary CG iterations {rec['cg_halo']} (single "
                f"{rec['cg_single']}); cold pre-solve {h_pre['cg_iters']} iterations, "
                f"{h_pre['s']:.3f} s (single {s_pre['cg_iters']}, {s_pre['s']:.3f} s)")
            log(f"  collectives a superstep: {rec['collectives']}; launches on the halo path "
                f"{launches}; ms of the halo superstep's phases {phase_ms}")
            if prec == "f64":
                for k, (ok, h, s) in enumerate(zip(same, h_steps, s_steps)):
                    check(ok, f"halo f64 step {k}: events {h['events']} vs {s['events']}, "
                              "or elements or charges differ")
                check(pb_err <= 1e-8, f"halo f64: potential_boundary error {pb_err:.3e}")
                check(kmc_rel <= 1e-6, f"halo f64: kmc_time {h_kmc} vs {s_kmc}")
        log(f"  halo width {width} sites against the slab at "
            + ", ".join(f"{K} cards: {S} ({'fits' if width <= S else 'does not fit'})"
                        for K, S in slabs.items()))
        summary["transport"] = halo_transport_path(out_root, mesh, backend, device, n_sites)
        log(f"  phase 12 in {time.perf_counter() - t_phase:.1f} s")
    finally:
        dist.destroy_process_group()
    return summary


def halo_transport_path(out_root, mesh, backend, device="cuda", n_sites=N_SITES):
    """Phase 12's transport run: the crossbar with the transport settings of
    PERF.md §4 and global heat (``HALO_TRANSPORT``) over the halo
    decomposition at world size 1 (``mesh``) and on the single-device eager
    superstep, each its cold solves and HALO_STEPS supersteps at Vd = 1 V, in
    f64 and in mixed precision.  The halo run is driven with the wrappers'
    counts set to 0 just before and read just after: the window kernel once
    an operator assembly in mixed precision (its plain version never), the
    pair-sweep, band, on-the-fly and event kernels never.  Gates, each
    precision: events, elements and charges equal step for step, every
    transport solve converged; at the first superstep's state (the single
    device's, fed to both) the halo operator and ``assemble_X_blocks``'s on
    one seeded vector within 1e-12 (f64) and 1e-6 (mixed) of their scale; in
    f64 the two power extractions of one potential vector within 1e-12 of
    their scale, and the local heat models (``halo_heat_local_cg``,
    ``update_temperature_local_cg``) on one seeded power that moves T by
    about 10 K within 1e-8 K.  Printed: I_macro and P_tot of both runs, ms a
    superstep and of each phase, the collectives a superstep, the CG
    iterations, an operator application's ms (and on the card its device
    busy ms, copies and launches) and a collective's alone.  Returns the
    summary."""
    import dataclasses

    import numpy as np
    import torch

    from devicekmc_tpu_torch.ops import banded, kmc_events, wkb_fly
    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.ops import wkb_window as ww
    from devicekmc_tpu_torch.parallel import halo_superstep as hs
    from devicekmc_tpu_torch.parallel import halo_transport as ht
    from devicekmc_tpu_torch.physics import current as cur
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import replace

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    wrappers = {"wkb_window_block": ww.wkb_window_block, "ell_gather": eg.ell_gather,
                "poisson_pairwise": pw.poisson_pairwise, "banded_matvec": banded.banded_matvec,
                "banded_matvec_out": banded.banded_matvec_out,
                "wkb_fly_matvec": wkb_fly.wkb_fly_matvec,
                "wkb_fly_matvec_out": wkb_fly.wkb_fly_matvec_out,
                "wkb_fly_matmat": wkb_fly.wkb_fly_matmat, "wkb_fly_pdisp": wkb_fly.wkb_fly_pdisp,
                "kmc_event_loop": kmc_events.kmc_event_loop}
    f64 = torch.float64
    summary = {}
    for prec, over in HALO_TRANSPORT.items():
        over = dict(HALO_TRANSPORT_COMMON, **over)
        single, s_steps = halo_sim(out_root, f"halo_transport_single_{prec}", None, device,
                                   n_sites, **over)
        single.run_bias_point(VD_MAIN, 1e30, max_steps=HALO_STEPS)
        halo, h_steps = halo_sim(out_root, f"halo_transport_{prec}", mesh, device, n_sites,
                                 **over)
        # ---- counters to 0, drive, read ----
        for w in wrappers.values():
            w.launches = 0
        plain, restore = _counted(ww, "wkb_window_block_plain")
        assemblies, restore_asm = _counted(ht, "assemble_halo_operator")
        timed = {name: _counted(hs, name, sync) for name in HALO_TRANSPORT_PHASES}
        mesh.comm.reset_counts()
        try:
            t = time.perf_counter()
            halo.run_bias_point(VD_MAIN, 1e30, max_steps=HALO_STEPS)
            sync()
            wall = time.perf_counter() - t
        finally:
            restore()
            restore_asm()
            for _, undo in timed.values():
                undo()
        launches = {name: w.launches for name, w in wrappers.items()}
        phase_ms = {HALO_TRANSPORT_PHASES[name]: [round(x, 3) for x in rec["ms"][-HALO_STEPS:]]
                    for name, (rec, _) in timed.items()}
        check(len(h_steps) == len(s_steps) == HALO_STEPS,
              f"halo transport {prec}: ran {len(h_steps)} and {len(s_steps)} supersteps")
        same = [h["events"] == s["events"] and torch.equal(h["element"], s["element"])
                and torch.equal(h["charge"], s["charge"]) for h, s in zip(h_steps, s_steps)]
        conv = [(h["metrics"]["transport_converged"], s["metrics"]["transport_converged"])
                for h, s in zip(h_steps, s_steps)]
        n_asm = assemblies["calls"]
        if cuda:
            if prec == "mixed":
                check(launches["wkb_window_block"] == n_asm > 0,
                      f"halo transport mixed: {launches['wkb_window_block']} window launches "
                      f"for {n_asm} assemblies")
            else:
                check(launches["wkb_window_block"] == 0, "halo transport f64: window launched")
            check(plain["calls"] == 0, f"halo transport {prec}: the window's plain version ran")
            check(launches["ell_gather"] > 0, f"halo transport {prec}: no gather launched")
        quiet = {k: v for k, v in launches.items() if k not in ("wkb_window_block", "ell_gather")}
        check(not any(quiet.values()), f"halo transport {prec}: launches {launches}")

        # ---- the operator and the extraction at the first superstep's state ----
        st0 = s_steps[0]["state"]
        hst = halo.state
        nr, Na = single.geom.N_real, single.geom.N_atom
        ts, sizes = halo.transport_static
        check(sizes["Na"] == Na, "halo transport: the atom counts differ")
        pad = lambda f: torch.cat([getattr(st0, f), getattr(hst, f)[nr:]])  # noqa: E731
        sh = hs._Shard(mesh.comm, halo.geom.neigh_idx, halo._halo_width, halo.geom.N_real)
        op = ht.assemble_halo_operator(sh, halo.geom, halo.params, ts, sizes, pad("element"),
                                       pad("charge"), pad("CB_edge"),
                                       T_cc_loc=halo._cc["cc"])
        blk = cur.assemble_X_blocks(single.geom, single.params, st0, cc=single._cc["cc"],
                                    band=single._cc.get("band"))
        rng = np.random.default_rng(7)
        x = torch.zeros(sizes["Na_pad"] + 2, dtype=f64, device=single.device)
        x[:Na + 1] = torch.from_numpy(rng.standard_normal(Na + 1)).to(x.device)
        y_h = op["apply"](x, f64)[:Na + 1]
        y_s = cur._apply_X_blocks(blk, x[:Na + 2], f64)[:Na + 1]
        # the virtual rows (loop_G ~ 1e7 high_G) and the atom rows apart
        op_err = max(float((y_h[r] - y_s[r]).abs().max() / y_s[r].abs().max())
                     for r in (slice(0, 2), slice(2, None)))
        # the tunnel rows alone (at world 1 the bucket's slots are the single
        # device's; the metal block where the single device stores it)
        n_mp, vcap = sizes["n_mp"], single.params.tunnel_vac_cap
        pairs = [(op["T_vm_loc"][:vcap, :n_mp], blk["T_vm"]), (op["T_vv_loc"][:vcap, :vcap],
                                                             blk["T_vv"])]
        if blk["T_cc"] is not None:
            pairs.append((op["T_cc_loc"][:n_mp, :n_mp], blk["T_cc"]))
        tunnel_err = max(float((a.double() - b.double()).abs().max()
                               / b.double().abs().max().clamp(min=1e-300)) for a, b in pairs)
        v = st0.virtual_potentials.to(f64)
        M = v * cur.G0
        ap_s = cur._site_power(single.geom, single.params, st0,
                               cur._pdisp_blocked(blk, M[2:], VD_MAIN))[0][
            single.geom.atom_ind.long()]
        Matoms = torch.cat([M[2:Na + 1], torch.zeros(sizes["Na_pad"] - Na + 1, dtype=f64,
                                                      device=M.device)])
        ap_h = ht.halo_atom_power(sh, halo.params, op, sizes, Matoms, VD_MAIN)[:Na]
        pw_err = float((ap_h - ap_s).abs().max() / ap_s.abs().max().clamp(min=1e-300))
        # what an operator application costs at this state, and its
        # collectives alone at their shapes (host clock, 20 calls)
        costs = {}
        for name, fn in (("apply_f64_ms", lambda: op["apply"](x, f64)),
                         ("apply_f32_ms", lambda: op["apply"](x, torch.float32)),
                         ("all_gather_ms", lambda: mesh.comm.all_gather(x[:sizes["Sa"]])),
                         ("all_reduce_ms", lambda: mesh.comm.all_reduce(
                             x[:sizes["n_mp_pad"]].float()))):
            fn()
            sync()
            t = time.perf_counter()
            for _ in range(20):
                fn()
            sync()
            costs[name] = (time.perf_counter() - t) * 1e3 / 20
        if cuda:
            # the f32 application under torch.profiler: the device's busy
            # share of its wall time, its device-to-host copies and launches
            apply32 = lambda: op["apply"](x, torch.float32)  # noqa: E731
            wall, busy, dtoh, _ = profile_calls(apply32, 20)
            launched, kernels = device_launches(apply32)
            costs.update(apply_f32_profiled_ms=wall / 20,
                         apply_f32_busy_ms=None if busy is None else busy / 20,
                         apply_f32_dtoh=None if dtoh is None else dtoh / 20,
                         apply_f32_launches=launched, apply_f32_device_kernels=len(kernels))
        del op, blk

        rec = dict(
            ms_halo=[round(h["ms"], 3) for h in h_steps],
            ms_single=[round(s["ms"], 3) for s in s_steps],
            events_halo=[h["events"] for h in h_steps],
            events_single=[s["events"] for s in s_steps], steps_equal=same,
            transport_converged=conv,
            cg_power_halo=[int(h["metrics"]["cg_iters_power"]) for h in h_steps],
            cg_power_single=[int(s["metrics"]["cg_iters_power"]) for s in s_steps],
            cg_boundary_halo=[h["cg"] for h in h_steps],
            I_macro=(halo.state.I_macro, single.state.I_macro),
            P_tot=(halo.state.P_tot, single.state.P_tot),
            T_bg=(halo.state.T_bg, single.state.T_bg),
            operator_err=op_err, tunnel_rows_err=tunnel_err, power_err=pw_err,
            launches=launches, assemblies=n_asm, costs=costs,
            collectives=[h["counts"] for h in h_steps], phase_ms=phase_ms,
            presolve_halo=halo.presolve_log, presolve_single=single.presolve_log,
            wall_s=wall, sizes=sizes)
        rel = lambda a, b: abs(a - b) / max(abs(b), 1e-300)  # noqa: E731
        med = statistics.median
        log(f"halo transport, {prec}, world 1 through {backend}: "
            f"{HALO_STEPS} supersteps {med(rec['ms_halo']):.2f} ms median {rec['ms_halo']} "
            f"against the single device's eager {med(rec['ms_single']):.2f} ms "
            f"{rec['ms_single']}; events {rec['events_halo']} (single {rec['events_single']}), "
            f"equal step for step {same}; transport converged {conv}; transport CG "
            f"iterations {rec['cg_power_halo']} (single {rec['cg_power_single']}); operator "
            f"within {op_err:.2e} of its scale (virtual and atom rows apart), tunnel rows "
            f"{tunnel_err:.2e}, extraction {pw_err:.2e}; I_macro "
            f"{rec['I_macro'][0]:.10e} against {rec['I_macro'][1]:.10e} A ("
            f"{rel(*rec['I_macro']):.2e}), P_tot {rec['P_tot'][0]:.10e} against "
            f"{rec['P_tot'][1]:.10e} W ({rel(*rec['P_tot']):.2e})")
        log(f"  collectives a superstep: {rec['collectives']}; launches on the halo path "
            f"{launches}, {n_asm} assemblies; ms of the halo superstep's phases {phase_ms}; "
            f"an operator application and a collective alone: {costs}")
        for k, (ok, h, s) in enumerate(zip(same, h_steps, s_steps)):
            check(ok, f"halo transport {prec} step {k}: events {h['events']} vs "
                      f"{s['events']}, or elements or charges differ")
        check(all(a and b for a, b in conv), f"halo transport {prec}: converged {conv}")
        for what, err in (("operator", op_err), ("tunnel rows", tunnel_err)):
            check(err <= (1e-12 if prec == "f64" else 1e-6),
                  f"halo transport {prec}: {what} error {err:.3e}")
        if prec == "f64":
            check(pw_err <= 1e-12, f"halo transport f64: extraction error {pw_err:.3e}")
            rec["local_heat"] = _halo_local_heat_check(single, halo, sh, st0, nr)
        summary[prec] = rec
        del single, halo
        if cuda:
            torch.cuda.empty_cache()
    log(f"  halo transport runs in {time.perf_counter() - t_phase:.1f} s")
    return summary


def _halo_local_heat_check(single, halo, sh, st0, nr):
    """The local (cg) heat model on the slabs against the single device's
    on one seeded power (the single device's first superstep's state),
    scaled so that the temperature moves by about 10 K: 4 transient
    substeps; within 1e-8 K.  Both models with symmetric contact spans."""
    import numpy as np
    import torch

    from devicekmc_tpu_torch.parallel import halo_superstep as hs
    from devicekmc_tpu_torch.parallel import halo_transport as ht
    from devicekmc_tpu_torch.physics import heat as heat_mod
    from devicekmc_tpu_torch.state import replace

    def model(sim, elements, n_sites):
        e = elements.cpu().numpy()
        nac = sim.cfg.num_atoms_contact
        spans = (heat_mod._num_in_contact_left(e, nac),
                 heat_mod._num_in_contact_left(e[::-1], nac))
        # built on the whole structure: at world size 1 the slab is all of it
        return heat_mod.build_heat_model(sim.geom, sim.params, sim.cfg, e,
                                         sim.geom.neigh_idx.cpu().numpy(), method="cg",
                                         contact_spans=spans)

    params = single.params
    step_time = 3 * params.delta_t
    T0 = params.background_temp
    elem_h = torch.cat([st0.element, halo.state.element[nr:]])
    heat_s = model(single, st0.element, single.geom.N)
    heat_h = hs.shard_heat_model(model(halo, elem_h, halo.geom.N), halo.geom.N, halo.mesh)
    rng = np.random.default_rng(11)
    p0 = torch.from_numpy(rng.uniform(0.0, 1.0, nr)).to(st0.power)
    temp0 = torch.full_like(st0.temperature, T0)
    single_T = lambda p: heat_mod.update_temperature_local_cg(  # noqa: E731
        single.geom, params, heat_s, replace(st0, power=p, temperature=temp0), step_time)[0]
    dT = float((single_T(p0).temperature - T0).abs().max())
    p = p0 * (10.0 / dT)
    ts_ = single_T(p)
    pad = lambda a, b: torch.cat([a, b[nr:]])  # noqa: E731
    temp_h, T_bg_h, _ = ht.halo_heat_local_cg(
        sh, halo.geom, halo.params, heat_h, elem_h, pad(p, torch.zeros_like(halo.state.power)),
        pad(temp0, halo.state.temperature), step_time)
    err = float((temp_h[:nr] - ts_.temperature).abs().max())
    moved = float((ts_.temperature - T0).abs().max())
    log(f"  local heat on the slab against the single device: {heat_s.n_interface} interface "
        f"sites, T moved {moved:.3f} K in {heat_mod.n_substeps(params, step_time)} substeps; "
        f"temperature within {err:.3e} K, T_bg {T_bg_h:.12f} against {ts_.T_bg:.12f} K")
    check(err <= 1e-8, f"halo local heat: temperature error {err:.3e} K")
    check(abs(T_bg_h - ts_.T_bg) <= 1e-8, f"halo local heat: T_bg {T_bg_h} vs {ts_.T_bg}")
    return dict(interface=heat_s.n_interface, moved_K=moved, temp_err_K=err,
                T_bg=(T_bg_h, ts_.T_bg))


# ---------------------------------------------------------------------------
# phase 13: the replicated decomposition
# ---------------------------------------------------------------------------

REPLICATE_STEPS = 3
#: phase 13's runs, each against the single device's eager run with the same
#: resolved options: the crossbar's headline in f64 at solver_tol 1e-12 and in
#: mixed precision, then the transport configuration with global heat
#: (without the band and the persistent tunnel store, which a mesh turns off)
REPLICATE_RUNS = {
    "f64": dict(precision="f64", solver_tol=1e-12),
    "mixed": {},
    "transport": dict(current=True, heat="global", transport_banded=False,
                      transport_incremental="off"),
}
#: the replicated superstep's phases, timed in phase 13 (function: name)
REPLICATE_PHASES = {"replicate_charge": "charge", "replicate_boundary": "boundary potential",
                    "replicate_poisson": "Poisson", "replicate_events": "events",
                    "replicate_power": "transport and power", "replicate_heat": "heat"}
#: the single device's phases (``superstep``), timed alike in phase 13's
#: single-device runs: each between two synchronizations, as the replicated
#: run's
SINGLE_PHASES = {"_phase_charge": "charge", "_phase_boundary": "boundary potential",
                 "_phase_poisson": "Poisson", "_phase_events": "events",
                 "_phase_power": "transport and power", "_phase_heat": "heat"}
#: the kernels of the replicated path (wrapper module, wrapper, plain version)
#: and the runs that must launch each (the pair sweep: its row range)
REPLICATE_KERNELS = {
    "ell_gather": ("ell_gather", "ell_gather_plain", ("f64", "mixed", "transport")),
    "poisson_pairwise": ("pairwise", "poisson_pairwise_plain", ("f64", "mixed", "transport")),
    "kmc_event_loop": ("kmc_events", "kmc_event_loop_plain", ("f64", "mixed", "transport")),
    "wkb_fly_matvec": ("wkb_fly", "wkb_fly_matvec_plain", ()),
    "wkb_fly_matvec_out": ("wkb_fly", None, ()),
    "wkb_fly_matmat": ("wkb_fly", "wkb_fly_matmat_plain", ("transport",)),
    "wkb_fly_pdisp": ("wkb_fly", "wkb_fly_pdisp_plain", ("transport",)),
    "wkb_window_block": ("wkb_window", "wkb_window_block_plain", ("transport",)),
}
#: ranks whose rows the pair sweep's row range is held to at the crossbar's
#: shape
ROW_SPLITS = 4
#: supersteps of the replica-axis check
REPLICA_STEPS = 2


def _ops_module(name):
    import importlib

    return importlib.import_module(f"devicekmc_tpu_torch.ops.{name}")


def pair_rows_checks(geom, params, state):
    """The pair sweep over a row range at the crossbar's shape (the charged
    list of ``state``): the rows of ROW_SPLITS ranks, each bit-equal to the
    same rows of one launch over every row and within 2e-6 of the plain
    version's scale; timed at a quarter of the rows and at all of them,
    beside the plain version and the bound.  Returns the record fields."""
    import torch

    from devicekmc_tpu_torch.ops.pairwise import (kernel_scalars, poisson_grid,
                                                  poisson_pairwise, poisson_pairwise_plain,
                                                  poisson_pairwise_rows)

    coords32 = geom.coords.to(torch.float32).contiguous()
    cidx = torch.nonzero(state.charge != 0).reshape(-1).to(torch.int32)
    cq = state.charge[cidx.long()].to(torch.float32)
    n, n_c = geom.N, int(cidx.numel())
    check(n_c > 0 and n % ROW_SPLITS == 0, f"row range: {n_c} charged, {n} rows")
    scal = kernel_scalars(params.sigma, params.k, list(geom.lattice_host), params.dtype)
    whole = poisson_pairwise(coords32, cidx, cq, *scal, geom.pbc)
    S = n // ROW_SPLITS
    err = 0.0
    for r in range(ROW_SPLITS):
        got = poisson_pairwise_rows(coords32, r * S, S, cidx, cq, *scal, geom.pbc)
        ref = poisson_pairwise_plain(coords32, cidx, cq, *scal, geom.pbc, row0=r * S,
                                     n_rows=S)
        check(torch.equal(got, whole[r * S:(r + 1) * S]),
              f"row range {r}: not the whole launch's rows bit for bit")
        err = max(err, _close(f"poisson_pairwise_rows {r}", got, ref, 2e-6))

    def bound(rows):
        return _bound(rows * n_c * POISSON_OPS_PER_PAIR[geom.pbc], rows * 16 + n_c * 8)

    ms = time_ms(lambda: poisson_pairwise_rows(coords32, 0, S, cidx, cq, *scal, geom.pbc))
    ms_all = time_ms(lambda: poisson_pairwise(coords32, cidx, cq, *scal, geom.pbc))
    plain_ms = time_ms(lambda: poisson_pairwise_plain(coords32, cidx, cq, *scal, geom.pbc,
                                                      row0=0, n_rows=S), reps=5)
    (b_ms, b_by), (b_all, _) = bound(S), bound(n)
    n_split = poisson_grid(n, n_c,
                           torch.cuda.get_device_properties(0).multi_processor_count)[1]
    log(f"poisson_pairwise_rows [{S} of {n} rows x {n_c} charged, the whole sweep's "
        f"{n_split} splits]: {ROW_SPLITS} row ranges bit-equal to the whole launch's rows, "
        f"max err against the plain version {err:.3e}; {ms:.4f} ms a quarter (bound "
        f"{b_ms:.4f} ms by {b_by}, plain {plain_ms:.4f} ms), {ms_all:.4f} ms every row "
        f"(bound {b_all:.4f} ms)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=f"{S} of {n} rows x {n_c} charged",
                ms_all_rows=ms_all, bound_ms_all_rows=b_all, n_split=n_split,
                row_ranges=ROW_SPLITS)


def replica_axis_check(out_root, mesh_batch):
    """The replica axis at world 1: phase 10's replicas (its crossbar, cold
    solve, ENSEMBLE_B replicas, keys of ENSEMBLE_SEED) through
    make_batched_superstep with and without a mesh along "batch"
    (shard_batch, then gather_batch), REPLICA_STEPS supersteps: every field
    bit for bit."""
    import torch

    from devicekmc_tpu_torch.parallel.batched import (batch_states, gather_batch,
                                                      make_batched_superstep, shard_batch)
    from devicekmc_tpu_torch.state import replace

    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "replica_axis"))
    geom, params = sim.geom, sim.params
    sim._chunked_boundary(VD_MAIN, params.solver_maxiter,
                          replace(params, boundary_precond="deflated"))
    states0 = batch_states(sim.state, ENSEMBLE_B, base_seed=ENSEMBLE_SEED)
    plain, meshed = states0, shard_batch(states0, mesh_batch)
    step = make_batched_superstep(geom, params, sim.heat)
    step_m = make_batched_superstep(geom, params, sim.heat, mesh=mesh_batch)
    events = []
    for _ in range(REPLICA_STEPS):
        plain, dts, m = step(plain, VD_MAIN)
        meshed, dts_m, _ = step_m(meshed, VD_MAIN)
        check(torch.equal(dts, dts_m), "replica axis: step times differ")
        events.append(m["n_events"].tolist())
    whole = gather_batch(meshed, mesh_batch)
    for f in dataclasses.fields(whole):
        a, b = getattr(whole, f.name), getattr(plain, f.name)
        check(a.dtype == b.dtype and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(),
              f"replica axis: {f.name} differs")
    log(f"replica axis at world 1 ({ENSEMBLE_B} replicas of phase 10's crossbar, keys of seed "
        f"{ENSEMBLE_SEED}): make_batched_superstep with a mesh along 'batch' (shard_batch, "
        f"gather_batch) against the same without one, {REPLICA_STEPS} supersteps: every "
        f"field bit for bit; events {events}")
    rec = dict(replicas=ENSEMBLE_B, steps=REPLICA_STEPS, events=events, bit_equal=True)
    return rec, mesh2d_check(sim, states0)


#: the kernels of the 2-D mesh's superstep (the replicated decomposition's
#: headline, each replica alone): wrapper module and plain version
MESH2D_KERNELS = {name: REPLICATE_KERNELS[name][:2]
                  for name in ("ell_gather", "poisson_pairwise", "kmc_event_loop")}


def mesh2d_check(sim, states0):
    """The 2-D ("batch", "sites") mesh at world 1 (a (1, 1) mesh through
    NCCL): ``states0``'s replicas through ``make_batched_superstep`` on the
    geometry of ``shard_simulation``, REPLICA_STEPS supersteps, with the
    counts of MESH2D_KERNELS' wrappers set to 0 just before and read just
    after (each launched, no plain version); then each replica alone through
    the single device's eager superstep from its own state and key: every
    field and step time bit for bit.  Returns the record."""
    import torch

    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.parallel import make_mesh
    from devicekmc_tpu_torch.parallel.batched import make_batched_superstep, shard_batch
    from devicekmc_tpu_torch.parallel.sharding import shard_simulation
    from devicekmc_tpu_torch.state import stack_states, unbatch_all

    geom, params = sim.geom, sim.params
    dev = geom.device.type
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    mesh = make_mesh(1, device=dev, axis_names=("batch", "sites"), shape=(1, 1))
    g2, _ = shard_simulation(geom, sim.state, mesh)
    step2 = make_batched_superstep(g2, params, sim.heat, mesh=mesh)
    wrappers = {name: getattr(_ops_module(mod), name)
                for name, (mod, _) in MESH2D_KERNELS.items()}
    plains = {name: _counted(_ops_module(mod), plain)
              for name, (mod, plain) in MESH2D_KERNELS.items()}
    # ---- counters to 0, drive, read ----
    for w in wrappers.values():
        w.launches = 0
    try:
        states, dts2, events = shard_batch(states0, mesh), [], []
        sync()
        t = time.perf_counter()
        for _ in range(REPLICA_STEPS):
            states, dts, m = step2(states, VD_MAIN)
            dts2.append(dts)
            events.append([int(x) for x in m["n_events"].tolist()])
        sync()
        wall = time.perf_counter() - t
    finally:
        for _, undo in plains.values():
            undo()
    launches = {name: w.launches for name, w in wrappers.items()}
    plain_calls = {name: rec["calls"] for name, (rec, _) in plains.items()}
    if dev == "cuda":
        for name, n in launches.items():
            check(n > 0, f"2-D mesh: {name} never launched")
        check(all(c == 0 for c in plain_calls.values()),
              f"2-D mesh: a plain version ran {plain_calls}")

    eager = engine.make_superstep(geom, params, sim.heat)
    ends, dts1 = [], []
    for st in unbatch_all(states0):
        dt = []
        for _ in range(REPLICA_STEPS):
            st, t1, _ = eager(st, VD_MAIN)
            dt.append(float(t1))
        ends.append(st)
        dts1.append(dt)
    single = stack_states(ends)
    for f in dataclasses.fields(single):
        a, b = getattr(states, f.name), getattr(single, f.name)
        check(a.dtype == b.dtype and a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes(),
              f"2-D mesh: {f.name} differs from the single device's eager superstep")
    got = torch.stack(dts2).T.cpu().tolist()
    check(got == dts1, f"2-D mesh: step times {got} against {dts1}")
    log(f"2-D ('batch', 'sites') mesh at world 1 (a (1, 1) mesh, {dev}; {ENSEMBLE_B} "
        f"replicas of phase 10's crossbar): make_batched_superstep on shard_simulation's "
        f"geometry, {REPLICA_STEPS} supersteps in {wall:.3f} s, against each replica alone "
        f"through the single device's eager superstep: every field and step time bit for "
        f"bit; events {events}; launches {launches}; plain calls {plain_calls}")
    return dict(replicas=ENSEMBLE_B, steps=REPLICA_STEPS, events=events, launches=launches,
                plain_calls=plain_calls, wall_s=wall, bit_equal=True)


def replicate_path(out_root, device="cuda", n_sites=N_SITES):
    """Phase 13: the replicated decomposition (``Simulation(mesh=...)``'s
    default) at world size 1 through NCCL (an in-process store, cuda:0) on
    the crossbar, REPLICATE_RUNS: each run's cold solves and REPLICATE_STEPS
    supersteps against the single device's eager run with the same resolved
    options: events, elements and charges equal, and the boundary and charge
    potentials, I_macro, P_tot and T_bg bit-equal, step for step.  Both runs
    time each phase between two synchronizations (REPLICATE_PHASES,
    SINGLE_PHASES), so their supersteps' ms compare.  The replicated runs
    are driven with the wrappers' counts set to 0 just before and read just
    after: the gather, the pair sweep (its row range) and the event loop
    launched in every run, the fly matvec and matmat, the window block and
    the dissipation kernel in the transport run, and no plain version.  Then
    the pair sweep's row range at the crossbar's shape (pair_rows_checks), the replica
    axis (replica_axis_check) and a checkpoint under a mesh under both
    decompositions (phase 8's resume_check on the small stack).  ``device=
    "cpu"`` (with a smaller ``n_sites``) rehearses the runs on the CPU
    through gloo (the kernel checks need the card).  Returns the phase's
    summary and the row range's record fields."""
    import torch
    import torch.distributed as dist

    from devicekmc_tpu_torch import superstep as superstep_mod
    from devicekmc_tpu_torch.parallel import make_mesh
    from devicekmc_tpu_torch.parallel import sharding as shd

    t_phase = time.perf_counter()
    cuda = device == "cuda"
    card = gpu_line() if cuda else "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    backend = "NCCL" if cuda else "gloo"
    check(not dist.is_initialized(), "a process group runs before the replicate phase")
    dist.init_process_group(backend.lower(), store=dist.HashStore(), rank=0, world_size=1)
    summary, row_rec = {}, None
    try:
        mesh = make_mesh(1, device=device)
        for tag, over in REPLICATE_RUNS.items():
            single, s_steps = halo_sim(out_root, f"rep_single_{tag}", None, device, n_sites,
                                       **over)
            timed_s = {name: _counted(superstep_mod, name, sync) for name in SINGLE_PHASES}
            try:
                single.run_bias_point(VD_MAIN, 1e30, max_steps=REPLICATE_STEPS)
            finally:
                for _, undo in timed_s.values():
                    undo()
            s_phase_ms = {SINGLE_PHASES[name]: [round(x, 3)
                                                for x in rec["ms"][-REPLICATE_STEPS:]]
                          for name, (rec, _) in timed_s.items() if rec["ms"]}
            s_pre = single.presolve_log
            del single
            rep, r_steps = halo_sim(out_root, f"rep_{tag}", mesh, device, n_sites,
                                    decomposition="replicate", **over)
            check(rep.decomposition == "replicate" and rep._band is None
                  and not rep.params.transport_incremental, f"replicate {tag}: options")
            # ---- counters to 0, drive, read ----
            wrappers = {name: getattr(_ops_module(mod), name)
                        for name, (mod, _, _) in REPLICATE_KERNELS.items()}
            for w in wrappers.values():
                w.launches = 0
            plains = {name: _counted(_ops_module(mod), plain)
                      for name, (mod, plain, _) in REPLICATE_KERNELS.items() if plain}
            timed = {name: _counted(shd, name, sync) for name in REPLICATE_PHASES}
            try:
                t = time.perf_counter()
                rep.run_bias_point(VD_MAIN, 1e30, max_steps=REPLICATE_STEPS)
                sync()
                wall = time.perf_counter() - t
            finally:
                for _, undo in list(plains.values()) + list(timed.values()):
                    undo()
            launches = {name: w.launches for name, w in wrappers.items()}
            plain_calls = {name: rec["calls"] for name, (rec, _) in plains.items()}
            phase_ms = {REPLICATE_PHASES[name]: [round(x, 3)
                                                 for x in rec["ms"][-REPLICATE_STEPS:]]
                        for name, (rec, _) in timed.items() if rec["ms"]}
            r_pre = rep.presolve_log
            if tag == "mixed":
                rows_sim = rep
            del rep
            check(len(r_steps) == len(s_steps) == REPLICATE_STEPS,
                  f"replicate {tag}: ran {len(r_steps)} and {len(s_steps)} supersteps")
            if cuda:
                for name, (_, _, runs) in REPLICATE_KERNELS.items():
                    if tag in runs:
                        check(launches[name] > 0, f"replicate {tag}: {name} never launched")
                if tag == "transport":
                    check(launches["wkb_fly_matvec"] + launches["wkb_fly_matvec_out"] > 0,
                          "replicate transport: the fly matvec never launched")
                check(all(c == 0 for c in plain_calls.values()),
                      f"replicate {tag}: a plain version ran {plain_calls}")

            fields = ("element", "charge", "pb")
            same = [r["events"] == s["events"] and all(torch.equal(r[f], s[f]) for f in fields)
                    for r, s in zip(r_steps, s_steps)]
            keys = ("potential_charge", "I_macro", "P_tot", "T_bg", "kmc_time")

            def val(st, k):
                v = getattr(st, k)
                return v.double().cpu() if torch.is_tensor(v) else torch.tensor(float(v))

            bits = [all(torch.equal(val(r["state"], k), val(s["state"], k)) for k in keys)
                    for r, s in zip(r_steps, s_steps)]
            rec = dict(
                ms_replicate=[round(r["ms"], 3) for r in r_steps],
                ms_single=[round(s["ms"], 3) for s in s_steps],
                events=[r["events"] for r in r_steps],
                events_single=[s["events"] for s in s_steps],
                cg_boundary=[r["cg"] for r in r_steps],
                steps_equal=same, fields_bit_equal=bits,
                collectives=[r["counts"] for r in r_steps], launches=launches,
                plain_calls=plain_calls, phase_ms=phase_ms, phase_ms_single=s_phase_ms,
                wall_s=wall,
                presolve=r_pre, presolve_single=s_pre,
                I_macro=float(r_steps[-1]["state"].I_macro),
                T_bg=float(r_steps[-1]["state"].T_bg))
            summary[tag] = rec
            med = statistics.median
            log(f"replicate phase, {tag} ({card}), world 1 through {backend}: "
                f"{REPLICATE_STEPS} supersteps {med(rec['ms_replicate']):.2f} ms median "
                f"{rec['ms_replicate']} against the single device's eager "
                f"{med(rec['ms_single']):.2f} ms {rec['ms_single']}; events {rec['events']} "
                f"(single {rec['events_single']}); events, elements, charges and "
                f"potential_boundary equal step for step {same}; potential_charge, I_macro, "
                f"P_tot, T_bg and kmc_time bit-equal {bits}; I_macro {rec['I_macro']:.6e} A, "
                f"T_bg {rec['T_bg']:.6f} K")
            log(f"  collectives a superstep: {rec['collectives']}; launches {launches}; plain "
                f"calls {plain_calls}; ms of the phases {phase_ms} (single device "
                f"{s_phase_ms}); cold solves {r_pre}")
            for k, ok in enumerate(same):
                check(ok, f"replicate {tag} step {k}: events, elements, charges or "
                          "potential_boundary differ from the single device's")
                check(bits[k], f"replicate {tag} step {k}: potential_charge, I_macro, P_tot, "
                               "T_bg or kmc_time differ from the single device's")
            if cuda:
                torch.cuda.empty_cache()
        per_rank = {W: shd.row_bytes(rows_sim.geom, W) for W in (1, 2, 4, 8)}
        summary["row_bytes"] = per_rank
        log("  bytes a rank holds of the [sites x max_nn] arrays (pair rows, a solve's ELL "
            "rows, the whole neigh_idx and rev_slot) against one device: "
            + "; ".join(f"{W} ranks {b['rank'] / 2**20:.2f} MiB ({b['pair_rows'] / 2**20:.2f} + "
                        f"{b['solve_rows'] / 2**20:.2f} + {b['neigh_idx_rev_slot'] / 2**20:.2f})"
                        for W, b in per_rank.items())
            + f"; one device {per_rank[1]['single_device'] / 2**20:.2f} MiB")
        if cuda:
            row_rec = pair_rows_checks(rows_sim.geom, rows_sim.params, rows_sim.state)
            del rows_sim
            summary["replica_axis"], summary["mesh2d"] = replica_axis_check(
                out_root, make_mesh(1, device=device, axis_names=("batch",)))
            torch.cuda.empty_cache()
            summary["checkpoints"] = {
                dec: resume_check(f"small stack over a mesh of 1 rank, {dec}",
                                  lambda t, dec=dec: small_device(
                                      device, os.path.join(out_root, f"mesh_ckpt_{dec}_{t}"),
                                      mesh=mesh, decomposition=dec, poisson_compact_cap=-1),
                                  2.5, out_root) for dec in ("replicate", "halo")}
        summary["seconds"] = round(time.perf_counter() - t_phase, 1)
        log(f"  phase 13 in {summary['seconds']} s")
    finally:
        dist.destroy_process_group()
    return summary, row_rec



# ---------------------------------------------------------------------------
# phase 14: the stored metal block and the f64 solve in the captured
# transport superstep
# ---------------------------------------------------------------------------

#: phase 14's configurations of the crossbar: tag, synthetic_crossbar's
#: heat, overrides, supersteps after the cold solves.  f64 takes its cold
#: transport solve in one call: segments restart the f64 deflated CG.  f64
#: runs the exact-erfc Poisson sweep (poisson_kernel "jnp"): with the
#: stored block and f64, the JAX package's full default (phase 15's fourth
#: configuration)
STORED_RUNS = (("stored graph", None, dict(transport_cc="stored"), TRANSPORT_STEPS),
               ("stored heat (global) graph", "global", dict(transport_cc="stored"),
                TRANSPORT_STEPS),
               ("f64 graph", None, dict(transport_cc="stored", precision="f64",
                                        solver_chunk_iters=0, poisson_kernel="jnp"), 4))
#: the JAX package's stored product that stored_matvec replaces
STORED_REPLACES = "devicekmc_tpu/physics/current.py:802"


def stored_eager_run(out_root, tag, heat, over, n_steps):
    """The eager driver's run of a phase 14 configuration: cold solves and
    ``n_steps`` supersteps at VD_MAIN, every solve converged, I_macro finite
    and positive, the block stored.  Returns (sim, records)."""
    import math

    import torch

    from devicekmc_tpu_torch import engine

    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(
        out_root, tag.replace(" ", "_").replace("(", "").replace(")", "") + "_eager"),
        current=True, heat=heat, **over)
    sim._make = engine.make_superstep
    check(sim.params.transport_cc == "stored", f"{tag}: transport_cc {sim.params.transport_cc}")
    recs = transport_record(sim)
    t0 = time.perf_counter()
    try:
        sim.run_bias_point(VD_MAIN, 1e30, max_steps=n_steps)
        torch.cuda.synchronize()
    finally:
        sim.__dict__.pop("_superstep", None)
    check(len(recs) == n_steps and all(s["transport_converged"] == 1.0 for s in sim.step_log),
          f"{tag} eager: {len(recs)} supersteps, a solve did not converge")
    I = sim.state.I_macro
    check(math.isfinite(I) and I > 0, f"{tag} eager: I_macro {I}")
    log(f"{tag}, eager: cold solves + {n_steps} supersteps in {time.perf_counter() - t0:.2f} "
        f"s; cold solves {[(c['phase'], c['cg_iters']) for c in sim.presolve_log]}; "
        f"iterations {[int(s['cg_iters_power']) for s in sim.step_log]}; I_macro {I}")
    return sim, recs


def _map_ws(ws, fn):
    """A transport workspace with ``fn`` applied to every tensor, those of
    its nested CG states and the fly scratch too."""
    kw = {}
    for f in dataclasses.fields(ws):
        v = getattr(ws, f.name)
        if hasattr(v, "data_ptr"):
            v = fn(v)
        elif dataclasses.is_dataclass(v):
            v = dataclasses.replace(v, **{g.name: fn(getattr(v, g.name))
                                          for g in dataclasses.fields(v)
                                          if hasattr(getattr(v, g.name), "data_ptr")})
        elif f.name == "fly":
            v = tuple(fn(t) for t in v)
        kw[f.name] = v
    return type(ws)(**kw)


def stored_matvec_checks(T, tag, plain_reps=5):
    """stored_matvec_out on the block ``T`` against its plain version and the
    product in f64, two launches bit-equal; timed warm, with a cold L2 (a
    64 MiB write before) and after a 64 MiB read, beside its bytes bound
    (the block once, the vector, the output), torch.mv (the library call)
    timed alike and the plain version."""
    import torch

    from devicekmc_tpu_torch.ops.transport_cg import stored_matvec_out, stored_matvec_plain

    n = T.shape[0]
    g = torch.Generator(device="cuda").manual_seed(n)
    x = torch.randn(n, generator=g, device="cuda", dtype=T.dtype)
    y = torch.empty(n, dtype=T.dtype, device="cuda")
    y2 = torch.empty_like(y)
    stored_matvec_out(T, x, y)
    stored_matvec_out(T, x, y2)
    check(torch.equal(y, y2), f"stored_matvec {tag}: two launches differ")
    ref = stored_matvec_plain(T, x)
    tol = 1e-5 if T.dtype == torch.float32 else 1e-12
    err = _close(f"stored_matvec {tag}", y, ref, tol)
    exact = (T.double() @ x.double()) if T.dtype == torch.float32 else None
    err_exact = float((y.double() - exact).abs().max()) if exact is not None else None
    del exact
    item = T.element_size()
    bytes_ = item * (n * n + 2 * n)
    bound, by = _bound(2 * n * n, bytes_)
    run = lambda: stored_matvec_out(T, x, y)  # noqa: E731
    mv = lambda: torch.mv(T, x)  # noqa: E731
    rec = dict(n=n, dtype=str(T.dtype).replace("torch.", ""), max_abs_err=err,
               max_abs_err_against_f64=err_exact, ms=time_ms(run), cold_ms=time_ms_cold(run),
               clean_ms=time_ms_clean(run),
               plain_ms=time_ms(lambda: stored_matvec_plain(T, x), reps=plain_reps, rounds=3),
               library_ms=time_ms(mv), library_cold_ms=time_ms_cold(mv),
               library_clean_ms=time_ms_clean(mv),
               bound_ms=bound, bound_by=by, block_mb=item * n * n / 1e6)
    log(f"stored_matvec {tag} (n {n}, {rec['dtype']}, {rec['block_mb']:.1f} MB): "
        f"{rec['ms']:.5f} ms warm, {rec['cold_ms']:.5f} ms cold L2, {rec['clean_ms']:.5f} "
        f"after a read; bound {bound:.5f} ms ({by}): {100 * bound / rec['ms']:.0f} % warm, "
        f"{100 * bound / rec['cold_ms']:.0f} % cold; torch.mv {rec['library_ms']:.5f} / "
        f"{rec['library_cold_ms']:.5f} / {rec['library_clean_ms']:.5f} ms; plain "
        f"{rec['plain_ms']:.5f} ms; max error {err} (against f64 {err_exact})")
    return rec


def f64_cg_checks(sim):
    """The f64 solve's kernels at the crossbar's f64 operator (its state
    after the run, a seeded direction): transport_blocks' f64-storage build
    and transport_tail64 (the rows of ap = A p, p.ap and alpha, the update,
    the direction and its packing in one cooperative launch) against their
    plain versions (PyTorch operations on the same tensors), timed warm and
    with a cold L2 beside their bytes bounds; the f64 solve captured and
    from the host loop, bit for bit."""
    import torch

    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.graph import Graph
    from devicekmc_tpu_torch.physics import current as cur

    cap = {}
    solve = tcg.solve_f64

    def grab(tws, op, x0, go, tol, maxiter):
        cap.update(tws=tws, op=op, x0=x0.clone(), tol=tol, maxiter=maxiter)
        return solve(tws, op, x0, go, tol, maxiter)

    tcg.solve_f64 = grab
    try:
        st = dataclasses.replace(sim.state, transport_Vd_prev=float("nan"))
        cur.update_power(sim.geom, sim.params, st, VD_MAIN, cc=dict(sim._cc), allow_skip=True)
    finally:
        tcg.solve_f64 = solve
    tws, op = cap["tws"], cap["op"]
    nsub = tws.x.shape[0]
    na, max_nn = op.anb.shape
    vcap, n_mp = op.T_vm.shape
    nv = int(op.n_vac)
    nnz = int((op.anb >= 0).sum())
    gen = torch.Generator(device="cpu").manual_seed(17)
    tws.xs64[:nsub].copy_(torch.randn(nsub, generator=gen, dtype=torch.float64))
    tws.xs64[nsub:].zero_()
    tws.xm.copy_(tws.xs64[2:][op.mp])
    tws.r.copy_(torch.randn(nsub, generator=gen, dtype=torch.float64))
    c = tws.c64
    c.act.fill_(True)
    c.rz.copy_(torch.dot(tws.r, op.minv * tws.r).reshape(1))
    c.thresh2.fill_(1e-300)
    clone = lambda w: _map_ws(w, lambda t: t.clone())  # noqa: E731
    f8, i4 = 8, 4
    out = {}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def timed(name, fn, plain, bytes_, e, **extra):
        out[name] = dict(err=e, ms=time_ms(fn), plain_ms=time_ms(plain, reps=5, rounds=3),
                         bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3, **extra)

    base = clone(tws)
    tcg.metal(base, op)
    k, p = clone(base), clone(base)
    tcg.blocks(k, op, True)
    tcg.blocks_plain(p, op, True)
    e = max(rel(getattr(k, f)[:nv if f != "mv" else n_mp], getattr(p, f)[:nv if f != "mv"
                                                                        else n_mp])
            for f in ("mv", "y_vm", "y_vv"))
    check(e <= 1e-12, f"transport_blocks (f64 blocks): {e} from its plain version")
    timed("blocks64", lambda: tcg.blocks(k, op, True), lambda: tcg.blocks_plain(p, op, True),
          f8 * (nv * n_mp + nv * nv + n_mp) + (i4 + f8) * nv + 2 * f8 * (na + op.nsi)
          + f8 * (n_mp + 2 * nv) + 2 * f8, e,
          cold_ms=time_ms_cold(lambda: tcg.blocks(k, op, True)))
    tcg.blocks(base, op, True)
    k, p = clone(base), clone(base)
    tcg.tail_f64(k, op, 20000)
    tcg.rows_ap_plain(p, op)
    tcg.update_f64_plain(p, op, 20000)
    e_ap = rel(k.c64.ap, p.c64.ap)
    e_alpha = abs(float(k.c64.alpha) / float(p.c64.alpha) - 1)
    e = max(rel(getattr(k, f), getattr(p, f)) for f in ("x", "r", "xs64", "xm"))
    e_rz = abs(float(k.c64.rz) / float(p.c64.rz) - 1)
    check(e_ap <= 1e-12 and e_alpha <= 1e-10 and e <= 1e-12 and e_rz <= 1e-10
          and all(torch.equal(getattr(k.c64, f), getattr(p.c64, f))
                  for f in ("act", "iters", "cond")),
          f"transport_tail64: ap {e_ap}, alpha {e_alpha}, vectors {e}, r.z {e_rz} from its "
          "plain version")
    # what the tail must move: the rows' own inputs (a valid slot's int32
    # index, a class byte an atom, the slice starts; p, the metal and
    # vacancy products, the dots, the rows' slots, the virtual rows and the
    # diagonal), ap written; x and r read and written, minv read, p written,
    # the metal vector written; timed from the same start, again and again
    # (threshold 0: the flag stays up, the predicate on)
    rows_vec = f8 * (nsub + 1) + (f8 + 2 * i4) * na + f8 * (2 * n_mp + 2 * nv) \
        + f8 * (2 * na + nsub)
    update = f8 * (4 * nsub + 2 * nsub) + f8 * n_mp
    k2 = clone(base)
    for w in (k2, p):
        w.c64.thresh2.zero_()
    timed("tail64", lambda: tcg.tail_f64(k2, op, 1 << 30),
          lambda: (tcg.rows_ap_plain(p, op), tcg.update_f64_plain(p, op, 1 << 30)),
          i4 * nnz + na + i4 * op.nb_start.numel() + rows_vec + f8 * nsub + update, e,
          ap_rel_err=e_ap, alpha_rel_err=e_alpha, rz_rel_err=e_rz,
          cold_ms=time_ms_cold(lambda: tcg.tail_f64(k2, op, 1 << 30)),
          slots_read=int(op.nb_idx.numel()), slots_valid=nnz)
    r = out["tail64"]
    log(f"transport_tail64 (f64 rows, update, direction): {r['ms']:.5f} ms, cold "
        f"{r['cold_ms']:.5f}; bound {r['bound_ms']:.5f} ms ({100 * r['bound_ms'] / r['ms']:.0f} "
        f"%); {r['slots_read']} slots read for {nnz} valid")

    # the solve, captured and from the host loop
    x0, tol, maxiter = cap["x0"], cap["tol"], cap["maxiter"]
    x0 = x0 * (1 + 1e-3 * torch.randn(x0.shape, generator=gen, dtype=torch.float64).cuda())
    go = torch.ones(1, dtype=torch.bool, device="cuda")
    res = tcg.solve_f64(tws, op, x0, go, tol, maxiter)
    eager = (res.x.clone(), int(res.iters))
    torch.cuda.synchronize()
    t = time.perf_counter()
    tcg.solve_f64(tws, op, x0, go, tol, maxiter)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    g = Graph(lambda: tcg.solve_f64(tws, op, x0, go, tol, maxiter), "cuda")
    got = g()
    check(torch.equal(got.x, eager[0]) and int(got.iters) == eager[1] and bool(got.converged),
          f"the f64 solve captured differs from the host loop ({int(got.iters)} against "
          f"{eager[1]} iterations)")
    graph_ms = time_ms(g, reps=3, rounds=3)
    out["solve"] = dict(iterations=eager[1], graph_ms=graph_ms, host_loop_ms=host_ms,
                        graph_ms_per_iteration=graph_ms / max(eager[1], 1),
                        host_ms_per_iteration=host_ms / max(eager[1], 1))
    log(f"f64 solve kernels at the crossbar (nsub {nsub}, n_mp {n_mp}, {nv} live of {vcap}): "
        + "; ".join(f"{k_} {v['ms']:.5f} ms (bound {v['bound_ms']:.5f}, plain "
                    f"{v['plain_ms']:.4f}, error {v['err']:.2e})"
                    for k_, v in out.items() if k_ != "solve")
        + f"; the solve of {eager[1]} iterations captured {graph_ms:.3f} ms "
        f"({out['solve']['graph_ms_per_iteration']:.4f} an iteration), host loop "
        f"{host_ms:.3f} ms ({out['solve']['host_ms_per_iteration']:.4f})")
    del g
    return out


#: supersteps of each of the fly and the stored transport graph in phase 14's
#: turns (fly, stored, stored, fly, ...)
AUTO_TURNS = 8


def fly_against_stored(sim_s, out_root, turns=AUTO_TURNS):
    """What transport_cc="auto" (the stored block) costs against the fly
    block on the graph: a fly transport graph run of the crossbar (cold
    solves + TRANSPORT_STEPS supersteps), then its supersteps and those of
    the stored graph ``sim_s`` in turns: the ms and inner iterations of
    each, their medians, and each form's least-squares line of ms against
    inner iterations (ms an inner iteration, ms of the rest)."""
    import torch

    sim_f = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "fly_turns"),
                               current=True)
    check(sim_f._graph_for(sim_f.params) is not None and sim_f.params.transport_cc == "fly",
          "the fly transport configuration does not run the graph")
    sim_f.run_bias_point(VD_MAIN, 1e30, max_steps=TRANSPORT_STEPS)
    rows = {"fly": [], "stored": []}
    for k in range(2 * turns):
        name = ("fly", "stored", "stored", "fly")[k % 4]
        s = sim_f if name == "fly" else sim_s
        torch.cuda.synchronize()
        t = time.perf_counter()
        s.state, _, m = s._superstep(s.state, VD_MAIN)
        torch.cuda.synchronize()
        rows[name].append(((time.perf_counter() - t) * 1e3, int(m["cg_iters_power"])))
    out = {}
    for name, r in rows.items():
        ms, it = [a for a, _ in r], [b for _, b in r]
        mi, mm = statistics.mean(it), statistics.mean(ms)
        var = sum((i - mi) ** 2 for i in it)
        slope = (sum((i - mi) * (t - mm) for i, t in zip(it, ms)) / var) if var else None
        out[name] = dict(ms=ms, inner_iterations=it, median_ms=statistics.median(ms),
                         ms_per_inner_iteration=slope,
                         rest_ms=None if slope is None else mm - slope * mi)
    log("fly against stored transport graph supersteps in turns: " + "; ".join(
        f"{name} median {v['median_ms']:.2f} ms, ms (inner iterations) "
        f"{[(round(a, 2), b) for a, b in zip(v['ms'], v['inner_iterations'])]}, line "
        f"{v['ms_per_inner_iteration']} ms an inner iteration + {v['rest_ms']} ms"
        for name, v in out.items()))
    del sim_f
    out["warm_solve"] = fly_against_stored_solve(sim_s)
    return out


def fly_against_stored_solve(sim_s):
    """The captured warm solve of one operator (``sim_s``'s state, its warm
    start perturbed) with the metal block stored and on the fly (the same
    positions and CB edges), timed in turns (fly, stored, stored, fly): ms
    a solve and an inner iteration of each."""
    import torch

    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.graph import Graph
    from devicekmc_tpu_torch.physics import current as cur

    tws, op, x0, gen = transport_operator(sim_s)
    g, st, p = sim_s.geom, sim_s.state, sim_s.params
    ai, mp = g.atom_ind.long(), g.atom_metalp_idx.long()
    ops = {"stored": op,
           "fly": op._replace(T_cc=None, mpos=g.coords[ai][mp].float().contiguous(),
                              mcb=st.CB_edge[ai][mp].float().contiguous(),
                              env=cur.wkb_env(g, p))}
    x0 = x0 * (1 + 1e-3 * torch.randn(x0.shape, generator=gen, dtype=torch.float64).cuda())
    go = torch.ones(1, dtype=torch.bool, device="cuda")
    graphs, iters = {}, {}
    for name, o in ops.items():
        graphs[name] = Graph(lambda o=o: tcg.solve(tws, o, x0, go, p.transport_tol, 20000),
                             "cuda")
        iters[name] = int(graphs[name]().iters)
    ms = {"fly": [], "stored": []}
    for name in ("fly", "stored", "stored", "fly"):
        ms[name].append(time_ms(graphs[name], reps=3, rounds=3))
    out = {name: dict(ms=v, inner_iterations=iters[name],
                      ms_per_inner_iteration=[t / max(iters[name], 1) for t in v])
           for name, v in ms.items()}
    log("the warm solve captured, one operator, in turns: " + "; ".join(
        f"{name} {[round(t, 4) for t in v['ms']]} ms for {v['inner_iterations']} inner "
        f"iterations ({[round(t, 5) for t in v['ms_per_inner_iteration']]} ms each)"
        for name, v in out.items()))
    del graphs
    return out


def stored_path(out_root):
    """Phase 14: STORED_RUNS each eagerly and on the captured graph (the
    main path: transport_graph_phase, counters to 0 around it, bit for bit
    step for step, in turns, 1 device-to-host copy a graph superstep; the
    stored block's product launched, the fly matvec never); stored_matvec
    at the crossbar's block (f32 and f64) and at the reference crossbar's
    24,768 metal atoms (f32, f64), beside the fly matvec at 3,527; the f64
    solve's kernels.  Returns (kernel records, summaries)."""
    import torch

    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec
    from devicekmc_tpu_torch.physics import current as cur

    summaries, blocks = {}, {}
    t0 = time.perf_counter()
    f64 = None
    for tag, heat, over, n in STORED_RUNS:
        eager = stored_eager_run(out_root, tag, heat, over, n)
        gsim, summ = transport_graph_phase(out_root, heat, eager, second_point=False,
                                           n_steps=n, tag=tag, **over)
        summaries[tag] = summ
        blocks[tag] = gsim._cc["cc"]
        if tag == "f64 graph":
            f64 = f64_cg_checks(gsim)
        elif heat is None:
            ref_sim = gsim
            summ["fly_against_stored"] = fly_against_stored(gsim, out_root)
        del eager, gsim
        torch.cuda.empty_cache()
    checks = {"crossbar f32": stored_matvec_checks(blocks["stored graph"], "crossbar f32"),
              "crossbar f64": stored_matvec_checks(blocks["f64 graph"], "crossbar f64")}
    # the fly matvec at the same metal set, in this call
    g, st = ref_sim.geom, ref_sim.state
    mp = g.atom_metalp_idx.long()
    ai = g.atom_ind.long()
    env = cur.wkb_env(g, ref_sim.params)
    pos, cb = g.coords[ai][mp].float().contiguous(), st.CB_edge[ai][mp].float().contiguous()
    x = torch.randn(mp.shape[0], device="cuda")
    fly_ms = time_ms(lambda: wkb_fly_matvec(pos, cb, x, env))
    del blocks
    torch.cuda.empty_cache()
    # the reference crossbar's 24,768 interior-metal atoms: the f32 block as
    # the stored assembly makes it, and its f64 copy
    pos, cb = reference_metal_set(ref_sim)
    ones = torch.ones(pos.shape[0], dtype=torch.bool, device="cuda")
    T = cur.tunnel_block(env, pos, cb, ones, pos, cb, ones, cur.wkb_single_T).contiguous()
    checks["reference f32"] = stored_matvec_checks(T, "reference f32", plain_reps=2)
    T = T.double()
    checks["reference f64"] = stored_matvec_checks(T, "reference f64", plain_reps=2)
    del T, ref_sim
    torch.cuda.empty_cache()
    s3 = checks["crossbar f32"]
    log(f"stored_matvec at the crossbar ({s3['n']} metal atoms, f32) {s3['ms']:.5f} ms against "
        f"the fly matvec's {fly_ms:.5f} ms in this call; phase 14 in "
        f"{time.perf_counter() - t0:.1f} s")
    for tag, summ in summaries.items():
        log(f"{tag}: graph median {summ['median_turns_graph']:.2f} ms against eager "
            f"{summ['median_turns_eager']:.2f} ms in turns; {summ['inner_iterations']} "
            f"iterations; copies {summ['dtoh_graph']} / {summ['dtoh_eager']}")
    launches = summaries["stored graph"]["launches_card"]
    src = "devicekmc_tpu_torch/csrc/transport_cg.cu"
    rec = {"name": "stored_matvec", "route": "cuda", "source": src,
           "replaces": STORED_REPLACES, "launches": launches["stored_matvec"],
           "max_abs_err": s3["max_abs_err"], "ms": s3["ms"], "plain_ms": s3["plain_ms"],
           "bound_ms": s3["bound_ms"], "bound_by": s3["bound_by"],
           "library_ms": s3["library_ms"], "library": "torch.mv", "cold_ms": s3["cold_ms"],
           "fly_matvec_ms": fly_ms, "checks": checks,
           "fly_against_stored_graph": summaries["stored graph"]["fly_against_stored"],
           "launches_stored_heat_graph_run": summaries["stored heat (global) graph"][
               "launches_card"]["stored_matvec"],
           "launches_f64_graph_run": summaries["f64 graph"]["launches_card"]["stored_matvec"],
           "computes": "the stored metal block's product y = T_cc x_m (f32 in mixed "
                       "precision, f64 in f64)"}
    u = f64["tail64"]
    rec64 = {"name": "transport_tail64", "route": "cuda", "source": src,
             "replaces": "devicekmc_tpu/ops/cg.py:112",
             "launches": summaries["f64 graph"]["launches_card"]["transport_tail64"],
             "max_abs_err": u["err"], "ms": u["ms"], "plain_ms": u["plain_ms"],
             "bound_ms": u["bound_ms"], "bound_by": "bytes", "library_ms": None,
             "library_none": "no one PyTorch call makes the rows, updates, reduces and sets "
                             "the direction",
             "cold_ms": u["cold_ms"], "blocks_f64_storage": f64["blocks64"],
             "solve": f64["solve"],
             "computes": "the f64 solve's tail in one cooperative launch: the rows of A p, "
                         "p.ap and alpha, the update, Jacobi direction, packing, flag and "
                         "predicate (criterion pre)"}
    return [rec, rec64], summaries


# ---------------------------------------------------------------------------
# phase 15: the exact-erfc Poisson sweep (poisson_kernel "jnp", the default)
# on the card, and the default configurations on the captured graph
# ---------------------------------------------------------------------------

#: the headline's Poisson bucket: a full bucket of sources
EXACT_BUCKET = 8192
#: sources past the bucket in the check above the cap
EXACT_OVER = 1024
#: operations of one pair of csrc/pairwise_exact.cu in its type (each add,
#: multiply, division, square root, comparison and rint counted once, and
#: erfc as one): 3 differences, 3 squares, 2 sums, the square root, the
#: 1e-10 scale, 2 comparisons, the erfc argument, erfc, 3 products, the
#: division and the accumulation; plus 8 for the two minimum-image wraps
#: under PBC
EXACT_OPS_PER_PAIR = {False: 19, True: 27}
#: FP64 outside the tensor cores, H100 SXM data sheet, 700 W
PEAK_FP64_PER_S = 34e12
#: the kernel against its plain version, of the potential's scale: f32 sums
#: of thousands of terms in another order and libdevice's erfcf against
#: PyTorch's; in f64 the sums' order alone
EXACT_TOL = {"f32": 1e-5, "f64": 1e-12}
#: the small stack's sources in the PBC check, and how many of them a
#: replica sweeps
EXACT_SMALL = (200, 150)
#: the JAX function the kernel replaces (XLA-fused jnp code, no Pallas kernel)
EXACT_REPLACES = "devicekmc_tpu/physics/potential.py:438"


def exact_sources(ids, q, dtype, coords):
    """A replica's sources as the kernel takes them: the sites ``ids``
    (numpy) with charges ``q``: (coordinates [cap, 3], site ids [cap] int32,
    charges [cap]) on the card in ``dtype``."""
    import torch

    idx = torch.as_tensor(ids, device="cuda")
    return (coords[idx].to(dtype), idx.to(torch.int32),
            torch.as_tensor(q, device="cuda").to(dtype))


def exact_case(tag, rows, srcs, counts, sc, pbc, tol, n_sweep=None, row0=0):
    """One launch of the exact kernel on B replicas' sources ``srcs`` (a
    list of exact_sources) against its plain version (each replica within
    ``tol`` of its scale, a replica that sweeps nothing all zeros), and
    against a second launch (bit-equal); a replica of a batch also against
    its own launch at B = 1.  Returns (kernel output, the worst error)."""
    import torch

    from devicekmc_tpu_torch.ops import pairwise as pw

    B = len(srcs)
    c, i, q = (torch.stack([s[j] for s in srcs]).contiguous() for j in range(3))
    cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
    args = (rows, row0, c, i, q, cnt, *sc, pbc)
    got = pw.poisson_exact_batched(*args, n_sweep=n_sweep)
    ref = pw.poisson_exact_batched_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, pw.poisson_exact_batched(*args, n_sweep=n_sweep)),
          f"{tag}: two calls differ")
    err = 0.0
    for b in range(B):
        if min(counts[b], c.shape[1]) == 0:
            check(bool((got[b] == 0).all()), f"{tag}: replica {b} sweeps nothing, not all 0")
            continue
        err = max(err, _close(f"{tag} replica {b}", got[b], ref[b], tol) / float(
            ref[b].abs().max()))
        if B > 1:
            one = pw.poisson_exact_batched(rows, row0, c[b:b + 1], i[b:b + 1], q[b:b + 1],
                                           cnt[b:b + 1], *sc, pbc, n_sweep=n_sweep)
            check(torch.equal(one[0], got[b]), f"{tag}: replica {b} differs from its own "
                  "launch at B = 1")
    return got, err


def exact_kernel_checks(sim, small):
    """The exact kernel against its plain version on the card: at the
    crossbar's rows (PBC off) over the run's charged sites, over a full
    bucket of EXACT_BUCKET sources and over more than the bucket (the first
    EXACT_BUCKET swept: the full bucket's bits), over none; B = 1 and
    ENSEMBLE_B replicas of other counts and lists (each replica its own
    launch's bits); a quarter of the rows bit-equal to those rows of the
    whole sweep; f32 and f64; on the small stack ``small`` with PBC on.
    Timed at the run's charged sites and at the bucket beside the bound
    and the plain version.  Returns the record's fields."""
    import numpy as np
    import torch

    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.physics.charge import update_charge
    from devicekmc_tpu_torch.state import _as_dtype

    geom, params = sim.geom, sim.params
    state, _ = update_charge(geom, params, sim.state)
    N = geom.N
    charged = torch.nonzero(state.charge != 0).reshape(-1).cpu().numpy()
    n_c = int(charged.size)
    check(0 < n_c < EXACT_BUCKET, f"exact kernel: {n_c} charged sites")
    rng = np.random.default_rng(15)
    others = np.setdiff1d(np.arange(N), charged)
    ids = np.concatenate([charged, rng.choice(others, EXACT_BUCKET + EXACT_OVER - n_c,
                                              replace=False)])
    q = np.concatenate([state.charge[torch.as_tensor(charged, device="cuda")].cpu().numpy(),
                        rng.choice([-2, -1, 1, 2], EXACT_BUCKET + EXACT_OVER - n_c)])
    out = {"n_charged": n_c, "bucket": EXACT_BUCKET}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        rows = geom.coords.to(dt).contiguous()
        sc = ([_as_dtype(x, dt) for x in geom.lattice_host], _as_dtype(params.sigma, dt),
              _as_dtype(params.k, dt))
        tol = EXACT_TOL[name]
        src = exact_sources(ids[:EXACT_BUCKET], q[:EXACT_BUCKET], dt, geom.coords)
        run, e_run = exact_case(f"exact {name} run", rows, [src], [n_c], sc, False, tol)
        full, e_full = exact_case(f"exact {name} bucket", rows, [src], [EXACT_BUCKET], sc,
                                  False, tol)
        over, _ = exact_case(f"exact {name} above the cap", rows, [src],
                             [EXACT_BUCKET + EXACT_OVER], sc, False, tol)
        check(torch.equal(over, full), f"exact {name}: above the cap is not the full bucket")
        exact_case(f"exact {name} none", rows, [src], [0], sc, False, tol)
        counts = [0, n_c, EXACT_BUCKET, EXACT_BUCKET + EXACT_OVER, n_c // 2, 1, 4095, 64]
        srcs = [exact_sources(np.roll(ids, 1013 * b)[:EXACT_BUCKET],
                              np.roll(q, 1013 * b)[:EXACT_BUCKET], dt, geom.coords)
                for b in range(ENSEMBLE_B)]
        _, e_b = exact_case(f"exact {name} B = {ENSEMBLE_B}", rows, srcs, counts, sc, False,
                            tol)
        # a rank's rows: the second quarter, the whole sweep's split rule
        S = N // 4
        for tag, whole, cnt in (("run", run, n_c), ("bucket", full, EXACT_BUCKET)):
            part, _ = exact_case(f"exact {name} rows of {tag}", rows[S:2 * S].contiguous(),
                                 [src], [cnt], sc, False, tol, n_sweep=N, row0=S)
            check(torch.equal(part[0], whole[0, S:2 * S]),
                  f"exact {name} {tag}: a row range is not the whole sweep's rows")
        # the small stack, PBC on
        g2 = small.geom
        n_src, n_sw = EXACT_SMALL
        rows2 = g2.coords.to(dt).contiguous()
        sc2 = ([_as_dtype(x, dt) for x in g2.lattice_host], sc[1], sc[2])
        ids2 = rng.choice(g2.N, n_src, replace=False)
        src2 = exact_sources(ids2, rng.choice([-2, -1, 1, 2], n_src), dt, g2.coords)
        _, e_pbc = exact_case(f"exact {name} small stack PBC", rows2, [src2], [n_sw], sc2,
                              True, tol)
        cnt1 = torch.tensor([n_c], dtype=torch.int32, device="cuda")
        cntb = torch.tensor([EXACT_BUCKET], dtype=torch.int32, device="cuda")
        c, i, qq = (t[None] for t in src)
        call = lambda cn: pw.poisson_exact_batched(rows, 0, c, i, qq, cn, *sc, False)  # noqa
        plain = lambda cn: pw.poisson_exact_batched_plain(rows, 0, c, i, qq, cn, *sc,  # noqa
                                                          False)
        itemsize = 4 if name == "f32" else 8
        peak = PEAK_FP32_PER_S if name == "f32" else PEAK_FP64_PER_S

        def bound(n_src):
            ops = N * n_src * EXACT_OPS_PER_PAIR[False]
            bytes_ = N * 4 * itemsize + n_src * (4 * itemsize + 4) + 4
            t_ops, t_bytes = ops / peak, bytes_ / PEAK_BYTES_PER_S
            return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

        (b_run, by), (b_full, _) = bound(n_c), bound(EXACT_BUCKET)
        r = dict(err_run=e_run, err_bucket=e_full, err_batch=e_b, err_small_pbc=e_pbc,
                 ms=time_ms(lambda: call(cnt1), reps=10), bound_ms=b_run, bound_by=by,
                 plain_ms=time_ms(lambda: plain(cnt1), reps=1, rounds=3, warmup=1),
                 ms_bucket=time_ms(lambda: call(cntb), reps=5), bound_ms_bucket=b_full,
                 plain_ms_bucket=time_ms(lambda: plain(cntb), reps=1, rounds=3, warmup=1),
                 **kernel_facts("pairwise_exact", "poisson_exact_kernel",
                                ("f" if name == "f32" else "d", False), lambda: call(cnt1)))
        out[name] = r
        log(f"poisson_exact {name} [{N} rows x {n_c} charged (the run's) and x {EXACT_BUCKET} "
            f"(a full bucket), PBC off; B = 1 and {ENSEMBLE_B}; counts 0, below and above the "
            f"cap; the small stack PBC on]: worst error of the scale "
            f"{max(e_run, e_full, e_b, e_pbc):.3e} (tolerance {tol}); two calls, a row range "
            f"and each replica of a batch bit-equal; {r['ms']:.4f} ms at the run's sites "
            f"(bound {b_run:.4f} ms by {by}, plain {r['plain_ms']:.3f} ms), "
            f"{r['ms_bucket']:.4f} ms at the bucket (bound {b_full:.4f} ms, plain "
            f"{r['plain_ms_bucket']:.3f} ms); {r['kernel']}: "
            f"{r['registers']} registers, {r['shared_bytes']} bytes shared, "
            f"{r['device_launches']} device launch a call")
    return out


def default_drive(sim, tag, n_steps, wrappers):
    """Counters to 0, ``sim.run_bias_point`` (cold solves + ``n_steps``),
    read: per superstep its events, elements, charges, potential_charge and
    potential_boundary, and the launches (the wrappers' and the card's); no
    plain version of a Poisson sweep may run."""
    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import pairwise as pw

    for w in wrappers.values():
        w.launches = 0
    _build.launch_counts("cuda").zero_()
    plains = [_counted(pw, name) for name in ("poisson_exact_batched_plain",
                                              "poisson_pairwise_batched_plain",
                                              "poisson_pairwise_plain")]
    recs, step = [], sim._superstep

    def one(state, Vd, *rest):
        out = step(state, Vd, *rest)
        st = out[0]
        recs.append(dict(events=int(out[2]["n_events"]), element=st.element.clone(),
                         charge=st.charge.clone(), pc=st.potential_charge.clone(),
                         pb=st.potential_boundary.clone()))
        return out

    sim._superstep = one
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
    return recs, {name: w.launches for name, w in wrappers.items()}, card_counts(), wall


def same_default_steps(tag, ref, got):
    """Two runs step for step: events, elements, charges and the charges'
    potential (the same kernel on the same charges) bit for bit, the
    boundary potential within 1e-12 of its scale (the graph's boundary CG
    sums in another order than the eager one's cuBLAS).  Returns the
    boundary potential's worst distance."""
    import torch

    check(len(ref) == len(got), f"{tag}: {len(ref)} vs {len(got)} supersteps")
    err = 0.0
    for k, (a, b) in enumerate(zip(ref, got)):
        check(a["events"] == b["events"] and torch.equal(a["element"], b["element"])
              and torch.equal(a["charge"], b["charge"]),
              f"{tag}: step {k} events {a['events']} vs {b['events']}, or elements or "
              "charges differ")
        check(torch.equal(a["pc"], b["pc"]), f"{tag}: step {k} potential_charge differs")
        err = max(err, rel_err(b["pb"], a["pb"]))
    check(err <= 1e-12, f"{tag}: potential_boundary {err:.3e} of its scale apart")
    return err


def default_headline(out_root):
    """The headline with poisson_kernel "jnp": its captured graph (the main
    path) and its eager superstep, each driven with the counters set to 0
    just before and read just after (the exact kernel once a superstep as
    the card counts it, the pair sweep never, no plain version), step for
    step (same_default_steps); both again in turns (graph_turns: 1
    device-to-host copy a graph superstep).  Returns (launches of the graph
    run, summary, the graph's simulation)."""
    import torch

    from devicekmc_tpu_torch import engine
    from devicekmc_tpu_torch.ops import ell_gather as eg
    from devicekmc_tpu_torch.ops import kmc_events
    from devicekmc_tpu_torch.ops import pairwise as pw

    n = WARMUP_STEPS + TIMED_STEPS
    wrappers = {"ell_gather": eg.ell_gather, "ell_gather_batched": eg.ell_gather_batched,
                "poisson_pairwise": pw.poisson_pairwise,
                "poisson_pairwise_batched": pw.poisson_pairwise_batched,
                "poisson_exact_batched": pw.poisson_exact_batched,
                "kmc_event_loop": kmc_events.kmc_event_loop,
                "kmc_event_loop_batched": kmc_events.kmc_event_loop_batched}
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "default_graph"),
                             poisson_kernel="jnp")
    check(sim.params.poisson_kernel == "jnp" and sim._graph_for(sim.params) is not None,
          "the headline with poisson_kernel jnp does not run the captured graph")
    recs, host, card, wall = default_drive(sim, "jnp headline graph", n, wrappers)
    sim_e = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "default_eager"),
                               poisson_kernel="jnp")
    sim_e._make = engine.make_superstep
    recs_e, host_e, card_e, wall_e = default_drive(sim_e, "jnp headline eager", n, wrappers)
    check(sim._graph.replays == n and sim_e._graph is None,
          f"jnp headline: {sim._graph.replays} replays, eager graph {sim_e._graph}")
    for tag, h, c in (("graph", host, card), ("eager", host_e, card_e)):
        check(h["poisson_exact_batched"] == c["poisson_exact_batched"] == n
              and h["poisson_pairwise"] == h["poisson_pairwise_batched"]
              == c["poisson_pairwise_batched"] == 0,
              f"jnp headline {tag}: launches {h}, on the card {c}")
    pb_err = same_default_steps("jnp headline graph against eager", recs_e, recs)
    key = "Z - calculation time - KMC superstep [s]"
    ms = [s[key] * 1e3 for s in sim.step_log[WARMUP_STEPS:]]
    ms_e = [s[key] * 1e3 for s in sim_e.step_log[WARMUP_STEPS:]]
    charged = [int(s["n_charged_sites"]) for s in sim.step_log]
    log(f"jnp headline: run_bias_point in {wall:.2f} s on the graph, {wall_e:.2f} s eagerly; "
        f"timed supersteps graph median {statistics.median(ms):.2f} ms "
        f"{[round(x, 2) for x in ms]}, "
        f"eager median {statistics.median(ms_e):.2f} ms {[round(x, 2) for x in ms_e]}; events "
        f"{[r['events'] for r in recs]}, elements, charges and potential_charge bit-equal "
        f"step for step, potential_boundary within {pb_err:.3e}; charged sites {charged}; "
        f"launches graph {host} (card {card['poisson_exact_batched']}), eager {host_e}")
    turns = graph_turns(sim, sim_e, wrappers)
    summary = dict(median_ms=statistics.median(ms), median_ms_eager=statistics.median(ms_e),
                   ms=ms, ms_eager=ms_e, charged=charged, potential_boundary_err=pb_err,
                   launches_graph=host, launches_eager=host_e, **turns)
    del sim_e
    torch.cuda.empty_cache()
    return host, summary, sim


def default_ensemble(sim):
    """ENSEMBLE_B replicas of the headline with poisson_kernel "jnp" from the
    state of ``sim``'s run (keys of ENSEMBLE_SEED): the ensemble's captured
    graph (parallel.batched.make_batched_superstep) against the eager
    batched superstep (superstep_batched), superstep by superstep in turns,
    counters to 0 just before: the exact kernel once a superstep for all
    replicas, as the card counts it; every replica's events, elements,
    charges and potential_charge bit for bit, potential_boundary within
    1e-12 of its scale; one graph superstep profiled (device-to-host
    copies).  Returns the summary."""
    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import pairwise as pw
    from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep
    from devicekmc_tpu_torch.superstep import superstep_batched

    geom, params = sim.geom, sim.params
    step = make_batched_superstep(geom, params, sim.heat)
    check(hasattr(step, "graphs"), "the jnp ensemble does not run the captured graph")
    states_g = batch_states(sim.state, ENSEMBLE_B, base_seed=ENSEMBLE_SEED)
    states_e = batch_states(sim.state, ENSEMBLE_B, base_seed=ENSEMBLE_SEED)
    n = WARMUP_STEPS + TIMED_STEPS
    pw.poisson_exact_batched.launches = 0
    _build.launch_counts("cuda").zero_()
    plain, restore = _counted(pw, "poisson_exact_batched_plain")
    ms_g, ms_e, pb_err, events = [], [], 0.0, []
    try:
        for k in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            states_g, _, m_g = step(states_g, VD_MAIN)
            torch.cuda.synchronize()
            ms_g.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            states_e, _, m_e = superstep_batched(geom, params, states_e, VD_MAIN)
            torch.cuda.synchronize()
            ms_e.append((time.perf_counter() - t) * 1e3)
            ev = m_g["n_events"].tolist()
            check(ev == m_e["n_events"].tolist()
                  and torch.equal(states_g.element, states_e.element)
                  and torch.equal(states_g.charge, states_e.charge)
                  and torch.equal(states_g.potential_charge, states_e.potential_charge),
                  f"jnp ensemble step {k}: graph and eager differ (events {ev} vs "
                  f"{m_e['n_events'].tolist()}, or elements, charges or potential_charge)")
            pb_err = max(pb_err, rel_err(states_g.potential_boundary,
                                         states_e.potential_boundary))
            events.append(ev)
    finally:
        restore()
    card = card_counts()["poisson_exact_batched"]
    check(plain["calls"] == 0 and pw.poisson_exact_batched.launches == card == 2 * n,
          f"jnp ensemble: {pw.poisson_exact_batched.launches} launches ({card} on the card) "
          f"in {n} supersteps of the graph and of the eager superstep, plain {plain['calls']}")
    check(pb_err <= 1e-12, f"jnp ensemble: potential_boundary {pb_err:.3e} of its scale apart")
    prof = profile_calls(lambda: step(states_g, VD_MAIN), 1)
    summary = dict(B=ENSEMBLE_B, ms_graph=ms_g, ms_eager=ms_e,
                   median_ms_graph=statistics.median(ms_g[WARMUP_STEPS:]),
                   median_ms_eager=statistics.median(ms_e[WARMUP_STEPS:]),
                   potential_boundary_err=pb_err, events=events, launches=card,
                   dtoh_graph=prof[2], busy_graph=None if prof[1] is None
                   else 100 * prof[1] / prof[0])
    check(prof[2] is None or prof[2] <= 1, f"jnp ensemble: {prof[2]} device-to-host copies in "
          "a graph superstep")
    log(f"jnp ensemble at B = {ENSEMBLE_B}: graph median {summary['median_ms_graph']:.2f} ms "
        f"{[round(x, 2) for x in ms_g]}, eager median {summary['median_ms_eager']:.2f} ms "
        f"{[round(x, 2) for x in ms_e]}; events, elements, charges and potential_charge "
        f"bit-equal step for step, potential_boundary within {pb_err:.3e}; exact kernel "
        f"{card} launches on the card in {n} supersteps of each; a graph superstep "
        f"{prof[2]} device-to-host copies")
    return summary


def default_path(out_root, small):
    """Phase 15: the exact kernel against its plain version
    (exact_kernel_checks), the headline with poisson_kernel "jnp" on its
    graph against its eager superstep (default_headline), and its ensemble
    (default_ensemble).  The f64 stored configuration with "jnp" is phase
    14's f64 run.  Returns (the kernel's record, the summary)."""
    import torch

    t0 = time.perf_counter()
    launches, head, sim = default_headline(out_root)
    ens = default_ensemble(sim)
    checks = exact_kernel_checks(sim, small)
    del sim
    torch.cuda.empty_cache()
    f32, f64 = checks["f32"], checks["f64"]
    rec = {
        "name": "poisson_exact_batched", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/pairwise_exact.cu", "replaces": EXACT_REPLACES,
        "replaces_note": "XLA-fused jnp code, not a Pallas kernel (poisson_kernel 'jnp')",
        "launches": launches["poisson_exact_batched"],
        "path": "headline with poisson_kernel jnp, captured graph",
        "max_abs_err": max(f32["err_run"], f32["err_bucket"], f32["err_batch"]),
        "err_of": "the potential's scale", "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"], "library_ms": None,
        "library_none": "no PyTorch call computes the screened pair sum",
        "shape": f"108944-site crossbar rows x {checks['n_charged']} charged, f32",
        "f32": f32, "f64": f64, "bucket": checks["bucket"],
        "launches_eager_run": head["launches_eager"]["poisson_exact_batched"],
        "launches_ensemble_runs": ens["launches"]}
    summary = dict(headline=head, ensemble=ens, seconds=time.perf_counter() - t0)
    log(f"phase 15 in {summary['seconds']:.1f} s")
    return rec, summary


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the checkpoint groups' gloo transport over the loopback device: every
    # rank of this script runs on one host
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    from devicekmc_tpu_torch.ops import _build

    t_start = time.perf_counter()
    # seconds of each part of the run, printed after the kernels line
    laps, t_lap = {}, [t_start]

    def lap(name):
        t = time.perf_counter()
        laps[name] = round(t - t_lap[0], 1)
        t_lap[0] = t

    libs = ["ell_gather", "pairwise", "pairwise_exact", "banded", "wkb_fly", "wkb_window",
            "kmc_events", "graph", "boundary_cg", "transport_cg", "heat"]
    latency_job = start_latency_build()
    _build.build(libs)
    finish_latency_build(latency_job)
    log(f"built kernels in {time.perf_counter() - t_start:.1f} s")
    for name in libs:
        regs = [l.strip() for l in _build.build_log(name).splitlines() if "registers" in l]
        log(f"  {name}: {regs}")
    u32, u64 = threefry_check()
    lap("build, threefry")

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
    lap("small stack")

    run, draws_crossbar, event_record, kernels, (xsim, headline) = headline_path(out_root)
    torch.cuda.empty_cache()
    lap("headline")
    boundary_cg = boundary_cg_system(xsim)
    batched = crossbar_batched_check(out_root, run)
    torch.cuda.empty_cache()
    lap("crossbar batched")
    transport_launches, (presolve, steps, readbacks), tgraph, records = transport_path(
        out_root)
    kernels += records
    torch.cuda.empty_cache()
    lap("transport")
    heat_launches, hgraph, pdisp, local_heat = heat_path(out_root)
    torch.cuda.empty_cache()
    lap("heat")
    readbacks_ref = cg_reference_run(out_root, (presolve, steps))
    torch.cuda.empty_cache()
    lap("cg reference run")
    stored_records, stored_summaries = stored_path(out_root)
    torch.cuda.empty_cache()
    lap("stored and f64")
    exact_record, default_summary = default_path(out_root, sim)
    exact_record["launches_f64_stored_graph_run"] = stored_summaries["f64 graph"][
        "launches_card"]["poisson_exact_batched"]
    del sim
    torch.cuda.empty_cache()
    lap("exact Poisson sweep, default configurations")

    t0 = time.perf_counter()
    small_modular_check(out_root)
    modular_launches = modular_path(out_root, run[0])
    torch.cuda.empty_cache()
    ckpt_small, ckpt_small_launches = small_resume_checks(out_root)
    ckpt_crossbar, ckpt_crossbar_launches = crossbar_resume_checks(out_root)
    for name in ("ell_gather_batched", "poisson_pairwise_batched", "kmc_event_loop_batched"):
        check(ckpt_crossbar_launches[name] > 0, f"checkpoint runs: {name} never launched")
    check(ckpt_small_launches["wkb_window_block"] > 0
          and ckpt_small_launches["wkb_fly_matvec"] + ckpt_small_launches["wkb_fly_matvec_out"]
          > 0, f"checkpointed transport runs: launches {ckpt_small_launches}")
    torch.cuda.empty_cache()
    bf16_record, bf16_launches, bgraph = bf16_transport_path(out_root, steps)
    torch.cuda.empty_cache()
    log(f"modular, checkpoint and bf16 phases in {time.perf_counter() - t0:.1f} s")
    lap("modular, checkpoint, bf16")
    ensemble_checks, ensemble = ensemble_path(out_root)
    torch.cuda.empty_cache()
    log("ensemble summary: " + json.dumps(ensemble))
    lap("ensemble")
    halo = halo_path(out_root)
    torch.cuda.empty_cache()
    log("halo summary: " + json.dumps(halo))
    lap("halo")
    replicate, pair_rows = replicate_path(out_root)
    torch.cuda.empty_cache()
    log("replicate summary: " + json.dumps(replicate))
    lap("replicate")
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
    for k in kernels:
        if k["name"] in halo["f64"]["launches"]:
            k["launches_halo_path"] = halo["f64"]["launches"][k["name"]]
            k["launches_halo_path_mixed"] = halo["mixed"]["launches"][k["name"]]
        if k["name"] in halo["transport"]["mixed"]["launches"]:
            k["launches_halo_transport_path"] = halo["transport"]["mixed"]["launches"][k["name"]]
            k["launches_halo_transport_path_f64"] = halo["transport"]["f64"]["launches"][
                k["name"]]
    for k in kernels:
        runs = {tag: rec["launches"][k["name"]] for tag, rec in replicate.items()
                if tag in REPLICATE_RUNS and k["name"] in rec["launches"]}
        if runs:
            k["launches_replicate_path"] = runs
    # the pair sweep over a quarter of the rows: the same kernel and entry as
    # poisson_pairwise (one launch counter), timed at a rank's rows
    kernels.append({
        "name": "poisson_pairwise_rows", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/pairwise.cu",
        "replaces": "devicekmc_tpu/ops/pairwise_pallas.py:146",
        "launches": replicate["mixed"]["launches"]["poisson_pairwise"],
        "path": "replicated decomposition at world 1, headline mixed",
        "kernel_of": "poisson_pairwise",
        "launches_replicate_path": {tag: replicate[tag]["launches"]["poisson_pairwise"]
                                    for tag in REPLICATE_RUNS},
        **pair_rows})
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
    kernels += local_heat["records"]
    # phase 14: its two kernels, and the launches of its graph runs
    kernels += stored_records
    # phase 15: the exact-erfc sweep, and its launches on the halo path
    exact_record.update(
        launches_halo_path=halo["f64"]["launches"]["poisson_exact_batched"],
        launches_halo_path_mixed=halo["mixed"]["launches"]["poisson_exact_batched"],
        halo_poisson_phase_ms={prec: halo[prec]["phase_ms"]["Poisson"]
                               for prec in ("f64", "mixed")})
    kernels.append(exact_record)
    for k in kernels:
        name = {"banded_matvec": "banded_matvec_out", "wkb_fly_matvec": "wkb_fly_matvec_out"
                }.get(k["name"], k["name"])
        for tag, summ in stored_summaries.items():
            if name in summ["launches_card"]:
                key = tag.replace(" ", "_").replace("(", "").replace(")", "")
                k[f"launches_{key}_run"] = summ["launches_card"][name]
    # the launches of the bf16 and local-heat graph runs (phases 9 and 5):
    # the card's counts of the kernels that count there, else the wrappers'
    for k in kernels:
        for tag, summ in (("bf16_graph_run", bgraph), ("local_heat_graph_run",
                                                       local_heat["lgraph"]),
                          ("small_stack_dense_heat_graph_run", local_heat["dgraph"])):
            name = {"banded_matvec": "banded_matvec_out", "banded_matvec_bf16":
                    "banded_matvec_out", "wkb_fly_matvec": "wkb_fly_matvec_out"}.get(
                        k["name"], k["name"])
            if k["name"].startswith("banded_matvec") \
                    and k["name"].endswith("bf16") != tag.startswith("bf16"):
                # the band's out= entry ran in the other storage in this run
                k[f"launches_{tag}"] = 0
            elif name in summ["launches_card"]:
                k[f"launches_{tag}"] = summ["launches_card"][name]
            elif name in summ["launches_host"]:
                k[f"launches_{tag}"] = summ["launches_host"][name]
    for k in kernels:
        if k["name"] in ("cg_matvec_dot", "cg_update_direction"):
            # the matrix-free local model's CG runs the boundary build: one
            # launch of each an iteration, as the card counts them
            k["launches_local_heat_graph_run"] = local_heat["lgraph"]["local_heat"][
                "cg_iters_card"]
    log("headline graph summary: " + json.dumps({**headline, **cg_summary}))
    log("transport graph summary: " + json.dumps(tgraph))
    log("heat (global) graph summary: " + json.dumps(hgraph))
    log("heat (local) graph summaries: " + json.dumps({
        "crossbar_cg": local_heat["lgraph"], "small_stack_dense": local_heat["dgraph"],
        "heat_phase_alone": local_heat["timing"]}))
    log("bf16 transport graph summary: " + json.dumps(bgraph))
    log("stored and f64 graph summaries: " + json.dumps(stored_summaries))
    log("default Poisson sweep (jnp) summary: " + json.dumps(default_summary))
    log(f"profiled calls taken again after a trace without device records: "
        f"{len(empty_traces)} {empty_traces}; launches in the traces of the profiled calls "
        f"against their counts: {traced_totals()}")
    lap("boundary cg kernels, records")
    for k in kernels:
        if k["name"] in ckpt_small_launches:
            k["launches_checkpoint_path"] = {
                "small stack with transport": ckpt_small_launches[k["name"]],
                "crossbar headline": ckpt_crossbar_launches[k["name"]]}
        if k["name"] in replicate["mesh2d"]["launches"]:
            k["launches_mesh2d_path"] = replicate["mesh2d"]["launches"][k["name"]]
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    # after the kernels line, so that the end of a long output keeps them
    print(json.dumps({"seconds": laps, "replicate": {
        tag: {k: replicate[tag][k] for k in ("ms_replicate", "ms_single", "phase_ms",
                                             "phase_ms_single", "events")}
        for tag in REPLICATE_RUNS}, "replicate_seconds": replicate["seconds"],
        "mesh2d": replicate["mesh2d"], "checkpoints": {
            "small stack with transport": ckpt_small, "crossbar headline": ckpt_crossbar,
            "mesh of 1 rank": replicate["checkpoints"]}}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
