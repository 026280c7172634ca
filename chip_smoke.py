#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):

1. builds the five CUDA libraries from devicekmc_tpu_torch/csrc (nvcc,
   sm_90a, one nvcc per source, in parallel) and prints ptxas's registers
   and shared memory per kernel;
2. small-device checks: the 256-site test stack on the card and through the
   port's CPU path, with the headline modules (mixed precision, Vd = 2.5 V,
   4 supersteps: event counts equal, potentials within 1e-5 of their scale),
   with blocked transport on (on-the-fly metal block, chunked cold solves,
   Vd = 10 V: event counts equal, I_macro within 1e-5), and with Joule
   heating in three forms: blocked on-the-fly transport + global heat, dense
   transport + global heat in f64 (the golden trajectory's configuration),
   blocked transport + local heat with the dense propagators (I_macro,
   P_tot, T_bg and the temperature field within stated tolerances);
3. headline path: the synthetic crossbar of 108,944 sites (the composition
   and neighbour statistics of the reference's timing crossbar), neighbour
   list built on the card; the gather and the Poisson kernel are held against
   their plain versions at this path's shapes and timed beside their bounds
   (the Poisson kernel PBC off and on, two calls bit-equal, with ptxas's
   registers and shared bytes and the device launches of one call as
   torch.profiler counts them: it must be the one kernel); then
   Simulation.run_bias_point runs the cold pre-solve, 2 warm-up and 4 timed
   supersteps at Vd = 1 V, with the launch counters set to 0 just before it;
4. transport path: the same crossbar with solve_current on (heating off,
   transport blocked, on-the-fly metal block, deflated cold solve with 24
   slabs, chunked cold solves, 256 integration steps, Vd = 1 V), counters
   set to 0 just before: CB-edge solve, cold deflated transport solve,
   8 supersteps; every transport solve must converge, I_macro be finite
   and positive, a skipped or an incremental assembly be seen, and the two
   headline and all four transport kernels be launched (the window block's
   launches split into full and partial assemblies by their rows).  Then
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
   of one call as torch.profiler counts them (it must be the one kernel);
5. heat path: the transport configuration with solve_heating_global on and
   A = ly * lz, counters set to 0 just before: cold solves, 8 supersteps;
   every transport solve must converge, the site power be non-zero on
   non-metal atoms only, T_bg be finite and never below background_temp, and
   the dissipation kernel be launched once per transport solve.  Then the
   dissipation kernel is held against its plain version and the stored-block
   sweep, Vd of both signs, PBC off and on, two launches bit-equal, at this
   path's metal set and at the reference crossbar's 24,768.  Then 3
   supersteps with solve_heating_local on (matrix-free model, symmetric
   contact spans), with the branch taken, the substeps and the CG iterations
   of every step.

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
TRANSPORT_STEPS = 8
HEAT_STEPS = 8
LOCAL_HEAT_STEPS = 3
# FP32 operations a pair that the dissipation sum adds to the pair value: dM,
# the product, two comparisons, select, two negations, multiply, add
PDISP_EXTRA_OPS = 8
# interior-metal atoms of the reference's timing crossbar
REF_N_MP = 24_768


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

def small_device(device, out_dir, current=False, heat=None):
    """The 256-site stack of tests/test_golden_trajectory.py with the
    headline modules; ``current`` adds blocked transport as the transport
    path runs it (transport_tol 1e-11: two solves that meet the default
    1e-8 agree on I_macro only to ~3e-5); ``heat`` adds Joule heating:
    "global-fly" (blocked on-the-fly transport, global model), "global-dense"
    (f64, dense transport, global model: the golden trajectory's
    configuration), "local-dense" (blocked transport, stored metal block,
    local model with the dense propagators)."""
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
    os.makedirs(out_dir, exist_ok=True)
    return Simulation(cfg, elements=s.elements, coords=s.coords, device=device)


def synthetic_crossbar(n_sites, device, out_dir, current=False, heat=None,
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
    metal stays inside the heat domain); ``overrides`` replace single
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
    sim = Simulation(cfg, elements=elems, coords=s.coords, device=device)
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

    from devicekmc_tpu_torch.ops.ell_gather import ell_gather, ell_gather_plain
    from devicekmc_tpu_torch.ops.pairwise import (
        kernel_scalars, poisson_grid, poisson_pairwise, poisson_pairwise_plain,
    )
    from devicekmc_tpu_torch.physics.charge import update_charge
    from devicekmc_tpu_torch.physics.events import pack_site_code

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

    gather = {}
    for c, vals in ((1, [flags]), (2, [phi, code])):
        got = ell_gather(idx, vals)
        ref = ell_gather_plain(idx, vals)
        torch.cuda.synchronize()
        err = 0.0
        for g, r in zip(got, ref):
            check(torch.equal(g[valid], r[valid]), f"gather C={c} differs")
            err = max(err, float((g[valid].double() - r[valid].double()).abs().max()))
        bytes_ = R * M * 4 + c * geom.N * 4 + c * R * M * 4
        gather[c] = dict(
            err=err, ms=time_ms_cold(lambda: ell_gather(idx, vals)),
            plain_ms=time_ms_cold(lambda: ell_gather_plain(idx, vals)),
            library_ms=time_ms_cold(lambda: [v[idx_long] for v in vals]),
            ms_warm=time_ms(lambda: ell_gather(idx, vals)),
            bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3,
        )
        log(f"ell_gather C={c} [{R}x{M}]: bit-equal on valid slots; cold L2 "
            f"{gather[c]['ms']:.4f} ms (bound {gather[c]['bound_ms']:.4f} ms, "
            f"plain {gather[c]['plain_ms']:.4f} ms, values[idx] "
            f"{gather[c]['library_ms']:.4f} ms); back to back "
            f"{gather[c]['ms_warm']:.4f} ms")

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


def transport_kernel_checks(sim):
    """The four transport kernels against their plain versions at the
    transport path's shapes: the band built for this structure, the run's
    metal atoms and CB edges, its vacancy bucket."""
    import torch

    from devicekmc_tpu_torch.ops.banded import (
        banded_matvec, banded_matvec_plain, window_stack,
    )
    from devicekmc_tpu_torch.ops.wkb_window import (
        wkb_window_block, wkb_window_block_plain,
    )
    from devicekmc_tpu_torch.physics import current as cur

    geom, params, state = sim.geom, sim.params, sim.state
    blk = cur.assemble_X_blocks(geom, params, state, band=sim._band)
    env = blk["fly"]["env"]
    out = {}

    # ---- banded matvec, beside the ELL gather form of the same product ----
    Cb = sim._band["C"]
    R, m_pad, B, _ = Cb.shape
    Na = geom.N_atom
    g = torch.Generator(device="cuda").manual_seed(1)
    xa = torch.randn(Na, generator=g, device="cuda")
    xp = torch.zeros((R + m_pad - 1) * B, device="cuda")
    xp[sim._band["front"]:sim._band["front"] + Na] = xa[sim._band["pi"]]
    xp2 = xp.reshape(R + m_pad - 1, B)
    y = banded_matvec(Cb, xp2)
    # rtol 2e-5 of the largest entry: f32 sums in another order
    err = _close("banded matvec", y, banded_matvec_plain(Cb, xp2), 2e-5)
    xst = window_stack(xp2, R, m_pad)
    nb32, nb_safe = blk["nb_vals"].float(), blk["nb_safe"]
    bytes_ = Cb.numel() * 4 + xp2.numel() * 4 + R * B * 4
    bound, by = _bound(2 * Cb.numel(), bytes_)
    out["banded"] = dict(
        err=err, bound_ms=bound, bound_by=by,
        ms=time_ms(lambda: banded_matvec(Cb, xp2), reps=10),
        plain_ms=time_ms(lambda: banded_matvec_plain(Cb, xp2), reps=5, rounds=3),
        library_ms=time_ms(lambda: torch.einsum("rkbj,rkj->rb", Cb, xst), reps=5, rounds=3),
        ell_ms=time_ms(lambda: (nb32 * xa[nb_safe]).sum(dim=1)),
        ell_bytes=nb32.numel() * 4 + nb_safe.numel() * 8,
        shape=f"C4 [{R}, {m_pad}, {B}, {B}] f32, {bytes_ / 2**30:.2f} GiB")
    nnz = int((Cb != 0).sum())
    log(f"banded_matvec {out['banded']['shape']} ({nnz} non-zeros, "
        f"{100 * nnz / Cb.numel():.3f} %): {out['banded']['ms']:.4f} ms (bound "
        f"{bound:.4f} ms by {by}), plain {out['banded']['plain_ms']:.4f} ms, einsum on "
        f"the window stack {out['banded']['library_ms']:.4f} ms, max err {err:.3e}; the "
        f"ELL form nb_vals * xa[nb_safe] in f32 ({out['banded']['ell_bytes'] / 2**20:.1f} "
        f"MiB): {out['banded']['ell_ms']:.4f} ms")

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

    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp, wkb_fly_pdisp_plain
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
    ops_pair = WKB_OPS_PER_PAIR[own_pbc] + PDISP_EXTRA_OPS
    bound, by = _bound(_wkb_ops(n * n, st["ok"], ops_pair), n * 20 + n * 4)
    rec.update(
        bound_ms=bound, bound_by=by,
        bound_all_pairs_ms=_bound(n * n * ops_pair, n * 20 + n * 4)[0],
        **kernel_facts("wkb_fly", "fly_pdisp_tiles", (),
                           lambda: wkb_fly_pdisp(pos, cb, ms, 1.0, env)),
        ms=time_ms(lambda: wkb_fly_pdisp(pos, cb, ms, 1.0, env)),
        plain_ms=time_ms(lambda: wkb_fly_pdisp_plain(pos, cb, ms, 1.0, env),
                         reps=plain_reps, rounds=3, warmup=1))
    log(f"wkb_fly_pdisp {tag} [n_mp={n}]: {rec['ms']:.4f} ms (data-sheet bound "
        f"{bound:.4f} ms by {by}, with every pair in full {rec['bound_all_pairs_ms']:.4f}; "
        f"{rec['registers']} registers, {rec['shared_bytes']} bytes shared, "
        f"{rec['device_launches']} device launch a call by the profiler), plain "
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
    """Phase 3: kernel checks and the headline run; returns the two kernels'
    records."""
    import torch

    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise

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

    # ---- counters to 0, drive, read ----
    ell_gather.launches = 0
    poisson_pairwise.launches = 0
    t0 = time.perf_counter()
    summary = sim.run_bias_point(VD_MAIN, 1e30, max_steps=WARMUP_STEPS + TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ell_gather": ell_gather.launches,
                "poisson_pairwise": poisson_pairwise.launches}
    steps = sim.step_log
    check(len(steps) == WARMUP_STEPS + TIMED_STEPS, f"ran {len(steps)} supersteps")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the headline path")

    st = sim.state
    phi_b = st.potential_boundary
    phi_c = st.potential_charge
    check(bool(torch.isfinite(phi_b).all() and torch.isfinite(phi_c).all()),
          "potentials finite")
    check(phi_b.shape == (g.N,) and phi_c.shape == (g.N,), "potential shapes")
    check(float(phi_b.abs().max()) <= VD_MAIN / 2 * (1 + 1e-6),
          "boundary potential within the contact voltages")
    check(conserved_counts(st) == counts0, "O+V and d+Od counts conserved")

    pre = sim.presolve_log[-1]
    log(f"cold deflated boundary pre-solve: {pre['cg_iters']} CG iterations, "
        f"{pre['s'] * 1e3:.1f} ms")
    timed = steps[WARMUP_STEPS:]
    ms = [s["Z - calculation time - KMC superstep [s]"] * 1e3 for s in timed]
    log(f"headline path: run_bias_point (cold deflated pre-solve + "
        f"{WARMUP_STEPS} warm-up + {TIMED_STEPS} timed supersteps) in {wall:.2f} s")
    for s in steps:
        log(f"  step {s['step']}: {s['Z - calculation time - KMC superstep [s]'] * 1e3:.2f} ms, "
            f"events {int(s['n_events'])}, cg_iters_boundary "
            f"{int(s['cg_iters_boundary'])}, n_charged_sites {int(s['n_charged_sites'])}, "
            f"n_active_rows {int(s['n_active_rows'])}, step_time {s['step_time']:.4g} s")
    log(f"timed supersteps: median {statistics.median(ms):.2f} ms, "
        f"min {min(ms):.2f} ms, max {max(ms):.2f} ms; launches {launches}; "
        f"kmc_time {summary['kmc_time']:.4g} s")

    return [
        {
            "name": "ell_gather", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/ell_gather.cu",
            "replaces": "devicekmc_tpu/ops/ell_gather_pallas.py:184",
            "launches": launches["ell_gather"],
            "max_abs_err": max(gather[1]["err"], gather[2]["err"]),
            "ms": gather[2]["ms"], "plain_ms": gather[2]["plain_ms"],
            "bound_ms": gather[2]["bound_ms"], "bound_by": "bytes",
            "library_ms": gather[2]["library_ms"],
            "shape": f"{g.N}x{g.max_nn}, 2 channels",
            "ms_warm": gather[2]["ms_warm"], "ms_warm_1ch": gather[1]["ms_warm"],
            "ms_1ch": gather[1]["ms"], "plain_ms_1ch": gather[1]["plain_ms"],
            "bound_ms_1ch": gather[1]["bound_ms"],
            "library_ms_1ch": gather[1]["library_ms"],
        },
        {
            "name": "poisson_pairwise", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/pairwise.cu",
            "replaces": "devicekmc_tpu/ops/pairwise_pallas.py:88",
            "launches": launches["poisson_pairwise"],
            "max_abs_err": max(poisson[False]["err"], poisson[True]["err"]),
            "ms": poisson[False]["ms"], "plain_ms": poisson[False]["plain_ms"],
            "bound_ms": poisson[False]["bound_ms"],
            "bound_by": poisson[False]["bound_by"], "library_ms": None,
            "ms_pbc": poisson[True]["ms"], "bound_ms_pbc": poisson[True]["bound_ms"],
            "n_split": poisson[False]["n_split"],
            **{key: poisson[False][key] for key in KERNEL_FACTS},
            "pbc": {key: poisson[True][key] for key in KERNEL_FACTS},
        },
    ]


def transport_path(out_root):
    """Phase 4: the transport run, then its kernels' checks; returns the
    four transport kernels' records and every kernel's launches on the
    run."""
    import math

    import torch

    from devicekmc_tpu_torch.ops import cg
    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matmat, wkb_fly_matvec
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block
    from devicekmc_tpu_torch.physics import current as cur

    t0 = time.perf_counter()
    sim = synthetic_crossbar(N_SITES, "cuda", os.path.join(out_root, "transport"),
                             current=True)
    torch.cuda.synchronize()
    g, p = sim.geom, sim.params
    Cb = sim._band["C"] if sim._band is not None else None
    check(Cb is not None, "the banded operator was not built")
    log(f"transport crossbar: N={g.N} sites, {g.N_atom} atoms, n_mp="
        f"{g.atom_metalp_idx.shape[0]}, tunnel_vac_cap {p.tunnel_vac_cap}, "
        f"transport_cc {p.transport_cc}, incremental {p.transport_incremental}, band "
        f"{tuple(Cb.shape)}; built in {time.perf_counter() - t0:.1f} s")
    check(p.transport_cc == "fly" and p.transport_incremental, "transport options")
    counts0 = conserved_counts(sim.state)

    # ---- counters to 0, drive, read ----
    wrappers = {"ell_gather": ell_gather, "poisson_pairwise": poisson_pairwise,
                "banded_matvec": banded_matvec, "wkb_fly_matvec": wkb_fly_matvec,
                "wkb_fly_matmat": wkb_fly_matmat, "wkb_window_block": wkb_window_block}
    # the window block's launches, by shape: the whole bucket (full assembly)
    # or the rows of the atoms that entered it (partial)
    vm_rows = []
    vm_block = cur._vm_block

    def counted_vm_block(env, vpos, *a):
        vm_rows.append(vpos.shape[0])
        return vm_block(env, vpos, *a)

    cur._vm_block = counted_vm_block
    for w in wrappers.values():
        w.launches = 0
    cg.readbacks = 0
    t0 = time.perf_counter()
    try:
        summary = sim.run_bias_point(VD_MAIN, 1e30, max_steps=TRANSPORT_STEPS)
        torch.cuda.synchronize()
    finally:
        cur._vm_block = vm_block
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    assemblies = {"full": sum(r != p.transport_delta_cap for r in vm_rows),
                  "partial": sum(r == p.transport_delta_cap for r in vm_rows)}
    check(sum(assemblies.values()) == launches["wkb_window_block"],
          f"window block shapes {vm_rows} for {launches['wkb_window_block']} launches")
    for name, n in launches.items():
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
    check(conserved_counts(sim.state) == counts0, "O+V and d+Od counts conserved")

    for pre in sim.presolve_log:
        log(f"cold {pre['phase']} solve: {pre['cg_iters']} CG iterations, "
            f"{pre['s'] * 1e3:.1f} ms")
    log(f"transport path: run_bias_point (CB edge, boundary and deflated transport "
        f"cold solves + {TRANSPORT_STEPS} supersteps) in {wall:.2f} s; "
        f"{cg.readbacks} CG read-backs; launches {launches}; window block rows a launch "
        f"{vm_rows} ({assemblies['full']} full, {assemblies['partial']} partial assemblies)")
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

    k = transport_kernel_checks(sim)
    ref = reference_width_fly(sim)
    fly, mm, ref_mm = k["fly"], k["fly"]["mm"], ref["mm"]
    n_mp = int(g.atom_metalp_idx.shape[0])
    facts = ("bound_all_pairs_ms", "kernel", "registers", "shared_bytes", "device_launches")
    pick = lambda r: {key: r[key] for key in facts}
    return launches, [
        {
            "name": "banded_matvec", "route": "cuda",
            "source": "devicekmc_tpu_torch/csrc/banded.cu",
            "replaces": "devicekmc_tpu/ops/banded_pallas.py:74",
            "launches": launches["banded_matvec"], "max_abs_err": k["banded"]["err"],
            "ms": k["banded"]["ms"], "plain_ms": k["banded"]["plain_ms"],
            "bound_ms": k["banded"]["bound_ms"], "bound_by": k["banded"]["bound_by"],
            "library_ms": k["banded"]["library_ms"], "shape": k["banded"]["shape"],
            "ell_form_ms": k["banded"]["ell_ms"],
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
            "launches_full": assemblies["full"], "launches_partial": assemblies["partial"],
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
    """One run of the heat path: the transport configuration with the
    ``model`` ("global" | "local") heat solver on, counters set to 0 just
    before run_bias_point and read just after.  Returns the simulation and
    the launch counts.  ``device="cpu"`` with a small ``n_sites`` rehearses
    the run without a card (no kernel is launched then, so pass no
    wrappers)."""
    import math

    import torch

    from devicekmc_tpu_torch.physics import current as cur
    from devicekmc_tpu_torch.physics import heat as heat_mod

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    sim = synthetic_crossbar(n_sites, device, os.path.join(out_root, "heat_" + model),
                             current=True, heat=model)
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

    solves, restore_solves = _counted(cur, "update_power_blocked")
    phase, restore_phase = _counted(heat_mod, "update_temperature", sync)
    local_log = []
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
        restore_phase()
    launches = {name: w.launches for name, w in wrappers.items()}

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
    return sim, launches


PDISP_FACTS = ("bound_all_pairs_ms", "registers", "shared_bytes", "device_launches")


def heat_path(out_root):
    """Phase 5: the heat runs (global, then local), then the dissipation
    kernel's checks; returns every kernel's launches on the global run and
    the new kernel's record."""
    import torch

    from devicekmc_tpu_torch.ops.banded import banded_matvec
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise
    from devicekmc_tpu_torch.ops.wkb_fly import (
        wkb_fly_matmat, wkb_fly_matvec, wkb_fly_pdisp,
    )
    from devicekmc_tpu_torch.ops.wkb_window import wkb_window_block
    from devicekmc_tpu_torch.physics import current as cur

    wrappers = {"ell_gather": ell_gather, "poisson_pairwise": poisson_pairwise,
                "banded_matvec": banded_matvec, "wkb_fly_matvec": wkb_fly_matvec,
                "wkb_fly_matmat": wkb_fly_matmat, "wkb_window_block": wkb_window_block,
                "wkb_fly_pdisp": wkb_fly_pdisp}
    sim, launches = heat_run(out_root, "global", HEAT_STEPS, wrappers)
    blk = cur.assemble_X_blocks(sim.geom, sim.params, sim.state, band=sim._band)
    f = blk["fly"]
    rec = pdisp_checks(f["mpos"], f["mcb"], f["env"], "heat path")
    pos, cb = reference_metal_set(sim)
    ref = pdisp_checks(pos, cb, f["env"], "reference width", plain_reps=1)
    del sim, blk, f
    torch.cuda.empty_cache()

    _, local_launches = heat_run(out_root, "local", LOCAL_HEAT_STEPS, wrappers)
    torch.cuda.empty_cache()
    n_mp = rec["n"]
    return launches, {
        "name": "wkb_fly_pdisp", "route": "cuda",
        "source": "devicekmc_tpu_torch/csrc/wkb_fly.cu",
        "replaces": "devicekmc_tpu/ops/wkb_pallas.py:383",
        "launches": launches["wkb_fly_pdisp"], "max_abs_err": rec["err"],
        "max_err_of_largest_sum": rec["rel_err"],
        "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"], "library_ms": None,
        "shape": f"n_mp={n_mp}, all n^2 pairs",
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from devicekmc_tpu_torch.ops import _build

    t_start = time.perf_counter()
    libs = ["ell_gather", "pairwise", "banded", "wkb_fly", "wkb_window"]
    _build.build(libs)
    log(f"built kernels in {time.perf_counter() - t_start:.1f} s")
    for name in libs:
        regs = [l.strip() for l in _build.build_log(name).splitlines() if "registers" in l]
        log(f"  {name}: {regs}")

    out_root = os.path.join(ROOT, "build", "chip_smoke")
    t0 = time.perf_counter()
    small_device_check(os.path.join(out_root, "small"))
    small_device_check(os.path.join(out_root, "small_current"), current=True, Vd=10.0)
    small_device_check(os.path.join(out_root, "small_heat_fly"), Vd=10.0, heat="global-fly")
    small_device_check(os.path.join(out_root, "small_heat_dense"), heat="global-dense")
    small_device_check(os.path.join(out_root, "small_heat_local"), Vd=10.0,
                       heat="local-dense")
    log(f"small-device checks in {time.perf_counter() - t0:.1f} s")

    kernels = headline_path(out_root)
    torch.cuda.empty_cache()
    transport_launches, records = transport_path(out_root)
    kernels += records
    torch.cuda.empty_cache()
    heat_launches, pdisp = heat_path(out_root)
    for k in kernels:
        k["launches_transport_path"] = transport_launches[k["name"]]
        k["launches_heat_path"] = heat_launches[k["name"]]
    # table order: the dissipation kernel stands before the window block
    kernels.insert(len(kernels) - 1, pdisp)
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
