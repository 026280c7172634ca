#!/usr/bin/env python3
"""Probes of two kernels of the headline path on the card, at the synthetic
crossbar's shapes (108,944 sites; the state after two graph supersteps):

* the KMC event loop (``csrc/kmc_events.cu``): a copy of the source with
  ``clock64()`` stamps inserted (STAMPS), whose thread 0 stamps the end of
  each phase of the first 256 events (STAMP_NAMES: the draw read, the
  levels of the selection, the event and its zeroing, and the barriers
  after the selection, the row sums and the block sums) and each warp's
  lane 0 the end of its share of the sums, run for ``--events`` events from
  the state's table; the medians of each phase's cycles; the L2 hit, DRAM
  and barrier latencies and a round of loads after another warp's stores
  (``tools/latency_probe.cu``); the loop timed at the path's time window
  and with ``--events`` events and no window;
* ``cg_matvec_dot`` (``csrc/boundary_cg.cu``) at the crossbar's boundary
  system (as ``chip_smoke.py`` phase 11 builds it): against its plain
  version, timed back to back and with a cold L2, beside
  ``torch.sparse.mm`` of the same operator in CSR, the nonzero bound and
  the 32-byte sectors that the rows' valid prefixes span.

* the transport CG (``--parts transport``) at the crossbar's transport
  operator: its kernels through their wrappers, the band with the kernels
  that run beside it, inner iterations and the warm solve captured (the
  solve also with other forms of the inner body: one branch or a branch
  each for the fly matvec and transport_blocks, the band captured first or
  last, in series), ``clock64()`` stamps of each kernel's phases
  (TRANSPORT_STAMPS: the blocks, rows and f64 pack; BAND_STAMPS: the band,
  also built with its window staged in shared memory, BAND_VARIANTS), and
  the transport and heat (global) configurations' graph supersteps, their
  ms an inner iteration, and the memory each run holds once built and the
  most its cold solves and first two supersteps allocate;

* the boundary CG's update and direction at the same system: through the
  package's wrappers, the update and direction kernels (the parent's pair
  ``cg_update`` + ``cg_direction``, beside ``torch.addcmul``, the one
  PyTorch call for the direction; or the fused ``cg_update_direction``)
  back to back and with a cold L2, also at B = 8 and 32 (the replica
  copied), beside their bytes bound; the captured solve a WHILE node, its
  time an iteration; the ensemble's captured superstep at B = 8 and 32; and
  a copy of the update kernel's source with ``clock64()`` stamps at the end
  of each phase in every block (UPDATE_STAMPS, for whichever of the two
  designs the measured package has), the medians and maxima of each phase
  over the blocks.

``--pkg DIR`` measures the package of another checkout instead (its
kernels through its wrappers, the stamps of its update kernel; no event
stamps, no variants), so that two designs are timed in turns on one card,
one process each, e.g. the parent commit's:

    git archive HEAD~1 devicekmc_tpu_torch setup.py | tar -x -C build/parent
    python3 tools/probe_cg_events.py --pkg build/parent --out build/p1.json
    python3 tools/probe_cg_events.py --out build/c1.json   # and again, in turns

``--variants`` also times this checkout's matvec rebuilt with other lanes a
row and slots a lane at several grids, and with parts of its work taken out,
reports the event loop's phases with 4 or 16 lanes a touched row and block,
and times ``cg_update_direction`` with other tiles and a launch that is not
cooperative (UPDATE_VARIANTS).  Needs the card:

    python3 tools/probe_cg_events.py [--events 200] [--variants] [--pkg DIR]
        [--parts events,matvec,update] [--out build/probe_cg_events.json]
"""

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the phases between the stamps 0-8 (8: the event's end)
STAMP_NAMES = ("draw read", "levels 0-1 (runs of blocks, blocks)", "level 2 (rows)",
               "level 3 (slots), i's rows", "j, event, zeroing", "barrier 1",
               "row sums + barrier", "block sums + barrier")
END = len(STAMP_NAMES)
PROBE_EVENTS, PROBE_STAMPS, PROBE_WARPS = 256, 9, 16

#: where the stamps go in csrc/kmc_events.cu: (text that occurs once, the
#: stamp, "after" or "before" it).  PROBE_STAMP(ev, k) in thread 0 ends
#: phase k; PROBE_WARP(ev, k) in each warp's lane 0 ends its share of the
#: row sums (0) and of the block sums (1).
STAMPS = (
    ("for (int ev = 0;; ++ev) {", "PROBE_STAMP(ev, 0);", "after"),
    ("const float lg32 = sh.lg32;", "PROBE_STAMP(ev, 1);", "after"),
    ("const int blk = min(first + a1 * c1 + k1, n_blocks - 1);", "PROBE_STAMP(ev, 2);",
     "after"),
    ("const int r = min(blk * kBlock + 4 * a2 + kk, n_rows - 1);", "PROBE_STAMP(ev, 3);",
     "after"),
    ("const int s = min(a3 * c_slot + kk, m - 1);", "PROBE_STAMP(ev, 4);", "after"),
    ("if (lane == 0) sh.go = go;", "PROBE_STAMP(ev, 5);", "after"),
    ("if (!sh.go) break;", "PROBE_STAMP(ev, 6);", "before"),
    ("atomicOr(s_mark + (blk >> 5), 1u << (blk & 31));\n      }\n    }\n",
     "PROBE_WARP(ev, 0);", "after"),
    ("// the marked blocks' sums from the row sums", "PROBE_STAMP(ev, 7);", "before"),
    ("if (gl == 0 && blk >= 0) s_blk[blk] = acc;\n      }\n    }\n", "PROBE_WARP(ev, 1);",
     "after"),
    ("  }\n\n  if (tid == 0) {\n    out[0] = event_time;", "PROBE_STAMP(ev, 8);", "before"),
)
STAMP_DEFS = """
__device__ long long g_probe_stamps[%(ev)d * %(st)d];
__device__ long long g_probe_warps[%(ev)d * %(w)d * 2];
#define PROBE_STAMP(e, k)                                                        \\
  do {                                                                           \\
    if (threadIdx.x == 0 && blockIdx.x == 0 && (e) < %(ev)d)                     \\
      g_probe_stamps[(e) * %(st)d + (k)] = clock64();                            \\
  } while (0)
#define PROBE_WARP(e, k)                                                         \\
  do {                                                                           \\
    if ((threadIdx.x & 31) == 0 && blockIdx.x == 0 && (e) < %(ev)d)              \\
      g_probe_warps[((e) * %(w)d + (threadIdx.x >> 5)) * 2 + (k)] = clock64();   \\
  } while (0)
""" % {"ev": PROBE_EVENTS, "st": PROBE_STAMPS, "w": PROBE_WARPS}
STAMP_EXPORTS = """
// the stamps, [events, stamps] and [events, warps, 2] int64, into host memory
extern "C" int dkmc_event_probe_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe_stamps, sizeof(g_probe_stamps));
}
extern "C" int dkmc_event_probe_warps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe_warps, sizeof(g_probe_warps));
}
"""

#: probe builds of the event loop laid out otherwise (name: [(old, new)] text
#: replacements), whose phases ``--variants`` also reports: 4 or 16 lanes a
#: touched row and a touched block
EVENT_VARIANTS = {
    "group4": [("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")],
    "group16": [("constexpr int kGroup = 8;", "constexpr int kGroup = 16;")],
}


def replace_once(text, old, new, what):
    if text.count(old) != 1:
        raise RuntimeError(f"{what}: {old!r} occurs {text.count(old)} times, not once")
    return text.replace(old, new)


def stamped_source(src):
    """csrc/kmc_events.cu with the stamps of STAMPS, their buffers and their
    exports."""
    for anchor, stamp, where in STAMPS:
        src = replace_once(src, anchor, anchor + stamp + "\n" if where == "after"
                           else stamp + "\n" + anchor, "kmc_events.cu")
    head = "constexpr int kD = 0, kOD = 1, kV = 2, kO = 3;\n"
    return replace_once(src, head, head + STAMP_DEFS, "kmc_events.cu") + STAMP_EXPORTS


def nvcc_build(src, out, include):
    """``src`` compiled as the package builds it (ops/_build.NVCC_FLAGS),
    ``include`` on the include path."""
    from devicekmc_tpu_torch.ops import _build

    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), out


def finish(jobs):
    """{key: library} of nvcc_build's jobs."""
    libs = {}
    for key, (proc, out) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = ctypes.CDLL(out)
        print(key, [l.strip() for l in log.splitlines() if "registers" in l], flush=True)
    return libs


def event_builds(bdir, variants):
    """The stamped event loop, and with ``variants`` its EVENT_VARIANTS:
    {name: nvcc job}."""
    from devicekmc_tpu_torch.ops import _build

    src = stamped_source((_build.CSRC / "kmc_events.cu").read_text())
    sources = {"probe": src}
    if variants:
        for name, subs in EVENT_VARIANTS.items():
            text = src
            for old, new in subs:
                text = replace_once(text, old, new, "kmc_events.cu")
            sources[name] = text
    jobs = {}
    for name, text in sources.items():
        path = os.path.join(bdir, f"kmc_events_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = nvcc_build(path, path[:-3] + ".so", _build.CSRC)
    return jobs


def raw_probe(cs):
    """Cycles of a round of loads of lines another warp just stored to, and
    of lines nothing stored to, plain and past L1 (dkmc_raw_probe)."""
    import torch

    buf = torch.zeros(2 * 224 * 32, dtype=torch.int32, device="cuda")
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for rep in range(4):
        for cg in (0, 1):
            err = cs.LATENCY["lib"].dkmc_raw_probe(buf.data_ptr(), cg, out.data_ptr(), stream)
            if err != 0:
                raise RuntimeError(f"dkmc_raw_probe: cudaError {err}")
            torch.cuda.synchronize()
            if rep:
                res.setdefault("ldcg" if cg else "plain", []).append(out[:2].tolist())
    return res


def stamps_of(lib, count):
    """The stamps of a stamped build's last launch: the medians of each
    phase's cycles, of the slowest and fastest warp's sums and of the draw,
    and the cycles an event."""
    stamps = (ctypes.c_longlong * (PROBE_EVENTS * PROBE_STAMPS))()
    warps = (ctypes.c_longlong * (PROBE_EVENTS * PROBE_WARPS * 2))()
    for fn, buf in ((lib.dkmc_event_probe_stamps, stamps),
                    (lib.dkmc_event_probe_warps, warps)):
        err = fn(ctypes.cast(buf, ctypes.c_void_p))
        if err != 0:
            raise RuntimeError(f"probe stamps: cudaError {err}")
    st = [[stamps[e * PROBE_STAMPS + k] for k in range(PROBE_STAMPS)]
          for e in range(min(count, PROBE_EVENTS))]
    w = lambda e, k, q: warps[(e * PROBE_WARPS + k) * 2 + q]
    ev = range(1, len(st))
    med = lambda xs: statistics.median(xs) if xs else None
    phases = {name: med([st[e][k + 1] - st[e][k] for e in ev])
              for k, name in enumerate(STAMP_NAMES)}
    phases.update({
        "slowest warp's row sums": med([max(w(e, k, 0) for k in range(PROBE_WARPS))
                                        - st[e][6] for e in ev]),
        "fastest warp's row sums": med([min(w(e, k, 0) for k in range(PROBE_WARPS))
                                        - st[e][6] for e in ev]),
        "slowest warp's block sums": med([max(w(e, k, 1) for k in range(PROBE_WARPS - 1))
                                          - st[e][7] for e in ev]),
        "draw warp's draw": med([w(e, PROBE_WARPS - 1, 1) - st[e][7] for e in ev]),
    })
    total = st[-1][END] - st[0][0] if st else 0
    return phases, med([st[e][END] - st[e][0] for e in ev]), total


def event_probe(cs, sim, stamped, n_events):
    """The event loop of the package on the path: timed through its wrapper
    at the path's time window and with ``n_events`` events and no window;
    with ``stamped`` ({name: stamped library}) each stamped build's phases,
    and the latencies."""
    import torch

    from devicekmc_tpu_torch.ops.kmc_events import kmc_event_loop
    from devicekmc_tpu_torch.physics.events import incremental_tables

    geom, params, state = sim.geom, sim.params, sim.state
    prob, row_sums, block_sums, aidx, inv, _ = incremental_tables(geom, params, state)
    n_rows, m = prob.shape
    n_blocks = block_sums.shape[0]

    def launch(fn, max_events, t_window):
        p, rs, bs = prob.clone(), row_sums.clone(), block_sums.clone()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cs.HOLD_CYCLES)
        a.record()
        res = fn(p, rs, bs, max_events, t_window)
        b.record()
        b.synchronize()
        return a.elapsed_time(b), res

    def wrapper(p, rs, bs, max_events, t_window):
        return kmc_event_loop(p, rs, bs, aidx, inv, geom.neigh_idx, geom.rev_slot,
                              state.element, state.charge, state.key, t_window, max_events,
                              params.dtype)

    def c_entry(lib):
        fn = lib.dkmc_kmc_event_loop
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_double, i, i, p, p]
        fn.restype = ctypes.c_int

        def run(p_, rs, bs, max_events, t_window):
            el, q = state.element.clone(), state.charge.clone()
            out = torch.empty(4, dtype=torch.float64, device="cuda")
            err = fn(p_.data_ptr(), int(p_.dtype == torch.float64), rs.data_ptr(),
                     bs.data_ptr(), aidx.data_ptr(), inv.data_ptr(), geom.neigh_idx.data_ptr(),
                     geom.rev_slot.data_ptr(), el.data_ptr(), q.data_ptr(), n_rows, n_blocks,
                     m, state.key[0], state.key[1], t_window, max_events,
                     int(params.dtype == torch.float32), out.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"stamped event loop: cudaError {err}")
            return el, q, out

        return run

    natural = 1.0 / params.freq
    res = {"table": f"{n_rows}x{m} {str(prob.dtype)[6:]}", "n_blocks": n_blocks}
    window = [launch(wrapper, params.max_events_per_superstep, natural) for _ in range(10)]
    cap = [launch(wrapper, n_events, float("inf")) for _ in range(10)]
    res.update(window_events=int(window[0][1][2][1]), cap_events=int(cap[0][1][2][1]),
               window_ms=statistics.median(t for t, _ in window),
               cap_ms=statistics.median(t for t, _ in cap))
    res["cap_us_per_event"] = res["cap_ms"] * 1e3 / max(res["cap_events"], 1)
    ref = cap[0][1]
    for name, lib in stamped.items():
        ms, got = launch(c_entry(lib), n_events, float("inf"))
        count = int(got[2][1])
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                and torch.equal(got[2][1:], ref[2][1:])):
            raise RuntimeError(f"the stamped build {name}: other events than the package's")
        phases, per_event, total = stamps_of(lib, count)
        res[f"stamped_{name}"] = dict(ms=ms, cycles_per_event=per_event, phase_cycles=phases,
                                      sm_mhz=total / (ms * 1e3) if ms > 0 else None)
    l2_ns, bar_ns = cs.latencies()
    res.update(l2_ns=l2_ns, barrier_ns=bar_ns,
               dram_ns=cs.latencies(lines=1 << 22, hops=1 << 19)[0], raw_cycles=raw_probe(cs))
    return res


#: the matvec's variants (lanes a row, slots a lane a pass) that
#: ``--variants`` times
MATVEC_VARIANTS = ((8, 8), (16, 4), (32, 2))
#: the matvec with parts of its work taken out (name: text replacements), to
#: see what its time is made of: no gather of p (each product takes p of its
#: own row), and no index stream either
MATVEC_PARTS = {
    "no_gather": [("s += v[k] * __ldg(pb + j[k]);", "s += v[k] * __ldg(pb + row);")],
    "values_only": [("s += v[k] * __ldg(pb + j[k]);", "s += v[k] * __ldg(pb + row);"),
                    ("j[k] = e < len ? __ldg(nb + e0 + e) : -1;", "j[k] = e < len ? e : -1;")],
}


def matvec_builds(bdir):
    """This checkout's boundary_cg.cu rebuilt with other constants of its
    matvec (MATVEC_VARIANTS) and with parts of its work taken out
    (MATVEC_PARTS): {(lanes, slots) or name: nvcc job}."""
    from devicekmc_tpu_torch.ops import _build

    src = (_build.CSRC / "boundary_cg.cu").read_text()
    lines = ("constexpr int kRowLanes = ", "constexpr int kSlots = ")
    sources = {}
    for var in MATVEC_VARIANTS:
        text = src
        for line, value in zip(lines, var):
            if line not in text:
                raise RuntimeError(f"boundary_cg.cu: no line {line!r} to vary")
            head, tail = text.split(line, 1)
            text = head + line + str(value) + tail[tail.index(";"):]
        sources[var] = text
    for name, subs in MATVEC_PARTS.items():
        text = src
        for old, new in subs:
            text = replace_once(text, old, new, "boundary_cg.cu")
        sources[name] = text
    jobs = {}
    for var, text in sources.items():
        tag = var if isinstance(var, str) else "{}_{}".format(*var)
        path = os.path.join(bdir, f"boundary_cg_{tag}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[var] = nvcc_build(path, path[:-3] + ".so", _build.CSRC)
    return jobs


def make_workspace(bcg, geom, dtype):
    """A workspace of one replica for the package on the path (the ones
    before the row lengths took ``(batch, n, dtype, device)``)."""
    if "neigh_idx" in inspect.signature(bcg.workspace).parameters:
        return bcg.workspace(1, geom.neigh_idx, geom.bp_interior_mask, dtype, "cuda")
    return bcg.workspace(1, geom.N, dtype, "cuda")


def matvec_probe(cs, sim, variants):
    """cg_matvec_dot at the crossbar's boundary system, against its plain
    version and torch.sparse.mm, and (``variants``, {(lanes, slots) or name:
    library}) other constants at several grids, or parts of its work taken
    out."""
    import dataclasses

    import torch

    from devicekmc_tpu_torch.ops import boundary_cg as bcg

    geom = sim.geom
    interior = geom.bp_interior_mask
    op, b, x0, pre, active, _ = boundary_system(cs, sim)
    diag, vals = op[:2]
    ws = make_workspace(bcg, geom, b.dtype)
    if variants:
        ws.part = torch.zeros(geom.N, dtype=b.dtype, device="cuda")  # room for any grid
    bcg.cg_setup(op, b, x0, pre, 0.0, cs.CG_MAXITER, active, ws)
    for _ in range(3):
        bcg.cg_iteration(ws, op, cs.CG_MAXITER)

    def clone(w):
        return dataclasses.replace(w, **{f.name: getattr(w, f.name).clone()
                                         for f in dataclasses.fields(w)
                                         if isinstance(getattr(w, f.name), torch.Tensor)})

    N, M = geom.N, geom.max_nn
    wk, wp = clone(ws), clone(ws)
    bcg.cg_matvec_dot(wk, op)
    bcg.cg_matvec_dot_plain(wp, op)
    scale = float(wp.ap.abs().max())
    fns = {"package": lambda w: bcg.cg_matvec_dot(w, op)}
    variant_err = {}
    for var, lib in (variants or {}).items():
        fn_v = lib.dkmc_cg_matvec_dot
        p, i = ctypes.c_void_p, ctypes.c_int
        fn_v.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        fn_v.restype = ctypes.c_int
        if isinstance(var, str):
            grids, label_of = [ws.grid_mv], lambda grid, var=var: var
        else:
            lanes, slots = var
            group = 8 * (32 // lanes)
            grids = [g for g in sorted({-(-N // group), 4 * 132, 8 * 132})
                     if g <= -(-N // group)]
            label_of = lambda grid, var=var: "lanes{}_slots{}_grid".format(*var) + str(grid)
        for grid in grids:

            def run(w, fn_v=fn_v, grid=grid):
                e = fn_v(1, diag.data_ptr(), vals.data_ptr(), geom.neigh_idx.data_ptr(),
                         w.row_len.data_ptr(), w.p.data_ptr(), w.ap.data_ptr(),
                         w.act.data_ptr(), w.rz.data_ptr(), w.alpha.data_ptr(),
                         w.part.data_ptr(), w.tickets.data_ptr(), N, M, 1, grid,
                         torch.cuda.current_stream().cuda_stream)
                if e != 0:
                    raise RuntimeError(f"cg_matvec_dot variant: cudaError {e}")

            label = label_of(grid)
            fns[label] = run
            wv = clone(ws)
            run(wv)
            variant_err[label] = max(float((wv.ap - wp.ap).abs().max()),
                                     float((wv.alpha - wp.alpha).abs().max()
                                           / wp.alpha.abs().max()) * scale)
    # the library's product
    nb = geom.neigh_idx.long()
    rows = torch.arange(N, device="cuda")
    keep = (nb >= 0) & interior[:, None] & interior[nb.clamp(min=0)]
    r_idx = torch.cat([rows[interior], rows[:, None].expand(N, M)[keep]])
    c_idx = torch.cat([rows[interior], nb[keep]])
    v = torch.cat([diag[0][interior], vals[0][keep]])
    order = torch.argsort(r_idx * N + c_idx)
    csr = torch.sparse_coo_tensor(torch.stack([r_idx[order], c_idx[order]]), v[order],
                                  (N, N)).coalesce().to_sparse_csr()
    pv = ws.p[0][:, None].contiguous()
    nnz_off, n_int = int(keep.sum()), int(interior.sum())
    # bytes: the nonzeros (value + index), the interior rows' diag, p, ap,
    # the row lengths (as chip_smoke.py phase 11 counts them)
    nbytes = 12 * nnz_off + 8 * n_int + 8 * 2 * N + 4 * N
    # the 32-byte sectors the interior rows' valid prefixes span
    lens = torch.where(interior, (nb >= 0).sum(-1), 0)
    start = rows * M
    sect = lambda width: int((((start + lens) * width + 31) // 32 - (start * width) // 32)
                             .masked_fill(lens == 0, 0).sum()) * 32
    res = dict(N=N, M=M, interior_rows=n_int, valid_slots=int(lens.sum()),
               nnz_interior_offdiag=nnz_off, bound_bytes=nbytes,
               bound_ms=nbytes / cs.PEAK_BYTES_PER_S * 1e3,
               prefix_value_sector_bytes=sect(8), prefix_index_sector_bytes=sect(4),
               max_abs_err=float((wk.ap - wp.ap).abs().max()), scale=scale,
               alpha_rel_err=float(abs(wk.alpha - wp.alpha) / abs(wp.alpha)),
               variant_max_abs_err=variant_err, times={})
    wt = clone(ws)
    fns["sparse.mm"] = lambda w: torch.sparse.mm(csr, pv)
    for label, f in fns.items():
        res["times"][label] = {"warm": cs.time_ms(lambda: f(wt)),
                               "cold": cs.time_ms_cold(lambda: f(wt))}
    return res


#: clock64() stamps of the boundary CG's update kernel, by the kernel the
#: measured source has: (text that occurs once, stamp, "after" or "before"
#: it); thread 0 of every block writes stamp k at its point (a block that
#: leaves early writes none of the later ones), and the phases between them
#: are named in UPDATE_PHASES
UPDATE_STAMPS = {
    "cg_update_direction_kernel": (
        ("  if (writer && threadIdx.x == 0) ctl_0 = ctl[0];\n", 0, "after"),
        ("  // 2. every tile's partial sums written\n", 1, "before"),
        ("  // 3. r.z, r.r and beta of the replicas spanned", 2, "before"),
        ("  // 4. the direction of each tile", 3, "before"),
        ("  // 5. block 0: the iterations run", 4, "before"),
        ("    if (handle) cudaGraphSetConditional(handle, go);\n  }\n", 5, "after"),
    ),
    "cg_update_kernel": (
        ("  const T a = alpha[b];\n  T s_rz = 0, s_rr = 0;\n", 0, "after"),
        ("  if (!last_ticket(tickets, b, grid, &s_flag)) return;\n  // this replica's", 1,
         "before"),
        ("  // this replica's last block: its r.z and r.r, beta and count\n", 2, "before"),
        ("  // the loop's ticket, one a replica that iterated", 3, "before"),
        ("  if (threadIdx.x == 0) {\n    const int it = ctl[0] + 1;", 4, "before"),
        ("    if (handle) cudaGraphSetConditional(handle, go);\n  }\n", 5, "after"),
    ),
}
UPDATE_PHASES = {
    "cg_update_direction_kernel": ("update, partial sums", "grid barrier",
                                   "r.z, r.r, beta of the replicas spanned", "direction",
                                   "block 0: flags, count, predicate"),
    "cg_update_kernel": ("update, partial sums", "the replica's ticket",
                         "the last block: two sums of the partials", "the loop's ticket",
                         "the loop's last block: flags, count, predicate"),
}
UPDATE_PROBE_BLOCKS = 8192
UPDATE_STAMP_DEFS = """
__device__ long long g_cg_stamps[%(b)d * 6];
__device__ unsigned long long g_cg_gt[%(b)d * 2];
#define CG_STAMP(k)                                                              \\
  do {                                                                           \\
    const unsigned blk_ = blockIdx.x + gridDim.x * blockIdx.y;                   \\
    if (threadIdx.x == 0 && blk_ < %(b)d) {                                      \\
      g_cg_stamps[blk_ * 6 + (k)] = clock64();                                   \\
      if ((k) == 0 || (k) == 5) {                                                \\
        unsigned long long t_;                                                   \\
        asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t_));                \\
        g_cg_gt[blk_ * 2 + ((k) == 5)] = t_;                                     \\
      }                                                                          \\
    }                                                                            \\
  } while (0)
""" % {"b": UPDATE_PROBE_BLOCKS}
UPDATE_STAMP_EXPORTS = """
// the stamps, [blocks, 6] int64, and the global timer at the first and last
// stamp, [blocks, 2] uint64 ns (of the last, block 0's is used): into host
// memory, and set to 0
extern "C" int dkmc_cg_probe_stamps(void* dst, void* gt) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_cg_stamps, sizeof(g_cg_stamps));
  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(gt, g_cg_gt, sizeof(g_cg_gt)));
}
extern "C" int dkmc_cg_probe_clear() {
  void *p = nullptr, *q = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_cg_stamps);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&q, g_cg_gt);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_cg_stamps));
  return (int)(e != cudaSuccess ? e : cudaMemset(q, 0, sizeof(g_cg_gt)));
}
"""


#: cg_update_direction rebuilt with 1, 3, 4 or 8 rows a thread (tiles of
#: 256 to 2,048 rows) and with a launch that is not cooperative, which
#: ``--variants`` times (name: [(old, new)] text replacements)
UPDATE_VARIANTS = {
    "rows1": [("constexpr int kRows = 2;", "constexpr int kRows = 1;")],
    "rows4": [("constexpr int kRows = 2;", "constexpr int kRows = 4;")],
    "rows8": [("constexpr int kRows = 2;", "constexpr int kRows = 8;")],
    "noncoop": [("attr[0].val.cooperative = 1;", "attr[0].val.cooperative = 0;")],
    "rows3": [("constexpr int kRows = 2;", "constexpr int kRows = 3;")],
}


def update_variant_builds(bdir, csrc):
    """This checkout's boundary_cg.cu with UPDATE_VARIANTS: {name: nvcc job}."""
    src = (csrc / "boundary_cg.cu").read_text()
    jobs = {}
    for name, subs in UPDATE_VARIANTS.items():
        text = src
        for old, new in subs:
            text = replace_once(text, old, new, "boundary_cg.cu")
        path = os.path.join(bdir, f"boundary_cg_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = nvcc_build(path, path[:-3] + ".so", csrc)
    return jobs


def update_kernel_of(src):
    """The update kernel that ``src`` (a boundary_cg.cu) holds."""
    names = [k for k in UPDATE_STAMPS if f"\n{k}(" in src]
    if len(names) != 1:
        raise RuntimeError(f"boundary_cg.cu: update kernels {names}, not one")
    return names[0]


def update_build(bdir, csrc):
    """The boundary_cg.cu of ``csrc`` with its update kernel's stamps: (its
    kernel's name, nvcc job); None when the source lacks an anchor (an
    earlier form of the kernel: its times are taken, not its phases)."""
    src = (csrc / "boundary_cg.cu").read_text()
    kernel = update_kernel_of(src)
    if any(src.count(anchor) != 1 for anchor, _, _ in UPDATE_STAMPS[kernel]):
        print(f"{kernel}: not the form of UPDATE_STAMPS' anchors, no stamps", flush=True)
        return None
    for anchor, k, where in UPDATE_STAMPS[kernel]:
        stamp = f"CG_STAMP({k});"
        src = replace_once(src, anchor, anchor + stamp + "\n" if where == "after"
                           else stamp + "\n" + anchor, "boundary_cg.cu")
    head = "constexpr int kSlots = 4;\n"
    src = replace_once(src, head, head + UPDATE_STAMP_DEFS, "boundary_cg.cu")
    path = os.path.join(bdir, "boundary_cg_stamped.cu")
    with open(path, "w") as f:
        f.write(src + UPDATE_STAMP_EXPORTS)
    return kernel, nvcc_build(path, path[:-3] + ".so", csrc)


def boundary_system(cs, sim):
    """The crossbar's boundary system as chip_smoke.py phase 11 builds it:
    (operator, b, warm start, Jacobi diagonal, active, tolerance)."""
    import numpy as np
    import torch

    from devicekmc_tpu_torch.physics import potential as pot
    from devicekmc_tpu_torch.state import stack_states

    geom, params = sim.geom, sim.params
    states = stack_states([sim.state])
    interior = geom.bp_interior_mask
    masks = (geom.bp_left_mask, geom.bp_right_mask, interior)
    edge_g = pot._edge_conductance_boundary(geom, states, params)
    b, _, diag, vals, pre = pot._dirichlet_system(geom, edge_g, -cs.VD_MAIN / 2,
                                                  cs.VD_MAIN / 2, masks)
    op = (diag, vals, geom.neigh_idx, interior)
    rng = np.random.default_rng(7)
    noise = torch.as_tensor(cs.CG_NOISE * rng.standard_normal(geom.N), device="cuda")
    x0 = torch.where(interior, states.potential_boundary + noise, 0.0)
    active = torch.ones(1, dtype=torch.bool, device="cuda")
    return op, b, x0, pre, active, params.solver_tol


def sm_mhz(cycles=20_000_000):
    """The SM clock under a busy loop: torch.cuda._sleep's cycles over its
    time between CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    return cycles / (a.elapsed_time(b) * 1e3)


def stamp_phases(lib, kernel):
    """Each phase's cycles of the stamped update kernel's last launch: the
    median and the most over the blocks that reached both its stamps, their
    count, and block 0's."""
    raw = (ctypes.c_longlong * (UPDATE_PROBE_BLOCKS * 6))()
    gt = (ctypes.c_ulonglong * (UPDATE_PROBE_BLOCKS * 2))()
    err = lib.dkmc_cg_probe_stamps(ctypes.cast(raw, ctypes.c_void_p),
                                   ctypes.cast(gt, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"update stamps: cudaError {err}")
    starts = [gt[2 * k] for k in range(UPDATE_PROBE_BLOCKS) if gt[2 * k]]
    rows = [raw[6 * k:6 * k + 6] for k in range(UPDATE_PROBE_BLOCKS)]
    rows = [r for r in rows if r[0]]
    out = {}
    for k, name in enumerate(UPDATE_PHASES[kernel]):
        d = [r[k + 1] - r[k] for r in rows if r[k] and r[k + 1]]
        out[name] = dict(blocks=len(d), median=statistics.median(d) if d else None,
                         max=max(d) if d else None,
                         block0=(rows[0][k + 1] - rows[0][k]
                                 if rows and rows[0][k] and rows[0][k + 1] else None))
    ends = [max(v for v in r if v) - r[0] for r in rows]
    spans = [max(v for v in r if v) - r[0] for r in rows]
    out["a block, first stamp to last"] = dict(
        blocks=len(spans), median=statistics.median(spans) if spans else None,
        max=max(spans) if spans else None)
    if starts:
        # global timer, ns: the blocks' first stamps after the earliest, and
        # block 0's first stamp to its last
        t0 = min(starts)
        out["globaltimer_ns"] = dict(start_spread=max(starts) - t0,
                                     start_median=statistics.median(starts) - t0,
                                     block0_span=gt[1] - gt[0] if gt[0] and gt[1] else None)
    return out


class _NoStamps(Exception):
    pass


def update_probe(cs, sim, stamped, variants=None, batches=(8, 32), ensemble=True):
    """The boundary CG's update and direction of the package at the
    crossbar's boundary system (``stamped``: (kernel name, library) of
    update_build): the kernels through the package's wrappers, back to back
    and cold, at B = 1 and ``batches``, beside their bytes bound; the
    parent's direction beside torch.addcmul; the captured solve an
    iteration; the ensemble's graph at ``batches`` (``ensemble``); the
    stamped build's phases; each of ``variants`` ({name: library} of
    update_variant_builds) back to back and in the captured solve, against
    the package's kernel."""
    import dataclasses

    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import boundary_cg as bcg
    from devicekmc_tpu_torch.ops.graph import Graph

    geom = sim.geom
    op, b, x0, pre, active, tol = boundary_system(cs, sim)
    fused = hasattr(bcg, "cg_update_direction")
    kernel, lib = stamped
    N, maxiter = geom.N, cs.CG_MAXITER
    res = {"design": "fused cg_update_direction" if fused else "cg_update + cg_direction",
           "stamped_kernel": kernel}

    # the captured solve, a WHILE node
    ws = make_workspace(bcg, geom, b.dtype)
    solve = Graph(lambda: bcg.cg_solve_device(op, b, x0, pre, tol, maxiter, active, ws), "cuda")
    iters = int(solve().iters[0])
    solve_ms = cs.time_ms(solve, reps=3, rounds=5, warmup=1)
    res.update(solve_iters=iters, solve_ms=solve_ms, iteration_ms=solve_ms / iters)

    def clone(w):
        return dataclasses.replace(w, **{f.name: getattr(w, f.name).clone()
                                         for f in dataclasses.fields(w)
                                         if isinstance(getattr(w, f.name), torch.Tensor)})

    w0 = make_workspace(bcg, geom, b.dtype)
    bcg.cg_setup(op, b, x0, pre, 0.0, maxiter, active, w0)
    for _ in range(3):
        bcg.cg_iteration(w0, op, maxiter)
    if fused:
        fns = {"cg_update_direction": lambda w: bcg.cg_update_direction(w, maxiter)}
        plain = {"cg_update_direction": lambda w: bcg.cg_update_direction_plain(w, maxiter)}
    else:
        fns = {"cg_update": lambda w: bcg.cg_update(w, maxiter),
               "cg_direction": lambda w: bcg.cg_direction(w),
               "pair": lambda w: (bcg.cg_update(w, maxiter), bcg.cg_direction(w)),
               "torch.addcmul": lambda w: torch.addcmul(w.z, w.beta[:, None], w.p, out=w.ap)}
        plain = {"cg_update": lambda w: bcg.cg_update_plain(w, maxiter),
                 "cg_direction": lambda w: bcg.cg_direction_plain(w)}
        wa, wd = clone(w0), clone(w0)
        bcg.cg_update(wa, maxiter)
        wd.z.copy_(wa.z)
        wd.beta.copy_(wa.beta)
        bcg.cg_direction(wd)
        res["addcmul_max_abs_err"] = float(
            (torch.addcmul(wa.z, wa.beta[:, None], wa.p) - wd.p).abs().max())
    vec = 8 * N
    res["bound_ms"] = {"cg_update_direction": 8 * vec, "pair": 8 * vec, "cg_update": 8 * vec,
                       "cg_direction": 3 * vec, "torch.addcmul": 3 * vec}
    res["bound_ms"] = {k: v / cs.PEAK_BYTES_PER_S * 1e3 for k, v in res["bound_ms"].items()}
    res["times"] = {}
    for name, fn in fns.items():
        w = clone(w0)
        res["times"][name] = {"warm": cs.time_ms(lambda: fn(w)),
                              "cold": cs.time_ms_cold(lambda: fn(w))}
    for name, fn in plain.items():
        w = clone(w0)
        res["times"][name]["plain"] = cs.time_ms(lambda: fn(w), reps=5)
    if fused:
        res["grid_b1"] = bcg.update_direction_grid(w0)
        # one launch's outputs, to hold two checkouts' kernels bit for bit
        import hashlib

        w = clone(w0)
        fns["cg_update_direction"](w)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for f in ("x", "r", "p", "rz", "rr", "beta", "act", "iters", "ctl", "cond"):
            digest.update(getattr(w, f).cpu().numpy().tobytes())
        res["digest"] = digest.hexdigest()

    # B > 1: the replica copied
    fields = ("x", "r", "p", "ap", "minv", "rz", "rr", "thresh2", "alpha", "beta", "act0",
              "act", "iters")

    def replicated(nb):
        wb = (bcg.workspace(nb, geom.neigh_idx, geom.bp_interior_mask, b.dtype, "cuda")
              if "neigh_idx" in inspect.signature(bcg.workspace).parameters
              else bcg.workspace(nb, N, b.dtype, "cuda"))
        for f in fields:
            getattr(wb, f).copy_(getattr(w0, f).expand_as(getattr(wb, f)))
        return wb

    res["batches"] = {}
    for nb in batches:
        wb = replicated(nb)
        name = "cg_update_direction" if fused else "pair"
        res["batches"][nb] = {"ms": cs.time_ms(lambda: fns[name](wb)),
                              "bound_ms": 8 * vec * nb / cs.PEAK_BYTES_PER_S * 1e3}
        if fused:
            res["batches"][nb]["grid"] = bcg.update_direction_grid(wb)
        del wb

    # the stamped build: one launch on a copy of w0, through the wrapper
    loaded = _build._libs.get("boundary_cg")
    _build._libs["boundary_cg"] = lib
    try:
        if lib is None:
            raise _NoStamps
        w = clone(w0)
        err = lib.dkmc_cg_probe_clear()
        if err != 0:
            raise RuntimeError(f"update stamps: cudaError {err}")
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cs.HOLD_CYCLES)
        a.record()
        (fns["cg_update_direction"] if fused else fns["cg_update"])(w)
        e.record()
        e.synchronize()
        res["stamped_ms"] = a.elapsed_time(e)
        res["stamp_cycles"] = stamp_phases(lib, kernel)
    except _NoStamps:
        res["stamp_cycles"] = None
    finally:
        _build._libs["boundary_cg"] = loaded
    res["sm_mhz"] = sm_mhz()

    # the variants, their library in the package's place (part: room for
    # any tile)
    res["variants"] = {}
    if variants:
        wref = clone(w0)
        fns["cg_update_direction"](wref)
    for name, vlib in (variants or {}).items():
        _build._libs["boundary_cg"] = vlib
        try:
            w = clone(w0)
            w.part = torch.zeros(N, dtype=b.dtype, device="cuda")
            fns["cg_update_direction"](w)
            err = max(float((getattr(w, f) - getattr(wref, f)).abs().max())
                      for f in ("x", "r", "p", "rz", "rr", "beta"))
            w = clone(w0)
            w.part = torch.zeros(N, dtype=b.dtype, device="cuda")
            warm = cs.time_ms(lambda: fns["cg_update_direction"](w))
            wv = make_workspace(bcg, geom, b.dtype)
            wv.part = torch.zeros(N, dtype=b.dtype, device="cuda")
            g = Graph(lambda: bcg.cg_solve_device(op, b, x0, pre, tol, maxiter, active, wv),
                      "cuda")
            it = int(g().iters[0])
            ms = cs.time_ms(g, reps=3, rounds=5, warmup=1)
            wb = replicated(max(batches))
            wb.part = torch.zeros(max(batches) * N, dtype=b.dtype, device="cuda")
            res["variants"][name] = dict(
                warm=warm, solve_iters=it, iteration_ms=ms / it, max_abs_diff=err,
                grid_b1=bcg.update_direction_grid(w),
                warm_largest_batch=cs.time_ms(lambda: fns["cg_update_direction"](wb)))
            del wb
        finally:
            _build._libs["boundary_cg"] = loaded

    if ensemble:
        from devicekmc_tpu_torch.parallel.batched import batch_states, make_batched_superstep

        step = make_batched_superstep(geom, sim.params, sim.heat)
        res["ensemble_ms"] = {}
        for nb in batches:
            st = batch_states(sim.state, nb, base_seed=cs.ENSEMBLE_SEED)
            ms = []
            for _ in range(6):
                torch.cuda.synchronize()
                t = time.perf_counter()
                st, _, _ = step(st, cs.VD_MAIN)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
            res["ensemble_ms"][nb] = {"median": statistics.median(ms[2:]), "ms": ms[2:]}
            del st
            torch.cuda.empty_cache()
    return res


#: clock64() stamps of the transport CG's kernels: (text that occurs once,
#: stamp, "after" or "before" it).  TP_BLOCK(k) in thread 0 of every block
#: writes block stamp k (clock64 and the global timer).  TRANSPORT_PHASES
#: names the phases between block stamps, by kernel.
TRANSPORT_STAMPS = {
    "pack": (
        ("  count_launch(count);\n  const int i = blockIdx.x * kThreads + threadIdx.x;\n",
         "  TP_BLOCK(0);\n", "after"),
        ("  if (k >= 0) xm[k] = (float)v;\n}\n", "  TP_BLOCK(1);\n", "before"),
    ),
    "blocks": (
        ("  const int nv = min(*A.n_vac, A.vcap);\n  const int n_ct", "  TP_BLOCK(0);\n",
         "before"),
        ("    // each column's partial T_vm^T x_v", "    TP_BLOCK(1);\n", "before"),
        ("    // the column tile's last live row tile", "    TP_BLOCK(2);\n", "before"),
        ("    return;\n  }\n\n  if (b >= 2 + n_vb) {", "    TP_BLOCK(3);\n", "before"),
        ("    for (int j = threadIdx.x; j < nv; j += kThreads) s_xall[j]", "    TP_BLOCK(1);\n",
         "before"),
        ("    if (s >= nv) return;\n    float c = 0.f;\n", "    TP_BLOCK(2);\n", "before"),
        ("    if (lane == 0) A.y_vv[s] = c;\n", "    TP_BLOCK(3);\n", "after"),
        ("    const int* nb = A.anb + (size_t)A.vidx[s] * A.max_nn;\n    const float* dv",
         "    TP_BLOCK(2);\n", "before"),
        ("    if (lane == 0) A.y_bump[s] = d;\n", "    TP_BLOCK(3);\n", "after"),
        ("  const bool is_gnd = b == 0;\n", "  TP_BLOCK(2);\n", "before"),
        ("  if (threadIdx.x == 0) A.dots[is_gnd ? 0 : 1] = sum;\n", "  TP_BLOCK(3);\n", "after"),
    ),
    "rows": (
        ("  const int i = blockIdx.x * kThreads + threadIdx.x;\n  T acc = 0;\n",
         "  TP_BLOCK(0);\n", "after"),
        ("  if (threadIdx.x == 0) A.part[blockIdx.x] = sum;\n", "  TP_BLOCK(1);\n", "after"),
        ("      A.rsum[0] = (double)total;\n    }\n  }\n", "  TP_BLOCK(2);\n", "after"),
    ),
}
TRANSPORT_PHASES = {
    "pack": ("a block's rows",),
    # by the block's kind: a tile of T_vm (loads and its rows' partial sums,
    # its columns' partial sums, the tickets and the tile sums), T_vv's rows
    # (the bump, x_v gathered, the rows), a dot (all of it in the last)
    "blocks": ("1", "2", "3"),
    "rows": ("a block's rows", "last-ticket sum"),
}
#: transport_blocks' block kinds and the names of their phases
BLOCKS_KINDS = {"T_vm tile": ("loads, rows' partial sums", "columns' partial sums",
                              "tickets, tile sums"),
                "T_vv rows": ("first loads issued", "x_v gathered", "T_vv rows"),
                "bump": ("-", "-", "the bump"),
                "dot": ("-", "-", "the dot")}
TP_BLOCKS, TP_STAMPS = 8192, 6
TP_STAMP_DEFS = """
__device__ long long g_tp_blk[@B@ * @S@];
__device__ unsigned long long g_tp_gt[@B@ * @S@];
#define TP_BLOCK(k)                                                              \\
  do {                                                                           \\
    if (threadIdx.x == 0 && blockIdx.x < @B@) {                                 \\
      unsigned long long t_;                                                     \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                     \\
      g_tp_blk[blockIdx.x * @S@ + (k)] = clock64();                             \\
      g_tp_gt[blockIdx.x * @S@ + (k)] = t_;                                     \\
    }                                                                            \\
  } while (0)
""".replace("@B@", str(TP_BLOCKS)).replace("@S@", str(TP_STAMPS))
TP_STAMP_EXPORTS = """
// the stamps into host memory: [blocks, stamps] clock64 and global timer;
// and set to 0
extern "C" int dkmc_tp_probe_read(void* blk, void* gt) {
  cudaError_t e = cudaMemcpyFromSymbol(blk, g_tp_blk, sizeof(g_tp_blk));
  return (int)(e != cudaSuccess ? e : cudaMemcpyFromSymbol(gt, g_tp_gt, sizeof(g_tp_gt)));
}
extern "C" int dkmc_tp_probe_clear() {
  void *p = nullptr, *q = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&p, g_tp_blk);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&q, g_tp_gt);
  if (e == cudaSuccess) e = cudaMemset(p, 0, sizeof(g_tp_blk));
  return (int)(e != cudaSuccess ? e : cudaMemset(q, 0, sizeof(g_tp_gt)));
}
"""


def transport_forms(src):
    """The kernels of TRANSPORT_STAMPS that ``src`` (a transport_cg.cu)
    holds."""
    return [k for k in TRANSPORT_STAMPS if f"\ntransport_{k}_kernel(" in src
            or f" transport_{k}_kernel(" in src]


def transport_build(bdir, csrc):
    """The transport_cg.cu of ``csrc`` with the stamps of every kernel of
    TRANSPORT_STAMPS it holds: (those kernels, nvcc job)."""
    src = (csrc / "transport_cg.cu").read_text()
    forms = transport_forms(src)
    for form in forms:
        for anchor, stamp, where in TRANSPORT_STAMPS[form]:
            src = replace_once(src, anchor, anchor + stamp if where == "after"
                               else stamp + anchor, "transport_cg.cu")
    head = "#include \"ticket.cuh\"\n"
    src = replace_once(src, head, head + TP_STAMP_DEFS, "transport_cg.cu")
    path = os.path.join(bdir, "transport_cg_stamped.cu")
    with open(path, "w") as f:
        f.write(src + TP_STAMP_EXPORTS)
    return forms, nvcc_build(path, path[:-3] + ".so", csrc)


#: clock64() stamps of the band kernel (csrc/banded.cu): a block's start,
#: its slice starts read, thread 0's row written; BAND_VARIANTS: builds of
#: the kernel otherwise (name: [(old, new)] text replacements): the block's
#: span of the window staged in shared memory, gathered from there
BAND_STAMPS = (
    ("  count_launch(count);\n  const int row =", "  TP_BLOCK(0);\n", "before"),
    ("  float acc = 0.f;\n#pragma unroll", "  TP_BLOCK(1);\n", "before"),
    ("  y[row] = acc;\n", "  TP_BLOCK(2);\n", "after"),
)
BAND_PHASES = ("slice starts read", "thread 0's row")
BAND_VARIANTS = {
    "direct": [],
    "staged window": [
        ("int n_rows, int B, float* __restrict__ y,",
         "int n_rows, int m_pad, int B, float* __restrict__ y,"),
        ("  const float* x = xw + (int64_t)(row / B) * B;\n",
         "  // the windows of the block's row blocks, one span of xw\n"
         "  extern __shared__ float xs[];\n"
         "  const int row0 = (int)blockIdx.x * kThreads, rb0 = row0 / B;\n"
         "  const int rb1 = (min(row0 + kThreads, n_rows) - 1) / B;\n"
         "  const int n = (rb1 - rb0 + m_pad) * B;\n"
         "  for (int e = (int)threadIdx.x; e < n; e += kThreads)\n"
         "    xs[e] = xw[(int64_t)rb0 * B + e];\n"
         "  __syncthreads();\n"
         "  const float* x = xs + (row / B - rb0) * B;\n"),
        ("__ldg(x + oi[q])", "x[oi[q]]"),
        ("  banded_slots_kernel<TV><<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, st>>>(",
         "  const size_t smem =\n"
         "      (size_t)((kThreads + B - 1) / B + 1 + m_pad) * B * sizeof(float);\n"
         "  if (smem > 48 * 1024) {\n"
         "    cudaError_t e = cudaFuncSetAttribute(banded_slots_kernel<TV>,\n"
         "        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);\n"
         "    if (e != cudaSuccess) return (int)e;\n"
         "  }\n"
         "  banded_slots_kernel<TV>\n"
         "      <<<(n_rows + kThreads - 1) / kThreads, kThreads, smem, st>>>("),
        ("static_cast<const float*>(xw), n_rows, B,",
         "static_cast<const float*>(xw), n_rows, m_pad, B,"),
    ],
}


def band_builds(bdir, csrc):
    """csrc/banded.cu with BAND_STAMPS, as each of BAND_VARIANTS: {name: nvcc
    job}; none for a package whose band kernel is not the slots kernel."""
    src = (csrc / "banded.cu").read_text()
    if "banded_slots_kernel" not in src:
        return {}
    for anchor, stamp, where in BAND_STAMPS:
        src = replace_once(src, anchor, anchor + stamp if where == "after"
                           else stamp + anchor, "banded.cu")
    head = "#include \"launch_count.cuh\"\n"
    src = replace_once(src, head, head + TP_STAMP_DEFS, "banded.cu") + TP_STAMP_EXPORTS
    jobs = {}
    for name, subs in BAND_VARIANTS.items():
        text = src
        for old, new in subs:
            text = replace_once(text, old, new, "banded.cu")
        path = os.path.join(bdir, f"banded_{name.replace(' ', '_')}.cu")
        with open(path, "w") as f:
            f.write(text)
        jobs[name] = nvcc_build(path, path[:-3] + ".so", csrc)
    return jobs


def band_probe(cs, op, xw, libs):
    """The band kernel's builds of ``libs`` (band_builds) at the operator's
    band: each bit-equal to the package's launch, timed back to back and
    with a cold L2, and one stamped launch's phases (BAND_PHASES)."""
    import torch

    from devicekmc_tpu_torch.ops.banded import banded_matvec

    slots = op.slots
    R, m_pad, B = slots.shape
    ref = banded_matvec(slots, xw)
    out = {}
    for name, lib in libs.items():
        fn = lib.dkmc_banded_matvec
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        y = torch.empty_like(ref)

        def run():
            err = fn(slots.off.data_ptr(), slots.val.data_ptr(), slots.start.data_ptr(),
                     xw.data_ptr(), R, m_pad, B, int(slots.val.dtype == torch.bfloat16),
                     y.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"band {name}: cudaError {err}")

        run()
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise RuntimeError(f"band {name}: not bit-equal to the package's kernel")
        lib.dkmc_tp_probe_read.argtypes = [ctypes.c_void_p] * 2
        lib.dkmc_tp_probe_read.restype = lib.dkmc_tp_probe_clear.restype = ctypes.c_int
        lib.dkmc_tp_probe_clear()
        torch.cuda._sleep(cs.HOLD_CYCLES)
        run()
        torch.cuda.synchronize()
        out[name] = dict(ms=cs.time_ms(run), cold_ms=cs.time_ms_cold(run),
                         stamps=transport_stamps(lib, None, {"": (0, TP_BLOCKS,
                                                                  BAND_PHASES)}))
    return out


def transport_stamps(lib, form, block_kinds=None):
    """Each phase of TRANSPORT_PHASES[form] of the stamped kernel's last
    launch, in cycles over the blocks that reached both its stamps (median,
    most, count); the global timer's spread of the blocks' first stamps and
    the span from the first to the last stamp of any block (ns); with
    ``block_kinds`` ({kind: (first block, end block, phase names)}) the
    phases by the blocks' kind ("-": a phase not reported)."""
    S = TP_STAMPS
    blk = (ctypes.c_longlong * (TP_BLOCKS * S))()
    gt = (ctypes.c_ulonglong * (TP_BLOCKS * S))()
    err = lib.dkmc_tp_probe_read(*(ctypes.cast(b, ctypes.c_void_p) for b in (blk, gt)))
    if err != 0:
        raise RuntimeError(f"transport stamps: cudaError {err}")
    rows = [blk[S * b:S * b + S] for b in range(TP_BLOCKS)]
    gts = [gt[S * b:S * b + S] for b in range(TP_BLOCKS)]
    live = [b for b in range(TP_BLOCKS) if rows[b][0]]
    med = lambda xs: statistics.median(xs) if xs else None
    out = {"blocks": len(live)}
    groups = block_kinds or {"": (0, TP_BLOCKS, TRANSPORT_PHASES[form])}
    for kind, (b_lo, b_hi, names) in groups.items():
        mine = [b for b in live if b_lo <= b < b_hi]
        for k, name in enumerate(names):
            d = [rows[b][k + 1] - rows[b][k] for b in mine if rows[b][k] and rows[b][k + 1]]
            if name != "-":
                out[f"{kind}: {name}" if kind else name] = dict(
                    blocks=len(d), median=med(d), max=max(d) if d else None)
    if live:
        starts = [gts[b][0] for b in live]
        t0 = min(starts)
        out["globaltimer_ns"] = dict(
            start_spread=max(starts) - t0, start_median=med(starts) - t0,
            span=max(max(v for v in gts[b] if v) for b in live) - t0)
    clear = lib.dkmc_tp_probe_clear()
    if clear != 0:
        raise RuntimeError(f"transport stamps: cudaError {clear}")
    return out


def transport_probe(cs, sim, stamped, band_libs, inner=20):
    """The transport CG's kernels of the package at the crossbar's transport
    operator (the state after two supersteps, chip_smoke.transport_operator's
    seeded direction): each kernel through its wrapper, back to back, beside
    the band and the fly matvec; ``inner`` inner iterations captured as one
    graph (a seeded CG start whose threshold is 0, so every iteration
    iterates), per iteration; the warm solve of chip_smoke.py's phase 4
    captured, per inner iteration; with ``stamped`` ((forms, library) of
    transport_build) one launch of each stamped kernel and its phases; the
    band kernel's builds ``band_libs`` (band_probe)."""
    import dataclasses

    import torch

    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import transport_cg as tcg
    from devicekmc_tpu_torch.ops.graph import Graph, fork, join

    tws, op, x0, gen = cs.transport_operator(sim)
    res = {"shape": dict(nsub=tws.x.shape[0], n_mp=int(op.T_vm.shape[1]),
                         vcap=int(op.T_vm.shape[0]), n_vac=int(op.n_vac),
                         max_nn=int(op.anb.shape[1]), nsi=op.nsi,
                         gnd_terms=int(op.anb.shape[0]) - op.gnd_lo)}

    def clone(ws):
        kw = {}
        for f in dataclasses.fields(ws):
            v = getattr(ws, f.name)
            if f.name == "cg":
                v = dataclasses.replace(v, **{g.name: getattr(v, g.name).clone()
                                              for g in dataclasses.fields(v)
                                              if torch.is_tensor(getattr(v, g.name))})
            elif f.name == "fly":
                v = tuple(t.clone() for t in v)
            elif torch.is_tensor(v):
                v = v.clone()
            kw[f.name] = v
        return type(ws)(**kw)

    # the inputs of each kernel: lo after the direction's products, hi
    # after the iterate's
    lo, hi = clone(tws), clone(tws)
    tcg.refine(lo, op, True, tcg.MAX_OUTER, 20000)
    tcg.blocks(lo, op, False)
    tcg.pack(hi, op, True)
    tcg.blocks(hi, op, True)
    tcg.band(lo, op)
    tcg.fly(lo, op)
    tcg.fly(hi, op)
    t = {}
    t["band"] = cs.time_ms(lambda: tcg.band(lo, op))
    t["fly"] = cs.time_ms(lambda: tcg.fly(lo, op))
    t["blocks_lo"] = cs.time_ms(lambda: tcg.blocks(lo, op, False))
    t["blocks_hi"] = cs.time_ms(lambda: tcg.blocks(hi, op, True))
    t["rows_lo"] = cs.time_ms(lambda: tcg.rows(lo, op, False))
    t["rows_hi"] = cs.time_ms(lambda: tcg.rows(hi, op, True))
    up = clone(lo)
    up.cg.thresh2.zero_()
    t["update_pack"] = cs.time_ms(lambda: tcg.update_pack(up, op))
    t["pack_hi"] = cs.time_ms(lambda: tcg.pack(hi, op, True))
    t["band_cold"] = cs.time_ms_cold(lambda: tcg.band(lo, op))
    res["ms"] = t
    if band_libs:
        res["band_builds"] = band_probe(cs, op, lo.xw, band_libs)

    # the body's products and inner iterations captured: the band alone, the
    # band with what runs beside it, and whole inner iterations from a CG
    # start (threshold 0)
    it = clone(tws)
    it.cg.act.fill_(True)
    it.cg.act0.fill_(True)
    tcg.refine(it, op, True, tcg.MAX_OUTER, 20000)
    it.cg.thresh2.zero_()
    it.cg.act.fill_(True)

    def beside(first, *parts):
        # the band and ``parts`` on a branch beside it, the band captured
        # ``first`` or after the branch's kernels
        def run():
            side = fork(it.x.device)
            if first:
                tcg.band(it, op)
            for part in parts:
                part(side)
            if not first:
                tcg.band(it, op)
            join(it.x.device)
        return run

    fly_b = lambda s_: tcg.fly(it, op, s_)
    blocks_b = lambda s_: tcg.blocks(it, op, False, s_)
    graphs = {"band": lambda: [tcg.band(it, op) for _ in range(inner)],
              "band beside fly + blocks": lambda: [tcg.products(it, op) for _ in range(inner)]}
    for name, fn in (("band first, fly + blocks beside it", beside(True, fly_b, blocks_b)),
                     ("band first, fly beside it", beside(True, fly_b)),
                     ("band first, blocks beside it", beside(True, blocks_b)),
                     ("fly + blocks alone", lambda: (fly_b(None), blocks_b(None)))):
        graphs[name] = lambda fn=fn: [fn() for _ in range(inner)]
    graphs["inner iteration"] = lambda: [tcg.inner_iteration(it, op) for _ in range(inner)]
    res["captured_ms_each"] = {}
    for name, fn in graphs.items():
        g = Graph(fn, "cuda")
        res["captured_ms_each"][name] = cs.time_ms(g, reps=3, rounds=5, warmup=1) / inner
        del g

    # the warm solve of chip_smoke.py's phase 4, captured, with the package's
    # inner body and with other forms of its products: the band captured
    # before its branch, part of the branch after the join, no branch (in
    # series, either order)
    x0p = x0 * (1 + 1e-3 * torch.randn(x0.shape, generator=gen, dtype=torch.float64).cuda())
    go = torch.ones(1, dtype=torch.bool, device="cuda")
    tol = sim.params.transport_tol

    def branch_of(*parts, after=(), band_first=False):
        # the branch of ``parts`` (captured before the band, or after it),
        # then ``after`` in series after the join
        def run(tw, op_, stream=None):
            side = fork(tw.x.device, stream)
            if band_first:
                tcg.band(tw, op_, stream)
            for part in parts:
                part(tw, op_, side)
            if not band_first:
                tcg.band(tw, op_, stream)
            join(tw.x.device, stream)
            for part in after:
                part(tw, op_, stream)
        return run

    def branches(band_first):
        # the fly matvec and transport_blocks on a branch each, the band
        # captured before them or after them
        def run(tw, op_, stream=None):
            dev = tw.x.device
            s1, s2 = fork(dev, stream, 1), fork(dev, stream, 2)
            if band_first:
                tcg.band(tw, op_, stream)
            tcg.fly(tw, op_, s1)
            tcg.blocks(tw, op_, False, s2)
            if not band_first:
                tcg.band(tw, op_, stream)
            join(dev, stream, 1)
            join(dev, stream, 2)
        return run

    def series(band_first):
        def run(tw, op_, stream=None):
            if band_first:
                tcg.band(tw, op_, stream)
            tcg.fly(tw, op_, stream)
            tcg.blocks(tw, op_, False, stream)
            if not band_first:
                tcg.band(tw, op_, stream)
        return run

    fly_p = lambda tw, op_, s_: tcg.fly(tw, op_, s_)
    blocks_p = lambda tw, op_, s_: tcg.blocks(tw, op_, False, s_)
    products = tcg.products
    forms = [("the package's", products),
             ("one branch (fly, blocks) first, the band after it", branch_of(fly_p, blocks_p)),
             ("one branch, blocks then fly, first", branch_of(blocks_p, fly_p)),
             ("band first, one branch (fly, blocks) beside it",
              branch_of(fly_p, blocks_p, band_first=True)),
             ("fly beside the band, blocks after", branch_of(fly_p, after=(blocks_p,))),
             ("blocks beside the band, fly after", branch_of(blocks_p, after=(fly_p,))),
             ("in series, band first", series(True)),
             ("in series, band last", series(False))]
    # a branch each for the fly matvec and transport_blocks needs a package
    # whose fork takes a branch number
    if "branch" in inspect.signature(fork).parameters:
        forms += [("fly and blocks on a branch each, the band after them", branches(False)),
                  ("band first, fly and blocks on a branch each", branches(True))]
    res["solve_forms"] = {}
    try:
        for name, form in forms:
            tcg.products = form
            sv = clone(tws)
            g = Graph(lambda: tcg.solve(sv, op, x0p, go, tol, 20000), "cuda")
            g()
            n = int(sv.it_in)
            ms = cs.time_ms(g, reps=1, rounds=5, warmup=1)
            res["solve_forms"][name] = dict(inner=n, rounds=int(sv.it_out), ms=ms,
                                            ms_per_inner=ms / n)
            del g
    finally:
        tcg.products = products
    res["solve"] = res["solve_forms"]["the package's"]

    # one launch of each stamped kernel, its library in the package's place
    forms, lib = stamped
    loaded = _build._libs.get("transport_cg")
    _build._libs["transport_cg"] = lib
    res["stamps"] = {}
    try:
        lib.dkmc_tp_probe_clear()
        vcap, n_mp = op.T_vm.shape
        for form in forms:
            for build in ((True,) if form == "pack" else (False, True)):
                w = clone(lo if not build else hi)
                launch = {"pack": lambda: tcg.pack(w, op, True),
                          "blocks": lambda: tcg.blocks(w, op, build),
                          "rows": lambda: tcg.rows(w, op, build)}[form]
                torch.cuda.synchronize()
                torch.cuda._sleep(cs.HOLD_CYCLES)
                a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                launch()
                e.record()
                e.synchronize()
                block_kinds = None
                if form == "blocks":
                    n_tb = -(-vcap // tcg.BLOCK_ROWS) * -(-n_mp // tcg.BLOCK_COLS)
                    n_vb = -(-vcap // 8)
                    small = 2 + 2 * n_vb
                    ranges = ((small, small + n_tb), (2 + n_vb, small), (2, 2 + n_vb), (0, 2))
                    block_kinds = {kind: (*r, names) for (kind, names), r in
                                   zip(BLOCKS_KINDS.items(), ranges)}
                res["stamps"][f"{form}_{'hi' if build else 'lo'}"] = dict(
                    ms=a.elapsed_time(e), **transport_stamps(lib, form, block_kinds))
    finally:
        _build._libs["transport_cg"] = loaded
    res["sm_mhz"] = sm_mhz()
    res["resources"] = {name: _build.kernel_resources(name)
                        for name in ("banded", "wkb_fly", "transport_cg", "boundary_cg")}
    return res


#: graph supersteps timed after the probe's warm-up, transport and heat
SUPERSTEPS = 8


def memory_of(run):
    """GiB the card holds before ``run()`` (a run just built) and the most
    it allocates while ``run()`` runs."""
    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return dict(held=held / 2**30, peak=torch.cuda.max_memory_allocated() / 2**30)


def superstep_probe(cs, sim, steps=SUPERSTEPS):
    """``steps`` supersteps of ``sim`` (its captured graph), each timed with
    the host clock between synchronizations beside its inner CG iterations;
    the least-squares slope of ms over iterations (ms an inner iteration:
    the steps' iteration counts differ, and move with the kernels' last
    bits) and its intercept (the rest of a superstep)."""
    import torch

    ms, iters = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.state, _, m = sim._superstep(sim.state, cs.VD_MAIN)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        iters.append(int(m["cg_iters_power"]))
    n = len(ms)
    mi, mm = sum(iters) / n, sum(ms) / n
    var = sum((i - mi) ** 2 for i in iters)
    slope = sum((i - mi) * (t - mm) for i, t in zip(iters, ms)) / var if var else None
    return dict(ms=ms, inner=iters, ms_per_inner=slope,
                rest_ms=None if slope is None else mm - slope * mi)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--events", type=int, default=200, help="events of the capped launch")
    ap.add_argument("--variants", action="store_true",
                    help="also time variants of both kernels (see the module's docstring)")
    ap.add_argument("--pkg", help="checkout whose devicekmc_tpu_torch is measured")
    ap.add_argument("--parts", default="events,matvec,update",
                    help="what to probe, of events, matvec, update and transport")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "probe_cg_events.json"))
    args = ap.parse_args()
    if args.pkg and args.variants:
        ap.error("--variants rebuilds this checkout's sources: not with --pkg")
    parts = set(args.parts.split(","))
    known = {"events", "matvec", "update", "transport"}
    if parts - known:
        ap.error(f"--parts: unknown {sorted(parts - known)}")
    sys.path.insert(0, os.path.abspath(args.pkg) if args.pkg else ROOT)
    import torch

    if not torch.cuda.is_available():
        print("probe_cg_events: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import devicekmc_tpu_torch
    from devicekmc_tpu_torch.ops import _build

    pkg = os.path.dirname(devicekmc_tpu_torch.__file__)
    print(f"devicekmc_tpu_torch from {pkg}", flush=True)
    t0 = time.perf_counter()
    bdir = os.path.join(ROOT, "build", "probe")
    os.makedirs(bdir, exist_ok=True)
    latency_job = cs.start_latency_build()
    events_jobs = {} if args.pkg or "events" not in parts else event_builds(bdir,
                                                                           args.variants)
    matvec_jobs = matvec_builds(bdir) if args.variants and "matvec" in parts else {}
    update_job = update_build(bdir, _build.CSRC) if "update" in parts else None
    update_variant_jobs = (update_variant_builds(bdir, _build.CSRC)
                           if args.variants and "update" in parts else {})
    transport_job = transport_build(bdir, _build.CSRC) if "transport" in parts else None
    band_jobs = band_builds(bdir, _build.CSRC) if "transport" in parts else {}
    _build.build(["ell_gather", "pairwise", "kmc_events", "graph", "boundary_cg"]
                 + (["banded", "wkb_fly", "wkb_window", "transport_cg"]
                    if "transport" in parts else []))
    cs.finish_latency_build(latency_job)
    stamped, variants = finish(events_jobs), finish(matvec_jobs)
    update_lib = None
    if update_job is not None:
        update_lib = finish({"update_stamped": update_job[1]})["update_stamped"]
        update_lib.dkmc_cg_probe_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for fn in (update_lib.dkmc_cg_probe_stamps, update_lib.dkmc_cg_probe_clear):
            fn.restype = ctypes.c_int
    transport_lib = None
    if transport_job is not None:
        transport_lib = finish({"transport_stamped": transport_job[1]})["transport_stamped"]
        transport_lib.dkmc_tp_probe_read.argtypes = [ctypes.c_void_p] * 2
        for fn in (transport_lib.dkmc_tp_probe_read, transport_lib.dkmc_tp_probe_clear):
            fn.restype = ctypes.c_int
    band_libs = finish(band_jobs)
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("kmc_events", "boundary_cg"):
        print(name, [l.strip() for l in _build.build_log(name).splitlines()
                     if "registers" in l], flush=True)

    out = {"gpu": cs.gpu_line(), "package": pkg}
    if "transport" in parts:
        # the memory each run holds once built, and the most it allocates in
        # its cold solves and two supersteps
        mem = {}
        tsim = cs.synthetic_crossbar(cs.N_SITES, "cuda", os.path.join(ROOT, "build",
                                                                      "probe_transport"),
                                     current=True)
        mem["transport"] = memory_of(lambda: tsim.run_bias_point(cs.VD_MAIN, 1e30,
                                                                 max_steps=2))
        out["transport"] = transport_probe(cs, tsim, (transport_job[0], transport_lib),
                                           band_libs)
        out["transport"]["supersteps"] = {"transport": superstep_probe(cs, tsim)}
        del tsim
        torch.cuda.empty_cache()
        hsim = cs.synthetic_crossbar(cs.N_SITES, "cuda", os.path.join(ROOT, "build",
                                                                      "probe_heat"),
                                     current=True, heat="global")
        mem["heat (global)"] = memory_of(lambda: hsim.run_bias_point(cs.VD_MAIN, 1e30,
                                                                     max_steps=2))
        out["transport"]["supersteps"]["heat (global)"] = superstep_probe(cs, hsim)
        out["transport"]["memory_gib"] = mem
        print("transport CG: " + json.dumps(out["transport"]), flush=True)
        del hsim
        torch.cuda.empty_cache()
    if parts - {"transport"}:
        sim = cs.synthetic_crossbar(cs.N_SITES, "cuda", os.path.join(ROOT, "build",
                                                                     "probe_run"))
        sim.run_bias_point(cs.VD_MAIN, 1e30, max_steps=2)
        torch.cuda.synchronize()
    if "events" in parts:
        out["events"] = event_probe(cs, sim, stamped, args.events)
        print("event loop: " + json.dumps(out["events"]), flush=True)
    if "matvec" in parts:
        out["matvec"] = matvec_probe(cs, sim, variants)
        print("cg_matvec_dot: " + json.dumps(out["matvec"]), flush=True)
    if "update" in parts:
        kernel = update_kernel_of((_build.CSRC / "boundary_cg.cu").read_text())
        out["update"] = update_probe(cs, sim, (kernel, update_lib), finish(update_variant_jobs))
        print("update and direction: " + json.dumps(out["update"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(out["gpu"], flush=True)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
