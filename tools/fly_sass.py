#!/usr/bin/env python3
"""Issue bounds of the port's compute-bound kernels from their compiled inner
loops, and their times at the paths' shapes.

    python3 tools/fly_sass.py [--dump DIR] [--no-widths] [--inputs FILE]
                              [--pkg DIR] [--times]

Builds ``devicekmc_tpu_torch/csrc/wkb_fly.cu``, ``pairwise.cu``,
``pairwise_exact.cu`` and ``wkb_window.cu`` as the port does (nvcc,
sm_90a), disassembles each library with ``cuobjdump -sass`` and, for every
kernel in it, finds the innermost loop that holds a ``MUFU.EX2`` (a backward
branch whose span is the smallest around one; for the exact-erfc sweep a
``MUFU.RSQ``, its square root, as its f64 erfc takes no ``MUFU.EX2``) and
counts what one unit of work costs there: a pair of the on-the-fly WKB
kernels and of the Poisson sweeps, an energy step of the window block.  Each
unit takes one such instruction, so an unrolled loop divides by its count:
instructions in all, special-function (``MUFU``) instructions, shared-memory
loads, shuffles, FP32 multiply-adds and FP64 instructions a unit.  (A loop
whose branches hold one ``MUFU.EX2`` each, as the window kernel's before it
took its barrier forms by select, counts them all: its figures a unit are
then too low by the untaken branch's share.  The exact sweep's rare slow
paths of its square root and divisions are calls out of the loop, not
counted.)

The issue bound of a call that computes U units is then

    U * max(instructions / 128, MUFU / 16, FP64 / 64) / (132 * clock)

seconds: an H100 SM issues 4 warp instructions (128 lanes) a clock, its
special-function units take 16 lanes a clock and its FP64 units 64; 132
SMs; ``clock`` is the SM
clock that ``nvidia-smi`` reports while the card runs the symmetric matvec
in a loop (needs the card; without one the table is printed without it).
With a card it then builds the synthetic crossbar of ``chip_smoke.py`` with
transport on (the cold solves and one superstep) and prints the issue bounds
at the paths' shapes: the on-the-fly kernels at the transport path's 3,527
metal atoms and at the reference crossbar's 24,768, for the pairs of the
32 x 32 chunks they do not skip (``--no-widths`` leaves these out); the
Poisson sweeps at the headline path's rows and charged sites (the crossbar's
state before its first superstep), PBC off and on, the exact one in f32 and
f64; the window block at the
run's vacancy bucket (full assembly), at 16 of its live rows (the partial
assembly's shape) and at the bucket against 24,768 metal atoms, for the
steps the pairs need, with every lane busy and with the share of lanes the
run's windows keep busy (``window_lane_share``).  Also prints ptxas's
registers and shared memory per kernel.  ``--dump`` writes the full
disassembly and the loops there.

``--inputs FILE`` keeps the crossbar's inputs of those shapes (and the
counts of pairs, steps and busy lanes) in FILE, made by the first run that
names it (with this checkout's package) and read by later ones.  ``--pkg
DIR`` takes ``devicekmc_tpu_torch`` from the checkout at DIR (say, the parent
commit unpacked under ``build/``), so that one call can compare two versions
of the kernels on the same inputs in turns (parent, change, change, parent);
``--times`` adds the time of one call of the Poisson sweeps and the window
block at each shape (CUDA events, ``chip_smoke.time_ms``) beside the bounds,
of the dissipation sweep at both metal widths, and of the neighbour gather
at the headline path's shape (1 and 2 channels, cold L2 and back to back)
and at two buckets of the rate table's rows taken through active_idx, and
of the full rate table (the gather and the rates computed from its
outputs).  Without ``--pkg`` it also times the gather at other grids than
its rule's.
"""

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_SM = 132
# buckets of rate-table rows (the engine's auto rule: 1,024 and up by powers of 2)
RATE_BUCKETS = (1024, 8192)
LANES_ISSUED_PER_CLK = 128
MUFU_LANES_PER_CLK = 16
FP64_LANES_PER_CLK = 64

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LIBS = ("wkb_fly", "pairwise", "pairwise_exact", "wkb_window")
_KERNELS = ("fly_matvec_tiles", "fly_matmat_tiles", "fly_pdisp_tiles",
            "poisson_pairwise_kernel", "poisson_exact_kernel", "window_block_kernel")
#: the instruction each unit of a kernel's loop takes once (default
#: ``MUFU.EX2``): the exact sweep's square root (``MUFU.RSQ``, in f64
#: ``MUFU.RSQ64H``); its f64 erfc takes no ``MUFU.EX2``
_UNIT = {"poisson_exact_kernel": "MUFU.RSQ"}
#: FP64 instructions, issued at 64 lanes a clock an SM
_FP64 = ("DFMA", "DADD", "DMUL", "DSETP", "DMNMX")


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def kernel_label(mangled):
    """A short name with the template arguments, e.g. ``fly_matvec_tiles<1,4>``
    (itanium mangling: ``ILb1ELi4EE`` -> bool 1, int 4) or
    ``poisson_exact_kernel<d,0>`` (``IdLb0EE`` -> double, bool 0)."""
    for base in _KERNELS:
        if base in mangled:
            args = re.search(base + r"I((?:[fd]|L[bi]\d+E)+)E", mangled)
            if not args:
                return base
            return base + "<" + ",".join(m.group(1) or m.group(2) for m in re.finditer(
                r"([fd])|L[bi](\d+)E", args.group(1))) + ">"
    return None


def parse_sass(text):
    """{label: [(address, opcode, full text), ...]} for the kernels of
    ``_KERNELS``."""
    out, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = kernel_label(line.split("Function :")[1].strip())
            if cur is not None:
                out[cur] = []
            continue
        m = _INS.search(line)
        if cur is None or not m:
            continue
        body = m.group(2).strip()
        toks = body.split()
        op = toks[1] if toks[0].startswith("@") and len(toks) > 1 else toks[0]
        out[cur].append((int(m.group(1), 16), op, body))
    return out


def pair_loop(ins, unit="MUFU.EX2"):
    """(start, end) indices of the smallest backward-branch span holding a
    ``unit`` instruction, or None."""
    addr_to_i = {a: i for i, (a, _, _) in enumerate(ins)}
    best = None
    for i, (a, op, body) in enumerate(ins):
        if not op.startswith("BRA"):
            continue
        tgt = re.search(r"0x([0-9a-f]+)", body)
        if not tgt:
            continue
        t = int(tgt.group(1), 16)
        if t >= a or t not in addr_to_i:
            continue
        j = addr_to_i[t]
        if any(o.startswith(unit) for _, o, _ in ins[j:i + 1]):
            if best is None or i - j < best[1] - best[0]:
                best = (j, i)
    return best


def loop_costs(ins, unit="MUFU.EX2"):
    """Counts a unit (a pair, or an energy step) in the unit loop of one
    kernel, whose units take one ``unit`` instruction each."""
    span = pair_loop(ins, unit)
    if span is None:
        return None
    body = ins[span[0]:span[1] + 1]
    pairs = sum(o.startswith(unit) for _, o, _ in body)
    count = lambda pred: sum(1 for _, o, _ in body if pred(o)) / pairs
    return dict(
        pairs_per_iteration=pairs,
        instructions=len(body) / pairs,
        mufu=count(lambda o: o.startswith("MUFU")),
        lds=count(lambda o: o.startswith("LDS")),
        shfl=count(lambda o: o.startswith("SHFL")),
        ffma=count(lambda o: o.startswith("FFMA")),
        fp64=count(lambda o: o.startswith(_FP64)),
        span=(body[0][0], body[-1][0]),
    )


def clocks_per_pair(cost):
    """SM clocks one unit takes at best, per SM: the largest of issue,
    special-function and FP64 time; and which of them."""
    t = {"issue": cost["instructions"] / LANES_ISSUED_PER_CLK,
         "special function": cost["mufu"] / MUFU_LANES_PER_CLK,
         "fp64": cost.get("fp64", 0.0) / FP64_LANES_PER_CLK}
    by = max(t, key=t.get)
    return t[by], by


def issue_bound_ms(cost, pairs, clock_mhz):
    return pairs * clocks_per_pair(cost)[0] / (N_SM * clock_mhz * 1e6) * 1e3


def analyse(lib_path):
    """{label: per-pair costs} of the built library; {} without cuobjdump."""
    exe = _cuobjdump()
    if exe is None:
        return {}, ""
    text = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    costs = {}
    for label, ins in parse_sass(text).items():
        c = loop_costs(ins, _UNIT.get(label.split("<")[0], "MUFU.EX2"))
        if c is not None:
            costs[label] = c
    return costs, text


def sm_clock_under_load(fn, seconds=1.5):
    """Median SM clock (MHz) that nvidia-smi reports while ``fn`` is called in
    a loop."""
    import statistics
    import time

    import torch

    t_end = time.time() + seconds
    clocks = []
    while time.time() < t_end:
        for _ in range(200):
            fn()
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
        clocks.append(float(out.stdout.strip().splitlines()[0]))
        torch.cuda.synchronize()
    return statistics.median(clocks)


def measure_sm_clock():
    """The SM clock (MHz) while the symmetric matvec runs on 8,192 random
    atoms (no chunk is skipped: every pair is computed)."""
    import numpy as np
    import torch

    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_matvec

    rng = np.random.default_rng(0)
    n = 8192
    pos = torch.as_tensor((rng.random((n, 3)) * 100).astype(np.float32), device="cuda")
    cb = torch.as_tensor(((rng.random(n) * 2 - 1) * 1.6e-19).astype(np.float32),
                         device="cuda")
    env = dict(prefac=-7.8e18, qV0=2.56e-19, ctol=1.6e-21, nn=3.5,
               lattice=(100.0, 100.0, 100.0), pbc=False)
    return sm_clock_under_load(lambda: wkb_fly_matvec(pos, cb, cb, env))


def path_inputs(path):
    """The inputs of the paths' shapes, kept in ``path`` (made here on the
    first call that names it, read on later ones; ``None``: made, not
    kept): the on-the-fly kernels' metal sets, the Poisson sweep's rows and
    charged set, the window block's vacancy bucket and metal sets, and the
    units of work each shape needs (``window_steps_plain`` and
    ``window_lane_share`` of the checkout that made the file)."""
    import torch

    if path and os.path.exists(path):
        return torch.load(path, weights_only=False)
    import chip_smoke as cs
    from devicekmc_tpu_torch.ops.pairwise import kernel_scalars
    from devicekmc_tpu_torch.ops.wkb_window import window_lane_share, window_steps_plain
    from devicekmc_tpu_torch.physics import current as cur
    from devicekmc_tpu_torch.physics.charge import update_charge
    from devicekmc_tpu_torch.ops.compact import nonzero_fixed
    from devicekmc_tpu_torch.physics.events import pack_site_code
    from devicekmc_tpu_torch.structure import Element

    sim = cs.synthetic_crossbar(cs.N_SITES, "cuda", os.path.join(ROOT, "build", "fly_sass"),
                                current=True)
    g, p = sim.geom, sim.params
    # the Poisson sweep as the headline path meets it at its start
    state, _ = update_charge(g, p, sim.state)
    cidx = torch.nonzero(state.charge != 0).reshape(-1).to(torch.int32)
    poisson = dict(coords=g.coords.to(torch.float32).contiguous(), cidx=cidx,
                   cq=state.charge[cidx.long()].to(torch.float32),
                   scal=kernel_scalars(p.sigma, p.k, list(g.lattice_host), p.dtype))
    # the gather's channels as chip_smoke.kernel_checks makes them
    elem = state.element
    gather = dict(
        idx=g.neigh_idx,
        flags=((g.metal_mask_table[elem.long()].to(torch.int32) << 1)
               | (elem == 2).to(torch.int32)),
        phi=(state.potential_boundary + state.potential_charge).to(torch.float32),
        code=pack_site_code(elem, state.charge, g.site_layer))
    # the rate table's rows as build_rate_table takes them through
    # active_idx, at two buckets of the engine's auto rule
    active = nonzero_fixed((elem == int(Element.DEFECT))
                           | (elem == int(Element.OXYGEN_DEFECT))
                           | (elem == int(Element.VACANCY)), max(RATE_BUCKETS))[0].long()
    gather["buckets"] = {b: g.neigh_idx[active[:b]].contiguous() for b in RATE_BUCKETS}
    # the full rate table, the reader of the gather's outputs
    rate = dict(geom=g, params=p, state=state)
    sim.run_bias_point(cs.VD_MAIN, 1e30, max_steps=1)
    blk = cur.assemble_X_blocks(g, p, sim.state, band=sim._band)
    env, mpos, mcb = blk["fly"]["env"], blk["fly"]["mpos"], blk["fly"]["mcb"]
    ai = g.atom_ind.long()
    vpos = g.coords[ai].float()[blk["vidx"]].contiguous()
    vcb = sim.state.CB_edge[ai].float()[blk["vidx"]].contiguous()
    v_ok = blk["v_ok"]
    live = torch.nonzero(v_ok).reshape(-1)[:16]
    rpos, rcb = cs.reference_metal_set(sim)
    window = {}
    for tag, (vp, vc, ok, mp, mc) in {
            "full": (vpos, vcb, v_ok, mpos, mcb),
            "partial": (vpos[live].contiguous(), vcb[live].contiguous(),
                        torch.ones(live.numel(), dtype=torch.bool, device="cuda"),
                        mpos, mcb),
            "ref": (vpos, vcb, v_ok, rpos, rcb)}.items():
        steps = window_steps_plain(vp, vc, ok, mp, mc, env)
        window[tag] = dict(vpos=vp, vcb=vc, v_ok=ok, pos=mp, cb=mc,
                           steps=int(steps.sum()), lane_share=window_lane_share(steps),
                           shape=f"[{vp.shape[0]} ({int(ok.sum())} live) x {mp.shape[0]}]")
    out = dict(env=env, fly={"n_mp=3527": (mpos, mcb), f"n_mp={cs.REF_N_MP}": (rpos, rcb)},
               poisson=poisson, window=window, gather=gather, rate=rate)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        torch.save(out, path)
    return out


def width_bounds(costs, clock_mhz, inputs):
    """Print the issue bound (ms) of the on-the-fly kernels each width runs,
    for the chunks that width's CB edges leave to compute."""
    import torch

    import chip_smoke as cs
    from devicekmc_tpu_torch.ops.wkb_fly import matvec_col_split

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    env = inputs["env"]
    for tag, (pos, cb) in inputs["fly"].items():
        st = cs.fly_pair_stats(cb, env["ctol"])
        S = matvec_col_split(pos.shape[0], n_sm)
        rows = [(f"fly_matvec_tiles<1,{S}>", st["live_sym"]),
                (f"fly_matvec_tiles<0,{S}>", st["live"]),
                ("fly_matmat_tiles<24>", st["live"]),
                # the upper-triangle form; an earlier version swept all chunks
                (f"fly_pdisp_tiles<{S}>", st["live_sym"]), ("fly_pdisp_tiles", st["live"])]
        print(f"{tag}: {st['live']} of {st['chunks']} chunks not skipped "
              f"({st['live_sym']} in the upper triangle)")
        for label, chunks in rows:
            if label in costs:
                print(f"  {label}: issue bound "
                      f"{issue_bound_ms(costs[label], chunks * 1024, clock_mhz):.5f} ms")


def _cost_of(costs, base, targs):
    """The loop costs of ``base<targs>``, or of ``base`` where the kernel is
    no template (an earlier version)."""
    return costs.get(f"{base}<{targs}>", costs.get(base))


def pdisp_ms(n, seed_offset=1):
    """Scaled potentials for the dissipation sweep at width ``n``, as
    ``chip_smoke.pdisp_checks`` makes them."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(n + seed_offset)
    return torch.rand(n, generator=g, device="cuda") * 7.7e-10


def grid_sweep(idx, vals):
    """Cold-L2 times of the gather at other grids than its rule's: a few
    blocks an SM, as many as the SMs hold, and one tile a warp (every block
    a single step), with four and with one slot a lane."""
    import chip_smoke as cs
    from devicekmc_tpu_torch.ops import _build
    from devicekmc_tpu_torch.ops import ell_gather as E

    n_sm = _build.sm_count(idx.device)
    res = E.resident_blocks(len(vals))
    rule = E.launch_grid(idx.numel(), len(vals), idx.device)
    grids = {"rule": rule}
    for k in (4, 1):
        for per_sm in sorted({1, 2, 4, res} - {0}):
            if per_sm <= res:
                grids[f"{k} a lane, {per_sm} an SM"] = (k, per_sm * n_sm)
        grids[f"{k} a lane, one tile a warp"] = (k, -(-idx.numel() // (32 * k * E._WARPS)))
    line = []
    for name, grid in grids.items():
        t = cs.time_ms_cold(lambda: E._gather(idx, vals, grid))
        line.append(f"{name} ({grid[1]} blocks) {t:.5f}")
    print(f"  grids, cold L2 ms ({res} blocks an SM resident; the rule: {rule[0]} a lane): "
          + "; ".join(line))


def kernel_times(inputs, sweep):
    """Times of one call (ms) of the gather at the headline path's shape
    (cold L2 and back to back, 1 and 2 channels, ``chip_smoke.time_ms_cold``
    and ``time_ms``; also with every source local, ``idx[r, s] = r``) and at
    the rate table's buckets of rows, of the full rate table (the gather and
    the rates computed from its outputs), and of the dissipation sweep at
    both fly widths.  ``sweep`` adds the gather's grid sweep."""
    import torch

    import chip_smoke as cs
    from devicekmc_tpu_torch.ops.ell_gather import ell_gather
    from devicekmc_tpu_torch.ops.wkb_fly import wkb_fly_pdisp
    from devicekmc_tpu_torch.physics.events import build_rate_table

    G = inputs["gather"]
    idx = G["idx"]
    R, M = idx.shape
    idx_local = torch.arange(R, dtype=torch.int32, device="cuda")[:, None].expand(R, M)
    idx_local = idx_local.contiguous()
    for c, vals in ((2, [G["phi"], G["code"]]), (1, [G["flags"]])):
        cold = cs.time_ms_cold(lambda: ell_gather(idx, vals))
        warm = cs.time_ms(lambda: ell_gather(idx, vals))
        local = cs.time_ms_cold(lambda: ell_gather(idx_local, vals))
        print(f"ell_gather C={c} [{idx.shape[0]}x{idx.shape[1]}]: {cold:.5f} ms cold L2, "
              f"{warm:.5f} ms back to back; idx = row (local sources) {local:.5f} ms cold")
        if sweep:
            grid_sweep(idx, vals)
    vals = [G["phi"], G["code"]]
    for ia in G["buckets"].values():
        cold = cs.time_ms_cold(lambda: ell_gather(ia, vals))
        warm = cs.time_ms(lambda: ell_gather(ia, vals))
        print(f"ell_gather C=2 [{ia.shape[0]}x{ia.shape[1]}] (rate-table rows through "
              f"active_idx): {cold:.5f} ms cold L2, {warm:.5f} ms back to back")
        if sweep:
            grid_sweep(ia, vals)
    rt = inputs["rate"]
    t = cs.time_ms_cold(lambda: build_rate_table(rt["geom"], rt["params"], rt["state"]))
    print(f"build_rate_table [{R}x{M}] (the gather and the rates from its outputs): "
          f"{t:.5f} ms cold L2")
    env = inputs["env"]
    for tag, (pos, cb) in inputs["fly"].items():
        ms = pdisp_ms(pos.shape[0])
        t = cs.time_ms(lambda: wkb_fly_pdisp(pos, cb, ms, 1.0, env))
        print(f"wkb_fly_pdisp {tag}: {t:.5f} ms a call")


def path_bounds(costs, clock_mhz, inputs, times):
    """Print the issue bounds (ms) of the Poisson sweep and the window block
    at the paths' shapes and, with ``times``, the time of one call there."""
    import chip_smoke as cs
    from devicekmc_tpu_torch.ops import wkb_window as W
    from devicekmc_tpu_torch.ops.pairwise import poisson_pairwise

    P = inputs["poisson"]
    n, n_c = P["coords"].shape[0], P["cidx"].shape[0]
    for pbc in (False, True):
        c = _cost_of(costs, "poisson_pairwise_kernel", int(pbc))
        line = f"poisson_pairwise pbc={pbc} [{n} rows x {n_c} charged]:"
        if c is not None:
            line += f" issue bound {issue_bound_ms(c, n * n_c, clock_mhz):.5f} ms"
        if times:
            args = (P["coords"], P["cidx"], P["cq"], *P["scal"], pbc)
            line += f"; {cs.time_ms(lambda: poisson_pairwise(*args)):.5f} ms a call"
        print(line)
    # the exact-erfc sweep at the same rows and charged set, f32 and f64
    import torch

    from devicekmc_tpu_torch.ops.pairwise import poisson_exact_batched

    for dt, letter in ((torch.float32, "f"), (torch.float64, "d")):
        rows = P["coords"].to(dt).contiguous()
        ci = P["cidx"].long()
        src = (rows[ci][None].contiguous(), P["cidx"][None].contiguous(),
               P["cq"].to(dt)[None].contiguous(),
               torch.tensor([n_c], dtype=torch.int32, device=rows.device))
        for pbc in (False, True):
            c = costs.get(f"poisson_exact_kernel<{letter},{int(pbc)}>")
            line = f"poisson_exact {letter} pbc={pbc} [{n} rows x {n_c} charged]:"
            if c is not None:
                clk, by = clocks_per_pair(c)
                line += (f" issue bound {issue_bound_ms(c, n * n_c, clock_mhz):.5f} ms "
                         f"(by {by})")
            if times:
                args = (rows, 0, *src, [100.0, 100.0, 100.0], 3.5e-10, 1.0, pbc)
                line += f"; {cs.time_ms(lambda: poisson_exact_batched(*args)):.5f} ms a call"
            print(line)
    env = inputs["env"]
    for tag, w in inputs["window"].items():
        c = costs.get("window_block_kernel")
        line = (f"wkb_window_block {tag} {w['shape']}: {w['steps']} steps, "
                f"{100 * w['lane_share']:.2f} % of the issued lane-steps busy")
        if c is not None:
            ideal = issue_bound_ms(c, w["steps"], clock_mhz)
            line += (f"; issue bound {ideal:.5f} ms with every lane busy, "
                     f"{ideal / w['lane_share']:.5f} ms at that share")
        if times:
            args = (w["vpos"], w["vcb"], w["v_ok"], w["pos"], w["cb"], env)
            line += f"; {cs.time_ms(lambda: W.wkb_window_block(*args)):.5f} ms a call"
        print(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", help="directory for the disassembly and the loops")
    ap.add_argument("--no-widths", action="store_true",
                    help="do not work out the on-the-fly kernels' bounds at the two widths")
    ap.add_argument("--inputs", help="file that keeps the paths' inputs between runs")
    ap.add_argument("--pkg", help="checkout whose devicekmc_tpu_torch is measured")
    ap.add_argument("--times", action="store_true",
                    help="time the Poisson sweep, the window block, the dissipation sweep "
                         "and the gather at the paths' shapes")
    args = ap.parse_args()
    if args.pkg:
        sys.path.insert(0, os.path.abspath(args.pkg))

    import devicekmc_tpu_torch
    from devicekmc_tpu_torch.ops import _build

    print(f"devicekmc_tpu_torch from {os.path.dirname(devicekmc_tpu_torch.__file__)}")
    _build.build(_LIBS)
    costs, res = {}, {}
    for lib in _LIBS:
        res.update({kernel_label(k): v for k, v in _build.kernel_resources(lib).items()})
        c, text = analyse(_build._lib_path(lib))
        costs.update(c)
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            with open(os.path.join(args.dump, f"{lib}.sass"), "w") as f:
                f.write(text)
    if not costs:
        print("cuobjdump not found or no unit loop recognised")
        return 1
    for label in sorted(costs):
        c = costs[label]
        clk, by = clocks_per_pair(c)
        regs, smem = res.get(label, (None, None))
        print(f"{label}: {c['instructions']:.2f} instructions a unit "
              f"({c['mufu']:.2f} MUFU, {c['lds']:.2f} LDS, {c['shfl']:.2f} SHFL, "
              f"{c['ffma']:.2f} FFMA, {c['fp64']:.2f} FP64; loop "
              f"0x{c['span'][0]:x}-0x{c['span'][1]:x}, "
              f"{c['pairs_per_iteration']} units an iteration) -> {clk:.4f} SM clocks a "
              f"unit by {by}; {regs} registers, {smem} bytes shared")
    if args.dump:
        with open(os.path.join(args.dump, "loops.json"), "w") as f:
            json.dump(costs, f, indent=1)
    import torch

    if torch.cuda.is_available():
        import chip_smoke as cs

        print(cs.gpu_line())
        clock = measure_sm_clock()
        print(f"SM clock under load: {clock:.0f} MHz")
        inputs = path_inputs(args.inputs)
        if not args.no_widths:
            width_bounds(costs, clock, inputs)
        path_bounds(costs, clock, inputs, args.times)
        if args.times:
            # the grid sweep needs this checkout's private launch helper
            kernel_times(inputs, sweep=not args.pkg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
