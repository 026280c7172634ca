#!/usr/bin/env python3
"""Issue bounds of the port's compute-bound kernels from their compiled inner
loops, and their times at the paths' shapes.

    python3 tools/fly_sass.py [--dump DIR] [--no-widths] [--inputs FILE]
                              [--pkg DIR] [--times]

Builds ``devicekmc_tpu_torch/csrc/wkb_fly.cu``, ``pairwise.cu`` and
``wkb_window.cu`` as the port does (nvcc, sm_90a), disassembles each library
with ``cuobjdump -sass`` and, for every kernel in it, finds the innermost
loop that holds a ``MUFU.EX2`` (a backward branch whose span is the smallest
around one) and counts what one unit of work costs there: a pair of the
on-the-fly WKB kernels and of the Poisson sweep, an energy step of the
window block.  Each unit takes one ``MUFU.EX2``, so an unrolled loop divides
by its count: instructions in all, special-function (``MUFU``)
instructions, shared-memory loads, shuffles and FP32 multiply-adds a unit.
(A loop whose branches hold one ``MUFU.EX2`` each, as the window kernel's
before it took its barrier forms by select, counts them all: its figures a
unit are then too low by the untaken branch's share.)

The issue bound of a call that computes U units is then

    U * max(instructions / 128, MUFU / 16) / (132 * clock)

seconds: an H100 SM issues 4 warp instructions (128 lanes) a clock and its
special-function units take 16 lanes a clock; 132 SMs; ``clock`` is the SM
clock that ``nvidia-smi`` reports while the card runs the symmetric matvec
in a loop (needs the card; without one the table is printed without it).
With a card it then builds the synthetic crossbar of ``chip_smoke.py`` with
transport on (the cold solves and one superstep) and prints the issue bounds
at the paths' shapes: the on-the-fly kernels at the transport path's 3,527
metal atoms and at the reference crossbar's 24,768, for the pairs of the
32 x 32 chunks they do not skip (``--no-widths`` leaves these out); the
Poisson sweep at the headline path's rows and charged sites (the crossbar's
state before its first superstep), PBC off and on; the window block at the
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
``--times`` adds the time of one call of the Poisson sweep and the window
block at each shape (CUDA events, ``chip_smoke.time_ms``) beside the bounds.
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
LANES_ISSUED_PER_CLK = 128
MUFU_LANES_PER_CLK = 16

_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_LIBS = ("wkb_fly", "pairwise", "wkb_window")
_KERNELS = ("fly_matvec_tiles", "fly_matmat_tiles", "fly_pdisp_tiles",
            "poisson_pairwise_kernel", "window_block_kernel")


def _cuobjdump():
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    return None


def kernel_label(mangled):
    """A short name with the template arguments, e.g. ``fly_matvec_tiles<1,4>``
    (itanium mangling: ``ILb1ELi4EE`` -> bool 1, int 4)."""
    for base in _KERNELS:
        if base in mangled:
            args = re.search(base + r"I((?:L[bi]\d+E)+)E", mangled)
            if not args:
                return base
            return base + "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
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


def pair_loop(ins):
    """(start, end) indices of the smallest backward-branch span holding a
    MUFU.EX2, or None."""
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
        if any(o.startswith("MUFU.EX2") for _, o, _ in ins[j:i + 1]):
            if best is None or i - j < best[1] - best[0]:
                best = (j, i)
    return best


def loop_costs(ins):
    """Counts a unit (a pair, or an energy step) in the unit loop of one
    kernel."""
    span = pair_loop(ins)
    if span is None:
        return None
    body = ins[span[0]:span[1] + 1]
    pairs = sum(o.startswith("MUFU.EX2") for _, o, _ in body)
    count = lambda pred: sum(1 for _, o, _ in body if pred(o)) / pairs
    return dict(
        pairs_per_iteration=pairs,
        instructions=len(body) / pairs,
        mufu=count(lambda o: o.startswith("MUFU")),
        lds=count(lambda o: o.startswith("LDS")),
        shfl=count(lambda o: o.startswith("SHFL")),
        ffma=count(lambda o: o.startswith("FFMA")),
        span=(body[0][0], body[-1][0]),
    )


def clocks_per_pair(cost):
    """SM clocks one unit takes at best, per SM: the larger of issue and
    special-function time; and which of the two."""
    t_issue = cost["instructions"] / LANES_ISSUED_PER_CLK
    t_mufu = cost["mufu"] / MUFU_LANES_PER_CLK
    return max(t_issue, t_mufu), "issue" if t_issue >= t_mufu else "special function"


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
        c = loop_costs(ins)
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

    sim = cs.synthetic_crossbar(cs.N_SITES, "cuda", os.path.join(ROOT, "build", "fly_sass"),
                                current=True)
    g, p = sim.geom, sim.params
    # the Poisson sweep as the headline path meets it at its start
    state, _ = update_charge(g, p, sim.state)
    cidx = torch.nonzero(state.charge != 0).reshape(-1).to(torch.int32)
    poisson = dict(coords=g.coords.to(torch.float32).contiguous(), cidx=cidx,
                   cq=state.charge[cidx.long()].to(torch.float32),
                   scal=kernel_scalars(p.sigma, p.k, list(g.lattice_host), p.dtype))
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
               poisson=poisson, window=window)
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
                ("fly_matmat_tiles<24>", st["live"]), ("fly_pdisp_tiles", st["live"])]
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
                    help="time the Poisson sweep and the window block at the paths' shapes")
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
              f"{c['ffma']:.2f} FFMA; loop 0x{c['span'][0]:x}-0x{c['span'][1]:x}, "
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
