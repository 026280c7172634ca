#!/usr/bin/env python3
"""Issue bound of the on-the-fly WKB kernels from their compiled inner loops.

    python3 tools/fly_sass.py [--dump DIR] [--no-widths]

Builds ``devicekmc_tpu_torch/csrc/wkb_fly.cu`` as the port does (nvcc, sm_90a),
disassembles the library with ``cuobjdump -sass`` and, for every kernel in
it, finds the innermost loop that holds the pair value's ``MUFU.EX2`` (a
backward branch whose span is the smallest around one) and counts what one
pair costs there: instructions in all, special-function (``MUFU``)
instructions, shared-memory loads, shuffles and FP32 multiply-adds.  One
``MUFU.EX2`` is one pair, so an unrolled loop divides by its count.

The issue bound of a call that computes P pairs is then

    P * max(instructions / 128, MUFU / 16) / (132 * clock)

seconds: an H100 SM issues 4 warp instructions (128 lanes) a clock and its
special-function units take 16 lanes a clock; 132 SMs; ``clock`` is the SM
clock that ``nvidia-smi`` reports while the card runs the symmetric matvec
in a loop (needs the card; without one the table is printed without it).
With a card it then builds the synthetic crossbar of ``chip_smoke.py`` and
prints each kernel's issue bound in ms at the transport path's 3,527 metal
atoms and at the reference crossbar's 24,768, for the pairs of the 32 x 32
chunks the kernel does not skip on that data (``--no-widths`` leaves this
out).  Also prints ptxas's registers and shared memory per kernel.
``--dump`` writes the full disassembly and the loops there.
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
_KERNELS = ("fly_matvec_tiles", "fly_matmat_tiles", "fly_pdisp_tiles")


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
    """{label: [(address, opcode, full text), ...]} for the fly kernels."""
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
    """Per-pair counts in the pair loop of one kernel."""
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
    """SM clocks one pair takes at best, per SM: the larger of issue and
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


def width_bounds(costs, clock_mhz):
    """Print the issue bound (ms) of the kernels each width runs, for the
    chunks that width's CB edges leave to compute."""
    import torch

    import chip_smoke as cs
    from devicekmc_tpu_torch.ops.wkb_fly import matvec_col_split
    from fly_accuracy import metal_sets

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    env, sets = metal_sets()
    for tag, (pos, cb) in sets.items():
        st = cs.fly_pair_stats(cb, env["ctol"])
        S = matvec_col_split(pos.shape[0], n_sm)
        rows = [(f"fly_matvec_tiles<1,{S}>", st["live_sym"]),
                (f"fly_matvec_tiles<0,{S}>", st["live"]),
                ("fly_matmat_tiles<24>", st["live"]), ("fly_pdisp_tiles", st["live"])]
        print(f"{tag}: {st['live']} of {st['chunks']} chunks not skipped "
              f"({st['live_sym']} in the upper triangle)")
        for label, chunks in rows:
            print(f"  {label}: issue bound "
                  f"{issue_bound_ms(costs[label], chunks * 1024, clock_mhz):.5f} ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dump", help="directory for the disassembly and the loops")
    ap.add_argument("--no-widths", action="store_true",
                    help="do not work out the bounds at the two widths")
    args = ap.parse_args()

    from devicekmc_tpu_torch.ops import _build

    _build.build(["wkb_fly"])
    res = {kernel_label(k): v for k, v in _build.kernel_resources("wkb_fly").items()}
    costs, text = analyse(_build._lib_path("wkb_fly"))
    if not costs:
        print("cuobjdump not found or no pair loop recognised")
        return 1
    for label in sorted(costs):
        c = costs[label]
        clk, by = clocks_per_pair(c)
        regs, smem = res.get(label, (None, None))
        print(f"{label}: {c['instructions']:.2f} instructions a pair "
              f"({c['mufu']:.2f} MUFU, {c['lds']:.2f} LDS, {c['shfl']:.2f} SHFL, "
              f"{c['ffma']:.2f} FFMA; loop 0x{c['span'][0]:x}-0x{c['span'][1]:x}, "
              f"{c['pairs_per_iteration']} pairs an iteration) -> {clk:.4f} SM clocks a "
              f"pair by {by}; {regs} registers, {smem} bytes shared")
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
        with open(os.path.join(args.dump, "wkb_fly.sass"), "w") as f:
            f.write(text)
        with open(os.path.join(args.dump, "wkb_fly_loops.json"), "w") as f:
            json.dump(costs, f, indent=1)
    import torch

    if torch.cuda.is_available():
        import chip_smoke as cs

        print(cs.gpu_line())
        clock = measure_sm_clock()
        print(f"SM clock under load: {clock:.0f} MHz")
        if not args.no_widths:
            width_bounds(costs, clock)
    return 0


if __name__ == "__main__":
    sys.exit(main())
