#!/usr/bin/env python3
"""Where a chip_smoke.py run spends its seconds, and how two runs differ.

    python3 tools/smoke_laps.py run CHECKOUT OUT.log
    python3 tools/smoke_laps.py compare A.log B.log [--top 12]

``run`` runs ``CHECKOUT/chip_smoke.py`` from CHECKOUT (any commit's: the
script is not changed) and writes each line of its standard output and
errors to OUT.log behind the seconds since the start; it prints the last
three lines and exits with the script's code.  ``compare`` lines up two such
logs by their lines with the numbers taken out (so a line of one commit
finds the same line of another), splits each run at the lines both have,
and prints the seconds of every segment in A and in B, the ``--top``
segments where B took longest over A, and both totals.
"""

import argparse
import difflib
import json
import os
import re
import subprocess
import sys
import time

_NUMBER = re.compile(r"[-+]?\d[\d.,eE+-]*")


def run(checkout, out):
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-u", "chip_smoke.py"], cwd=checkout,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    tail = []
    with open(out, "w") as f:
        for line in proc.stdout:
            f.write(f"{time.perf_counter() - t0:10.2f} {line}")
            tail = (tail + [line.rstrip("\n")])[-3:]
    rc = proc.wait()
    for line in tail:
        print(line[:2000], flush=True)
    print(f"chip_smoke.py from {checkout}: exit {rc} after {time.perf_counter() - t0:.1f} s",
          flush=True)
    return rc


def read(path):
    """(key, seconds, text) of each line: the key is the line's first 80
    characters with every number replaced by '#'."""
    rows = []
    for line in open(path, errors="replace"):
        t, _, text = line.strip("\n").lstrip().partition(" ")
        try:
            rows.append((_NUMBER.sub("#", text)[:80], float(t), text))
        except ValueError:
            continue
    return rows


def compare(a_path, b_path, top):
    a, b = read(a_path), read(b_path)
    match = difflib.SequenceMatcher(None, [r[0] for r in a], [r[0] for r in b],
                                    autojunk=False)
    anchors = [(i + k, j + k) for i, j, n in match.get_matching_blocks() for k in range(n)]
    segs, prev = [], (0.0, 0.0, "start")
    for i, j in anchors:
        ta, tb = a[i][1], b[j][1]
        if ta - prev[0] >= 0.5 or tb - prev[1] >= 0.5:
            segs.append(dict(until=a[i][2][:100], a_s=round(ta - prev[0], 2),
                             b_s=round(tb - prev[1], 2)))
            prev = (ta, tb, a[i][2])
    if a and b:
        segs.append(dict(until="end", a_s=round(a[-1][1] - prev[0], 2),
                         b_s=round(b[-1][1] - prev[1], 2)))
    for s in segs:
        s["b_minus_a"] = round(s["b_s"] - s["a_s"], 2)
    worst = sorted(segs, key=lambda s: -s["b_minus_a"])[:top]
    out = dict(a=a_path, b=b_path, total_a=a[-1][1] if a else None,
               total_b=b[-1][1] if b else None, matched_lines=len(anchors),
               segments=segs, most_slower_in_b=worst)
    print(json.dumps(out, indent=1), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("checkout")
    r.add_argument("out")
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    c.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if args.cmd == "run":
        return run(os.path.abspath(args.checkout), args.out)
    compare(args.a, args.b, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
