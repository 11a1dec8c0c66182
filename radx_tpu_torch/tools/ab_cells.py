"""Parent against change on benchmark cells, in turns, on one card.

    python -m radx_tpu_torch.tools.ab_cells --parent DIR --change DIR \\
        --cells NAME[,NAME...] --pairs 10 --seed S [--out DIR]

Runs ``python -m benchmark.run --cells CELLS --seed S`` from the root of
each checkout (a process of its own, which builds that checkout's kernels),
pair by pair: parent then change in even pairs, change then parent in odd
ones.  Prints each run's ``rows_per_s`` and ``peak_device_gib`` per cell as
one JSON line, then per cell one summary line: each side's median and
quartiles of ``rows_per_s``, the parent's own spread (q3 - q1 over its
median), the pairs the change won (ties count for neither), the change's
median over the parent's, and each side's highest peak.  A gain holds where
the change wins at least nine tenths of the pairs and the medians differ by
more than the parent's spread.  Exits 1 when a run fails (its gate or its
exit code).  ``--out`` keeps each run's output (default: none kept).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def quartiles(xs):
    """(q1, median, q3) of a list of numbers."""
    if len(xs) == 1:
        return xs[0], xs[0], xs[0]
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return q[0], q[1], q[2]


def summarize(parent, change):
    """Per cell, from two lists of runs ({cell: {"rows_per_s", ...}}) of
    equal length, paired in order: the summary of the module docstring."""
    out = {}
    for cell in parent[0]:
        p = [r[cell]["rows_per_s"] for r in parent]
        c = [r[cell]["rows_per_s"] for r in change]
        pq, cq = quartiles(p), quartiles(c)
        spread = (pq[2] - pq[0]) / pq[1]
        wins = sum(b > a for a, b in zip(p, c))
        ratio = cq[1] / pq[1]
        out[cell] = {
            "pairs": len(p), "change_wins": wins,
            "parent_rows_per_s": dict(zip(("q1", "median", "q3"), pq)),
            "change_rows_per_s": dict(zip(("q1", "median", "q3"), cq)),
            "parent_spread": spread, "change_over_parent": ratio,
            "gain": wins * 10 >= 9 * len(p) and ratio - 1 > spread,
            "parent_peak_gib": max(r[cell]["peak_device_gib"] for r in parent),
            "change_peak_gib": max(r[cell]["peak_device_gib"] for r in change),
        }
    return out


def run_once(root, cells, seed, log):
    """One benchmark run from ``root``: its last line's workloads."""
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--cells", cells, "--seed",
         str(seed), "--out", os.path.join(root, "benchmark", "out")],
        cwd=root, capture_output=True, text=True)
    if log:
        with open(log, "w") as f:
            f.write(proc.stdout + proc.stderr)
    lines = proc.stdout.strip().splitlines()
    doc = json.loads(lines[-1]) if lines else {}
    if proc.returncode or not doc.get("ok"):
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise SystemExit(f"benchmark run in {root} failed "
                         f"(exit {proc.returncode})")
    return doc["workloads"]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m radx_tpu_torch.tools.ab_cells",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--cells", required=True)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.out:
        os.makedirs(a.out, exist_ok=True)
    runs = {"parent": [], "change": []}
    for i in range(a.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            log = (os.path.join(a.out, f"pair{i}_{side}.log") if a.out
                   else None)
            w = run_once(getattr(a, side), a.cells, a.seed, log)
            runs[side].append(w)
            print(json.dumps({"pair": i, "side": side, "workloads": {
                n: {k: v.get(k) for k in ("rows_per_s", "peak_device_gib")}
                for n, v in w.items()}}), flush=True)
    for cell, s in summarize(runs["parent"], runs["change"]).items():
        print(json.dumps({"cell": cell, **s}), flush=True)


if __name__ == "__main__":
    main()
