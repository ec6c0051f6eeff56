#!/usr/bin/env python3
"""Runs of one cell as the driver makes them, and their spread.

    python3 perfbench/spread.py --workload <cell> --seeds S [S ...] \\
        [--seconds N] [--trace 0|1] [--sets 1|2] [--tag NAME]

Each run is a new process of ``perfbench/run.py`` with its own seed;
with ``--sets 2`` the seeds run twice, as the driver's two sets. Every
result line is appended to ``chiprun_out/runs_<tag>.jsonl``; then, for
each metric and set, the median and the spread: the distance between
the first and third quartile (``statistics.quantiles(values, n=4)``) as
a share of the median.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=int, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = args.seconds or bench["run_seconds"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = out / f"runs_{args.tag or args.workload}.jsonl"
    sets = []
    for s in range(args.sets):
        rows = []
        for seed in args.seeds:
            t = time.time()
            proc = subprocess.run(
                [sys.executable, "perfbench/run.py", "--workload",
                 args.workload, "--seed", str(seed), "--seconds",
                 str(seconds), "--trace", str(args.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.time() - t
            lines = proc.stdout.strip().splitlines()
            result = json.loads(lines[-1]) if proc.returncode == 0 and \
                lines else None
            row = {"workload": args.workload, "set": s, "seed": seed,
                   "trace": args.trace, "seconds": seconds, "rc":
                   proc.returncode, "wall_s": wall, "result": result}
            if result is None or not result["correct"]:
                row["stderr"] = proc.stderr[-3000:]
            with log.open("a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
            rows.append(row)
        sets.append(rows)
    for s, rows in enumerate(sets):
        good = [r["result"] for r in rows if r["result"]]
        names = sorted({k for r in good for k in r["metrics"]})
        for k in names:
            vals = [r["metrics"][k]["value"] for r in good
                    if k in r["metrics"]]
            if len(vals) >= 2:
                print(f"set {s} {k}: median {statistics.median(vals):.6g} "
                      f"spread {100 * spread(vals):.3f} % over {len(vals)} "
                      f"runs; runs {vals}", flush=True)
        print(f"set {s}: correct {sum(r['correct'] for r in good)} of "
              f"{len(rows)}", flush=True)


if __name__ == "__main__":
    main()
