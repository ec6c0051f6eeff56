#!/usr/bin/env python3
"""The sizing step of the list cells, on one card.

    python3 perfbench/sizing.py [--log2n 24 26 ...] [--seed S] [--trees]

For each n, on List(n, gamma = 1) with list-srs-p16's solver: a cold
call, two warm calls (wall each), the peak device memory of a warm call,
the idle share of one more call under the profiler, and every output
held to the plain reference. ``--trees`` does the same for the tree
cells' two instances. Prints one JSON line per size and writes them all
to ``chiprun_out/sizing.json``. ``--survey S ...`` instead makes one
cold call a seed at each size, with its attempts, escalations, peak and
check (``chiprun_out/survey.json``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def measure(path, inst, config, dev, torch):
    from perfbench import devtrace
    from repro_torch.core.listrank import sim_mesh
    prog = path.Program(inst, sim_mesh(config["pes"]), config, dev)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        out, stats = prog.call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        del out
    peak = torch.cuda.max_memory_allocated(dev)
    (out, stats), events, _, _, wall = devtrace.window(prog.call, torch, dev)
    busy = sum(b - a for a, b in devtrace.busy_intervals(events)) / 1e6
    numbers = path.check(inst, [path.sample(out, None)] if path.UNIT ==
                         "nodes" else [], out, None, dev)
    return {"cold_s": walls[0], "warm_s": walls[1:], "peak_gib": peak / 2**30,
            "profiled_s": wall, "idle_pct": 100 * (1 - busy / wall),
            "rounds": stats["rounds"] // config["pes"],
            "stages": stats["stage_wall_s"],
            "checks": {k: v[0] for k, v in numbers.items()}}


def survey(log2n: int, seeds, config, dev, torch) -> list[dict]:
    """One cold call of List(2^log2n, gamma = 1) a seed: its wall,
    peak, attempts and escalations, and its outputs held to the
    reference; a call that raises is recorded with its error."""
    from perfbench.paths import list as path
    from repro_torch.core.listrank import sim_mesh
    rows = []
    for seed in seeds:
        inst, _ = path.make({"n": 1 << log2n, "gamma": 1.0}, seed)
        prog = path.Program(inst, sim_mesh(config["pes"]), config, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        row = {"log2n": log2n, "seed": seed}
        t = time.perf_counter()
        try:
            out, stats = prog.call()
            torch.cuda.synchronize()
            row.update(wall_s=time.perf_counter() - t,
                       attempts=stats["attempts"],
                       scales=stats["scales_log"],
                       rounds=stats["rounds"] // config["pes"])
            row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
            row["checks"] = {k: v[0] for k, v in path.check(
                inst, [], out, None, dev).items()}
            del out
        except Exception as e:  # the program's failure is the reading
            row.update(wall_s=time.perf_counter() - t,
                       error=f"{type(e).__name__}: {str(e)[:300]}")
            row["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        del prog, inst
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, nargs="*", default=[24, 26])
    ap.add_argument("--seed", type=int, default=20261018)
    ap.add_argument("--trees", action="store_true")
    ap.add_argument("--survey", type=int, nargs="*", default=None,
                    help="seeds of a survey of one call each at each --log2n")
    args = ap.parse_args()
    import torch
    from perfbench.paths import list as list_path, tree as tree_path
    dev = torch.device("cuda", 0)
    cfg_dir = ROOT / "perfbench" / "configs"
    if args.survey is not None:
        config = json.loads((cfg_dir / "list-srs-p16.json").read_text())
        rows = [r for k in args.log2n
                for r in survey(k, args.survey, config, dev, torch)]
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "survey.json").write_text(json.dumps(rows, indent=1))
        return
    rows = []
    runs = [("list", k, list_path, "list-srs-p16") for k in args.log2n]
    if args.trees:
        runs += [("gnm", 22, tree_path, "tree-euler-p16"),
                 ("rgg", 22, tree_path, "tree-euler-p16")]
    for kind, k, path, cfg_name in runs:
        config = json.loads((cfg_dir / f"{cfg_name}.json").read_text())
        t = time.perf_counter()
        if kind == "list":
            inst, _ = path.make({"n": 1 << k, "gamma": 1.0}, args.seed)
        else:
            inst, _ = path.make({"n": 1 << k, "locality": kind == "rgg"},
                                args.seed)
        row = {"kind": kind, "log2n": k, "instance_s": time.perf_counter() - t}
        row.update(measure(path, inst, config, dev, torch))
        del inst
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sizing.json").write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
