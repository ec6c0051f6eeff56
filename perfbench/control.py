#!/usr/bin/env python3
"""The readings that set a cell's limits: its numbers on sound runs of
the program and on its control, one call a seed, in one process.

    python3 perfbench/control.py --workload <cell> --seeds S [S ...] \\
        [--control-seeds S [S ...]]

For each of ``--seeds`` it makes the cell's instance, makes one call of
the program (the first of the process is cold) and holds it to the
reference as a run does; for each of ``--control-seeds`` the same with
the path's ``Control`` in the program's place (the list configurations:
the program's own float32 weight path; the tree configuration: the
reference summed in bfloat16). Prints one JSON line a seed, then the
lower reading (the largest of the program's) and the upper reading (the
smallest of the control's) of every number, and writes them to
``chiprun_out/control_<cell>.json``. The benchmark's own runs do not
run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def readings(workload: str, seeds, variant: str, device_type: str = "cuda",
             root=None) -> list[dict]:
    """The checks of one call a seed: [{"seed", "checks"}, ...]."""
    from perfbench import harness
    spec = harness.cell_spec(workload, *(() if root is None else (root,)))
    rows = []
    for seed in seeds:
        t = time.time()
        res = harness.run_cell(spec, seed, 0.0, False, t, device_type,
                               variant=variant, warm=False)
        rows.append({"seed": seed, "variant": variant,
                     "checks": {k: c["value"]
                                for k, c in res["checks"].items()},
                     "wall_s": time.time() - t})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def summary(program: list[dict], control: list[dict]) -> dict:
    """{number: {"lower": largest sound reading, "upper": smallest
    control reading}} (None where no run read it)."""
    names = sorted({k for r in program + control for k in r["checks"]})

    def pick(rows, fn, k):
        vals = [r["checks"][k] for r in rows if k in r["checks"]]
        return fn(vals) if vals else None
    return {k: {"lower": pick(program, max, k),
                "upper": pick(control, min, k)} for k in names}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("control.py: needs a CUDA device")
    from repro_torch.kernels import build
    build.build()
    program = readings(args.workload, args.seeds, "Program")
    control = readings(args.workload, args.control_seeds, "Control")
    out = {"workload": args.workload, "program": program,
           "control": control, "summary": summary(program, control)}
    print(json.dumps(out["summary"]), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"control_{args.workload}.json").write_text(
        json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
