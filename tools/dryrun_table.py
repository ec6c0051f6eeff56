#!/usr/bin/env python3
"""Summarise the dry run's records as one markdown table.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    python3 tools/dryrun_table.py [dryrun_out]

A row an architecture, a column a shape; each cell gives, at 256 / 512
cards, the predicted peak per card in GB (``*`` past the card's 80 GB),
the roofline's step bound in ms, and the bottleneck. A skipped cell gives
why in a word.
"""
from __future__ import annotations

import collections
import json
import pathlib
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("single", "multi")


def ms(seconds: float) -> str:
    v = seconds * 1e3
    return f"{v:.3g}" if v < 100 else f"{v:.0f}"


def cell(recs: dict) -> str:
    got = [recs[m] for m in MESHES if m in recs]
    done = [r for r in got if "skipped" not in r]
    if not done:
        why = got[0]["skipped"] if got else "no record"
        return "skipped: " + ("full attention" if "sub-quadratic" in why
                              else why)

    def both(fn):
        return " / ".join(fn(r) if "skipped" not in r else "skipped"
                          for r in got)
    peak = both(lambda r: f"{r['memory']['peak_bytes_per_device'] / 1e9:.1f}"
                + ("" if r["memory"]["fits_hbm"] else "*"))
    bound = both(lambda r: ms(r["roofline"]["step_time_bound_s"]))
    necks = {r["roofline"]["bottleneck"].removesuffix("_s") for r in done}
    return f"{peak} GB; {bound} ms; {', '.join(sorted(necks))}"


def rows(out_dir: pathlib.Path) -> list[str]:
    table = collections.defaultdict(dict)
    for path in sorted(out_dir.glob("*.json")):
        arch, shape, tag = path.stem.split("__")[:3]
        table[arch, shape][tag] = json.loads(path.read_text())
    archs = sorted({a for a, _ in table})
    lines = ["| arch | " + " | ".join(SHAPES) + " |",
             "|---|" + "---|" * len(SHAPES)]
    for arch in archs:
        lines.append(f"| {arch} | " + " | ".join(
            cell(table[arch, s]) for s in SHAPES) + " |")
    return lines


def main() -> None:
    out_dir = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "dryrun_out")
    print("\n".join(rows(out_dir)))


if __name__ == "__main__":
    main()
