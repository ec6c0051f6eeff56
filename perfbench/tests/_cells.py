"""Shared by the benchmark's CPU tests: a cell of BENCHMARK.json at a
size the CPU runs in seconds."""
from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

#: instance size of each front door's cells on the CPU
TINY = {"list": 1 << 12, "tree": 1 << 11}


def tiny_spec(workload: str, root=ROOT) -> dict:
    spec = harness.cell_spec(workload, root)
    n = TINY.get(spec["config"]["path"], spec["traffic"]["n"])
    spec["traffic"] = dict(spec["traffic"], n=n)
    return spec
