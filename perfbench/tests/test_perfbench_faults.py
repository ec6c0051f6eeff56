"""The check catches each fault a cell can have: a run of the harness
on the CPU, past its look for a card, with the timed path broken
underneath, comes out not correct; the same run unbroken comes out
correct."""
from __future__ import annotations

import time

import pytest

from perfbench.tests import _faults
from perfbench.tests._cells import harness, tiny_spec

WORKLOADS = harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]
CASES = [(w["name"], fault.__name__) for w in WORKLOADS
         for fault in _faults.FAULTS[w["config"]]]


def _run(workload: str, fault=None) -> dict:
    spec = tiny_spec(workload)
    if spec["config"]["ranks"] > 1:
        return harness.run_cell(spec, 271828, 0.5, False, time.time(),
                                device_type="cpu", prelude=fault)
    undo = fault() if fault is not None else None
    try:
        return harness.run_cell(spec, 271828, 0.5, False, time.time(),
                                device_type="cpu")
    finally:
        if undo is not None:
            undo()


@pytest.mark.parametrize("workload", sorted(w["name"] for w in WORKLOADS))
def test_perfbench_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload,fault", CASES)
def test_perfbench_fault_is_not_correct(workload, fault):
    res = _run(workload, getattr(_faults, fault))
    assert res["correct"] is False and res["failed"] >= 1
