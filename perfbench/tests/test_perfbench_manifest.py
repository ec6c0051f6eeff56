"""BENCHMARK.json keeps to the benchmark's contract, and a cell, a
configuration, a traffic mix and a metric are added as files and entries
that the harness finds by name, with no edit to a file it has."""
from __future__ import annotations

import json
import re
import shutil
import time

from perfbench.tests._cells import ROOT, harness, tiny_spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _metric_cells(metric):
    return set(metric.get("workloads", [w["name"] for w in BENCH["workloads"]]))


def test_perfbench_keys_names_and_units():
    assert set(BENCH) == KEYS["top"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for kind, rows in [("config", BENCH["configs"]),
                       ("workload", BENCH["workloads"]),
                       ("end_to_end", BENCH["end_to_end"]),
                       ("per_layer", BENCH["per_layer"])]:
        names = [r["name"] for r in rows]
        assert len(names) == len(set(names))
        for r in rows:
            assert set(r) - {"workloads"} == KEYS[kind], r["name"]
            assert NAME.match(r["name"]), r["name"]
            for text in ("why", "layer", "source"):
                if text in r:
                    assert 1 <= len(r[text]) <= 200 and "\n" not in r[text]
            if "unit" in r:
                assert UNIT.match(r["unit"]) and r["better"] in (
                    "lower", "higher")
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_perfbench_cells_and_metrics_fit_together():
    configs = {c["name"] for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in cells.values()]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in cells.values()} == configs
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for name in cells:
        reported = {m for m, row in e2e.items() if name in _metric_cells(row)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(name in _metric_cells(m) for m in BENCH["per_layer"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in _metric_cells(m):
            assert cell in cells
            assert cell in _metric_cells(e2e[m["moves"]]), (m["name"], cell)
        layers.setdefault(m["layer"], set()).add(m["name"])
        if "roofline" in m["name"]:
            assert m["unit"] == "%" and re.match(
                r"^[a-z_]+_roofline(\.[a-z0-9]+)?$", m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for w in cells.values():
        assert (ROOT / "perfbench" / "traffic"
                / f"{w['traffic']}.json").is_file()


def test_perfbench_new_entries_are_found_by_name(tmp_path):
    """A throwaway front door (its own instance family), configuration,
    traffic mix, metric and cell, added as new files and entries to a
    copy of the benchmark, run through the harness unchanged."""
    for d in ("configs", "traffic", "metrics", "paths"):
        shutil.copytree(ROOT / "perfbench" / d, tmp_path / "perfbench" / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "perfbench/configs/list-srs-p16.json").read_text())
    cfg.update(name="throwaway-p8", pes=8, path="throwaway")
    (tmp_path / "perfbench/paths/throwaway.py").write_text(
        "from perfbench import instances\n"
        "from perfbench.paths.list import (  # noqa: F401\n"
        "    UNIT, Control, Program, check, sample, sample_index)\n\n\n"
        "def make(traffic, seed):\n"
        "    succ, rank = instances.gen_list(traffic['n'], 0.0, seed=seed,\n"
        "                                    num_lists=traffic['lists'])\n"
        "    return {'succ': succ, 'rank': rank}, traffic['n']\n")
    (tmp_path / "perfbench/configs/throwaway-p8.json").write_text(
        json.dumps(cfg))
    (tmp_path / "perfbench/traffic/throwaway.json").write_text(json.dumps(
        {"n": 1 << 10, "lists": 3}))
    (tmp_path / "perfbench/metrics/calls_made.py").write_text(
        "def read(ctx):\n    return ctx['calls']\n")
    bench["configs"].append({"name": "throwaway-p8", "source": "a test",
                             "file": "perfbench/configs/throwaway-p8.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "list.throwaway",
                               "config": "throwaway-p8",
                               "traffic": "throwaway", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "calls_made", "unit": "calls",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["list.throwaway"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = tiny_spec("list.throwaway", tmp_path)
    assert spec["config"]["pes"] == 8 and spec["traffic"]["lists"] == 3
    res = harness.run_cell(spec, 11, 0.2, False, time.time(),
                           device_type="cpu")
    assert res["correct"]
    assert set(res["metrics"]) == {"calls_made", "peak_gib", "setup_s"}
    assert res["metrics"]["calls_made"]["value"] == res["attempted"]
