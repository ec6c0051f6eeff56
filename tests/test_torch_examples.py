"""The port's examples, run on the CPU at small sizes.

``examples/torch_trace_solve.py`` (the port of ``examples/trace_solve.py``)
at n = 2^12, p = 8: the solve matches the sequential oracle (the example
asserts it), every table prints, and the Chrome trace it writes parses
and holds a span for every stage.
"""
import importlib.util
import json
import os

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples")


def load_example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_solve_example(tmp_path, capsys):
    out = tmp_path / "trace.json"
    res = load_example("torch_trace_solve").main(
        [str(out), "--n", str(1 << 12), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "matches the oracle" in printed
    for title in ("span tree:", "model-vs-measured", "worst fill",
                  "destination skew", "metrics registry:"):
        assert title in printed, title
    trace = json.loads(out.read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"solve", "prep", "descend@0", "descend@1", "base@2", "ascend@1",
            "ascend@0", "post"} <= names
    assert res["stats"]["attempts"] >= 1
    assert res["stats"]["telemetry"]["stages"]
