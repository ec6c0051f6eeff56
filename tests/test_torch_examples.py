"""The port's examples, run on the CPU at small sizes.

``examples/torch_trace_solve.py`` (the port of ``examples/trace_solve.py``)
at n = 2^12, p = 8: the solve matches the sequential oracle (the example
asserts it), every table prints, and the Chrome trace it writes parses
and holds a span for every stage.

``examples/torch_train_100m.py``: llama-100m's parameter count is the
reference config's exactly; ``--tiny`` trains, checkpoints and resumes
through the launcher; the config registry is as found after ``main``
(the reference's example leaves ``configs`` changed), and without
``--ckpt-dir`` the temporary checkpoint directory is gone.

Every port example imports neither jax nor the JAX package, and runs on
the card unless ``--device`` says otherwise. The other examples' parity
with the reference is in ``tests/test_torch_examples_{lists,trees,lm}.py``.
"""
import ast
import json
import math
import os

import pytest
import torch

from _torch_examples import EXAMPLES, load_example
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from repro_torch import configs

PORT_EXAMPLES = ("torch_trace_solve", "torch_quickstart", "torch_euler_tour",
                 "torch_tree_stats", "torch_connectivity",
                 "torch_serve_demo", "torch_train_100m",
                 "torch_dp_compression")


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


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_port_example_imports_no_jax(name):
    with open(os.path.join(EXAMPLES, f"{name}.py")) as f:
        tree = ast.parse(f.read())
    mods = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
            for a in node.names]
    mods += [node.module for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) and node.module]
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert any(m.startswith("repro_torch") for m in mods)


@pytest.mark.parametrize("name", PORT_EXAMPLES[1:])
def test_port_example_runs_on_the_card_by_default(name, monkeypatch):
    """Without ``--device`` an example asks for the card, which raises
    here (no CUDA): nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_example(name).main(["--steps", "1"]
                                if name == "torch_train_100m" else [])


def test_train_100m_parameter_count_is_the_references():
    import jax.numpy as jnp
    import repro.configs.tinyllama_1_1b as ref_tl
    from repro.models import model as ref_model
    from repro.models.params import count_params as ref_count
    from repro_torch.models import model as M
    from repro_torch.models.params import count_params
    ref_cfg = ref_tl.CONFIG.with_(
        name="llama-100m", num_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        dtype=jnp.float32)
    cfg = load_example("torch_train_100m").llama_100m()
    assert count_params(M.param_specs(cfg)) \
        == ref_count(ref_model.param_specs(ref_cfg)) == 125_061_888


def _summary(printed: str) -> dict:
    return json.loads(printed.strip().splitlines()[-1])


def test_train_100m_tiny_checkpoints_and_resumes(tmp_path, capsys):
    example = load_example("torch_train_100m")
    ckpt = tmp_path / "ckpt"
    args = ["--tiny", "--steps", "3", "--ckpt-dir", str(ckpt), "--device",
            "cpu"]
    first = example.main(args)
    summary = _summary(capsys.readouterr().out)
    assert [r["step"] for r in first["history"]] == [3]
    assert all(math.isfinite(r["loss"]) for r in first["history"])
    assert os.listdir(ckpt) == ["step_00000003"]
    assert summary["steps"] == 3 and summary["supervisor"]["checkpoints"] == 1
    # a second call on the directory resumes at step 3 and runs no step
    second = example.main(args)
    summary = _summary(capsys.readouterr().out)
    assert second["history"] == []
    assert summary["steps"] == 3 and summary["supervisor"]["checkpoints"] == 0


def test_train_100m_leaves_configs_as_found(capsys):
    """The full config's path registers llama-100m for the launcher's call
    only (``--steps 0``: the launcher builds the model and its optimizer
    state, runs no step), and its temporary checkpoint directory is gone
    after it."""
    archs = configs.list_archs()
    smoke = configs.get_config("tinyllama-1.1b", smoke=True)
    full = configs.get_config("tinyllama-1.1b")
    res = load_example("torch_train_100m").main(["--steps", "0", "--device",
                                                 "cpu"])
    assert _summary(capsys.readouterr().out)["arch"] == "llama-100m"
    assert res["history"] == [] and res["params"] == 125_061_888
    assert not os.path.exists(res["ckpt_dir"])
    assert configs.list_archs() == archs
    assert configs.get_config("tinyllama-1.1b", smoke=True) == smoke
    assert configs.get_config("tinyllama-1.1b") == full
    with pytest.raises(KeyError):
        configs.get_config("llama-100m")
