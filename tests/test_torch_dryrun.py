"""The port's shape-only dry run (``launch/dryrun.py``) and its layout
modules against the JAX package's.

- ``runtime/sharding.py``: every architecture's full-width parameter specs
  resolved on meshes (16, 16), (2, 16, 16), (32, 8) and (2, 32, 8) under
  the default rules and the ``dp16`` and ``dp`` presets equal the
  reference's ``PartitionSpec``s entry by entry, with equal downgrade
  reports (the reference on ``compat.abstract_mesh``: no devices);
- ``adamw.state_shardings`` with ZeRO-1 on and off, and every family's
  ``cache_axes`` resolved, equal the reference's;
- ``configs/shapes.py``: for every (architecture, shape) cell the inputs'
  shapes and dtypes, ``applicable`` and ``token_count``; the parameters of
  ``abstract_params`` leaf by leaf and ``count_params``; the dry run's
  ``analytic_memory_bytes``, model FLOPs and active parameters (relative
  1e-12);
- argument bytes: seven SMOKE cells on a (4, 2) mesh with patched shapes
  equal the reference's compiled ``memory_analysis()`` exactly, with the
  same arguments kept (the reference compiles in children with 8 CPU
  devices; its ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so
  only a child imports it);
- FLOPs: a dense decoder's forward counts its closed-form sum of 2·M·N·K;
  with remat off a training step counts 3x the forward;
- collectives: granite-moe SMOKE under a (4, 2) mesh counts the
  ``all_to_all`` and ``psum`` calls and bytes a real CPU step makes;
- the command line at tinyllama-1.1b's full width (a 15 GB layout) runs
  in a child whose resident memory stays under 1.5 GiB;
- the dispatch modes make autograd accumulate gradients out of place,
  which ``StepMemory`` counts as the plain run's in-place sum: its peak
  and final bytes of a forward and backward equal the CPU allocator's on
  real tensors.
"""
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_reference_child import run_reference
from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401
from repro_torch import configs
from repro_torch.configs import shapes as SH
from repro_torch.core.listrank import sim_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models.params import count_params, is_spec
from repro_torch.optim import adamw
from repro_torch.runtime import context
from repro_torch.runtime import sharding as shlib
from repro_torch.train import steps as train_steps

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCHS = configs.list_archs()
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")),
          ((2, 32, 8), ("pod", "data", "model")))
RULE_SETS = ("default", "dp16", "dp")
#: the seven cells whose compiled argument bytes the port must equal:
#: (arch, shape, kind, seq, batch) on a (4, 2) ("data", "model") mesh
ARG_CELLS = (("tinyllama-1.1b", "train_4k", "train", 64, 8),
             ("tinyllama-1.1b", "decode_32k", "decode", 128, 8),
             ("granite-moe-1b-a400m", "train_4k", "train", 64, 8),
             ("granite-moe-1b-a400m", "decode_32k", "decode", 128, 8),
             ("hymba-1.5b", "prefill_32k", "prefill", 128, 8),
             ("seamless-m4t-medium", "decode_32k", "decode", 128, 8),
             ("mamba2-130m", "decode_32k", "decode", 128, 8))
ARG_MESH = (4, 2)
#: bytes XLA's output size adds for its output tuple: one pointer a leaf
TUPLE_ENTRY_BYTES = 8


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's compiled cells and its formulas, from children."""
    jobs = {("cell",) + c[:2]: ("dryrun_cell", c + (ARG_MESH,))
            for c in ARG_CELLS}
    jobs["formulas"] = ("dryrun_formulas", (
        [(a, s) for a in ARCHS for s in SH.SHAPES],))
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), devices=8,
                         procs=3)


def ref_rules(name: str) -> dict:
    """The rule table the dry run resolves parameters with (the port's
    presets; ``test_rule_presets_are_the_references`` holds them to the
    reference's)."""
    rules = dict(shlib.DEFAULT_RULES)
    if name != "default":
        rules.update(D.RULE_PRESETS[name])
    return rules


def ref_specs(shardings) -> list:
    import jax
    from jax.sharding import NamedSharding
    return [tuple(s.spec) for s in jax.tree.leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))]


def port_specs(tree) -> list:
    return [s for _, s in shlib.flatten_with_path(tree, D._is_spec)]


def dtype_name(dt) -> str:
    return str(dt).replace("torch.", "") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


def test_rule_presets_are_the_references(ref):
    assert D.RULE_PRESETS == ref["formulas"]["presets"]
    assert D.BATCH_AXES == ref["formulas"]["batch_axes"]


@pytest.mark.parametrize("rules", RULE_SETS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_shardings_equal_the_references(arch, rules):
    from repro import compat
    from repro import configs as ref_configs
    from repro.models import model as ref_M
    from repro.runtime import sharding as ref_sh
    for shape, names in MESHES:
        am = compat.abstract_mesh(shape, names)
        rep_ref = ref_sh.ResolveReport()
        want = ref_specs(ref_sh.tree_shardings(
            ref_M.param_specs(ref_configs.get_config(arch)), am,
            ref_rules(rules), rep_ref))
        rep = shlib.ResolveReport()
        got = port_specs(shlib.tree_shardings(
            M.param_specs(configs.get_config(arch)), sim_mesh(shape, names),
            ref_rules(rules), rep))
        assert got == want, (shape, rules)
        assert rep.downgrades == rep_ref.downgrades, (shape, rules)
        assert list(rep.chosen) == list(rep_ref.chosen)


def test_resolve_spec_cases():
    mesh = sim_mesh((2, 4), ("data", "model"))
    rep = shlib.ResolveReport()
    # the first candidate that divides and whose axes are unused
    assert shlib.resolve_spec((8, 6), ("experts", "mlp"), mesh,
                              report=rep, name="w") == ("data", None)
    assert rep.downgrades == ["w[mlp]: 6 not divisible/available for "
                              "('model',) -> replicated"]
    assert shlib.resolve_spec((4, 8), ("batch", "heads"), mesh) == \
        ("data", "model")
    assert shlib.resolve_spec((3,), ("experts",), mesh) == (None,)
    assert shlib.shard_shape((8, 8, 5), ("data", ("model",), None),
                             mesh) == (4, 2, 5)
    assert shlib.shard_shape((8, 12), (("data", "model"), None), mesh) == \
        (1, 12)
    with pytest.raises(ValueError):
        shlib.shard_shape((6,), ("model",), mesh)
    assert shlib.shard_bytes((8, 12), 2, ("data", "model"), mesh) == \
        4 * 3 * 2


@pytest.mark.parametrize("arch", ARCHS)
def test_state_shardings_and_cache_axes_equal_the_references(arch):
    import jax
    from repro import compat
    from repro import configs as ref_configs
    from repro.models import model as ref_M
    from repro.optim import adamw as ref_adamw
    from repro.runtime import sharding as ref_sh
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    for shape, names in MESHES:
        am, sm = compat.abstract_mesh(shape, names), sim_mesh(shape, names)
        for zero1 in (True, False):
            want = ref_specs(ref_adamw.state_shardings(
                ref_M.param_specs(rcfg), am, ref_adamw.AdamWConfig(),
                zero1=zero1))
            got = port_specs(adamw.state_shardings(
                M.param_specs(cfg), sm, adamw.AdamWConfig(), zero1=zero1))
            assert got == want, (shape, zero1)
        # the cache, resolved leaf by leaf as the dry runs resolve it
        rep_ref, rep = ref_sh.ResolveReport(), shlib.ResolveReport()
        cache_ref = jax.eval_shape(lambda: ref_M.init_cache(rcfg, 128, 4096))
        paths = jax.tree_util.tree_flatten_with_path(cache_ref)[0]
        axes_ref = jax.tree.leaves(ref_M.cache_axes(rcfg), is_leaf=lambda x: (
            type(x) is tuple and all(e is None or isinstance(e, str)
                                     for e in x)))
        want = [tuple(ref_sh.resolve_spec(
            leaf.shape, ax, am, name="cache/" + "/".join(
                str(getattr(k, "key", k)) for k in path), report=rep_ref))
            for (path, leaf), ax in zip(paths, axes_ref)]
        with torch._subclasses.fake_tensor.FakeTensorMode():
            cache = M.init_cache(cfg, 128, 4096, "cpu")
        got = port_specs(D._tree_shardings_from_axes(
            cache, M.cache_axes(cfg), sm, rep, "cache"))
        assert got == want, shape
        assert rep.downgrades == rep_ref.downgrades, shape
        assert [tuple(t.shape) for t in jax.tree.leaves(cache_ref)] == \
            [tuple(t.shape) for _, t in shlib.flatten_with_path(
                cache, D._is_tensor)]


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_and_abstract_params_equal_the_references(ref, arch):
    import jax
    from repro import configs as ref_configs
    from repro.configs import shapes as ref_SH
    from repro.models import model as ref_M
    from repro.models.params import count_params as ref_count
    assert SH.SHAPES == {k: SH.ShapeSpec(**vars(v))
                         for k, v in ref_SH.SHAPES.items()}
    assert SH.VLM_PATCHES == ref_SH.VLM_PATCHES
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    # parameters, leaf by leaf in the reference's flattening order
    flat = jax.tree_util.tree_flatten_with_path(ref_M.abstract(rcfg))[0]
    want = [("/".join(k.key for k in path), tuple(x.shape),
             dtype_name(x.dtype)) for path, x in flat]
    params = M.abstract(cfg)
    got = [(name, tuple(t.shape), dtype_name(t.dtype)) for name, t in
           shlib.flatten_with_path(params, D._is_tensor)]
    assert got == want
    assert all(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               for _, t in shlib.flatten_with_path(params, D._is_tensor))
    assert count_params(M.param_specs(cfg)) == \
        ref_count(ref_M.param_specs(rcfg))
    assert all(is_spec(s) for s in shlib.flatten_with_path(
        M.param_specs(cfg), is_spec) for s in [s[1]])
    for shape_name in SH.SHAPES:
        assert SH.applicable(cfg, shape_name) == \
            ref_SH.applicable(rcfg, shape_name)
        assert SH.token_count(cfg, shape_name) == \
            ref_SH.token_count(rcfg, shape_name)
        kw_ref, kind_ref = ref_SH.input_specs(rcfg, shape_name)
        kw, kind = SH.input_specs(cfg, shape_name)
        assert kind == kind_ref
        flat_ref = jax.tree_util.tree_flatten_with_path(kw_ref)[0]
        flat = shlib.flatten_with_path(kw, lambda x: isinstance(
            x, (torch.Tensor, int)))
        assert [(n, tuple(t.shape), dtype_name(t.dtype)) if
                isinstance(t, torch.Tensor) else (n, t) for n, t in flat] == \
            [("/".join(str(k.key) for k in path),
              tuple(x.shape), dtype_name(x.dtype))
             if hasattr(x, "shape") else
             ("/".join(str(k.key) for k in path), x)
             for path, x in flat_ref]
        # the dry run's formulas
        want = ref["formulas"]["cells"][arch, shape_name]
        n_params = count_params(M.param_specs(cfg))
        active = D.active_params(cfg, n_params)
        assert (n_params, active) == (want["params"], want["active"])
        assert SH.token_count(cfg, shape_name) == want["tokens"]
        assert (6 if kind == "train" else 2) * active * want["tokens"] == \
            want["model_flops"]
        for chips, value in want["bytes_model"].items():
            got = D.analytic_memory_bytes(cfg, shape_name, kind, chips,
                                          n_params, active)
            assert got == pytest.approx(value, rel=1e-12)


@pytest.mark.parametrize("cell", ARG_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_argument_bytes_equal_the_compiled_references(ref, cell,
                                                      monkeypatch):
    arch, shape_name, kind, seq, batch = cell
    monkeypatch.setitem(SH.SHAPES, shape_name,
                        SH.ShapeSpec(shape_name, seq, batch, kind))
    rec, _ = D.lower_cell(arch, shape_name,
                          cfg_override=configs.get_config(arch, smoke=True),
                          mesh=sim_mesh(ARG_MESH, ("data", "model")))
    want = ref[("cell",) + cell[:2]]
    mem = rec["memory"]
    assert mem["argument_bytes_per_device"] == want["argument"]
    assert mem["alias_bytes_per_device"] == want["alias"]
    assert mem["kept_input_indices"] == want["kept"]
    assert rec["sharding_downgrades"] == want["downgrades"]
    # XLA's output size adds a pointer a leaf of its output tuple
    assert want["output"] == mem["output_bytes_per_device"] + \
        TUPLE_ENTRY_BYTES * mem["output_leaves"]


def test_seamless_decode_prunes_the_encoder(ref, monkeypatch):
    """A decode step never reads the encoder stack: its parameters are
    left out of the argument bytes, as ``keep_unused=False`` leaves
    them out of the reference's executable."""
    monkeypatch.setitem(SH.SHAPES, "decode_32k",
                        SH.ShapeSpec("decode_32k", 128, 8, "decode"))
    arch = "seamless-m4t-medium"
    rec, _ = D.lower_cell(arch, "decode_32k",
                          cfg_override=configs.get_config(arch, smoke=True),
                          mesh=sim_mesh(ARG_MESH, ("data", "model")))
    pruned = rec["memory"]["pruned_inputs"]
    assert pruned and all(n.startswith(("params/enc_", "params/prefix_proj"))
                          for n in pruned)
    assert {n for n in pruned if n.startswith("params/enc_layers")}
    assert rec["memory"]["argument_bytes_per_device"] < \
        rec["memory"]["resident_input_bytes_per_device"]


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "gemma2-2b",
                                  "qwen2.5-14b"))
def test_flops_are_the_closed_form(arch, monkeypatch):
    cfg = configs.get_config(arch, smoke=True).with_(use_kernels=False,
                                                     remat=False)
    b, l = 8, 64
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    params = M.abstract(cfg, mode)
    with mode:
        tokens = torch.empty((b, l), dtype=torch.int32)
        with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
            M.forward(params, {"tokens": tokens}, cfg)
    t, d, dh = b * l, cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    layer = (2 * t * d * hq * dh + 2 * 2 * t * d * hkv * dh  # q; k, v
             + 2 * t * hq * dh * d                           # o
             + 2 * 2 * b * hq * l * l * dh                   # scores, PV
             + 3 * 2 * t * d * cfg.d_ff)                     # SwiGLU
    forward = cfg.num_layers * layer + 2 * t * d * cfg.padded_vocab
    assert fc.get_total_flops() == forward
    monkeypatch.setitem(SH.SHAPES, "train_4k",
                        SH.ShapeSpec("train_4k", l, b, "train"))
    one = sim_mesh((1, 1), ("data", "model"))
    rec, _ = D.lower_cell(arch, "train_4k", remat=False, mesh=one,
                          cfg_override=configs.get_config(arch, smoke=True))
    assert rec["cost"]["flops_per_device"] == 3 * forward
    rec, _ = D.lower_cell(arch, "train_4k", remat=True, mesh=one,
                          cfg_override=configs.get_config(arch, smoke=True))
    # remat recomputes each layer's forward up to its last saved tensor
    # (torch's early stop): all but the SwiGLU's down projection, whose
    # output a post-norm (gemma2) saves
    recompute = layer if cfg.post_norms else layer - 2 * t * cfg.d_ff * d
    assert rec["cost"]["flops_per_device"] == \
        3 * forward + cfg.num_layers * recompute


def test_moe_collectives_equal_a_real_steps(monkeypatch):
    arch = "granite-moe-1b-a400m"
    cfg = configs.get_config(arch, smoke=True)
    b, l = 8, 64
    monkeypatch.setitem(SH.SHAPES, "train_4k",
                        SH.ShapeSpec("train_4k", l, b, "train"))
    mesh = sim_mesh((4, 2), ("data", "model"))
    rec, _ = D.lower_cell(arch, "train_4k", cfg_override=cfg, mesh=mesh)
    # the same step on real tensors
    real = cfg.with_(remat=True, use_kernels=False, remat_policy="nothing")
    params = M.init(real, torch.Generator("cpu").manual_seed(0), "cpu")
    opt = adamw.init(params, adamw.AdamWConfig())
    gen = torch.Generator("cpu").manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (b, l), generator=gen,
                        dtype=torch.int32)
    with context.use_mesh(mesh) as ctx:
        train_steps.train_step(params, opt, {"tokens": tok, "labels": tok},
                               real, train_steps.TrainConfig())
    tr = ctx.transport("cpu")
    coll = rec["collectives"]
    assert coll["counts"] == dict(sorted(tr.counts.items()))
    assert coll["counts"]["all_to_all"] > 0 and coll["counts"]["psum"] > 0
    assert coll["all-to-all"] == tr.nbytes["all_to_all"]
    assert coll["all-reduce"] == tr.nbytes["psum"]
    assert {(c["collective"], tuple(c["axes"])): c["bytes_per_device"]
            for c in coll["by_axes"]} == dict(tr.axes_nbytes)
    # the expert axis crosses nodes: InfiniBand; the model axis: NVLink
    for c in coll["by_axes"]:
        assert c["link_bytes_per_s"] == mesh_lib.link_bandwidth(
            mesh, c["axes"])


def test_production_mesh_and_links():
    single = mesh_lib.make_production_mesh()
    multi = mesh_lib.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.axis_sizes) == (("data", "model"),
                                                      (32, 8))
    assert (multi.axis_names, multi.axis_sizes) == (
        ("pod", "data", "model"), (2, 32, 8))
    assert mesh_lib.link_bandwidth(single, ("model",)) == mesh_lib.NVLINK_BW
    assert mesh_lib.link_bandwidth(single, ("data",)) == mesh_lib.IB_BW
    assert mesh_lib.link_bandwidth(multi, ("pod", "data")) == mesh_lib.IB_BW
    assert mesh_lib.PEAK_FLOPS_BF16 == 989e12
    assert mesh_lib.HBM_BW == 3.35e12


def test_command_line_allocates_nothing(tmp_path):
    """tinyllama-1.1b's train_4k on a (1, 1) mesh: a 15 GB layout of
    parameters and optimizer state, traced in a child whose maximum
    resident memory stays under 1.5 GiB; the record is complete."""
    code = ("import resource, runpy, sys; sys.argv = sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__'); print('maxrss_kb', "
            "resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)")
    env = one_thread_env(PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-c", code, "dryrun", "--arch", "tinyllama-1.1b",
         "--shape", "train_4k", "--mesh", "1x1", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300, check=True)
    rss_kb = int(out.stdout.rsplit("maxrss_kb", 1)[1])
    assert rss_kb * 1024 < 1.5 * 2 ** 30
    rec = json.loads((tmp_path / "tinyllama-1.1b__train_4k__mesh1x1.json")
                     .read_text())
    mem = rec["memory"]
    layout = 1_101_096_960 * (2 + 3 * 4)  # bf16 weights, m, v, master
    assert mem["resident_input_bytes_per_device"] >= layout
    assert mem["argument_bytes_per_device"] >= layout
    assert mem["peak_bytes_per_device"] > mem["argument_bytes_per_device"]
    for key in ("output_bytes_per_device", "temp_bytes_per_device",
                "alias_bytes_per_device", "forward_backward_bytes_per_device",
                "update_bytes_per_device"):
        assert mem[key] > 0, key
    assert rec["cost"]["flops_per_device"] > rec["roofline"]["model_flops"]
    assert rec["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                             "collective_s")
    assert rec["chips"] == 1 and rec["mesh"] == "1x1"
    assert set(rec["no_counterpart"]) >= {"probe_info", "--no-probes"}
    assert rec["trace_s"] >= 0 and rec["params"] == 1_101_096_960


def test_modes_accumulate_gradients_out_of_place():
    """Without a dispatch mode autograd accumulates a stacked weight's
    per-layer gradients in place (``add_``); under one (``StepMemory``,
    fake tensors) it adds out of place, so two full-size buffers are live
    at each accumulation: ``StepMemory`` counts such an add as the plain
    run's in-place sum (next test)."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        w = torch.randn(4, 64, 64).requires_grad_()
        x = torch.randn(8, 64)
        loss = sum((x @ w[i]).sum() for i in range(4))
        return torch.autograd.grad(loss, [w])

    def adds(mode):
        with profile(activities=[ProfilerActivity.CPU]) as prof, mode:
            step()
        return sorted(e.name for e in prof.events()
                      if e.name in ("aten::add", "aten::add_"))
    plain = adds(contextlib.nullcontext())
    traced = adds(D.StepMemory())
    assert plain.count("aten::add_") == 3          # the engine, in place
    assert "aten::add_" not in traced and "aten::add" in traced


def _cpu_allocator_peak(fn) -> tuple[int, int]:
    """(peak, end) of the bytes the CPU allocator holds over ``fn()``
    beyond what it held before, from the profiler's memory events."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    live = peak = 0
    for _, nbytes in sorted((e["args"]["Ev Idx"], e["args"]["Bytes"])
                            for e in events if e.get("name") == "[memory]"):
        live += nbytes
        peak = max(peak, live)
    del out
    return peak, live


@pytest.mark.parametrize("remat", (True, False), ids=("remat", "no_remat"))
@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "granite-moe-1b-a400m",
                                  "mamba2-130m"))
@pytest.mark.parametrize("shape", ((1, 8), (4, 64)), ids=("1x8", "4x64"))
def test_step_memory_matches_the_cpu_allocator(arch, remat, shape):
    """A forward and backward's peak and final bytes on fake tensors
    (``StepMemory``) against the CPU allocator's over the same call on
    real tensors: the final bytes (the gradients) equal, the peak within
    1e-4 (a few scalar temporaries). At 1 x 8 tokens the stacked
    gradients' accumulation sets the peak."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models.params import leaves
    cfg = configs.get_config(arch, smoke=True).with_(remat=remat,
                                                     use_kernels=False)
    b, l = shape
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.randint(0, cfg.vocab_size, (b, l), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(1))
    real = _cpu_allocator_peak(lambda: train_steps.value_and_grad(
        params, {"tokens": tok, "labels": tok}, cfg,
        train_steps.TrainConfig()))
    mode = FakeTensorMode()
    fake = M.abstract(cfg, mode)
    with mode:
        ftok = torch.empty((b, l), dtype=torch.int32)
    tracker = D.StepMemory()
    tracker.add_inputs(leaves(fake) + [ftok])
    with mode, tracker:
        tracker.enter_phase("forward_backward")
        out = train_steps.value_and_grad(fake, {"tokens": ftok,
                                                "labels": ftok},
                                         cfg, train_steps.TrainConfig())
    assert tracker.live == real[1]
    assert tracker.peaks["forward_backward"] == pytest.approx(real[0],
                                                              rel=1e-4)
    del out
