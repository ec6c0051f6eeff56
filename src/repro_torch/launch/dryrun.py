"""Shape-only dry run: drive every (arch x shape) cell's step on fake
tensors at its global shapes for an H100 mesh, with nothing allocated.

The port's counterpart of the JAX package's ``repro.launch.dryrun``,
which lowers and compiles each cell for a TPU pod. Here the step is the
port's own (``train_steps.train_step``'s two halves, ``model.prefill``,
``model.decode_step``), run once under ``FakeTensorMode`` (shapes and
dtypes, no storage) on the mesh of ``launch/mesh.py``'s
``make_production_mesh``: (32, 8) for 256 cards, (2, 32, 8) for 512. The
config is the reference's: remat, ``use_kernels=False`` (no kernel
launches, nothing touches a card), remat policy ``nothing``. Per cell:

  - the layout: every parameter, optimizer state (ZeRO-1), batch and
    cache leaf resolved to a spec (``runtime/sharding.py``), with the
    reference's downgrade report;
  - memory per device: the argument bytes are the local shard bytes of
    the inputs the step reads (inputs it never reads are pruned, as
    ``jax.jit``'s ``keep_unused=False`` prunes them); the output bytes
    are its outputs under the same specs, the alias bytes the donated
    inputs they replace; the peak is what the port holds: its inputs
    plus the live bytes of the storages the step allocates, followed
    through the run by :class:`StepMemory`. Activations (the forward and
    backward) are divided by the cards the batch is sharded over, the
    optimizer update's bytes scaled to the per-device state; ``temp`` is
    what the peak holds beyond arguments and outputs;
  - FLOPs per device: ``FlopCounterMode`` over the same step, divided by
    the cards. Nothing is scanned, so every layer is counted: no probe,
    no extrapolation;
  - collectives: what the port's own step issues, counted by the mesh
    context's ``CountingTransport`` (the expert-parallel MoE's
    ``all_to_all`` and ``psum``), with bytes per card by mesh axis. The
    port has no SPMD partitioner, so the collectives GSPMD would insert
    for a ``model``-sharded dense layout have no counterpart here
    (``collectives["scope"]`` says so);
  - the roofline's three terms, priced with the H100's constants
    (``launch/mesh.py``): each collective by its axes, NVLink inside a
    node, InfiniBand between nodes.

The reference's ``probe_info``, HLO byte counts and ``--no-probes`` have
no counterpart (``no_counterpart`` in each record); ``trace_s`` replaces
``lower_s`` and ``compile_s``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
      [--multi-pod] [--mesh 1x1] [--out dryrun_out]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--jobs 2]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import shapes as SH
from repro_torch.core.listrank.transport import sim_mesh
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models.params import count_params
from repro_torch.optim import adamw
from repro_torch.runtime import context as runtime_context
from repro_torch.runtime import sharding as shlib
from repro_torch.train import steps as train_steps

#: the fake tensors' device: the plain CPU path of every layer (the
#: model has no CUDA-only branch on it)
FAKE_DEVICE = "cpu"
#: where the records go unless ``--out`` says otherwise (listed in
#: .gitignore)
OUT_DIR = "dryrun_out"
#: the reference's collective names, each the port's counterpart
COLLECTIVES = {"all-to-all": "all_to_all", "all-reduce": "psum",
               "all-gather": "all_gather", "reduce-scatter": None,
               "collective-permute": None}
COLLECTIVE_SCOPE = (
    "the collectives the port's step issues through the mesh context's "
    "transport (the expert-parallel MoE's all_to_all and psum), counted at "
    "run time; the port has no SPMD partitioner, so the all-gathers, "
    "reduce-scatters and all-reduces GSPMD inserts for the model-sharded "
    "dense layout and the data-parallel gradient reduction are not counted")
NO_COUNTERPART = {
    "probe_info": "no probes: the port runs every layer of the full depth",
    "bytes_per_device_hlo": "no HLO: the port's memory term is the model's",
    "scan_flops_per_device": "no scan: layers are a Python loop",
    "collective_bytes": "no post-SPMD HLO to parse (see collectives.scope)",
    "--no-probes": "no probes to skip",
}

BATCH_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "prefix_embeds": ("batch", "seq", None),
    "enc_embeds": ("batch", "seq", None),
}

#: the logits' layout (the reference leaves it to the compiler)
LOGITS_AXES = ("batch", None, "vocab")


# ---------------------------------------------------------------------------
# following the step's storages
# ---------------------------------------------------------------------------


class StepMemory(TorchDispatchMode):
    """Follows a step on fake tensors: the live bytes of every storage an
    op creates (freed when its last tensor goes), the peak per phase, and
    which registered input storages some op reads (an argument of an op
    that is not a view and does not only write it).

    Under a dispatch mode autograd sums two gradients of one tensor out
    of place, where a plain run adds into the buffer it drops (``add_``);
    so an ``add`` of two gradients inside a backward, one of which is
    freed before the next op, is counted as the plain run's in-place sum.

    Push it above the ``FakeTensorMode`` the tensors belong to."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.phase = "step"
        self.peaks: dict[str, int] = {}
        self.read: set[int] = set()
        self._inputs: dict[int, object] = {}
        self._seen: weakref.WeakSet = weakref.WeakSet()
        self._schemas: dict = {}
        #: an accumulation whose peak waits on whether an operand dies:
        #: (its operands' storages, weakly; its output's bytes; the live
        #: bytes after it)
        self._pending = None

    def add_inputs(self, tensors) -> None:
        for t in tensors:
            st = t.untyped_storage()
            self._inputs[id(st)] = st
            self._seen.add(st)

    def enter_phase(self, name: str) -> None:
        self._settle()
        self.phase = name
        self._peak(self.live)

    def __exit__(self, *exc):
        self._settle()
        return super().__exit__(*exc)

    def _peak(self, live: int) -> None:
        if live > self.peaks.get(self.phase, 0):
            self.peaks[self.phase] = live

    def _settle(self) -> None:
        if self._pending is not None:
            operands, nbytes, live = self._pending
            self._pending = None
            dropped = any(ref() is None for ref in operands)
            self._peak(live - nbytes if dropped else live)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _reads(self, func) -> tuple:
        if func not in self._schemas:
            self._schemas[func] = tuple(
                (i, a.name) for i, a in enumerate(func._schema.arguments)
                if not (a.alias_info is not None and a.alias_info.is_write))
        return self._schemas[func]

    @staticmethod
    def _accumulates(func, args, kwargs, out) -> bool:
        """An ``add`` of two gradients of ``out``'s shape and dtype inside
        a backward (none requires grad: a recompute's tensors do)."""
        return (func is torch.ops.aten.add.Tensor and not kwargs
                and torch._C._current_graph_task_id() != -1
                and all(isinstance(t, torch.Tensor) and not t.requires_grad
                        and t.shape == out.shape and t.dtype == out.dtype
                        for t in args[:2]))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._settle()
        if not (func.is_view or func.namespace == "prim"):  # prim: metadata
            for i, name in self._reads(func):
                v = args[i] if i < len(args) else kwargs.get(name)
                for t in (v if isinstance(v, (list, tuple)) else (v,)):
                    if isinstance(t, torch.Tensor):
                        key = id(t.untyped_storage())
                        if key in self._inputs:
                            self.read.add(key)
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st not in self._seen:
                    self._seen.add(st)
                    n = st.nbytes()
                    self.live += n
                    weakref.finalize(st, self._free, n)
        if self._accumulates(func, args, kwargs, out):
            self._pending = (
                tuple(weakref.ref(t.untyped_storage()) for t in args[:2]),
                out.untyped_storage().nbytes(), self.live)
        else:
            self._peak(self.live)
        return out


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[id(st)] = st.nbytes()
    return sum(seen.values())


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    """A spec: a plain tuple of None, axis names and tuples of names."""
    return (type(x) is tuple and all(
        e is None or isinstance(e, str) or
        (type(e) is tuple and all(isinstance(a, str) for a in e))
        for e in x))


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _batch_shardings(batch, mesh, report):
    """Specs of the batch's inputs. As in the reference, the batch, the
    cache and the decode inputs resolve under ``DEFAULT_RULES`` whatever
    rule preset the parameters take."""
    out = {}
    for k in sorted(batch):
        v = batch[k]
        axes = BATCH_AXES.get(k, ("batch",) + (None,) * (v.dim() - 1))
        out[k] = shlib.resolve_spec(v.shape, axes, mesh, name=f"batch/{k}",
                                    report=report)
    return out


def _tree_shardings_from_axes(tree, axes_tree, mesh, report, prefix):
    """Specs for a tree of tensors (a cache) from the same tree of
    logical axes (``model.cache_axes``)."""
    leaves = shlib.flatten_with_path(tree, _is_tensor)
    axes = [a for _, a in shlib.flatten_with_path(axes_tree, _is_spec)]
    return shlib.unflatten_like(tree, [
        shlib.resolve_spec(t.shape, ax, mesh, name=f"{prefix}/{name}",
                           report=report)
        for (name, t), ax in zip(leaves, axes)], _is_tensor)


def _leaves(group: str, tree, spec_tree) -> list:
    """[(name, tensor, spec)] of ``tree`` beside its specs."""
    ts = shlib.flatten_with_path(tree, _is_tensor)
    ss = [s for _, s in shlib.flatten_with_path(spec_tree, _is_spec)]
    if len(ts) != len(ss):
        raise ValueError(f"{group}: {len(ts)} tensors, {len(ss)} specs")
    return [(f"{group}/{n}" if n else group, t, s)
            for (n, t), s in zip(ts, ss)]


def _dev_bytes(t, spec, mesh) -> int:
    return shlib.shard_bytes(t.shape, t.element_size(), spec, mesh)


# ---------------------------------------------------------------------------
# the reference's formulas
# ---------------------------------------------------------------------------


def analytic_memory_bytes(cfg, shape_name, kind, chips, n_params, active):
    """Fused per-device HBM traffic estimate (the reference's documented
    model, a lower bound):

      train : params  active*2B*3 (fwd+bwd+remat reads)
              + n_params*(4B*6) (adam m/v/master fp32 read+write)
              + acts tokens/dev * d_model * layers * 2B * 20
              + logits tokens/dev * padded_vocab * 4B * 2
      serve : params active*2B + cache read+write + acts (k=8)
    """
    tokens = SH.token_count(cfg, shape_name)
    tok_dev = tokens / chips
    L = cfg.num_layers + cfg.num_encoder_layers
    d = cfg.d_model
    if kind == "train":
        par = active / chips * 2 * 3 + n_params / chips * 4 * 6
        acts = tok_dev * d * L * 2 * 20
        logits = tok_dev * cfg.padded_vocab * 4 * 2
        return par + acts + logits
    # serving
    par = active / chips * 2
    acts = tok_dev * d * L * 2 * 8
    s = SH.SHAPES[shape_name]
    if cfg.family in ("decoder", "encdec", "hybrid"):
        kv = (L * s.global_batch * cfg.n_kv_heads * s.seq_len
              * cfg.resolved_head_dim * 2 * 2) / chips
    else:
        kv = 0.0
    if cfg.family in ("mamba", "hybrid"):
        d_inner = cfg.ssm_expand * d
        h = d_inner // cfg.ssm_head_dim
        kv += (cfg.num_layers * s.global_batch * h * cfg.ssm_state
               * cfg.ssm_head_dim * 4 * 2) / chips
    mult = 2 if kind == "prefill" else 1  # prefill writes what it reads
    logits = (s.global_batch if kind != "train" else tok_dev) \
        * cfg.padded_vocab * 4 / chips
    return par + acts + kv * mult + logits


def active_params(cfg, n_params: int) -> int:
    """Parameters a token reaches: an MoE model's with ``top_k`` experts
    (the reference's count)."""
    if cfg.moe:
        return count_params(M.param_specs(
            cfg.with_(num_experts=max(cfg.top_k, 1))))
    return n_params


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _mesh_name(mesh) -> str:
    return "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def _trace(cfg, shape_name, mesh, rules, report, zero1, tcfg):
    """Run the cell's step once on fake tensors. Returns (kind, inputs,
    outputs, donated group names, run facts)."""
    mode = FakeTensorMode()
    dev = FAKE_DEVICE
    kwargs, kind = SH.input_specs(cfg, shape_name, mode, dev)
    specs_tree = M.param_specs(cfg)
    params = M.abstract(cfg, mode, dev)
    params_sh = shlib.tree_shardings(specs_tree, mesh, rules, report)
    inputs = _leaves("params", params, params_sh)
    tracker = StepMemory()
    flops = FlopCounterMode(display=False)
    facts = {}

    with mode:
        if kind == "train":
            opt = adamw.init(params, tcfg.optimizer)
            opt_sh = adamw.state_shardings(specs_tree, mesh, tcfg.optimizer,
                                           rules, zero1=zero1)
            batch = kwargs["batch"]
            batch_sh = _batch_shardings(batch, mesh, report)
            inputs += _leaves("opt", opt, opt_sh)
            inputs += _leaves("batch", batch, batch_sh)
            lead = batch_sh["tokens"][0]
            donated = ("params", "opt")
        else:
            b = SH.SHAPES[shape_name].global_batch
            cache = M.init_cache(cfg, b, kwargs["max_seq"], dev)
            cache_sh = _tree_shardings_from_axes(
                cache, M.cache_axes(cfg), mesh, report, "cache")
            if kind == "prefill":
                batch = kwargs["batch"]
                batch_sh = _batch_shardings(batch, mesh, report)
                inputs += _leaves("batch", batch, batch_sh)
                lead = batch_sh["tokens"][0]
            else:
                tok = kwargs["tokens"]
                tok_sh = shlib.resolve_spec(tok.shape, ("batch", None), mesh,
                                            name="tokens", report=report)
                inputs.append(("tokens", tok, tok_sh))
                lead = tok_sh[0]
            inputs += _leaves("cache", cache, cache_sh)
            if "enc_out" in kwargs:  # the reference's argument order
                enc = kwargs["enc_out"]
                inputs.append(("enc_out", enc, shlib.resolve_spec(
                    enc.shape, ("batch", "seq", None), mesh, name="enc_out",
                    report=report)))
            donated = ("cache",)

    tracker.add_inputs(t for _, t, _ in inputs)
    ctx_mesh = runtime_context.use_mesh(mesh)
    t0 = time.perf_counter()
    with mode, tracker, flops, ctx_mesh as ctx:
        if kind == "train":
            tracker.enter_phase("forward_backward")
            loss, extras, grads = train_steps.gradients(params, batch, cfg,
                                                        tcfg)
            facts["boundary_bytes"] = tracker.live
            facts["grad_bytes"] = _storage_bytes(
                t for _, t, _ in _leaves("grads", grads, params_sh))
            tracker.enter_phase("update")
            new_params, new_opt, om = train_steps.apply_update(
                params, opt, grads, tcfg)
            metrics = {"loss": loss, **om, **extras}
            outputs = (_leaves("params", new_params, params_sh)
                       + _leaves("opt", new_opt, opt_sh)
                       + [(f"metrics/{k}", v, ()) for k, v in
                          sorted(metrics.items())])
            del loss, extras, grads, new_params, new_opt, om, metrics
        else:
            tracker.enter_phase("forward")
            with torch.no_grad():
                if kind == "prefill":
                    logits, cache = M.prefill(params, batch, cfg, cache)
                else:
                    logits, cache = M.decode_step(
                        params, kwargs["tokens"], kwargs["max_seq"] - 1, cfg,
                        cache, kwargs.get("enc_out"))
            outputs = [("logits", logits, shlib.resolve_spec(
                logits.shape, LOGITS_AXES, mesh))]
            outputs += _leaves("cache", cache, cache_sh)
            del logits
    facts["trace_s"] = time.perf_counter() - t0
    facts["flops"] = flops.get_total_flops()
    transport = ctx._transports.get(str(torch.device(dev)))
    facts["counts"] = dict(transport.counts) if transport else {}
    facts["nbytes"] = dict(transport.nbytes) if transport else {}
    facts["axes_nbytes"] = dict(transport.axes_nbytes) if transport else {}
    facts["peaks"] = dict(tracker.peaks)
    facts["read"] = tracker.read
    facts["batch_cards"] = math.prod(
        mesh.shape[a] for a in shlib.entry_axes(lead))
    return kind, inputs, outputs, donated, facts


def memory_record(kind, inputs, outputs, donated, facts, mesh) -> dict:
    """The per-device memory of a traced cell (see the module doc)."""
    read = [(n, t, s) for n, t, s in inputs
            if id(t.untyped_storage()) in facts["read"]]
    arg = sum(_dev_bytes(t, s, mesh) for _, t, s in read)
    out = sum(_dev_bytes(t, s, mesh) for _, t, s in outputs)
    alias = sum(_dev_bytes(t, s, mesh) for n, t, s in read
                if n.split("/")[0] in donated)
    # what the port holds of its inputs: each storage once
    held = {}
    for _, t, s in inputs:
        held.setdefault(id(t.untyped_storage()), _dev_bytes(t, s, mesh))
    resident = sum(held.values())
    cards = facts["batch_cards"]
    peaks = facts["peaks"]
    rec = {}
    if kind == "train":
        fb = peaks["forward_backward"] / cards
        grads = facts["grad_bytes"]
        params = [(t, s) for n, t, s in inputs if n.startswith("params/")]
        state = [(t, s) for n, t, s in inputs if n.startswith("opt/")]

        def ratio(pairs):
            whole = sum(t.numel() * t.element_size() for t, _ in pairs)
            return sum(_dev_bytes(t, s, mesh) for t, s in pairs) / whole
        upd = ((facts["boundary_bytes"] - grads) / cards
               + grads * ratio(params)
               + (peaks["update"] - facts["boundary_bytes"]) * ratio(state))
        rec["forward_backward_bytes_per_device"] = fb
        rec["update_bytes_per_device"] = upd
        new = max(fb, upd)
    else:
        new = peaks["forward"] / cards
        rec["forward_bytes_per_device"] = new
    peak = resident + new
    return {
        "argument_bytes_per_device": arg,
        "output_bytes_per_device": out,
        "temp_bytes_per_device": max(0.0, peak - (arg + out - alias)),
        "alias_bytes_per_device": alias,
        "output_leaves": len(outputs),
        "peak_bytes_per_device": peak,
        "resident_input_bytes_per_device": resident,
        "pruned_inputs": [n for n, t, s in inputs
                          if id(t.untyped_storage()) not in facts["read"]],
        "kept_input_indices": [i for i, (_, t, _) in enumerate(inputs)
                               if id(t.untyped_storage()) in facts["read"]],
        **rec,
        "activation_cards": cards,
        "fits_hbm": peak <= mesh_lib.HBM_BYTES,
    }


def collectives_record(facts, mesh) -> tuple[dict, float]:
    """(the record's collectives, their seconds on the card's links)."""
    coll = {ref: float(facts["nbytes"].get(prim, 0)) if prim else 0.0
            for ref, prim in COLLECTIVES.items()}
    coll["collective_ops"] = sum(facts["counts"].values())
    coll["counts"] = dict(sorted(facts["counts"].items()))
    by_axes, seconds = [], 0.0
    for (prim, axes), nbytes in sorted(facts["axes_nbytes"].items()):
        bw = mesh_lib.link_bandwidth(mesh, axes)
        by_axes.append({"collective": prim, "axes": list(axes),
                        "bytes_per_device": nbytes, "link_bytes_per_s": bw})
        seconds += nbytes / bw
    coll["by_axes"] = by_axes
    coll["scope"] = COLLECTIVE_SCOPE
    return coll, seconds


def expert_parallel_fits(cfg, shape_name: str, mesh) -> tuple[bool, str]:
    """Whether an MoE model's batch splits over the mesh's data-parallel
    cards, as ``layers.moe_ffn_ep`` (and the reference's ``shard_map``)
    needs; reason if not."""
    dp = [a for a in ("pod", "data") if a in mesh.axis_names]
    cards = math.prod(mesh.shape[a] for a in dp)
    batch = SH.SHAPES[shape_name].global_batch
    if cfg.moe and batch % cards:
        return False, (f"the expert-parallel MoE splits the batch over "
                       f"{'x'.join(dp)} ({cards} cards): {batch} rows do not "
                       f"split (the reference's shard_map refuses it too)")
    return True, ""


@contextlib.contextmanager
def patched_shape(shape_name: str, seq_len: int, global_batch: int):
    """``SHAPES[shape_name]`` at another length and batch (same kind) for
    the block: a cell at a size one card holds."""
    saved = SH.SHAPES[shape_name]
    SH.SHAPES[shape_name] = SH.ShapeSpec(shape_name, seq_len, global_batch,
                                         saved.kind)
    try:
        yield SH.SHAPES[shape_name]
    finally:
        SH.SHAPES[shape_name] = saved


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               zero1: bool = True, donate: bool = True,
               remat: bool = True, extra_rules: dict | None = None,
               cfg_override=None, remat_policy: str = "nothing",
               mesh=None, use_kernels: bool = False, tcfg=None):
    """Trace one cell on fake tensors; returns (record, None) (the
    reference's second value is its compiled executable). ``mesh``: the
    production mesh unless given (any ``SimMesh``); ``use_kernels``: the
    LM kernels' wrappers in place of the plain layers (on fake tensors
    they run their plain versions: nothing launches, but autograd keeps
    what the kernels keep); ``tcfg``: the training step's config."""
    cfg = cfg_override or configs.get_config(arch)
    cfg = cfg.with_(remat=remat, use_kernels=use_kernels, scan_layers=True,
                    remat_policy=remat_policy)
    ok, why = SH.applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}, None
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    ok, why = expert_parallel_fits(cfg, shape_name, mesh)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
                "skipped": why}, None
    rules = dict(shlib.DEFAULT_RULES)
    if extra_rules:
        rules.update(extra_rules)
    report = shlib.ResolveReport()
    tcfg = tcfg or train_steps.TrainConfig()

    kind, inputs, outputs, donated, facts = _trace(
        cfg, shape_name, mesh, rules, report, zero1, tcfg)
    if not donate:
        donated = ()
    chips = math.prod(mesh.shape[a] for a in mesh.axis_names)
    memory = memory_record(kind, inputs, outputs, donated, facts, mesh)
    coll, t_coll = collectives_record(facts, mesh)

    n_params = count_params(M.param_specs(cfg))
    active = active_params(cfg, n_params)
    flops_dev = facts["flops"] / chips
    bytes_model = analytic_memory_bytes(cfg, shape_name, kind, chips,
                                        n_params, active)
    terms = {"compute_s": flops_dev / mesh_lib.PEAK_FLOPS_BF16,
             "memory_s": bytes_model / mesh_lib.HBM_BW,
             "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    tokens = SH.token_count(cfg, shape_name)
    model_flops = (6 if kind == "train" else 2) * active * tokens
    bound = max(terms.values())
    record = {
        "arch": arch, "shape": shape_name, "kind": kind,
        "mesh": _mesh_name(mesh), "chips": chips, "card": mesh_lib.CARD,
        "trace_s": round(facts["trace_s"], 1),
        "params": n_params, "active_params": active, "tokens": tokens,
        "memory": memory,
        "cost": {"flops_per_device": flops_dev,
                 "bytes_per_device_model": bytes_model},
        "collectives": coll,
        "roofline": {**terms, "bottleneck": bottleneck,
                     "model_flops": model_flops,
                     "useful_flops_ratio": (model_flops / facts["flops"]
                                            if facts["flops"] else 0.0),
                     "step_time_bound_s": bound,
                     "mfu_bound": model_flops / chips
                     / mesh_lib.PEAK_FLOPS_BF16 / max(bound, 1e-12)},
        "sharding_downgrades": report.downgrades,
        "config": {"zero1": zero1, "donate": donate, "remat": remat,
                   "remat_policy": remat_policy, "use_kernels": use_kernels},
        "no_counterpart": NO_COUNTERPART,
    }
    return record, None


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

RULE_PRESETS = {
    # DP over the data axis only; model axis left for ZeRO state
    # sharding. Params replicated.
    "dp16": {
        "batch": (("data",), ()),
        "mlp": ((),), "qkv_features": ((),), "kv_features": ((),),
        "heads": ((),), "kv_heads": ((),), "head_dim": ((),),
        "vocab": (("model",), ()),
    },
    # pure data-parallel: batch over every mesh axis, params replicated,
    # optimizer states ZeRO-sharded.
    "dp": {
        "batch": (("pod", "data", "model"), ("data", "model"), ("data",), ()),
        "mlp": ((),), "qkv_features": ((),), "kv_features": ((),),
        "heads": ((),), "kv_heads": ((),), "head_dim": ((),),
        "vocab": (("model",), ()),
    },
}


def parse_mesh(text: str):
    """``"1x1"`` -> a (1, 1) ``("data", "model")`` SimMesh; three sizes
    add ``"pod"`` in front."""
    sizes = tuple(int(x) for x in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}
    if len(sizes) not in names:
        raise ValueError(f"--mesh takes 2 or 3 sizes, got {text!r}")
    return sim_mesh(sizes, names[len(sizes)])


def _tag(args) -> str:
    tag = "multi" if args.multi_pod else "single"
    if args.mesh:
        tag = f"mesh{args.mesh}"
    if args.rules:
        tag += f"__{args.rules}"
    if args.remat_policy != "nothing":
        tag += f"__{args.remat_policy}"
    return tag


def run_one(args):
    rec, _ = lower_cell(args.arch, args.shape, args.multi_pod,
                        zero1=not args.no_zero1, remat=not args.no_remat,
                        extra_rules=RULE_PRESETS.get(args.rules),
                        remat_policy=args.remat_policy,
                        mesh=parse_mesh(args.mesh) if args.mesh else None)
    if args.rules or args.remat_policy != "nothing":
        rec["rules"] = args.rules
    if "skipped" not in rec:
        print(json.dumps(rec["memory"], indent=1))  # does it fit
        print({"flops_per_device": rec["cost"]["flops_per_device"],
               "collectives": rec["collectives"]["counts"]})
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{args.arch}__{args.shape}__{_tag(args)}.json"
    path.write_text(json.dumps(rec, indent=1))
    print(json.dumps({k: rec[k] for k in rec
                      if k not in ("memory", "cost", "collectives",
                                   "no_counterpart")}
                     if "skipped" not in rec else rec, indent=1))
    print("wrote", path)


def run_all(args):
    archs = args.archs.split(",") if args.archs else configs.list_archs()
    cells = [(a, s) for a in archs for s in SH.SHAPES]
    procs, failures = [], []
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                 if p]))

    def drain(block=False):
        while procs and (block or len(procs) >= args.jobs):
            for i, (p, a, s) in enumerate(procs):
                if p.poll() is not None:
                    if p.returncode != 0:
                        failures.append((a, s, p.returncode))
                        print(f"FAILED {a} {s} rc={p.returncode}", flush=True)
                    procs.pop(i)
                    break
            else:
                time.sleep(0.5)

    flags = [f for f, on in (("--multi-pod", args.multi_pod),
                             ("--no-zero1", args.no_zero1),
                             ("--no-remat", args.no_remat)) if on]
    for opt in ("rules", "mesh"):
        if getattr(args, opt):
            flags += [f"--{opt}", getattr(args, opt)]
    flags += ["--remat-policy", args.remat_policy]
    for arch, shape in cells:
        path = pathlib.Path(args.out) / f"{arch}__{shape}__{_tag(args)}.json"
        if path.exists() and not args.force:
            print("cached", path.name, flush=True)
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", args.out] + flags
        drain()
        print("launch", arch, shape, flush=True)
        procs.append((subprocess.Popen(cmd, env=env,
                                       stdout=subprocess.DEVNULL), arch,
                      shape))
    drain(block=True)
    print("failures:", failures or "none")
    return 1 if failures else 0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=configs.list_archs())
    ap.add_argument("--shape", choices=list(SH.SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="another mesh than the production one, e.g. 1x1 "
                         "(data x model) or 2x4x8 (pod x data x model)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--archs", default="",
                    help="comma-separated arch filter for --all")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="nothing",
                    choices=["nothing", "save_moe", "offload_moe"])
    ap.add_argument("--rules", default="",
                    help="named sharding-rule override (e.g. 'dp' = pure "
                         "data-parallel over data x model + ZeRO)")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    if args.all:
        sys.exit(run_all(args))
    if not args.arch or not args.shape:
        ap.error("--arch/--shape required (or --all)")
    run_one(args)


if __name__ == "__main__":
    main()
