"""The JAX package's tree and graph front doors, its supervised
solves, its expert-parallel MoE, its int8 compression and AdamW state,
and its remat'd gradients, run in a child process for the port's parity
tests (``tests/test_torch_treealg.py``, ``tests/test_torch_graphalg.py``,
``tests/test_torch_faultinject.py``, ``tests/test_torch_obs.py``,
``tests/test_torch_telemetry.py``, ``tests/test_torch_moe_ep.py``,
``tests/test_torch_compression.py``, ``tests/test_torch_remat.py``,
``tests/test_torch_dist_recovery.py``).

Each of these calls compiles large simshard programs, and many such
compiles in one pytest worker have crashed XLA's CPU compiler in a later
test file of the same worker; a child process per test file keeps them
out of the worker. :func:`run_reference` runs a batch of named jobs in a
few child processes at once (a ``spawn`` pool; each takes the next job
when it finishes one) and returns their results as numpy arrays, dicts
and ints.

The children of one test run share a JAX persistent compilation cache
in a directory under the run's common base temporary directory (never
one that outlives the run), so a program that two children compile,
such as a solve at the same shapes, is compiled once.
"""
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
P = 8
TREE_ARRAYS = ("parent", "root_of", "depth", "subtree_size", "preorder",
               "postorder")
GRAPH_ARRAYS = ("components", "parent", "depth", "subtree_size", "preorder",
                "postorder")


#: seconds a child may take over one job
CHILD_TIMEOUT_S = 900


def _cache_dir(tmp_dir) -> str:
    """The run's shared compilation cache: beside the per-worker base
    temporary directories under pytest-xdist, else in the base one."""
    base = os.path.dirname(os.path.abspath(str(tmp_dir)))
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = os.path.dirname(base)
    return os.path.join(base, "jax_compilation_cache")


def _start_child():
    """A child's set-up, before its first job: jax on the CPU."""
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import jax
    jax.config.update("jax_platform_name", "cpu")


def _run_job(item):
    key, (name, args) = item
    return key, JOBS[name](*args)


def run_reference(jobs: dict, tmp_dir, devices: int = 1,
                  procs: int = 1) -> dict:
    """Run ``jobs`` ({key: (job name, args)}) in ``procs`` child processes
    that take the next job as they finish one (so independent jobs only;
    list the longest first), and return {key: result}. Each child's jax
    sees ``devices`` CPU devices (``XLA_FLAGS``, set before jax is
    imported)."""
    import multiprocessing as mp
    env = {"JAX_COMPILATION_CACHE_DIR": _cache_dir(tmp_dir),
           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0",
           "JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES": "0"}
    if devices > 1:
        env["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_"
                            f"host_platform_device_count={devices}").strip()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)  # the children copy it as they start
    try:
        pool = mp.get_context("spawn").Pool(min(procs, len(jobs)),
                                            initializer=_start_child)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        done = pool.imap_unordered(_run_job, list(jobs.items()))
        results = dict(done.next(timeout=CHILD_TIMEOUT_S) for _ in jobs)
        pool.close()
        pool.join()
    finally:
        pool.terminate()
    return results


# --------------------------------------------------------------------------
# the jobs (run in the child only)
# --------------------------------------------------------------------------

def _ints(stats) -> dict:
    return {k: int(v) for k, v in stats.items()
            if isinstance(v, (int, np.integer))}


def _arrays(obj, names) -> dict:
    return {**{k: np.asarray(getattr(obj, k)) for k in names},
            "stats": _ints(obj.stats)}


def build(parent, weighted, cut_at):
    """The reference's tour (succ, w, stats) as its ``build_tour``
    runs it (first attempt; caps are exact)."""
    import jax.numpy as jnp
    from repro.core.listrank import sim_mesh, transport
    from repro.core.listrank.exchange import MeshPlan
    from repro.core.treealg import euler
    mesh = sim_mesh(P)
    n = parent.shape[0]
    closed = cut_at is not None and cut_at != int(
        np.flatnonzero(parent == np.arange(n))[0])
    pad = (-n) % P
    parent_pad = np.concatenate([parent, np.arange(n, n + pad)])
    m = parent_pad.shape[0] // P
    cap1, cap2 = euler.tour_caps(parent_pad, P)
    succ, w, stats = euler._jitted_builder(
        mesh, MeshPlan.from_mesh(mesh, ("pe",), None), m, cap1, cap2,
        weighted, closed)(
            transport.put_sharded(mesh, ("pe",),
                                  jnp.asarray(parent_pad, jnp.int32)),
            jnp.int32(cut_at if closed else -1))
    return {"succ": np.asarray(succ), "w": np.asarray(w),
            "stats": {k: int(v) for k, v in stats.items()},
            "parent_pad": parent_pad, "m": m, "caps": (cap1, cap2),
            "closed": closed}


def tree_stats(parent):
    from repro.core import treealg
    from repro.core.listrank import ListRankConfig, sim_mesh
    return _arrays(treealg.tree_stats(parent, sim_mesh(P),
                                      cfg=ListRankConfig()), TREE_ARRAYS)


def root_tree(parent, new_root):
    from repro.core import treealg
    from repro.core.listrank import ListRankConfig, sim_mesh
    return np.asarray(treealg.root_tree(parent, new_root, sim_mesh(P),
                                        cfg=ListRankConfig()))


def solve_forest(parents):
    from repro.core import treealg
    from repro.core.listrank import ListRankConfig, sim_mesh
    return [_arrays(st, TREE_ARRAYS) for st in treealg.solve_forest(
        parents, sim_mesh(P), cfg=ListRankConfig())]


def graph_stats(edges, n):
    from repro.core import graphalg
    from repro.core.listrank import ListRankConfig, sim_mesh
    return _arrays(graphalg.graph_stats(edges, n, sim_mesh(P),
                                        cfg=ListRankConfig()), GRAPH_ARRAYS)


def connected_components(edges, n):
    from repro.core import graphalg
    from repro.core.listrank import ListRankConfig, sim_mesh
    labels, stats = graphalg.connected_components(edges, n, sim_mesh(P),
                                                  cfg=ListRankConfig())
    return np.asarray(labels), _ints(stats)


def spanning_forest(edges, n):
    from repro.core import graphalg
    from repro.core.listrank import ListRankConfig, sim_mesh
    parent, labels, stats = graphalg.spanning_forest(edges, n, sim_mesh(P),
                                                     cfg=ListRankConfig())
    return np.asarray(parent), np.asarray(labels), _ints(stats)


def _golden_case(name):
    from _simshard_cases import golden_cases
    return next(c for c in golden_cases() if c[0] == name)


def fingerprints():
    """{case name: the reference's solve fingerprint} of every golden
    case at p = 8, seed 0 (no solve runs)."""
    import jax.numpy as jnp
    from _simshard_cases import golden_cases
    from repro.core.listrank import resume
    from repro.core.listrank.api import canonical_weight_dtype
    return {name: resume.solve_fingerprint(
        jnp.asarray(s, jnp.int32), jnp.asarray(r, canonical_weight_dtype(
            r.dtype)), s.shape[0], P, 0, cfg)
        for name, s, r, cfg in golden_cases()}


def preempted_solve(name, ckpt_dir, stage, level):
    """Solve golden case ``name`` under a SolveSupervisor on ``ckpt_dir``
    and preempt it after ``stage``@``level`` (legacy PRNG, as the goldens
    were made): leaves that boundary's checkpoint."""
    import jax
    from repro.core.listrank import FaultSpec, rank_list_with_stats, sim_mesh
    from repro.runtime.fault_tolerance import (Preempted, SolveSupervisor,
                                               SolveSupervisorConfig)
    _, s, r, cfg = _golden_case(name)
    sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=ckpt_dir))
    with jax.threefry_partitionable(False):
        try:
            rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg, supervisor=sup,
                                 inject=FaultSpec("preempt", stage=stage,
                                                  level=level))
        except Preempted:
            return sup.ckpt.latest_step()
    raise AssertionError("the solve was not preempted")


def resumed_solve(name, ckpt_dir):
    """Golden case ``name`` resumed under a SolveSupervisor on
    ``ckpt_dir`` (legacy PRNG): its golden record, recovery stats and
    stage log."""
    import jax
    from _simshard_cases import case_record
    from repro.core.listrank import rank_list_with_stats, sim_mesh
    from repro.runtime.fault_tolerance import (SolveSupervisor,
                                               SolveSupervisorConfig)
    _, s, r, cfg = _golden_case(name)
    sup = SolveSupervisor(SolveSupervisorConfig(ckpt_dir=ckpt_dir))
    with jax.threefry_partitionable(False):
        sf, rf, stats = rank_list_with_stats(s, r, sim_mesh(P), cfg=cfg,
                                             supervisor=sup)
    return {"record": case_record(sf, rf, stats),
            "recovery": dict(stats["recovery"]),
            "stage_log": tuple(stats["stage_log"])}


def span_tree(tracer) -> dict:
    """A tracer's spans as (name, cat, depth, parent index) and its
    instants as (name, cat, depth), in recording order."""
    return {"spans": [(s.name, s.cat, s.depth, s.parent)
                      for s in tracer.spans],
            "instants": [(s.name, s.cat, s.depth) for s in tracer.instants]}


def telemetry_solve(name, ckpt_dir=None, faults=()):
    """Golden case ``name`` traced with ``cfg.telemetry`` on (legacy
    PRNG), optionally supervised on ``ckpt_dir`` with ``faults``
    injected: its golden record, ``stats["telemetry"]`` and span tree."""
    import jax
    from _simshard_cases import case_record
    from repro.core.listrank import rank_list_with_stats, sim_mesh
    from repro.obs import Tracer
    from repro.runtime.fault_tolerance import (SolveSupervisor,
                                               SolveSupervisorConfig)
    _, s, r, cfg = _golden_case(name)
    sup = (SolveSupervisor(SolveSupervisorConfig(ckpt_dir=ckpt_dir))
           if ckpt_dir is not None else None)
    tr = Tracer()
    with jax.threefry_partitionable(False):
        sf, rf, stats = rank_list_with_stats(
            s, r, sim_mesh(P), cfg=cfg.with_(telemetry=True), tracer=tr,
            supervisor=sup, inject=list(faults) or None)
    return {"record": case_record(sf, rf, stats),
            "telemetry": stats["telemetry"], "trace": span_tree(tr),
            "stage_log": tuple(stats["stage_log"])}


def tree_telemetry(parent):
    """``tree_stats`` traced with ``cfg.telemetry`` on: the tour span's
    StageRecord and the batched solve's ``stats["telemetry"]``."""
    from repro.core import treealg
    from repro.core.listrank import ListRankConfig, sim_mesh
    from repro.obs import Tracer
    tr = Tracer()
    st = treealg.tree_stats(parent, sim_mesh(P), tracer=tr,
                            cfg=ListRankConfig(telemetry=True))
    tour = next(s for s in tr.spans if s.name == "build_tour")
    return {**_arrays(st, TREE_ARRAYS), "tour": tour.args["telemetry"],
            "telemetry": st.stats["telemetry"], "trace": span_tree(tr)}


def graph_telemetry(mode, edges, n):
    """``connected_components`` (``mode`` "cc") or ``graph_stats``
    ("stats") traced with ``cfg.telemetry`` on: the components, integer
    stats, ``stats["telemetry"]`` and the span tree."""
    from repro.core import graphalg
    from repro.core.listrank import ListRankConfig, sim_mesh
    from repro.obs import Tracer
    tr = Tracer()
    cfg = ListRankConfig(telemetry=True)
    if mode == "cc":
        labels, stats = graphalg.connected_components(
            edges, n, sim_mesh(P), cfg=cfg, tracer=tr)
    else:
        gs = graphalg.graph_stats(edges, n, sim_mesh(P), cfg=cfg, tracer=tr)
        labels, stats = gs.components, gs.stats
    return {"labels": np.asarray(labels), "stats": _ints(stats),
            "telemetry": stats["telemetry"], "trace": span_tree(tr)}


def _moe_layer_setup(arch, ffn, x):
    import jax.numpy as jnp
    from repro import configs
    return (configs.get_config(arch, smoke=True),
            {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in ffn.items()}, jnp.asarray(x))


def _mesh_ctx(shape):
    from repro import compat
    from repro.runtime import context
    return context.use_mesh(compat.make_mesh(shape, ("data", "model")))


def moe_layer_ep(arch, ffn, x, shape, factors):
    """``moe_ffn`` of ``arch``'s SMOKE config with the MoE weights ``ffn``
    on ``x`` under a ("data", "model") mesh context of ``shape`` (its
    ``moe_ffn_ep``), at each capacity factor: {factor: (y, aux)}, all
    factors in one compiled program."""
    import jax
    from repro.models import layers as L
    cfg, p, x = _moe_layer_setup(arch, ffn, x)
    with _mesh_ctx(shape):
        outs = jax.jit(lambda p, x: [
            L.moe_ffn(p, x, cfg.with_(capacity_factor=cf))
            for cf in factors])(p, x)
    return {cf: (np.asarray(y), float(aux))
            for cf, (y, aux) in zip(factors, outs)}


def moe_layer_dense(arch, ffn, x, factors, grad_shape):
    """``_moe_ffn_dense`` at each capacity factor ({factor: (y, aux)});
    the gradients of ``sum(y * y)`` in the weights and ``x`` through the
    dense dispatch and through ``moe_ffn_ep`` under a mesh of
    ``grad_shape``, at the last factor; and the error ``moe_ffn_ep``
    raises in bfloat16 (None if none)."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as L
    cfg0, p, x = _moe_layer_setup(arch, ffn, x)
    out = {"dense": {cf: tuple(np.asarray(v) for v in jax.jit(
        lambda p, x, cf=cf: L._moe_ffn_dense(
            p, x, cfg0.with_(capacity_factor=cf)))(p, x)) for cf in factors}}
    cfg = cfg0.with_(capacity_factor=factors[-1])

    def grads(fn):
        g = jax.jit(jax.grad(lambda p, x: jnp.sum(fn(p, x)[0] ** 2),
                             argnums=(0, 1)))(p, x)
        return jax.tree.map(np.asarray, g)
    out["grad_dense"] = grads(lambda p, x: L._moe_ffn_dense(p, x, cfg))
    with _mesh_ctx(grad_shape):
        out["grad_ep"] = grads(lambda p, x: L.moe_ffn(p, x, cfg))
    bf16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    bf16["router"] = p["router"]
    try:  # raised while tracing
        with _mesh_ctx((1, 1)):
            jax.eval_shape(lambda p, x: L.moe_ffn(p, x, cfg0), bf16,
                           x.astype(jnp.bfloat16))
        out["bf16_error"] = None
    except TypeError as exc:
        out["bf16_error"] = str(exc)
    return out


def moe_train_step(arch, batch, mesh):
    """One ``train_step`` of ``arch``'s SMOKE model from
    ``M.init(PRNGKey(0))`` on ``batch``, under a (1, 1) mesh context when
    ``mesh``: the initial parameters, the updated ones and the
    metrics."""
    import functools
    import jax
    from repro import configs
    from repro.models import model as M
    from repro.optim import adamw
    from repro.train import steps
    cfg = configs.get_config(arch, smoke=True)
    params = jax.jit(M.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    tcfg = steps.TrainConfig()
    step = jax.jit(functools.partial(steps.train_step, cfg=cfg, tcfg=tcfg))
    opt = adamw.init(params, tcfg.optimizer)
    if mesh:  # the context is read while tracing
        with _mesh_ctx((1, 1)):
            new, _, metrics = step(params, opt, batch)
    else:
        new, _, metrics = step(params, opt, batch)
    return {"params": jax.tree.map(np.asarray, params),
            "new": jax.tree.map(np.asarray, new),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def qint8(arrays):
    """Per array: the reference's ``QInt8.quantize`` (q, scale), its
    dequantization and ``quantization_error``, each jitted, as the
    reference's callers run them."""
    import jax
    from repro.runtime import compression as C
    quant = jax.jit(C.QInt8.quantize)
    deq = jax.jit(lambda x: C.QInt8.quantize(x).dequantize())
    err = jax.jit(C.quantization_error)
    out = []
    for x in arrays:
        q = quant(x)
        out.append({"q": np.asarray(q.q), "scale": np.asarray(q.scale),
                    "shape": q.shape, "deq": np.asarray(deq(x)),
                    "err": np.asarray(err(x))})
    return out


def compressed_psum(x, error, steps):
    """``compressed_psum`` over the "data" axis of a shard_map on every
    device, ``x`` and ``error`` (devices, ...) split over it, run
    ``steps`` times with the error fed back: each call's (reduced,
    new_error)."""
    import functools
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.runtime import compression as C
    mesh = compat.make_mesh((len(jax.devices()),), ("data",))

    @jax.jit
    @functools.partial(compat.shard_map, mesh=mesh,
                       in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data")))
    def step(x, err):
        red, new = C.compressed_psum(x[0], "data", err[0])
        return red[None], new[None]
    out = []
    for i in range(steps):
        red, error = step(x * (i + 1), error)
        out.append((np.asarray(red), np.asarray(error)))
    return out


def adamw_int8(vals, grads, cfg_kw, port_ckpt):
    """The reference's AdamW with ``cfg_kw`` (int8 moments) from
    ``adamw.init`` of the float32 params ``vals``, one jitted update per
    entry of ``grads``: every step's params, moments (q, scale) and
    master; the final (params, state) written by the reference's
    Checkpointer into ``port_ckpt + "_ref"``; and the port's checkpoint at
    ``port_ckpt`` restored by the reference's Checkpointer into the same
    structure."""
    import functools
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import Checkpointer
    from repro.optim import adamw
    from repro.runtime import compression as C
    cfg = adamw.AdamWConfig(**cfg_kw)
    params = jax.tree.map(jnp.asarray, vals)
    state = adamw.init(params, cfg)
    update = jax.jit(functools.partial(adamw.update, cfg=cfg))

    def host(tree):  # QInt8 leaves as {"q", "scale"}: no jax to unpickle
        return jax.tree.map(
            lambda x: ({"q": np.asarray(x.q), "scale": np.asarray(x.scale)}
                       if isinstance(x, C.QInt8) else np.asarray(x)),
            tree, is_leaf=lambda x: isinstance(x, C.QInt8))
    steps = []
    for g in grads:
        params, state, _ = update(jax.tree.map(jnp.asarray, g), state,
                                  params)
        steps.append({"params": host(params), "state": host(state)})
    ck = Checkpointer(port_ckpt + "_ref", async_save=False)
    ck.save(len(grads), (params, state))
    keys = ck.manifest()["keys"]
    got, _ = Checkpointer(port_ckpt).restore(None, (params, state))
    return {"steps": steps, "keys": keys, "restored": host(got)}


def loss_grads(arch, batch, enc_embeds=None):
    """The reference's ``loss_fn`` value and gradient in every parameter
    (``jax.value_and_grad``, jitted; ``cfg.remat`` at its default, on) of
    ``arch``'s SMOKE config in float32 from ``M.init(PRNGKey(0))`` on
    ``batch``: the parameters, the loss and the gradients."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import model as M
    from repro.train import steps
    cfg = configs.get_config(arch, smoke=True).with_(dtype=jnp.float32)
    params = jax.jit(M.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    b = dict(batch)
    if enc_embeds is not None:
        b["enc_embeds"] = enc_embeds
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: steps.loss_fn(p, b, cfg, steps.TrainConfig()),
        has_aux=True))(params, b)
    return {"params": jax.tree.map(np.asarray, params), "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


def _dryrun_module():
    """The reference's dry run, imported after this child's backend is up
    (its import sets ``XLA_FLAGS`` to 512 host devices, which must not
    reach a backend that is not initialised yet)."""
    import jax
    jax.devices()
    from repro.launch import dryrun
    return dryrun


def dryrun_cell(arch, shape_name, kind, seq, batch, mesh_shape):
    """Compile the reference's dry-run step of ``arch``'s SMOKE config at
    ``shape_name`` patched to (seq, batch) on a ``("data", "model")``
    mesh of this child's devices, as its ``lower_cell`` does (default
    rules, ZeRO-1, donation, remat, no kernels, scanned layers): the
    executable's memory analysis and the flat argument names it keeps."""
    import jax
    dr = _dryrun_module()
    from repro import compat, configs
    from repro.configs import shapes as SH
    from repro.runtime import sharding as shlib
    cfg = configs.get_config(arch, smoke=True).with_(
        remat=True, use_kernels=False, scan_layers=True,
        remat_policy="nothing")
    mesh = compat.make_mesh(mesh_shape, ("data", "model"))
    report = shlib.ResolveReport()
    saved = SH.SHAPES[shape_name]
    SH.SHAPES[shape_name] = SH.ShapeSpec(shape_name, seq, batch, kind)
    try:  # the child's next job sees the shapes as they were
        lowered, _ = dr._lower(cfg, shape_name, mesh,
                               dict(shlib.DEFAULT_RULES), report, True, True)
    finally:
        SH.SHAPES[shape_name] = saved
    mem = lowered.compile().memory_analysis()
    kept = lowered._lowering.compile_args.get("kept_var_idx")
    return {"argument": int(mem.argument_size_in_bytes),
            "output": int(mem.output_size_in_bytes),
            "alias": int(mem.alias_size_in_bytes),
            "temp": int(mem.temp_size_in_bytes),
            "kept": sorted(kept) if kept is not None else None,
            "downgrades": list(report.downgrades)}


def dryrun_formulas(cells):
    """The reference's dry-run tables and per-cell figures for full-width
    configs: its ``RULE_PRESETS`` and ``BATCH_AXES``, and (arch, shape) ->
    params, active params, tokens, model FLOPs and
    ``analytic_memory_bytes`` at 256 and 512 chips."""
    dr = _dryrun_module()
    from repro import configs
    from repro.configs import shapes as SH
    from repro.models import model as M
    from repro.models.params import count_params
    out = {}
    for arch, shape_name in cells:
        cfg = configs.get_config(arch).with_(
            remat=True, use_kernels=False, scan_layers=True)
        kind = SH.SHAPES[shape_name].kind
        n_params = count_params(M.param_specs(cfg))
        active = count_params(M.param_specs(cfg.with_(
            num_experts=max(cfg.top_k, 1)))) if cfg.moe else n_params
        tokens = SH.token_count(cfg, shape_name)
        out[arch, shape_name] = {
            "params": n_params, "active": active, "tokens": tokens,
            "model_flops": (6 if kind == "train" else 2) * active * tokens,
            "bytes_model": {chips: dr.analytic_memory_bytes(
                cfg, shape_name, kind, chips, n_params, active)
                for chips in (256, 512)}}
    return {"cells": out, "presets": dr.RULE_PRESETS,
            "batch_axes": dr.BATCH_AXES}


JOBS = {f.__name__: f for f in (build, tree_stats, root_tree, solve_forest,
                                graph_stats, connected_components,
                                spanning_forest, fingerprints,
                                preempted_solve, resumed_solve,
                                telemetry_solve, tree_telemetry,
                                graph_telemetry, moe_layer_ep,
                                moe_layer_dense, moe_train_step, qint8,
                                compressed_psum, adamw_int8, loss_grads,
                                dryrun_cell, dryrun_formulas)}

