"""The JAX package's tree and graph front doors, its supervised
solves, its expert-parallel MoE, its int8 compression and AdamW state,
and its remat'd gradients, run in a child process for the port's parity
tests (``tests/test_torch_treealg.py``, ``tests/test_torch_graphalg.py``,
``tests/test_torch_faultinject.py``, ``tests/test_torch_obs.py``,
``tests/test_torch_telemetry.py``, ``tests/test_torch_moe_ep.py``,
``tests/test_torch_compression.py``, ``tests/test_torch_remat.py``,
``tests/test_torch_dist_recovery.py``), its routings on a three-axis
mesh (``tests/test_torch_routing_parity.py``), the reference's
examples (``tests/test_torch_examples_*.py``), and the head-dim-128
decoders' logits and serving engine (``tests/test_torch_d128_models.py``,
and kimi-k2's attention and routing geometry in
``tests/test_torch_kimi_width.py``).

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


def routing_solve(succ, rank, shape, names, fields, ind):
    """One solve of (succ, rank) on ``sim_mesh(shape, names)`` with
    ``ListRankConfig(**fields)`` and the indirection ``ind``
    (``("topology", intra, inter)``, ``("grid",)`` or None): its outputs
    and integer stats, and the hops the tuner chooses for the mesh at
    this n."""
    from repro.core.listrank import (IndirectionSpec, ListRankConfig,
                                     rank_list_with_stats, sim_mesh, tuner)
    spec = (None if ind is None else IndirectionSpec.grid(names)
            if ind[0] == "grid" else IndirectionSpec.topology(*ind[1:]))
    s, r, st = rank_list_with_stats(succ, rank, sim_mesh(shape, names),
                                    cfg=ListRankConfig(**fields),
                                    indirection=spec)
    return {"succ": np.asarray(s), "rank": np.asarray(r), "stats": _ints(st),
            "chosen": tuner.choose_indirection(ListRankConfig(), names, shape,
                                               succ.shape[0]).hops}


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


# --------------------------------------------------------------------------
# the examples (examples/*.py), as the reference's examples call the JAX
# package: on a jax mesh of this child's devices (run_reference(devices=8))
# --------------------------------------------------------------------------

def _mesh(shape, names):
    from repro import compat
    return compat.make_mesh(shape, names)


def quickstart_example(succ, rank):
    """``examples/quickstart.py``'s two solves of (succ, rank) on a (2, 4)
    ("row", "col") mesh with grid indirection, fixed ruler fraction 1/32
    and auto-tuned: outputs, integer stats, the auto level plan's
    fractions and r*."""
    from repro.core.listrank import (IndirectionSpec, ListRankConfig,
                                     analysis, rank_list_with_stats, tuner)
    mesh = _mesh((2, P // 2), ("row", "col"))
    grid = IndirectionSpec.grid(("row", "col"))
    n = succ.shape[0]
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True,
                         ruler_fraction=1 / 32)
    s, r, st = rank_list_with_stats(succ, rank, mesh, cfg=cfg,
                                    indirection=grid)
    auto = cfg.with_(ruler_fraction=None)
    _, r2, st2 = rank_list_with_stats(succ, rank, mesh, cfg=auto,
                                      indirection=grid)
    return {"succ": np.asarray(s), "rank": np.asarray(r), "stats": _ints(st),
            "rank_auto": np.asarray(r2), "stats_auto": _ints(st2),
            "level_fracs": [lp.frac for lp in tuner.level_plan(
                auto, P, grid.depth, n)],
            "r_star": analysis.r_star(n, P, 2, analysis.SUPERMUC)}


def euler_tour_example(succ, rank, arcs):
    """``examples/euler_tour.py`` on a ("pe",) mesh: the tour's ranks and
    integer stats, and the depth, subtree size and parent its loops derive
    from them (copied from the example)."""
    from repro.core.listrank import ListRankConfig, rank_list_with_stats
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True)
    _, rank_out, stats = rank_list_with_stats(succ, rank,
                                              _mesh((P,), ("pe",)), cfg=cfg)
    n_arcs = arcs.shape[0]
    n_nodes = n_arcs // 2 + 1
    pos = (n_arcs - 1) - np.asarray(rank_out)[:n_arcs]
    down_pos = np.full(n_nodes, -1)
    up_pos = np.full(n_nodes, -1)
    for c in range(1, n_nodes):
        down_pos[c] = pos[2 * (c - 1)]
        up_pos[c] = pos[2 * (c - 1) + 1]
    size = np.ones(n_nodes, np.int64)
    size[1:] = (up_pos[1:] - down_pos[1:] - 1) // 2 + 1
    size[0] = n_nodes
    order = np.argsort(pos)
    depth_at = np.cumsum(np.where(order % 2 == 0, 1, -1))
    depth = np.zeros(n_nodes, np.int64)
    for c in range(1, n_nodes):
        depth[c] = depth_at[down_pos[c]]
    parent = np.zeros(n_nodes, np.int64)
    for c in range(1, n_nodes):
        parent[c] = arcs[2 * (c - 1)][0]
    return {"rank": np.asarray(rank_out), "stats": _ints(stats),
            "depth": depth, "size": size, "parent": parent}


def tree_stats_example(parents):
    """``examples/tree_stats.py`` on a ("pe",) mesh: ``solve_forest`` of
    ``parents`` and ``root_tree`` of the largest at its deepest node."""
    from repro.core import treealg
    from repro.core.listrank import ListRankConfig
    mesh = _mesh((P,), ("pe",))
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True)
    forest = treealg.solve_forest(parents, mesh, cfg=cfg)
    big = int(np.argmax([q.shape[0] for q in parents]))
    deepest = int(np.argmax(forest[big].depth))
    return {"forest": [_arrays(st, TREE_ARRAYS) for st in forest],
            "rerooted": np.asarray(treealg.root_tree(parents[big], deepest,
                                                     mesh, cfg=cfg)),
            "big": big, "deepest": deepest}


def connectivity_example(cc_graphs, edges, n):
    """``examples/connectivity.py`` on a ("pe",) mesh: the components of
    each of ``cc_graphs`` ({family: edges}), then ``graph_stats`` of
    ``edges`` and ``tree_stats`` of its forest."""
    from repro.core import graphalg, treealg
    from repro.core.listrank import ListRankConfig
    mesh = _mesh((P,), ("pe",))
    cfg = ListRankConfig(srs_rounds=1, local_contraction=True)
    cc = {}
    for fam, e in cc_graphs.items():
        labels, st = graphalg.connected_components(e, n, mesh, cfg=cfg)
        cc[fam] = (np.asarray(labels), _ints(st))
    gs = graphalg.graph_stats(edges, n, mesh, cfg=cfg)
    st = treealg.tree_stats(gs.parent, mesh, cfg=cfg)
    return {"cc": cc, "graph": _arrays(gs, GRAPH_ARRAYS),
            "tree": _arrays(st, TREE_ARRAYS)}


def serve_demo_example(prompts):
    """``examples/serve_demo.py``: gemma2-2b's SMOKE model from
    ``M.init(PRNGKey(0))`` served to ``prompts`` (4 slots, max_seq 192, 24
    new tokens, greedy): the parameters, every request's tokens and the
    ticks."""
    import jax
    from repro import configs
    from repro.models import model as M
    from repro.serve.engine import Request, ServeConfig, ServingEngine
    cfg = configs.get_config("gemma2-2b", smoke=True)
    params = M.init(jax.random.PRNGKey(0), cfg)
    eng = ServingEngine(params, cfg, ServeConfig(
        slots=4, max_seq=192, max_new_tokens=24, temperature=0.0))
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt))
    ticks = 0
    while eng.queue or eng.active.any():
        eng.step(jax.random.PRNGKey(ticks))
        ticks += 1
    return {"params": jax.tree.map(np.asarray, params),
            "out": {u: [int(t) for t in v] for u, v in eng.out.items()},
            "ticks": ticks}


def dp_compression_example(dim, rows, lr, steps):
    """``examples/dp_compression.py``'s loop (the compiled ``shard_map``
    step over a ("data",) mesh of this child's devices), compressed and
    exact: the loss after every step of each."""
    import functools
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as PS
    from repro import compat
    from repro.runtime import compression
    p = len(jax.devices())
    mesh = compat.make_mesh((p,), ("data",))
    rng = np.random.default_rng(0)
    w_true = jnp.asarray(rng.normal(size=(dim,)), jnp.float32)
    x_all = jnp.asarray(rng.normal(size=(p * rows, dim)), jnp.float32)
    y_all = x_all @ w_true

    def run(compressed):
        @jax.jit
        @functools.partial(
            compat.shard_map, mesh=mesh,
            in_specs=(PS(), PS("data"), PS("data"), PS("data")),
            out_specs=(PS(), PS("data")))
        def step(w, x, y, err):
            g = 2 * x.T @ (x @ w - y) / x.shape[0]
            if compressed:
                g, err = compression.compressed_psum(g, "data", err[0])
                g = g / p
                err = err[None]
            else:
                g = jax.lax.pmean(g, "data")
            return w - lr * g, err

        w = jnp.zeros((dim,), jnp.float32)
        err = jnp.zeros((p, dim), jnp.float32)
        losses = []
        for _ in range(steps):
            w, err = step(w, x_all, y_all, err)
            losses.append(float(jnp.mean((x_all @ w - y_all) ** 2)))
        return losses
    return {"exact": run(False), "compressed": run(True)}


def d128_logits(arch, seed, toks, cache_len, steps, prefix=None,
                overrides=None):
    """``arch``'s SMOKE model (with the config fields ``overrides``) from
    ``M.init(PRNGKey(seed))``: its parameters,
    the forward logits of ``toks`` (B, L), and the logits of a prefill of
    their first half into a cache of ``cache_len`` followed by ``steps``
    decode steps fed the next tokens, with the cache after them; with
    ``prefix`` (B, P, D_in) patch embeddings the same again behind them,
    the steps at positions P + L / 2 + i."""
    import jax
    from repro import configs
    from repro.models import model as M
    cfg = configs.get_config(arch, smoke=True).with_(**(overrides or {}))
    params = M.init(jax.random.PRNGKey(seed), cfg)
    b, seq = toks.shape
    half = seq // 2
    prefill = jax.jit(lambda p, batch, c: M.prefill(p, batch, cfg, c))
    decode = jax.jit(lambda p, t, pos, c: M.decode_step(p, t, pos, cfg, c))

    def run(batch, start):
        lg, cache = prefill(params, batch, M.init_cache(cfg, b, cache_len))
        logits = [np.asarray(lg)]
        for i in range(steps):
            lg, cache = decode(params, toks[:, half + i:half + i + 1],
                               start + i, cache)
            logits.append(np.asarray(lg))
        return {"logits": np.concatenate(logits, axis=1),
                "cache": [np.asarray(c) for c in cache]}

    out = {"params": jax.tree.map(np.asarray, params),
           "forward": np.asarray(jax.jit(lambda p, t: M.forward(
               p, {"tokens": t}, cfg)[0])(params, toks)),
           "plain": run({"tokens": toks[:, :half]}, half)}
    if prefix is not None:
        out["prefix"] = run({"tokens": toks[:, :half],
                             "prefix_embeds": prefix},
                            prefix.shape[1] + half)
    return out


def d128_engine(arch, prompts, kw, biases=None, vocab=None, pad_rows=None,
                overrides=None):
    """The reference's ``ServingEngine`` (``ServeConfig(**kw)``, its Pallas
    attention in interpret mode) on ``arch``'s SMOKE model (with the config
    fields ``overrides``) from
    ``M.init(PRNGKey(0))`` with the q/k/v ``biases`` put in, the vocabulary
    cut to ``vocab`` and the head's rows past it set to ``pad_rows``,
    serving ``prompts``: the parameters and every request's tokens."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.models import model as M
    from repro.serve.engine import Request, ServeConfig, ServingEngine
    cfg = configs.get_config(arch, smoke=True).with_(use_kernels=True,
                                                     **(overrides or {}))
    if vocab is not None:
        cfg = cfg.with_(vocab_size=vocab)
    params = M.init(jax.random.PRNGKey(0), cfg)
    for name, a in (biases or {}).items():
        params["layers"]["mixer"][name] = jnp.asarray(a)
    if pad_rows is not None:
        emb = params["embed"]["embedding"]
        params["embed"]["embedding"] = emb.at[vocab:].set(
            jnp.asarray(pad_rows, emb.dtype))
    eng = ServingEngine(params, cfg, ServeConfig(**kw))
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt))
    out = eng.run_to_completion()
    return {"params": jax.tree.map(np.asarray, params),
            "out": {u: [int(t) for t in v] for u, v in out.items()}}


JOBS = {f.__name__: f for f in (build, tree_stats, root_tree, solve_forest,
                                graph_stats, connected_components,
                                spanning_forest, fingerprints,
                                preempted_solve, resumed_solve,
                                telemetry_solve, tree_telemetry,
                                graph_telemetry, routing_solve,
                                moe_layer_ep,
                                moe_layer_dense, moe_train_step, qint8,
                                compressed_psum, adamw_int8, loss_grads,
                                dryrun_cell, dryrun_formulas,
                                quickstart_example, euler_tour_example,
                                tree_stats_example, connectivity_example,
                                serve_demo_example, dp_compression_example,
                                d128_logits, d128_engine)}

