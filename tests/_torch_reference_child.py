"""The JAX package's tree and graph front doors and its supervised
solves, run in a child process for the port's parity tests
(``tests/test_torch_treealg.py``, ``tests/test_torch_graphalg.py``,
``tests/test_torch_faultinject.py``, ``tests/test_torch_obs.py``,
``tests/test_torch_telemetry.py``).

Each of these calls compiles large simshard programs, and many such
compiles in one pytest worker have crashed XLA's CPU compiler in a later
test file of the same worker; a child process per test file keeps them
out of the worker. :func:`run_reference` runs a batch of named jobs in
one child and returns their results as numpy arrays, dicts and ints.

    python tests/_torch_reference_child.py JOBS.pkl OUT.pkl
"""
import os
import pickle
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
P = 8
TREE_ARRAYS = ("parent", "root_of", "depth", "subtree_size", "preorder",
               "postorder")
GRAPH_ARRAYS = ("components", "parent", "depth", "subtree_size", "preorder",
                "postorder")


def run_reference(jobs: dict, tmp_dir) -> dict:
    """Run ``jobs`` ({key: (job name, args)}) in one child process and
    return {key: result}."""
    inp = os.path.join(str(tmp_dir), "jobs.pkl")
    out = os.path.join(str(tmp_dir), "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump(jobs, f)
    subprocess.run([sys.executable, os.path.abspath(__file__), inp, out],
                   check=True, timeout=900)
    with open(out, "rb") as f:
        return pickle.load(f)


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


JOBS = {f.__name__: f for f in (build, tree_stats, root_tree, solve_forest,
                                graph_stats, connected_components,
                                spanning_forest, fingerprints,
                                preempted_solve, resumed_solve,
                                telemetry_solve, tree_telemetry,
                                graph_telemetry)}


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import jax
    jax.config.update("jax_platform_name", "cpu")
    with open(sys.argv[1], "rb") as f:
        jobs = pickle.load(f)
    results = {key: JOBS[name](*args) for key, (name, args) in jobs.items()}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(results, f)
