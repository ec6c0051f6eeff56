"""graphalg front doors: edges in, components / forests / tree
statistics out — one pipeline per attempt.

``graph_stats`` chains every stage of the "edges → rooted forest →
Euler tour → stats" pipeline:

  1. hooking + pointer-jumping rounds (:mod:`graphalg.cc`) — component
     labels (= min node id) and spanning-forest edge marks;
  2. unrooted-tour construction (:mod:`graphalg.forest`) — the forest's
     Euler tour cut at each component's min-id root;
  3. a full list-ranking solve (``api._solve_sharded``, the staged
     solve's stage bodies in one attempt) with unit weights: tour
     positions, hence the *orientation* (parent array) of every forest
     edge and each node's subtree size;
  4. a second solve over the same successor array with the now-known
     ±1 depth weights;
  5. finalization: each tree's start arc sends the tour length L to the
     root's owner, every down-arc sends its child's ``(parent,
     rank1_down, rank1_up, rank±_down)`` to the child's owner, and every
     node fetches its tree's L through one more aggregated gather —
     closed-form arc arithmetic turns these into depth / subtree size /
     pre- & postorder.

``connected_components`` and ``spanning_forest`` run prefixes of the
same body (stages 1 and 1–3). All capacities are host-derived
(:func:`graphalg.cc.derive_caps` + ``api.build_specs`` for the solves);
any overflow surfaces as a fatal stat and the host loop reruns the whole
pipeline with the tuner's targeted escalation — the ``graph`` family for
hooking/tour capacities, the chase/sub/gather families for the solves'.

The front doors run on the CUDA device unless ``device`` says
otherwise. ``perm_fn_for(seed)`` supplies the ruler permutations of the
solve seeded ``seed`` (the unit solve takes ``seed``, the ±1 solve
``seed + 1``; default :func:`srs.default_perm_fn`). A ``tracer`` gets a
``graphalg:{mode}`` span with one ``graphalg:{mode}#k`` attempt span
per pipeline attempt (annotated with the attempt's collectives and
their §2.6 price) and an ``escalate:graphalg:{mode}`` instant per
escalation; with ``cfg.telemetry`` the committed attempt's per-PE
record — one record through hooking, tour, both solves and the
finalization, as the reference accumulates it — becomes
``stats["telemetry"]`` (its StageRecord and headroom rows).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.listrank import api as api_lib
from repro_torch.core.listrank import exchange as exchange_lib
from repro_torch.core.listrank import resume as resume_lib
from repro_torch.core.listrank import transport as transport_lib
from repro_torch.core.listrank import tuner
from repro_torch.core.listrank.batched import set_drop, take
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.core.listrank.srs import (STAT_KEYS, _merge,
                                           default_perm_fn,
                                           gather_until_done)
from repro_torch.core.graphalg import cc as cc_lib
from repro_torch.core.graphalg import forest as forest_lib
# the single int32 wire-format id headroom constant (arc ids reach
# 2*E_pad and must stay addressable)
from repro_torch.core.treealg.batch import PACKED_ID_LIMIT as _ID_LIMIT
from repro_torch.device import resolve_device
from repro_torch.obs import telemetry as tele_lib
from repro_torch.obs import trace as trace_lib

FATAL_KEYS = resume_lib.FATAL_KEYS + cc_lib.GRAPH_FATAL_KEYS


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Per-node outputs of :func:`graph_stats` (host numpy).

    ``depth``/``subtree_size``/``preorder``/``postorder`` are the tree
    statistics of the spanning forest rooted at each component's
    minimum node id; pre/postorder are 0-based per tree. The
    ``is_ancestor``/interval helpers are the closed-form query layer
    over those numbers (no further solves or collectives).
    """
    components: np.ndarray    #: component label (= min node id)
    parent: np.ndarray        #: oriented spanning forest, root-parented
    depth: np.ndarray
    subtree_size: np.ndarray
    preorder: np.ndarray
    postorder: np.ndarray
    stats: dict

    @property
    def n_nodes(self) -> int:
        return self.components.shape[0]

    @property
    def roots(self) -> np.ndarray:
        return np.flatnonzero(self.components == np.arange(self.n_nodes))

    @property
    def n_components(self) -> int:
        return int(self.roots.shape[0])

    def component_size(self, v) -> np.ndarray:
        """Size of the component containing node(s) ``v``."""
        return self.subtree_size[self.components[v]]

    def same_component(self, u, v) -> np.ndarray:
        return self.components[u] == self.components[v]

    def is_ancestor(self, u, v) -> np.ndarray:
        """True iff ``u`` is an ancestor of ``v`` (inclusive) in the
        spanning forest — closed-form from the pre/postorder numbers
        (``treealg.ops.is_ancestor``)."""
        from repro_torch.core.treealg import ops
        return ops.is_ancestor(self.preorder, self.postorder,
                               self.components, u, v)

    def subtree_interval(self, u):
        """Preorder interval [lo, hi] covered by ``u``'s subtree."""
        from repro_torch.core.treealg import ops
        return ops.subtree_interval(self.preorder, self.subtree_size, u)


# --------------------------------------------------------------------------
# the pipeline (batched over the PE axis)
# --------------------------------------------------------------------------

class _Phases:
    """The pipeline's phases: wall seconds, each to a device sync
    (:meth:`wall`), and transport calls cut into labelled units
    (:meth:`cut`: one hooking round's legs, one shortcut iteration, the
    tour, one solve stage, the finalization)."""

    def __init__(self, plan):
        self.plan = plan
        self.prefix = ""
        self.walls: list[tuple[str, float]] = []
        self.units: list[tuple[str, dict]] = []
        self._mark = collections.Counter(plan.transport.counts)
        self._t = time.perf_counter()

    def cut(self, label: str) -> None:
        now = collections.Counter(self.plan.transport.counts)
        self.units.append((self.prefix + label, dict(now - self._mark)))
        self._mark = now

    def wall(self, label: str) -> None:
        resume_lib._sync(self.plan.device)
        t = time.perf_counter()
        self.walls.append((label, t - self._t))
        self._t = t


def _pipeline(edges_d, seed: int, perm_fn_for, *, plan, cfg: ListRankConfig,
              caps: cc_lib.GraphCaps, specs, m: int, m_e: int, mode: str,
              phases: _Phases):
    """One attempt of the pipeline on the (p, m_e, 2) int32 edges.
    Returns (out, stats, tele): (p, m) int32 outputs, 0-dim counters,
    and the attempt's per-PE telemetry record (None unless
    ``plan.telemetry``; it is never reduced over PEs)."""
    p, dev = plan.p_local, plan.device
    pe = plan.my_id()
    base = (pe * m)[:, None]
    gid = base + torch.arange(m, dtype=torch.int32, device=dev)
    ebase = (pe * m_e)[:, None]
    arc_gid = 2 * ebase + torch.arange(2 * m_e, dtype=torch.int32,
                                       device=dev)
    ea = edges_d[..., 0].contiguous()
    eb = edges_d[..., 1].contiguous()
    depth_hops = plan.indirection.depth

    def owner_node(g):
        return g // m

    # graph-pipeline counters plus the solver's (the two solves merge
    # into the same dict)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    stats = {**dict.fromkeys(STAT_KEYS, z), **cc_lib.zero_graph_stats(dev)}
    if plan.telemetry:
        stats["telemetry"] = tele_lib.stage_zero(p, depth_hops, dev)

    def finish(out, stats):
        stats = dict(stats)
        return out, stats, stats.pop("telemetry", None)

    # ---- 1. components + spanning-forest edge marks
    f, fmask, stats = cc_lib.cc_rounds(plan, caps, ea, eb, m, m_e, stats,
                                       phases)
    phases.wall("cc")
    if mode == "cc":
        return finish({"components": f}, stats)

    # ---- 2. unrooted Euler tour of the forest
    succ_t, w1, first_mask, tst = forest_lib.build_forest_tour(
        plan, caps, ea, eb, fmask, f, m, m_e)
    stats["tour_msgs"] = stats["tour_msgs"] + plan.psum(tst["sent"])[0]
    stats["tour_undelivered"] = stats["tour_undelivered"] + plan.psum(
        tst["leftover"])[0]
    if plan.telemetry:
        stats = _merge(stats, {"telemetry": {"graph": tst["telemetry"]}})
    phases.cut("tour")
    phases.wall("tour")

    # ---- 3. unit-weight ranking -> positions -> orientation
    phases.prefix = "solve1:"
    sout1 = api_lib._solve_sharded(
        succ_t, w1, perm_fn_for(seed), plan=plan, cfg=cfg, specs=specs,
        m=2 * m_e, footprint=phases)
    phases.prefix = ""
    rank1 = sout1[1]
    stats = _merge(stats, sout1[2])
    if plan.telemetry:
        stats = _merge(stats, {"telemetry": sout1[3]})
    phases.wall("solve1")
    child, parent_of, r1_down, r1_up, down0 = forest_lib.orient_forest(
        rank1, ea, eb, m_e)

    scaps = [caps.tour] * depth_hops
    if mode == "forest":
        # deliver each child its parent (one forest edge per child: the
        # kept slots are distinct); roots keep themselves
        dlv, dval, _, pst = exchange_lib.route(
            plan, scaps, {"c": child, "q": parent_of}, owner_node(child),
            fmask)
        cslot = torch.where(dval, dlv["c"] - base, m)
        parent = set_drop(gid, cslot, dlv["q"])
        have = set_drop(torch.zeros_like(f, dtype=torch.bool), cslot, True)
        miss = (~have & (f != gid)).sum(1, dtype=torch.int32)
        stats["stats_undelivered"] = stats["stats_undelivered"] + plan.psum(
            pst["leftover"] + miss)[0]
        if plan.telemetry:
            stats = _merge(stats,
                           {"telemetry": {"graph": pst["telemetry"]}})
        phases.cut("finalize")
        phases.wall("finalize")
        return finish({"components": f, "parent": parent}, stats)

    # ---- 4. ±1 depth weights over the same tour
    w2 = forest_lib.pm_weights(succ_t, arc_gid, fmask, down0)
    phases.prefix = "solve2:"
    sout2 = api_lib._solve_sharded(
        succ_t, w2, perm_fn_for(seed + 1), plan=plan, cfg=cfg, specs=specs,
        m=2 * m_e, footprint=phases)
    phases.prefix = ""
    rankpm = sout2[1]
    stats = _merge(stats, sout2[2])
    if plan.telemetry:
        stats = _merge(stats, {"telemetry": sout2[3]})
    phases.wall("solve2")
    rpm = rankpm.reshape(p, m_e, 2)
    rpm_down = torch.where(down0, rpm[..., 0], rpm[..., 1])

    # ---- 5a. tree length L to each root's owner (tour start arcs:
    # L = rank1(start) + 1; one start arc per root, distinct slots)
    fm = first_mask.reshape(p, m_e, 2)
    has_first = fm[..., 0] | fm[..., 1]
    r1m = rank1.reshape(p, m_e, 2)
    L_val = torch.where(fm[..., 0], r1m[..., 0], r1m[..., 1]) + 1
    # the start arc is a down-arc out of the root: its parent side
    root_node = parent_of
    ldlv, lval, _, lst = exchange_lib.route(
        plan, [caps.scalar] * depth_hops, {"r": root_node, "L": L_val},
        owner_node(root_node), has_first)
    rslot = torch.where(lval, ldlv["r"] - base, m)
    L_arr = set_drop(torch.zeros_like(f), rslot, ldlv["L"])

    # ---- 5b. per-child stats to the child's owner (distinct slots)
    sdlv, sval, _, sst = exchange_lib.route(
        plan, scaps,
        {"c": child, "q": parent_of, "rd": r1_down, "ru": r1_up,
         "rpm": rpm_down},
        owner_node(child), fmask)
    cslot = torch.where(sval, sdlv["c"] - base, m)
    parent = set_drop(gid, cslot, sdlv["q"])
    rd = set_drop(torch.zeros_like(f), cslot, sdlv["rd"])
    ru = set_drop(torch.zeros_like(f), cslot, sdlv["ru"])
    rpmd = set_drop(torch.zeros_like(f), cslot, sdlv["rpm"])
    have = set_drop(torch.zeros_like(f, dtype=torch.bool), cslot, True)
    miss = (~have & (f != gid)).sum(1, dtype=torch.int32)

    # ---- 5c. every node fetches its tree's L (aggregated gather)
    def lookup_L(gids, valid):
        return {"L": take(L_arr, torch.clamp(gids - base, 0, m - 1))}

    lresp, lans, lgst = gather_until_done(
        plan, f, torch.ones_like(f, dtype=torch.bool), owner_node, lookup_L,
        caps.scalar, caps.scalar, dedup=True)
    L_of = torch.where(lans, lresp["L"], 0)
    stats["stats_undelivered"] = stats["stats_undelivered"] + (
        lgst["undelivered"] + plan.psum(lst["leftover"] + sst["leftover"]
                                        + miss))[0]
    if plan.telemetry:
        finale = tele_lib.merge(tele_lib.merge(lst["telemetry"],
                                               sst["telemetry"]),
                                lgst["telemetry"])
        stats = _merge(stats, {"telemetry": {"graph": finale}})
    phases.cut("finalize")

    # ---- closed-form per-node statistics
    is_nonroot = have
    depth = torch.where(is_nonroot, 2 - rpmd, 0)
    size = torch.where(is_nonroot, (rd - ru + 1) // 2, L_of // 2 + 1)
    pos_down = L_of - 1 - rd
    pos_up = L_of - 1 - ru
    pre = torch.where(is_nonroot, (pos_down + 1 + depth) // 2, 0)
    post = torch.where(is_nonroot, (pos_up + 2 - depth) // 2 - 1,
                       torch.clamp(L_of // 2, min=0))
    phases.wall("finalize")
    out = {"components": f, "parent": parent, "depth": depth,
           "subtree_size": size, "preorder": pre, "postorder": post}
    return finish(out, stats)


# --------------------------------------------------------------------------
# host loops
# --------------------------------------------------------------------------

def _check_edges(edges, n_nodes: int) -> np.ndarray:
    if isinstance(edges, torch.Tensor):
        edges = edges.detach().cpu().numpy()
    edges = np.asarray(edges)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError("edges must be an (E, 2) array of node ids")
    if n_nodes <= 0:
        raise ValueError("n_nodes must be positive")
    edges = edges.astype(np.int64)
    if edges.size and not ((edges >= 0) & (edges < n_nodes)).all():
        raise ValueError("edge endpoints out of range")
    return edges


def _prepare(edges, n_nodes, mesh, pe_axes, cfg, device):
    """Shared host-side prep on a resolved mesh: padding, plan, capacity
    derivation."""
    edges = _check_edges(edges, n_nodes)
    plan = api_lib.make_plan(mesh, pe_axes, cfg, device)
    p = plan.p
    n_pad = n_nodes + (-n_nodes) % p
    m = n_pad // p
    # padding edges are self-loops at node 0: they never propose a hook
    # and never join the forest, so no validity plumbing is needed
    e_pad = max(edges.shape[0], p)
    e_pad = e_pad + (-e_pad) % p
    m_e = e_pad // p
    if n_pad >= _ID_LIMIT or 2 * e_pad >= _ID_LIMIT:
        raise ValueError(
            f"instance too large for int32 ids: n_pad={n_pad}, "
            f"2*E_pad={2 * e_pad} must stay below {_ID_LIMIT}")
    edges_pad = np.zeros((e_pad, 2), np.int64)
    edges_pad[:edges.shape[0]] = edges

    base_caps = cc_lib.derive_caps(edges_pad, n_pad, p, cfg)
    if cfg.algorithm == "auto":
        cfg = cfg.with_(algorithm=tuner.choose_algorithm(
            cfg, p, plan.indirection.depth, 2 * m_e))
    return cfg, plan, edges_pad, base_caps, n_pad, m, e_pad, m_e


def _attempt_specs(cfg, plan, m_e: int, e_pad: int,
                   scales: tuner.CapacityScales = tuner.CapacityScales()):
    """Solve-stage spec ladder for one attempt. The solves rank a tour
    over *edge-sharded* arcs: a node's incident arcs all live on edge
    PEs, so wave traffic concentrates harder than the uniform-list
    expectation behind the capacity derivation — the chase/queue slack
    starts doubled. The two solves share one ladder over the
    2*E_pad-arc instance; every arc may be a terminal (self-loop
    padding), hence the full term bound."""
    cfg_solve = cfg.with_(capacity_slack=2 * cfg.capacity_slack,
                          queue_slack=2 * cfg.queue_slack)
    return api_lib.build_specs(cfg_solve, plan, 2 * m_e, 2 * e_pad,
                               term_bound=2 * m_e, scales=scales)


def _run_pipeline(edges, n_nodes, mesh, pe_axes, cfg, mode, seed,
                  max_retries, tracer=None, device=None, perm_fn_for=None):
    cfg = cfg or ListRankConfig()
    pe_axes = tuple(pe_axes) if pe_axes is not None \
        else tuple(mesh.axis_names)
    _, mesh = transport_lib.resolve_backend(cfg.backend, mesh, pe_axes)
    device = resolve_device(device, mesh)
    cfg, plan, edges_pad, base_caps, n_pad, m, e_pad, m_e = _prepare(
        edges, n_nodes, mesh, pe_axes, cfg, device)
    # every rank holds the whole edge list and copies its own block
    edges_d = api_lib.local_block(plan, edges_pad.astype(np.int32), device)
    perm_fn_for = perm_fn_for or default_perm_fn
    tr = trace_lib.ensure(tracer)

    scales = tuner.CapacityScales()
    last_stats = None
    with tr.span(f"graphalg:{mode}", cat="solve", n_nodes=n_nodes,
                 p=plan.p, mode=mode,
                 backend=transport_lib.backend_name(mesh)) as pipe_span:
        for attempt in range(max_retries + 1):
            caps = base_caps.scaled(scales.graph)
            specs = _attempt_specs(cfg, plan, m_e, e_pad, scales)
            att = tr.begin(f"graphalg:{mode}#{attempt + 1}",
                           cat="stage-attempt", stage=f"graphalg:{mode}",
                           level=-1, attempt=attempt + 1,
                           scales=tuner.format_scales(scales))
            plan.transport.clear()
            phases = _Phases(plan)
            t0 = time.perf_counter()
            out, stats, tele = _pipeline(
                edges_d, seed, perm_fn_for, plan=plan, cfg=cfg, caps=caps,
                specs=specs, m=m, m_e=m_e, mode=mode, phases=phases)
            keys = list(stats)
            host_stats = dict(zip(keys, torch.stack(
                [stats[k] for k in keys]).tolist()))
            dt = time.perf_counter() - t0
            if tr.enabled:
                att.annotate(**resume_lib.attempt_prediction(plan,
                                                             cfg.machine))
            host_stats["attempts"] = attempt + 1
            if sum(host_stats[k] for k in FATAL_KEYS) == 0:
                host_stats["stage_wall_s"] = tuple(phases.walls)
                host_stats["stage_collectives"] = tuple(phases.units)
                util = {}
                if tele is not None:
                    agg = tele_lib.aggregate(tele_lib.to_host(
                        tele, plan.transport))
                    util = tele_lib.utilization(agg)
                    spec0 = specs[0]
                    rec = tele_lib.StageRecord(
                        label=f"graphalg:{mode}", kind="pipeline", level=-1,
                        caps={"chase": tuple(spec0.mail_caps),
                              "sub": (spec0.cap_sub,),
                              "gather": tuple(
                                  max(a, b) for a, b in zip(
                                      spec0.gather_req_cap,
                                      spec0.gather_resp_cap)),
                              "graph": (caps.tour,)},
                        queue_cap=spec0.queue_cap, tele=agg)
                    host_stats["telemetry"] = {
                        "stages": [rec.to_json()],
                        "headroom": tele_lib.headroom_rows(
                            [rec], tuner.format_scales(scales))}
                    tr.counter("telemetry/util_max", util["util_max"])
                    tr.counter("telemetry/util_mean", util["util_mean"])
                tr.end(att, wall_s=dt, outcome="committed", **util)
                # every node's outputs on every rank (one uncounted
                # gather a leaf on the distributed transport)
                host = {k: plan.transport.gather_pes(v).reshape(-1)[
                    :n_nodes].cpu().numpy() for k, v in out.items()}
                pipe_span.annotate(attempts=attempt + 1, outcome="ok")
                if tr.enabled:
                    from repro_torch.obs import metrics as metrics_lib
                    metrics_lib.ingest_host_stats(tr.metrics, host_stats,
                                                  prefix=f"graphalg/{mode}/")
                return host, host_stats
            tr.end(att, wall_s=dt, outcome="overflow",
                   fatal={k: host_stats[k] for k in FATAL_KEYS
                          if host_stats.get(k, 0) > 0})
            last_stats = host_stats
            scales = tuner.escalate(scales, host_stats)
            tr.instant(f"escalate:graphalg:{mode}", cat="retry",
                       scales=tuner.format_scales(scales))
        pipe_span.annotate(outcome="exhausted")
    raise RuntimeError(
        f"graphalg {mode} did not complete after {max_retries + 1} "
        f"attempts; stats={last_stats}")


def pipeline_collective_footprint(edges, n_nodes: int, mesh,
                                  pe_axes: Sequence[str] | None = None,
                                  cfg: ListRankConfig | None = None,
                                  mode: str = "stats", device=None,
                                  seed: int = 0):
    """Run the pipeline once and return its transport calls per unit:
    ``{label: {collective: count}}`` for ``cc:hook`` (one hooking
    round's label gather, proposals and confirmations), ``cc:jump`` (one
    shortcut iteration), ``cc:stats`` (one round's counter reduction),
    ``cc:end``, ``tour``, each solve stage (``solve1:<stage>``,
    ``solve2:<stage>``) and ``finalize``. A label whose units disagree
    maps to the tuple of its distinct counts instead."""
    _, stats = _run_pipeline(edges, n_nodes, mesh, pe_axes, cfg, mode, seed,
                             max_retries=0, device=device)
    return footprint_of(stats["stage_collectives"])


def footprint_of(stage_collectives) -> dict:
    """Group a run's ``stage_collectives`` ((label, counts) units) by
    label, as :func:`pipeline_collective_footprint` returns them."""
    grouped: dict = {}
    for label, counts in stage_collectives:
        seen = grouped.setdefault(label, [])
        if counts not in seen:
            seen.append(counts)
    return {k: v[0] if len(v) == 1 else tuple(v) for k, v in grouped.items()}


def connected_components(edges, n_nodes: int, mesh,
                         pe_axes: Sequence[str] | None = None,
                         cfg: ListRankConfig | None = None, seed: int = 0,
                         max_retries: int = 3, tracer=None, device=None,
                         perm_fn_for=None):
    """Connected components of an undirected edge list on the mesh.

    Returns (labels, stats): ``labels[v]`` is the minimum node id of
    v's component (a canonical labeling).
    """
    out, stats = _run_pipeline(edges, n_nodes, mesh, pe_axes, cfg, "cc",
                               seed, max_retries, tracer, device,
                               perm_fn_for)
    return out["components"], stats


def spanning_forest(edges, n_nodes: int, mesh,
                    pe_axes: Sequence[str] | None = None,
                    cfg: ListRankConfig | None = None, seed: int = 0,
                    max_retries: int = 3, tracer=None, device=None,
                    perm_fn_for=None):
    """Oriented spanning forest of an undirected edge list.

    Returns (parent, labels, stats): ``parent`` is a rooted forest of
    *graph edges* — each component spanned and rooted at its minimum
    node id (``parent[root] == root``) — which feeds directly into
    ``treealg`` (``tree_stats`` / ``solve_forest`` / ``root_tree``).
    """
    out, stats = _run_pipeline(edges, n_nodes, mesh, pe_axes, cfg,
                               "forest", seed, max_retries, tracer, device,
                               perm_fn_for)
    return out["parent"], out["components"], stats


def graph_stats(edges, n_nodes: int, mesh,
                pe_axes: Sequence[str] | None = None,
                cfg: ListRankConfig | None = None, seed: int = 0,
                max_retries: int = 3, tracer=None, device=None,
                perm_fn_for=None) -> GraphStats:
    """Components, oriented spanning forest, and per-node tree
    statistics from a raw edge list.

    Returns a :class:`GraphStats` with, per node: component label,
    spanning-forest parent, depth, subtree size and pre/postorder
    numbers (plus the closed-form ``is_ancestor``/interval query layer
    over them). ``stats`` holds the graph and solver counters,
    ``attempts``, ``stage_wall_s`` (each phase's wall seconds) and
    ``stage_collectives`` (each unit's transport calls, as
    :func:`footprint_of` groups them).
    """
    out, stats = _run_pipeline(edges, n_nodes, mesh, pe_axes, cfg, "stats",
                               seed, max_retries, tracer, device,
                               perm_fn_for)
    return GraphStats(components=out["components"], parent=out["parent"],
                      depth=out["depth"], subtree_size=out["subtree_size"],
                      preorder=out["preorder"], postorder=out["postorder"],
                      stats=stats)
