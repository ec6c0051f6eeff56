"""Device-side Euler-tour construction from a sharded parent array.

The tree (or forest) arrives as block-sharded parent pointers — node c
on PE ``c // m`` with ``parent[root] == root`` — and leaves as the
tour's list-ranking instance: a sharded successor array over the arc
ids plus the matching weights. Node c owns the two arc slots
``down(c) = 2c`` and ``up(c) = 2c + 1`` (``(q→c)`` and ``(c→q)`` for
q = parent[c]); a root's slots are weight-0 self-loop dummies, so the
arc array is exactly twice the node array and shards on the same block
boundaries — PE k owns the arcs of its own nodes.

Construction is two exchange rounds (one :func:`exchange.request_reply`):

  1. every non-root node reports ``(child, parent)`` to its parent's
     owner. The owner recovers each node's adjacency list as one run of
     :func:`exchange.sort_and_group` (children pre-sorted by id, then
     stably grouped by parent), which yields first-child marks (run
     starts) and next-sibling links (run neighbors) in one pass.
  2. the owner replies ``(next_sibling, parent_is_root, parent's first
     child)`` to each child's owner.

Everything else is local arc arithmetic. Capacities for both rounds are
exact (the host derives the per-(sender, receiver) message histogram
from the parent array), so a nonzero ``tour_undelivered`` is defensive
and triggers a doubling retry on the host.

Every per-PE tensor carries the leading PE axis; ids are int32.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.listrank import api as api_lib
from repro_torch.core.listrank import exchange as exchange_lib
from repro_torch.core.listrank import instances
from repro_torch.core.listrank import transport as transport_lib
from repro_torch.core.listrank.batched import INT_MAX, set_drop, take
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.device import resolve_device
from repro_torch.obs import telemetry as tele_lib
from repro_torch.obs import trace as trace_lib


def down(c):
    """Arc id of (parent(c) → c) in the device layout."""
    return 2 * c


def up(c):
    """Arc id of (c → parent(c)) in the device layout."""
    return 2 * c + 1


def tour_caps(parent: np.ndarray, p: int) -> tuple[int, int]:
    """Exact per-peer mailbox capacities for the two construction
    rounds: the max entry of the (sender, receiver) message histogram,
    and of its transpose for the replies."""
    n = parent.shape[0]
    m = n // p
    idx = np.arange(n)
    nonroot = parent != idx
    hist = np.zeros((p, p), np.int64)
    np.add.at(hist, (idx[nonroot] // m, parent[nonroot] // m), 1)
    c1 = int(hist.max()) if nonroot.any() else 0
    return max(c1, 8), max(c1, 8)  # reply histogram = transpose, same max


def _build_sharded(parent, cut: int, *, plan, m: int, child_cap: int,
                   reply_cap: int, weighted: bool, closed: bool):
    """One construction attempt on the (p, m) int32 parent tensor.
    Returns (succ, w, stats): (p, 2m) int32 tensors and the psum'd
    (p,) ``tour_undelivered`` / ``tour_msgs`` counters — with
    ``plan.telemetry`` a 4th element, the rounds' per-PE telemetry record
    (graph family; never psum'd)."""
    p, dev = plan.p_local, plan.device
    base = (plan.my_id() * m)[:, None]
    gid = base + torch.arange(m, dtype=torch.int32, device=dev)
    q = parent
    is_root = q == gid
    nonroot = ~is_root
    neg1 = torch.full((p, 1), -1, dtype=torch.int32, device=dev)

    def owner_of(g):
        return g // m

    def reply_fn(delivered, dval):
        # adjacency runs: one pre-sort by child id, then sort_and_group
        # stably groups by parent — within each parent's run the children
        # ascend, i.e. the tour's adjacency order.
        ch, par = delivered["child"], delivered["parent"]
        ordc = torch.argsort(torch.where(dval, ch, INT_MAX), dim=1,
                             stable=True)
        ch_c, par_c, val_c = take(ch, ordc), take(par, ordc), take(dval, ordc)
        order, skey, _, newrun = exchange_lib.sort_and_group(par_c, val_c,
                                                             INT_MAX)
        ch_s = take(ch_c, order)
        val_s = skey != INT_MAX

        # first child of each local node: the run starts (one per parent,
        # so the kept slots are distinct), scattered by the local parent
        # id; a valid run's key is owned here by routing.
        pslot = torch.where(val_s, skey - base, m)
        fc = set_drop(torch.full((p, m), -1, dtype=torch.int32, device=dev),
                      torch.where(newrun & val_s, pslot, m), ch_s)
        # next sibling: the following sorted row, if in the same run
        has_next = torch.cat([~newrun[:, 1:], torch.zeros_like(newrun[:, :1])],
                             1)
        ns_row = torch.where(has_next, torch.cat([ch_s[:, 1:], neg1], 1), -1)
        pslot_c = torch.clamp(pslot, 0, m - 1)
        par_root = val_s & take(is_root, pslot_c)
        par_fc = take(fc, pslot_c)
        # reply (next sibling, parent-is-root, parent's first child) to
        # each child's owner
        return ({"child": ch_s, "ns": ns_row, "proot": par_root,
                 "pfc": par_fc}, owner_of(ch_s), val_s, fc)

    rdel, rval, fc, rr_st = exchange_lib.request_reply(
        plan, child_cap, reply_cap, {"child": gid, "parent": q},
        owner_of(q), nonroot, reply_fn)
    # one reply per child: the kept slots are distinct
    rslot = torch.where(rval, rdel["child"] - base, m)
    ns = set_drop(torch.full((p, m), -1, dtype=torch.int32, device=dev),
                  rslot, rdel["ns"])
    proot = set_drop(torch.zeros_like(nonroot), rslot, rdel["proot"])
    pfc = set_drop(torch.full((p, m), -1, dtype=torch.int32, device=dev),
                   rslot, rdel["pfc"])
    have = set_drop(torch.zeros_like(nonroot), rslot, True)

    # local arc assembly (the tour's successor rules)
    succ_down = torch.where(fc >= 0, down(fc), up(gid))
    # last sibling: up(parent), except at the root where the tour is cut
    # (terminal) — or, for a closed tour, wraps to the root's first arc.
    at_root_end = down(pfc) if closed else up(gid)
    succ_up = torch.where(ns >= 0, down(ns),
                          torch.where(proot, at_root_end, up(q)))
    if closed:
        # cut the circular tour at `cut`: down(cut) becomes the terminal
        succ_down = torch.where(gid == cut, down(gid), succ_down)
    succ_down = torch.where(nonroot, succ_down, down(gid))
    succ_up = torch.where(nonroot, succ_up, up(gid))
    succ = torch.stack([succ_down, succ_up], 2).reshape(p, 2 * m)

    arc_gid = 2 * base + torch.arange(2 * m, dtype=torch.int32, device=dev)
    is_term = succ == arc_gid
    if weighted:
        w = torch.where(arc_gid % 2 == 0, 1, -1).to(torch.int32)
    else:
        w = torch.ones_like(succ)
    w = torch.where(is_term, 0, w)

    missing = (nonroot & ~have).sum(1, dtype=torch.int32)
    stats = {"tour_undelivered": plan.psum(missing + rr_st["leftover"]),
             "tour_msgs": plan.psum(rr_st["sent"])}
    if plan.telemetry:
        tele = tele_lib.merge(
            tele_lib.stage_zero(p, plan.indirection.depth, dev),
            {"graph": rr_st["telemetry"]})
        return succ, w, stats, tele
    return succ, w, stats


def _host_parent(parent) -> np.ndarray:
    if isinstance(parent, torch.Tensor):
        parent = parent.detach().cpu().numpy()
    return np.asarray(parent).astype(np.int64)


def build_tour(parent, mesh, pe_axes=None, cfg: ListRankConfig | None = None,
               weighted: bool = False, cut_at: int | None = None,
               max_retries: int = 2, tracer=None, device=None):
    """Build the Euler tour of a block-sharded tree/forest on the mesh.

    Args:
      parent: (n_nodes,) parent pointers, ``parent[root] == root``
        (numpy or a tensor). Multiple roots = a forest (each tree's tour
        is cut at its root). Padded with singleton roots to a PE multiple.
      weighted: ±1 depth weights instead of unit weights.
      cut_at: close every root loop and cut the (single) tree's circular
        tour at ``down(cut_at)`` instead — the re-rooting primitive
        behind :func:`repro_torch.core.treealg.ops.root_tree`. Requires
        a single-tree input.
      device: where the tour is built (the CUDA device when None; without
        CUDA that raises). On a ``DistMesh`` every rank passes the whole
        parent array and builds its own block of the tour.
      tracer: records a ``build_tour`` span with one ``build_tour#k``
        attempt span per construction attempt; with ``cfg.telemetry``
        the tour span carries the rounds' graph-family StageRecord.

    Returns:
      (succ, weight, n_pad): (2*n_pad,) int32 tensors on ``device`` — a
      list-ranking instance over the arc ids, block-sharded like the
      nodes — and the padded node count. Slots of padding/root nodes are
      weight-0 self-loops. On a ``DistMesh`` every rank gets the whole
      tour (one uncounted gather), the input the list front door takes.
    """
    cfg = cfg or ListRankConfig()
    pe_axes = tuple(pe_axes) if pe_axes is not None else tuple(mesh.axis_names)
    backend, mesh = transport_lib.resolve_backend(cfg.backend, mesh,
                                                  pe_axes)
    device = resolve_device(device, mesh)
    parent_np = _host_parent(parent)
    n = parent_np.shape[0]
    if n == 0:
        raise ValueError("empty tree")
    idx = np.arange(n)
    if not ((parent_np >= 0) & (parent_np < n)).all():
        raise ValueError("parent pointers out of range")
    closed = cut_at is not None
    if closed:
        roots = idx[parent_np == idx]
        if roots.size != 1:
            raise ValueError("cut_at requires a single-tree input")
        if not 0 <= cut_at < n:
            raise ValueError("cut_at out of range")
        if cut_at == int(roots[0]):
            closed = False  # already rooted there; the default cut is it
    plan = api_lib.make_plan(mesh, pe_axes, cfg, device)
    p = plan.p
    pad = (-n) % p
    parent_pad = np.concatenate([parent_np, np.arange(n, n + pad)])
    n_pad = n + pad
    m = n_pad // p
    parent_d = api_lib.local_block(plan, parent_pad.astype(np.int32), device)
    cut = int(cut_at) if closed else -1

    cap1, cap2 = tour_caps(parent_pad, p)
    tr = trace_lib.ensure(tracer)
    with tr.span("build_tour", cat="solve", n_nodes=n, p=p,
                 backend=backend) as tour_span:
        for attempt in range(max_retries + 1):
            att = tr.begin(f"build_tour#{attempt + 1}", cat="stage-attempt",
                           stage="build_tour", level=-1,
                           attempt=attempt + 1)
            t0 = time.perf_counter()
            out = _build_sharded(
                parent_d, cut, plan=plan, m=m, child_cap=cap1,
                reply_cap=cap2, weighted=weighted, closed=closed)
            succ, w, stats = out[:3]
            # one sync an attempt: the counter's read bounds the wall
            ok = int(stats["tour_undelivered"][0]) == 0
            dt = time.perf_counter() - t0
            if ok:
                util = {}
                if plan.telemetry:
                    agg = tele_lib.aggregate(tele_lib.to_host(
                        out[3], plan.transport))
                    util = tele_lib.utilization(agg)
                    tour_span.annotate(
                        telemetry=tele_lib.StageRecord(
                            label="build_tour", kind="tour", level=-1,
                            caps={"graph": (cap1, cap2)}, queue_cap=0,
                            tele=agg).to_json())
                tr.end(att, wall_s=dt, outcome="committed", **util)
                tour_span.annotate(attempts=attempt + 1, outcome="ok")
                succ = plan.transport.gather_pes(succ)
                w = plan.transport.gather_pes(w)
                return succ.reshape(2 * n_pad), w.reshape(2 * n_pad), n_pad
            tr.end(att, wall_s=dt, outcome="overflow")
            cap1, cap2 = 2 * cap1, 2 * cap2  # defensive: caps are exact
        tour_span.annotate(outcome="exhausted")
    raise RuntimeError(
        f"Euler tour construction incomplete after {max_retries + 1} "
        f"attempts; stats={ {k: int(v[0]) for k, v in stats.items()} }")


def oracle_tour(n_nodes: int, parent: np.ndarray) -> np.ndarray:
    """Host-side oracle in the *device* layout: the expected successor
    array for a rooted forest, built by relabeling the
    ``instances.gen_euler_tour`` construction rules (its ``2(c-1)``
    ids become ``2c``; roots gain self-loop dummy slots)."""
    n = n_nodes
    idx = np.arange(n)
    is_root = parent == idx
    cand = idx[~is_root]
    first_child, next_sib = instances.adjacency_links(np.asarray(parent,
                                                                 np.int64))
    succ = np.arange(2 * n, dtype=np.int64)
    c = cand
    q = parent[c]
    fc = first_child[c]
    ns = next_sib[c]
    succ[2 * c] = np.where(fc >= 0, 2 * fc, 2 * c + 1)
    succ[2 * c + 1] = np.where(ns >= 0, 2 * ns,
                               np.where(is_root[q], 2 * c + 1, 2 * q + 1))
    return succ
