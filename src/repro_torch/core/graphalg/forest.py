"""Euler tours of *unrooted* spanning forests (edge-list layout).

``treealg.euler`` builds tours from a parent array — the orientation is
an input. Here the forest arrives as the undirected edge marks that the
hooking rounds produced (:func:`graphalg.cc.cc_rounds`), so the tour
must be built from raw adjacency and the orientation *falls out of the
ranking*: rank the tour cut at each component's root, and for every
forest edge the arc traversed first is the parent→child direction.

Arc layout: forest edge at global edge slot ``e`` owns the arc pair
``2e`` (a→b) and ``2e+1`` (b→a) — arcs shard with the edges, twins are
co-located, and ``owner(arc) = arc // (2 m_E)``. Construction is one
:func:`exchange.request_reply` round:

  1. every forest edge reports ``(node, in_arc, out_arc)`` to each
     endpoint's owner;
  2. the owner groups the reports per node (pre-sort by *neighbor* id,
     then the stable ``sort_and_group`` — each node's ascending-neighbor
     circular adjacency order, treealg's ascending-child convention),
     links each in-arc to the *next* out-arc around the node (wrapping),
     cuts the wrap at component roots (``label == id``) to make the
     tour's terminal, flags the root's first out-arc as the tree's
     start, and replies to the arc owners (twins are co-located, so one
     reply serves both).

Non-forest edges' arcs are weight-0 self-loops, so the instance shards
perfectly whatever the number of forest edges. Capacities for both legs
come from the exact endpoint histogram of the full edge list.

Every per-PE tensor carries the leading PE axis.
"""
from __future__ import annotations

import torch

from repro_torch.core.listrank import exchange as exchange_lib
from repro_torch.core.listrank.batched import INT_MAX, set_drop, take
from repro_torch.core.graphalg.cc import GraphCaps


def build_forest_tour(plan, caps: GraphCaps, ea, eb, fmask, f, m: int,
                      m_e: int):
    """Device-side tour construction.

    Args:
      ea/eb: (p, m_e) per-PE edge endpoints (global node ids).
      fmask: (p, m_e) spanning-forest marks from the hooking rounds.
      f: (p, m) converged component labels (roots are ``f[v] == v``).

    Returns (succ, w_unit, first_mask, stats_local): the (p, 2*m_e) tour
    successor and unit weights, the tree-start arc marks, and *local*
    (un-psummed) {"sent", "leftover"} transport counters (plus the
    round's per-PE ``"telemetry"`` record with ``plan.telemetry``).
    """
    p, dev = plan.p_local, plan.device
    pe = plan.my_id()
    base = (pe * m)[:, None]
    gid = base + torch.arange(m, dtype=torch.int32, device=dev)
    ebase = (pe * m_e)[:, None]
    eid = ebase + torch.arange(m_e, dtype=torch.int32, device=dev)
    is_root = f == gid
    arc_gid = 2 * ebase + torch.arange(2 * m_e, dtype=torch.int32,
                                       device=dev)

    def owner_node(g):
        return g // m

    def owner_arc(a):
        return a // (2 * m_e)

    # one report per (forest edge, endpoint): the in-arc entering the
    # endpoint, the out-arc leaving it, and the neighbor at the far end
    node = torch.cat([ea, eb], 1)
    nbr = torch.cat([eb, ea], 1)
    ain = torch.cat([2 * eid + 1, 2 * eid], 1)
    aout = torch.cat([2 * eid, 2 * eid + 1], 1)
    rvalid = torch.cat([fmask, fmask], 1)

    def reply_fn(dlv, dval):
        nd, ai, ao = dlv["node"], dlv["ain"], dlv["aout"]
        # canonical circular adjacency: ascending *neighbor id* per node
        # (pre-sort by neighbor, then stable group by node). The forest
        # never keeps parallel edges, so the neighbor key is unique
        # within a node's run.
        orda = torch.argsort(torch.where(dval, dlv["nbr"], INT_MAX), dim=1,
                             stable=True)
        nd_c, ai_c, ao_c = take(nd, orda), take(ai, orda), take(ao, orda)
        val_c = take(dval, orda)
        order, skey, pos, newrun = exchange_lib.sort_and_group(
            nd_c, val_c, INT_MAX)
        ai_s, ao_s = take(ai_c, order), take(ao_c, order)
        val_s = skey != INT_MAX
        q = val_s.shape[1]
        i = torch.arange(q, dtype=torch.int32, device=dev)

        # circular next: in-arc i links to the next entry's out-arc,
        # wrapping the last entry of each run to the run's first
        last = torch.cat([newrun[:, 1:], torch.ones_like(newrun[:, :1])], 1)
        first_out = take(ao_s, i - pos)  # run start = i - pos
        nxt = torch.where(last, first_out,
                          torch.cat([ao_s[:, 1:], ao_s[:, :1]], 1))
        # cut at component roots: the wrap arc terminates the tour, and
        # the root's first out-arc is the tree's start
        nslot = torch.clamp(skey - base, 0, m - 1)
        rooted = val_s & take(is_root, nslot)
        cut = last & rooted
        succ_val = torch.where(cut, ai_s, nxt)
        fflag = newrun & rooted
        return ({"ain": ai_s, "succ": succ_val, "aout": ao_s,
                 "fflag": fflag}, owner_arc(ai_s), val_s)

    rdel, rval, _, rr_st = exchange_lib.request_reply(
        plan, caps.tour, caps.tour,
        {"node": node, "nbr": nbr, "ain": ain, "aout": aout},
        owner_node(node), rvalid, reply_fn)

    # receive: in-arc successors and tree-start flags (one reply per
    # in-arc, so the kept slots are distinct)
    aslot = torch.where(rval, rdel["ain"] - 2 * ebase, 2 * m_e)
    succ = set_drop(arc_gid, aslot, rdel["succ"])
    oslot = torch.where(rval & rdel["fflag"], rdel["aout"] - 2 * ebase,
                        2 * m_e)
    first_mask = set_drop(torch.zeros_like(succ, dtype=torch.bool), oslot,
                          True)
    have = set_drop(torch.zeros_like(succ, dtype=torch.bool), aslot, True)

    # every forest arc must have received its successor
    expect = fmask.repeat_interleave(2, dim=1)
    missing = (expect & ~have).sum(1, dtype=torch.int32)
    w_unit = (succ != arc_gid).to(torch.int32)
    stats_local = {"sent": rr_st["sent"],
                   "leftover": rr_st["leftover"] + missing}
    if plan.telemetry:
        stats_local["telemetry"] = rr_st["telemetry"]
    return succ, w_unit, first_mask, stats_local


def orient_forest(rank1, ea, eb, m_e: int):
    """Per-edge orientation from the unit ranking: the arc with the
    larger rank-to-terminal comes earlier in the tour and is the
    parent→child traversal.

    Returns (child, parent, r1_down, r1_up, down0) per local edge
    slot, computed for *every* slot — callers gate on their forest
    mask downstream; ``down0`` marks edges whose even arc (a→b) is
    the downward one.
    """
    r = rank1.reshape(rank1.shape[0], m_e, 2)
    r0, r1 = r[..., 0], r[..., 1]
    down0 = r0 > r1
    child = torch.where(down0, eb, ea)
    parent = torch.where(down0, ea, eb)
    r1_down = torch.where(down0, r0, r1)
    r1_up = torch.where(down0, r1, r0)
    return child, parent, r1_down, r1_up, down0


def pm_weights(succ, arc_gid, fmask, down0):
    """±1 depth weights for the second solve: +1 on down-arcs, -1 on
    up-arcs, 0 on terminals and non-forest self-loops."""
    w_even = torch.where(down0, 1, -1).to(torch.int32)
    w = torch.stack([w_even, -w_even], 2).reshape(arc_gid.shape)
    live = fmask.repeat_interleave(2, dim=1) & (succ != arc_gid)
    return torch.where(live, w, 0)
