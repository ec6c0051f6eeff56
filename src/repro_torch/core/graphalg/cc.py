"""Distributed connected components: min-label hooking + pointer
jumping over block-sharded edge lists (the graphalg contraction core).

The input is an edge list sharded like every other instance here — PE k
owns edges ``[k*mE, (k+1)*mE)`` and nodes ``[k*m, (k+1)*m)`` — and the
whole computation is bulk-synchronous rounds where every remote access
rides the packed exchange layer (one ``all_to_all`` per hop). Per
hooking round:

  1. **label gather** — every edge fetches its endpoints' current
     labels ``f[a], f[b]`` (static targets, host-exact capacities from
     the endpoint histogram, request dedup per PE);
  2. **hook proposals** — every cross-label edge proposes
     ``f[max(la,lb)] = min(la,lb)`` to the owner of the larger label;
     the owner applies the min proposal per *root* (``f[t] == t``) and
     resolves the winning edge by a second scatter-min on edge ids;
  3. **winner confirmation** — each hooked root confirms its winning
     edge back to that edge's owning PE, which marks it as a
     spanning-forest edge;
  4. **shortcut** — pointer jumping ``f = f[f]`` to a fixed point, so
     next round's labels are component roots again.

Labels converge to the component's minimum node id. The round budget is
part of :class:`GraphCaps`; a ``cc_unconverged`` stat triggers the
tuner's ``graph``-family retry (doubled budget).

Both loops (hooking rounds, shortcut iterations) are host loops that
read one psum'd count per iteration — one device sync each. The
min-scatters are ``scatter_reduce("amin")``, whose result does not
depend on the order of duplicate indices.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.listrank import exchange as exchange_lib
from repro_torch.core.listrank.batched import INT_MAX, set_drop, take
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.core.listrank.srs import gather_until_done
from repro_torch.obs import telemetry as tele_lib

#: graphalg's own stat keys; the ``cc_*``/``tour_*``/``stats_*`` fatal
#: keys map to the tuner's ``graph`` capacity family (tuner.FAMILY_OF).
GRAPH_FATAL_KEYS = ("cc_undelivered", "cc_unconverged", "tour_undelivered",
                    "stats_undelivered")


@dataclasses.dataclass(frozen=True)
class GraphCaps:
    """Host-derived static capacities of the graphalg pipeline.

    ``label`` and ``tour`` are sized from the exact endpoint histogram
    of the full edge list (an upper bound for the forest subset); the
    rest bound dynamic-destination traffic with slack and rely on the
    retry loop.
    """

    label: int     #: endpoint label gather (host-exact, static targets)
    prop: int      #: hook proposals to label owners (dynamic)
    confirm: int   #: winner confirmations to edge owners (dynamic)
    jump: int      #: pointer-jump gathers f[f] (dynamic, deduped)
    tour: int      #: adjacency reports/replies + stats scatter (exact)
    scalar: int    #: per-tree scalar traffic (tour length broadcast)
    rounds: int    #: hooking-round budget
    jumps: int     #: shortcut iterations per hooking round

    def scaled(self, scale: float) -> "GraphCaps":
        """The tuner's ``graph``-family escalation: every capacity —
        including the round budget — times ``scale``."""
        if scale == 1.0:
            return self
        s = max(scale, 1.0)
        return GraphCaps(*(int(math.ceil(getattr(self, f.name) * s))
                           for f in dataclasses.fields(self)))


def endpoint_histogram(edges: np.ndarray, p: int, m: int) -> np.ndarray:
    """Exact (edge-owner PE, endpoint-owner PE) message histogram of
    one endpoint-addressed round — both endpoints of every edge."""
    e_pad = edges.shape[0]
    m_e = e_pad // p
    src = np.repeat(np.arange(e_pad) // m_e, 2)
    dst = edges.reshape(-1) // m
    hist = np.zeros((p, p), np.int64)
    np.add.at(hist, (src, dst), 1)
    return hist


def derive_caps(edges: np.ndarray, n_pad: int, p: int,
                cfg: ListRankConfig) -> GraphCaps:
    """Host-side capacity derivation for the pipeline (attempt 1)."""
    e_pad = edges.shape[0]
    m_e = e_pad // p
    m = n_pad // p
    slack = cfg.capacity_slack
    hist_max = int(endpoint_histogram(edges, p, m).max()) if e_pad else 0
    exact = max(cfg.min_capacity, hist_max)
    per_peer = lambda q: max(cfg.min_capacity,
                             int(math.ceil(slack * q / p)))
    logn = max(int(math.ceil(math.log2(max(n_pad, 2)))), 1)
    return GraphCaps(
        label=exact,
        prop=per_peer(m_e),
        confirm=per_peer(m),
        jump=per_peer(m),
        tour=exact,
        scalar=per_peer(m),
        rounds=2 * logn + 16,
        jumps=logn + 8,
    )


#: schema of the graphalg pipeline's stat counters
GRAPH_STAT_HELP = {
    "cc_rounds": "hooking + shortcut rounds executed",
    "cc_msgs": "hooking/shortcut messages routed",
    "cc_undelivered": "FATAL: hooking-pipeline messages undelivered",
    "cc_unconverged": "FATAL: labels not converged within round budget",
    "tour_undelivered": "FATAL: Euler-tour construction undelivered",
    "tour_msgs": "Euler-tour construction messages",
    "stats_undelivered": "FATAL: tree-stats scatter undelivered",
    "forest_edges": "spanning-forest edges selected (gauge)",
}


def zero_graph_stats(device) -> dict[str, torch.Tensor]:
    """The graph counters as 0-dim int32 totals, all zero."""
    z = torch.zeros((), dtype=torch.int32, device=device)
    return dict.fromkeys(GRAPH_STAT_HELP, z)


def _lookup_labels(f, base, m):
    """Owner-side label lookup for gather rounds (targets are global
    node ids; routing guarantees they are owned here)."""
    def lookup(gids, valid):
        slots = torch.clamp(gids - base, 0, m - 1)
        return {"lab": take(f, slots)}
    return lookup


def _min_scatter(m: int, slot, vals):
    """Per-PE ``full(m + 1, INT_MAX).at[slot].min(vals)[:m]``: the
    order-free min of every value sent to each slot (slot ``m`` is the
    discard row)."""
    p = slot.shape[0]
    out = torch.full((p, m + 1), INT_MAX, dtype=torch.int32,
                     device=slot.device)
    out.scatter_reduce_(1, slot.long(), vals, "amin")
    return out[:, :m]


def _shortcut(plan, caps: GraphCaps, f, base, m, owner_of, footprint=None):
    """Pointer jumping ``f = f[f]`` to a fixed point (bounded).

    Returns ``(f, undelivered, msgs, tele)``: the psum'd (p,)
    undelivered count and the per-PE message count, summed over the
    iterations, and their merged per-PE routing telemetry (None unless
    ``plan.telemetry``)."""
    p, dev = plan.p_local, plan.device
    und = torch.zeros(p, dtype=torch.int32, device=dev)
    msgs = torch.zeros(p, dtype=torch.int32, device=dev)
    tele = (tele_lib.route_zero(p, plan.indirection.depth, dev)
            if plan.telemetry else None)
    ones = torch.ones_like(f, dtype=torch.bool)
    changed, it = 1, 0
    while changed > 0 and it < caps.jumps:
        resp, answered, gst = gather_until_done(
            plan, f, ones, owner_of, _lookup_labels(f, base, m), caps.jump,
            caps.jump, dedup=True)
        nf = torch.where(answered, resp["lab"], f)
        changed_t = plan.psum((nf != f).sum(1, dtype=torch.int32))
        f, it = nf, it + 1
        und = und + gst["undelivered"]
        msgs = msgs + gst["msgs"]
        if plan.telemetry:
            tele = tele_lib.merge(tele, gst["telemetry"])
        if footprint is not None:
            footprint.cut("cc:jump")
        changed = int(changed_t[0])
    return f, und, msgs, tele


def cc_rounds(plan, caps: GraphCaps, ea, eb, m: int, m_e: int, stats,
              footprint=None):
    """The hooking loop.

    Args:
      ea/eb: (p, m_e) int32 per-PE edge endpoints (global node ids);
        padding edges are self-loops and never propose.
      stats: the pipeline's 0-dim counters (updated copy returned); with
        ``plan.telemetry`` also its per-PE ``"telemetry"`` record, into
        which every round's hooking legs merge (graph family).
      footprint: a ``cut(label)`` recorder of transport calls, cut after
        each round's hooking legs (``cc:hook``), each shortcut iteration
        (``cc:jump``), each round's counter reduction (``cc:stats``) and
        the loop's end (``cc:end``).

    Returns (f, fmask, stats): the converged labels (p, m), the local
    spanning-forest edge marks (p, m_e), and updated stats.
    """
    p, dev = plan.p_local, plan.device
    pe = plan.my_id()
    base = (pe * m)[:, None]
    ebase = (pe * m_e)[:, None]
    f = base + torch.arange(m, dtype=torch.int32, device=dev)
    eid = ebase + torch.arange(m_e, dtype=torch.int32, device=dev)

    def owner_node(g):
        return g // m

    fmask = torch.zeros((p, m_e), dtype=torch.bool, device=dev)
    targets = torch.cat([ea, eb], 1)
    tvalid = torch.ones_like(targets, dtype=torch.bool)
    depth = plan.indirection.depth
    stats = dict(stats)
    n_hooked = torch.ones(p, dtype=torch.int32, device=dev)
    changed, it = 1, 0
    while changed > 0 and it < caps.rounds:
        # 1. endpoint labels (static targets, host-exact caps)
        resp, answered, gst = gather_until_done(
            plan, targets, tvalid, owner_node, _lookup_labels(f, base, m),
            caps.label, caps.label, dedup=True)
        la, lb = resp["lab"][:, :m_e], resp["lab"][:, m_e:]
        # gather undelivered comes back psum'd; route stats are local
        gund = gst["undelivered"]
        msgs = gst["msgs"]

        # 2. hook proposals: cross-label edges to the larger label
        both = answered[:, :m_e] & answered[:, m_e:]
        pvalid = both & (la != lb)
        tgt = torch.maximum(la, lb)
        val = torch.minimum(la, lb)
        dlv, dval, _, pst = exchange_lib.route(
            plan, [caps.prop] * depth, {"t": tgt, "v": val, "e": eid},
            owner_node(tgt), pvalid)
        und = pst["leftover"]
        msgs = msgs + sum(pst["sent"])

        # 3. apply: min proposal per root, winner edge by a second
        # min-scatter among the entries achieving it
        slot = torch.where(dval, dlv["t"] - base, m)
        slot_c = torch.clamp(slot, 0, m - 1)
        ok = dval & (take(f, slot_c) == dlv["t"])  # target still a root
        minval = _min_scatter(m, torch.where(ok, slot, m), dlv["v"])
        hooked = minval < INT_MAX
        win = ok & (dlv["v"] == take(minval, slot_c))
        weid = _min_scatter(m, torch.where(win, slot, m), dlv["e"])
        f = torch.where(hooked, minval, f)
        n_hooked = plan.psum(hooked.sum(1, dtype=torch.int32))

        # 4. confirm winning edges to their owning PEs (an edge proposes
        # once, so it wins at most one root: the marked slots are
        # distinct)
        weid_c = torch.where(hooked, weid, 0)
        cdlv, cval, _, cst = exchange_lib.route(
            plan, [caps.confirm] * depth, {"e": weid_c}, weid_c // m_e,
            hooked)
        und = und + cst["leftover"]
        msgs = msgs + sum(cst["sent"])
        eslot = torch.where(cval, cdlv["e"] - ebase, m_e)
        fmask = set_drop(fmask, eslot, True)
        if footprint is not None:
            footprint.cut("cc:hook")

        # 5. shortcut to stars for the next round
        f, jund, jmsgs, jtele = _shortcut(plan, caps, f, base, m,
                                          owner_node, footprint)
        stats["cc_rounds"] = stats["cc_rounds"] + 1
        stats["cc_msgs"] = stats["cc_msgs"] + plan.psum(msgs + jmsgs)[0]
        stats["cc_undelivered"] = stats["cc_undelivered"] + (
            gund + jund + plan.psum(und))[0]
        if plan.telemetry:
            # all four hooking legs ride graph-family caps; per-PE only
            round_tele = tele_lib.merge(
                tele_lib.merge(gst["telemetry"], jtele),
                tele_lib.merge(pst["telemetry"], cst["telemetry"]))
            stats["telemetry"] = tele_lib.merge(stats["telemetry"],
                                                {"graph": round_tele})
        if footprint is not None:
            footprint.cut("cc:stats")
        changed, it = int(n_hooked[0]), it + 1
    # a nonzero count of the last round's hooks at exit means the round
    # budget ran out with hooks still firing — unconverged
    stats["cc_unconverged"] = stats["cc_unconverged"] + n_hooked[0]
    stats["forest_edges"] = plan.psum(fmask.sum(1, dtype=torch.int32))[0]
    if footprint is not None:
        footprint.cut("cc:end")
    return f, fmask, stats
