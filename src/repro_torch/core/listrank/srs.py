"""Sparse ruling set with ruler spawning (paper Algorithm 1 + §2.2-2.5).

Structure:

  solve_store(level):
    if base level: pointer doubling (or all-gather) base case
    else:
      chase: bulk-synchronous wave rounds with ruler spawning
      extract ruler∪terminal subproblem into a sparse store
      solve_store(level+1)
      write back + ruler propagation (remote gather, aggregated)

``solve_store`` ranks every element of the instance w.r.t. the *initial*
element of its list (the natural direction of forward chasing). The
caller fixes the direction either by the §2.5 postprocess (default) or
by running on the reversed instance (faithful Algorithm 1) — see api.py.

Static-capacity adaptations: fixed-capacity mailboxes with leftover
re-queuing, a windowed permutation scan for spawning, and an outer
restart loop that guarantees coverage regardless of capacity or
spawn-window choices. Every potential overflow is surfaced in ``stats``
and triggers a retry with larger capacities in the staged solve.

Every loop is a host loop that reads one psum'd count per round; the
count is the same on every PE, so all PEs step together. Every per-PE
tensor carries the leading PE axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.listrank import store as store_lib
from repro_torch.core.listrank.batched import INT_MAX, set_drop, take
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.core.listrank.doubling import allgather_solve, doubling_solve
from repro_torch.core.listrank.exchange import (MeshPlan, compact_queue,
                                                remote_gather, route_compact)
from repro_torch.obs import telemetry as tele_lib


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """Static per-recursion-level capacities (host-derived in api.py)."""
    cap: int                      # store capacity at this level
    r_static: int                 # static ruler-count bound per PE
    mail_caps: tuple[int, ...]    # per-hop mailbox capacity
    queue_cap: int
    spawn_window: int
    max_rounds: int
    cap_sub: int                  # capacity of the next level's store
    gather_req_cap: int
    gather_resp_cap: int
    base: bool                    # True => solve with the base case
    #: ruler fraction of the live instance (tuner.level_plan — the same
    #: derivation that sized r_static, so r_target <= r_static).
    ruler_frac: float
    #: bound on outer chase restarts (ListRankConfig.max_restarts).
    max_restarts: int


#: the solver's stat counters (the reference's ``zero_stats`` keys)
STAT_KEYS = ("rounds", "restarts", "chase_msgs", "spawn_lost", "rulers",
             "sub_size", "dropped", "sub_overflow", "store_miss",
             "undelivered", "pd_rounds", "pd_msgs", "reversal_msgs",
             "fixup_msgs", "max_queue")

#: schema of the solver's stat counters (repro_torch.obs.metrics ingests
#: host_stats under these help strings; keep in sync with STAT_KEYS).
STAT_HELP = {
    "rounds": "chase rounds executed across all levels",
    "restarts": "outer chase restarts (coverage stragglers)",
    "chase_msgs": "chase wave messages routed",
    "spawn_lost": "spawn proposals dropped by the spawn window",
    "rulers": "rulers selected (final attempt, all levels)",
    "sub_size": "recursion subproblem elements extracted",
    "dropped": "FATAL: chase mailbox/queue overflow drops",
    "sub_overflow": "FATAL: recursion sub-store overflow",
    "store_miss": "FATAL: store lookups routed to a non-owner",
    "undelivered": "FATAL: gather/reversal/fixup messages undelivered",
    "pd_rounds": "pointer-doubling rounds (base case or pd algorithm)",
    "pd_msgs": "pointer-doubling gather messages",
    "reversal_msgs": "Algorithm-1 reversal preprocessing messages",
    "fixup_msgs": "\u00a72.3 restoration fixup messages",
    "max_queue": "peak chase queue occupancy (gauge)",
    "attempts": "driver attempts (1 + capacity escalations)",
}


def zero_stats(p: int, device) -> dict[str, torch.Tensor]:
    """Per-PE (p,) int32 counters, all zero."""
    z = torch.zeros(p, dtype=torch.int32, device=device)
    return {k: z for k in STAT_KEYS}


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        if k == "telemetry":
            # the per-PE telemetry record (cfg.telemetry): HWM leaves
            # max-merge, counters add — see repro_torch.obs.telemetry.
            out[k] = tele_lib.merge(a.get(k), v)
        elif k == "max_queue":
            out[k] = torch.maximum(a[k], v)
        else:
            out[k] = a[k] + v
    return out


def _sum32(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=1, dtype=torch.int32)


# --------------------------------------------------------------------------
# ruler permutations
# --------------------------------------------------------------------------

def default_perm_fn(seed: int):
    """The port's ruler-permutation source: ``perm_fn(level, pe, cap)``
    draws ``torch.randperm(cap)`` from a CPU ``torch.Generator`` seeded
    from ``(seed, level, pe)`` — the same permutation on every device."""
    def perm_fn(level: int, pe: int, cap: int) -> torch.Tensor:
        state = np.random.SeedSequence([seed, level, pe]).generate_state(
            2, np.uint32)
        g = torch.Generator().manual_seed(
            int(state[0]) << 32 | int(state[1]))
        return torch.randperm(cap, generator=g, dtype=torch.int32)
    return perm_fn


def perm_fn_from_numpy(table):
    """A ``perm_fn`` reading a ``{(level, pe, cap): np.ndarray}`` table
    (any mapping with ``__getitem__``), e.g. permutations exported from
    another implementation of the solver."""
    def perm_fn(level: int, pe: int, cap: int) -> torch.Tensor:
        return torch.from_numpy(np.array(table[(level, pe, cap)],
                                         dtype=np.int32))
    return perm_fn


def _perms(perm_fn, level: int, pes: range, cap: int,
           device) -> torch.Tensor:
    """The (len(pes), cap) ruler permutations of the PEs ``pes`` (their
    global ids: a rank draws its own PEs' rulers)."""
    p = len(pes)
    perm = torch.stack([torch.as_tensor(perm_fn(level, pe, cap)).to(
        torch.int32) for pe in pes])
    if perm.shape != (p, cap):
        raise ValueError(f"perm_fn returned shape {tuple(perm.shape[1:])}, "
                         f"expected ({cap},)")
    return perm.to(device)


# --------------------------------------------------------------------------
# host-looped gathers and routes
# --------------------------------------------------------------------------

def gather_until_done(plan: MeshPlan, targets, valid, owner_of, lookup_fn,
                      req_cap, resp_cap, dedup, max_iters=16):
    """remote_gather retried until every valid query is answered.

    Abandoned in-flight fragments from a failed pass are simply dropped
    and re-requested — gathers are read-only, hence idempotent. With
    ``plan.telemetry`` the passes' merged routing record rides in the
    returned stats' ``"telemetry"``."""
    results, remaining = None, valid
    msgs = torch.zeros(plan.p_local, dtype=torch.int32, device=plan.device)
    tele = _route_zero(plan)
    rn, rn_t, it = 1, None, 0
    while rn > 0 and it < max_iters:
        resp, answered, st = remote_gather(plan, targets, remaining, owner_of,
                                           lookup_fn, req_cap, resp_cap, dedup)
        if results is None:
            results = {k: torch.zeros_like(v) for k, v in resp.items()}
        results = {k: torch.where(answered, resp[k], v)
                   for k, v in results.items()}
        remaining = remaining & ~answered
        rn_t = plan.psum(_sum32(remaining))
        msgs = msgs + st["req_sent"] + st["resp_sent"]
        if plan.telemetry:
            tele = tele_lib.merge(tele, st["telemetry"])
        rn = int(rn_t[0])
        it += 1
    out_stats = {"undelivered": rn_t, "msgs": msgs}
    if plan.telemetry:
        out_stats["telemetry"] = tele
    return results, ~remaining & valid, out_stats


def _route_zero(plan: MeshPlan):
    """A zero routing-telemetry record for ``plan`` (None unless
    ``plan.telemetry``)."""
    if not plan.telemetry:
        return None
    return tele_lib.route_zero(plan.p_local, plan.indirection.depth,
                               plan.device)


def route_until_done(plan: MeshPlan, caps, payload, dest, valid,
                     deliver_fn, carry, max_iters=64):
    """Route messages, applying deliver_fn(carry, delivered, dvalid) each
    round, re-queuing leftovers until everything is delivered. Leftover
    compaction is fused into the routing sort (route_compact).

    Returns ``(carry, pending, msgs, tele)`` — ``tele`` is the merged
    per-PE routing telemetry (None unless ``plan.telemetry``)."""
    q = dest.shape[1]
    pending_t = plan.psum(_sum32(valid))
    pending, it = int(pending_t[0]), 0
    msgs = torch.zeros(plan.p_local, dtype=torch.int32, device=plan.device)
    tele = _route_zero(plan)
    while pending > 0 and it < max_iters:
        delivered, dval, (payload, dest, valid), dropped, st = route_compact(
            plan, caps, [(payload, dest, valid)], q)
        carry = deliver_fn(carry, delivered, dval)
        pending_t = plan.psum(_sum32(valid) + dropped)
        msgs = msgs + sum(st["sent"])
        if plan.telemetry:
            tele = tele_lib.merge(tele, st["telemetry"])
        pending = int(pending_t[0])
        it += 1
    return carry, pending_t, msgs, tele


# --------------------------------------------------------------------------
# chase phase
# --------------------------------------------------------------------------

def _make_rulers(st, visited, is_ruler, slots, sel):
    """Mark slots as rulers and build their wave emissions (Alg.1 l.3-5,
    9-11): emit (rank[r], succ[r], r), then succ[r]<-r, rank[r]<-0.
    Selected slots are distinct (a permutation's entries or an arange)."""
    cap = st.cap
    slots_i = torch.clamp(slots, max=cap - 1)
    slots_c = torch.where(sel, slots, cap)
    gid = take(st.ids, slots_i)
    succ_r = take(st.succ, slots_i)
    rank_r = take(st.rank, slots_i)
    emit_valid = sel & (succ_r != gid)
    emissions = ({"target": succ_r, "ruler": gid, "weight": rank_r},
                 emit_valid)
    st = store_lib.scatter_update(st, slots_c, sel, succ=gid,
                                  rank=torch.zeros_like(rank_r))
    visited = set_drop(visited, slots_c, True)
    is_ruler = set_drop(is_ruler, slots_c, True)
    return st, visited, is_ruler, emissions


def _launch_from_perm(st, visited, is_ruler, perm, r_target):
    """Exact ruler selection: the first r_target unvisited slots in perm
    order (level start and restarts)."""
    cap = st.cap
    pidx = torch.clamp(perm, max=cap - 1)
    ok = (perm < cap) & take(st.valid, pidx) & ~take(visited, pidx)
    cnt = torch.cumsum(ok.to(torch.int32), dim=1, dtype=torch.int32)
    sel = ok & (cnt <= r_target[:, None])
    found = torch.searchsorted(cnt, r_target[:, None].contiguous(),
                               out_int32=True)[:, 0]
    consumed = torch.clamp(found + 1, max=perm.shape[1])
    out = _make_rulers(st, visited, is_ruler, torch.where(sel, pidx, cap), sel)
    return out, consumed, _sum32(sel)


def _spawn(st, visited, is_ruler, perm, perm_pos, window, k):
    """Windowed spawn of up to k rulers from the unvisited pool (§2.5
    Ruler Selection and Spawning: scan a random permutation onward from
    the current position, skipping visited elements)."""
    cap = st.cap
    # dynamic_slice semantics: the window start clamps to len - window
    start = torch.clamp(perm_pos, max=perm.shape[1] - window).long()
    w = torch.gather(perm, 1, start[:, None] + torch.arange(
        window, device=perm.device))
    widx = torch.clamp(w, max=cap - 1)
    ok = (w < cap) & take(st.valid, widx) & ~take(visited, widx)
    cnt = torch.cumsum(ok.to(torch.int32), dim=1, dtype=torch.int32)
    sel = ok & (cnt <= k[:, None])
    avail = cnt[:, -1]
    spawned = torch.minimum(k, avail)
    found = torch.searchsorted(cnt, k[:, None].contiguous(),
                               out_int32=True)[:, 0]
    consumed = torch.where(avail <= k, window, found + 1)
    st, visited, is_ruler, emissions = _make_rulers(
        st, visited, is_ruler, torch.where(sel, widx, cap), sel)
    new_pos = torch.clamp(perm_pos + consumed, max=cap)
    return st, visited, is_ruler, new_pos, emissions, k - spawned


def _zero_frag(p: int, n: int, rank_dtype, device):
    """An all-invalid chase-message fragment of static size n."""
    z = torch.zeros((p, n), dtype=torch.int32, device=device)
    payload = {"target": z, "ruler": z,
               "weight": torch.zeros((p, n), dtype=rank_dtype, device=device)}
    return payload, z, torch.zeros((p, n), dtype=torch.bool, device=device)


def _chase(plan: MeshPlan, spec: LevelSpec, owner_of, st, visited, is_ruler,
           is_sub, forced, perm, r_target, stats):
    """The wave loop: launch → (route → process → spawn)*, with an outer
    restart loop guaranteeing coverage.

    The round state is three fixed-shape fragments — the compacted
    leftover queue plus the previous round's forward/spawn emissions —
    routed together by ``route_compact``, whose bucket sort doubles as
    queue compaction."""
    cap = st.cap
    qc = spec.queue_cap
    p, dev = plan.p_local, plan.device
    rank_dtype = st.rank.dtype
    inbox = plan.hop_size(plan.indirection.hops[-1]) * spec.mail_caps[-1]

    def emit_frag(emissions):
        pl, ev = emissions
        return pl, owner_of(pl["target"]).to(torch.int32), ev

    def fresh_frags(queue):
        return (queue, _zero_frag(p, inbox, rank_dtype, dev),
                _zero_frag(p, spec.spawn_window, rank_dtype, dev))

    def rounds(c):
        st, visited, is_ruler, is_sub, perm_pos, frags, stats, pending, \
            rounds_done = c
        while pending > 0 and rounds_done < spec.max_rounds:
            delivered, dval, queue2, dropped, rst = route_compact(
                plan, spec.mail_caps, list(frags), qc)
            slots, found = store_lib.slot_of(st, delivered["target"])
            ok = dval & found
            old_succ = take(st.succ, slots)
            old_rank = take(st.rank, slots)
            die = take(is_sub, slots)
            # Alg.1: update succ/rank for every reached element (l.14 and
            # the "still update the values" rule for rulers/terminals).
            # Each element has one predecessor and each element emits at
            # most once, so the reached slots are distinct.
            st = store_lib.scatter_update(
                st, slots, ok, succ=delivered["ruler"],
                rank=delivered["weight"])
            visited = set_drop(visited, torch.where(ok, slots, cap), True)
            # forward the wave (l.13) unless it died on a ruler/terminal
            fwd2 = emit_frag(({"target": old_succ,
                               "ruler": delivered["ruler"],
                               "weight": delivered["weight"] + old_rank},
                              ok & ~die))
            # ruler spawning (l.9-11): one new wave per death
            k = _sum32(ok & die)
            st, visited, is_ruler, perm_pos, spawn_emit, lost = _spawn(
                st, visited, is_ruler, perm, perm_pos, spec.spawn_window, k)
            is_sub = is_sub | is_ruler
            spawn2 = emit_frag(spawn_emit)
            qcount = _sum32(queue2[2]) + _sum32(fwd2[2]) + _sum32(spawn2[2])
            pending_t = plan.psum(qcount + dropped)
            upd = {
                "rounds": 1,
                "chase_msgs": sum(rst["sent"]),
                "spawn_lost": lost,
                "dropped": dropped,
                "store_miss": _sum32(dval & ~found),
                "max_queue": qcount,
            }
            if plan.telemetry:
                upd["telemetry"] = {"chase": rst["telemetry"],
                                    "queue_hwm": qcount}
            stats = _merge(stats, upd)
            frags = (queue2, fwd2, spawn2)
            rounds_done += 1
            pending = int(pending_t[0])
        return (st, visited, is_ruler, is_sub, perm_pos, frags, stats,
                pending, rounds_done)

    # forced rulers (Alg.1 l.2 findInit — known initial elements) + the
    # random initial ruler set, then the main chase.
    ar = torch.arange(cap, dtype=torch.int32, device=dev).expand(p, cap)
    st, visited, is_ruler, forced_emit = _make_rulers(
        st, visited, is_ruler, torch.where(forced, ar, cap), forced)
    (st, visited, is_ruler, rand_emit), consumed, n_rulers = \
        _launch_from_perm(st, visited, is_ruler, perm, r_target)
    is_sub = is_sub | is_ruler
    qpl, qd, qv, drop0 = compact_queue(
        [emit_frag(forced_emit), emit_frag(rand_emit)], qc)
    stats = _merge(stats, {"dropped": drop0,
                           "rulers": n_rulers + _sum32(forced)})
    pend0 = int(plan.psum(_sum32(qv))[0])
    c = rounds((st, visited, is_ruler, is_sub, consumed,
                fresh_frags((qpl, qd, qv)), stats, pend0, 0))

    # restart loop: cover stragglers (forward-chasing deadlock or spawn-
    # window losses). New rulers from the unvisited pool; the drained
    # fragments are folded into the fresh queue.
    def uncovered_of(c):
        return plan.psum(_sum32(c[0].valid & ~c[1]))

    uncovered_t = uncovered_of(c)
    restarts = 0
    while int(uncovered_t[0]) > 0 and restarts < spec.max_restarts:
        st, visited, is_ruler, is_sub, perm_pos, (queue, fwd, spawn), \
            stats, _, rd = c
        (st, visited, is_ruler, emit), _, n1 = _launch_from_perm(
            st, visited, is_ruler, perm, r_target)
        is_sub = is_sub | is_ruler
        qpl, qd, qv, drop1 = compact_queue(
            [queue, fwd, spawn, emit_frag(emit)], qc)
        stats = _merge(stats, {"dropped": drop1, "rulers": n1,
                               "restarts": 1})
        pend = int(plan.psum(_sum32(qv))[0])
        c = rounds((st, visited, is_ruler, is_sub, perm_pos,
                    fresh_frags((qpl, qd, qv)), stats, pend, rd))
        uncovered_t = uncovered_of(c)
        restarts += 1
    st, visited, is_ruler, is_sub, perm_pos, _, stats, _, _ = c
    stats = _merge(stats, {"undelivered": uncovered_t})
    return st, is_sub, stats


def flip_direction(plan: MeshPlan, spec: LevelSpec, owner_of, st, is_term0,
                   stats):
    """Direction flip (paper §2.5): convert initial-ranking into
    sink(terminal)-ranking. Terminals report (their id, list length) to
    the initial element's owner; every element then asks its initial
    (requests aggregated per PE) and sets
      succ <- terminal,  rank <- total - rank.
    """
    cap = st.cap
    gid = st.ids
    term_of = torch.zeros_like(st.ids)
    total_of = torch.zeros_like(st.rank)
    have = torch.zeros_like(st.valid)

    payload = {"target": st.succ, "term": gid, "total": st.rank}
    dest = owner_of(st.succ).to(torch.int32)

    def deliver(carry, delivered, dval):
        # one terminal per list reports to its list's initial: the
        # reached slots are distinct
        term_of, total_of, have = carry
        slots, found = store_lib.slot_of(st, delivered["target"])
        idx = torch.where(dval & found, slots, cap)
        return (set_drop(term_of, idx, delivered["term"]),
                set_drop(total_of, idx, delivered["total"]),
                set_drop(have, idx, True))

    mail = tuple(max(c, 8) for c in spec.mail_caps)
    (term_of, total_of, have), pending, msgs, rtele = route_until_done(
        plan, mail, payload, dest, is_term0, deliver,
        (term_of, total_of, have))

    def lookup_fn(gids, valid):
        slots, found = store_lib.slot_of(st, gids)
        ok = found & valid & take(have, slots)
        tot = take(total_of, slots)
        return {"term": torch.where(ok, take(term_of, slots), gids),
                "total": torch.where(ok, tot, torch.zeros_like(tot)),
                "found": ok}

    resp, answered, gst = gather_until_done(
        plan, st.succ, st.valid, owner_of, lookup_fn,
        spec.gather_req_cap, spec.gather_resp_cap, dedup=True)
    upd = answered & resp["found"]
    out = st.replace(succ=torch.where(upd, resp["term"], st.succ),
                     rank=torch.where(upd, resp["total"] - st.rank, st.rank))
    fix = {
        "fixup_msgs": msgs + gst["msgs"],
        "undelivered": pending + gst["undelivered"] +
        plan.psum(_sum32(st.valid & ~upd))}
    if plan.telemetry:
        # the terminal-report leg rides the chase-family mail caps; the
        # initial lookup rides the gather caps.
        fix["telemetry"] = {"chase": rtele, "gather": gst["telemetry"]}
    stats = _merge(stats, fix)
    return out, stats


# --------------------------------------------------------------------------
# recursion
# --------------------------------------------------------------------------

def _extract_sub(st, is_sub, cap_sub):
    cap = st.cap
    member = st.valid & is_sub
    ar = torch.arange(cap, dtype=torch.int32, device=st.ids.device)
    score = torch.where(member, ar, INT_MAX)
    order = torch.argsort(score, dim=1, stable=True)
    take_ = order[:, :cap_sub].to(torch.int32)
    n_sub = _sum32(member)
    sval = ar[:cap_sub] < torch.clamp(n_sub, max=cap_sub)[:, None]
    rank_t = take(st.rank, take_)
    sub = store_lib.Store(
        ids=torch.where(sval, take(st.ids, take_), INT_MAX),
        succ=torch.where(sval, take(st.succ, take_), INT_MAX),
        rank=torch.where(sval, rank_t, torch.zeros_like(rank_t)),
        valid=sval,
        dense=False,
    )
    overflow = torch.clamp(n_sub - cap_sub, min=0)
    return sub, take_, overflow


def base_level(plan: MeshPlan, cfg: ListRankConfig, spec: LevelSpec,
               owner_of, st, stats):
    """The recursion's base case: pointer doubling (or all-gather)."""
    if cfg.base_case == "allgather":
        st, pst = allgather_solve(plan, st)
    else:
        st, pst = doubling_solve(plan, st, owner_of, spec.gather_req_cap,
                                 spec.gather_resp_cap, spec.max_rounds,
                                 dedup=cfg.dedup_requests)
    upd = {"pd_rounds": pst["pd_rounds"], "pd_msgs": pst["pd_msgs"],
           "undelivered": pst["pd_undelivered"]}
    if plan.telemetry and "telemetry" in pst:
        upd["telemetry"] = {"gather": pst["telemetry"]}
    stats = _merge(stats, upd)
    return st, stats


def descend_level(plan: MeshPlan, cfg: ListRankConfig, spec: LevelSpec,
                  owner_of, st, perm_fn, level: int, stats, forced=None):
    """The downward half of one recursion level: chase + subproblem
    extraction. Returns ``(st, sub, take, is_sub, is_term, stats)`` —
    everything :func:`ascend_level` needs to finish the level once the
    subproblem is solved."""
    cap = st.cap
    p, dev = plan.p_local, plan.device
    is_term = st.valid & (st.succ == st.ids)
    visited = is_term | ~st.valid
    is_ruler = torch.zeros_like(st.valid)
    is_sub = is_term
    if forced is None:
        forced = torch.zeros_like(st.valid)
    forced = forced & st.valid & ~is_term

    perm = _perms(perm_fn, level, plan.local_pes, cap, dev)
    perm = torch.cat([perm, torch.full((p, spec.spawn_window), cap,
                                       dtype=torch.int32, device=dev)], 1)

    # ruler target: the level's tuned fraction of the live instance,
    # clipped to the static bound derived from the same fraction. The
    # product is taken in float32, as the reference computes it.
    n_active = _sum32(st.valid)
    frac = torch.tensor(spec.ruler_frac, dtype=torch.float32, device=dev)
    r_target = torch.clamp((frac * n_active.to(torch.float32)).to(
        torch.int32), min=cfg.min_rulers_per_pe)
    r_target = torch.clamp(r_target, max=spec.r_static)

    st, is_sub, stats = _chase(plan, spec, owner_of, st, visited, is_ruler,
                               is_sub, forced, perm, r_target, stats)

    sub, take_, overflow = _extract_sub(st, is_sub, spec.cap_sub)
    n_sub = _sum32(sub.valid)
    upd = {"sub_overflow": overflow, "sub_size": n_sub}
    if plan.telemetry:
        # sub-store occupancy as a fill record: demand (incl. overflow)
        # over cap_sub — >1 explains a sub escalation.
        upd["telemetry"] = {"sub": tele_lib.store_fill(
            p, plan.indirection.depth, n_sub + overflow, spec.cap_sub)}
    stats = _merge(stats, upd)
    return st, sub, take_, is_sub, is_term, stats


def ascend_level(plan: MeshPlan, cfg: ListRankConfig, spec: LevelSpec,
                 owner_of, st, sub, take_, is_sub, is_term, stats,
                 want_sink: bool = True):
    """The upward half of one recursion level: write back the solved
    subproblem, propagate through rulers, flip direction if the caller
    wants sink-ranking."""
    cap = st.cap
    # write back solved sub elements (take_ holds distinct slots)
    idx = torch.where(sub.valid, take_, cap)
    st = st.replace(succ=set_drop(st.succ, idx, sub.succ),
                    rank=set_drop(st.rank, idx, sub.rank))

    # ruler propagation (Alg.1 l.16-19): non-sub elements ask their ruler
    non_sub = st.valid & ~is_sub
    cur = st
    resp, answered, gst = gather_until_done(
        plan, st.succ, non_sub, owner_of,
        lambda g, v: store_lib.lookup(cur, g, v),
        spec.gather_req_cap, spec.gather_resp_cap, cfg.dedup_requests)
    upd = answered & resp["found"]
    st = st.replace(succ=torch.where(upd, resp["succ"], st.succ),
                    rank=torch.where(upd, st.rank + resp["rank"], st.rank))
    prop = {
        "undelivered": gst["undelivered"] +
        plan.psum(_sum32(non_sub & ~upd)),
        "fixup_msgs": gst["msgs"]}
    if plan.telemetry:
        prop["telemetry"] = {"gather": gst["telemetry"]}
    stats = _merge(stats, prop)

    if want_sink:
        st, stats = flip_direction(plan, spec, owner_of, st, is_term, stats)
    return st, stats


def solve_store(plan: MeshPlan, cfg: ListRankConfig, specs, owner_of, st,
                perm_fn, level: int, stats, forced=None,
                want_sink: bool = True):
    """Recursively solve the instance in ``st``: ``descend_level`` →
    recurse → ``ascend_level`` (``base_level`` at the bottom) — the same
    stage functions the staged solve (resume.run_staged) runs one at a
    time. Returns sink-ranking when ``want_sink``; otherwise the raw
    initial-ranking that forward chasing produces."""
    spec = specs[level]
    if spec.base:
        return base_level(plan, cfg, spec, owner_of, st, stats)
    st, sub, take_, is_sub, is_term, stats = descend_level(
        plan, cfg, spec, owner_of, st, perm_fn, level, stats, forced)
    sub, stats = solve_store(plan, cfg, specs, owner_of, sub, perm_fn,
                             level + 1, stats, want_sink=True)
    return ascend_level(plan, cfg, spec, owner_of, st, sub, take_, is_sub,
                        is_term, stats, want_sink)
