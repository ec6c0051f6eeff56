"""Distributed pointer doubling (Wyllie), engineered per the paper:
request aggregation (dedup), message indirection, and overflow-tolerant
rounds. Serves both as the standalone PD baseline and as the SRS base
case.

Each round, every unfinished element asks the owner of its current
successor for (succ[succ[i]], rank[succ[i]]) and applies
  rank[i] += rank[succ[i]];  succ[i] = succ[succ[i]].
Terminals absorb (self-loop, weight 0), so ceil(log2(maxlen)) rounds
suffice. Requests that overflow a mailbox are retried next round.

The round loop runs on the host and reads the psum'd pending count once
per round; the count is the same on every PE, so all PEs step together.
"""
from __future__ import annotations

import torch

from repro_torch.core.listrank import store as store_lib
from repro_torch.core.listrank.batched import INT_MAX, take, unpermute
from repro_torch.core.listrank.exchange import MeshPlan, remote_gather
from repro_torch.obs import telemetry as tele_lib


def doubling_solve(plan: MeshPlan, st: store_lib.Store,
                   owner_of, req_cap, resp_cap,
                   max_steps: int, dedup: bool = True):
    """Run pointer doubling over a store. Returns (store, stats); with
    ``plan.telemetry`` ``stats["telemetry"]`` is the rounds' merged
    gather-family routing record."""
    z = torch.zeros(plan.p_local, dtype=torch.int32, device=plan.device)
    stats = {"pd_rounds": z, "pd_msgs": z, "pd_undelivered": z}
    if plan.telemetry:
        stats["telemetry"] = tele_lib.route_zero(
            plan.p_local, plan.indirection.depth, plan.device)
    pending, steps = 1, 0
    while pending > 0 and steps < max_steps:
        done = (st.succ == st.ids) | ~st.valid
        cur = st
        resp, answered, gst = remote_gather(
            plan, st.succ, st.valid & ~done, owner_of,
            lambda g, v: store_lib.lookup(cur, g, v),
            req_cap, resp_cap, dedup=dedup)
        upd = answered & resp["found"] & ~done
        new_succ = torch.where(upd, resp["succ"], st.succ)
        new_rank = torch.where(upd, st.rank + resp["rank"], st.rank)
        # finished once the successor is a fixed point (terminal)
        now_done = done | (upd & (resp["succ"] == st.succ))
        pend = plan.psum(((~now_done) & st.valid).sum(1, dtype=torch.int32))
        st = st.replace(succ=new_succ, rank=new_rank)
        upd = {
            "pd_rounds": stats["pd_rounds"] + 1,
            "pd_msgs": stats["pd_msgs"] + gst["req_sent"] + gst["resp_sent"],
            "pd_undelivered": stats["pd_undelivered"] + gst["undelivered"],
        }
        if plan.telemetry:
            upd["telemetry"] = tele_lib.merge(stats["telemetry"],
                                              gst["telemetry"])
        stats = upd
        pending = int(pend[0])
        steps += 1
    stats["pd_converged"] = pending == 0
    return st, stats


def allgather_solve(plan: MeshPlan, st: store_lib.Store):
    """Small-base-case alternative: replicate the sub-instance on every
    PE (one all-gather) and finish with local vectorized Wyllie."""
    ids = plan.all_gather(st.ids)
    succ = plan.all_gather(st.succ)
    rank = plan.all_gather(st.rank)
    valid = plan.all_gather(st.valid)
    p, n = ids.shape
    order = torch.argsort(torch.where(valid, ids, INT_MAX), dim=1,
                          stable=True)
    ids_s, succ_s = torch.gather(ids, 1, order), torch.gather(succ, 1, order)
    rank_s, valid_s = torch.gather(rank, 1, order), torch.gather(valid, 1,
                                                                order)
    slot = torch.clamp(torch.searchsorted(ids_s, succ_s, out_int32=True),
                       0, n - 1)
    found = (take(ids_s, slot) == succ_s) & valid_s
    ar = torch.arange(n, dtype=torch.int32, device=ids.device).expand(p, n)
    slot = torch.where(found, slot, ar)
    # the gathered instance has n slots; lists can be up to n long
    steps = max(1, int(n).bit_length()) + 1
    s, r = slot, rank_s
    for _ in range(steps):
        s, r = take(s, s), r + take(r, s)
    succ_f = take(ids_s, s)
    # write back into this PE's slots: invert the sort permutation to
    # find where this PE's gathered rows (me*cap + j) landed.
    cap = st.cap
    inv = unpermute(order, ar.to(torch.int64))
    my_rows = (plan.my_id()[:, None].to(torch.int64) * cap
               + torch.arange(cap, device=ids.device))
    my_slots = torch.gather(inv, 1, my_rows)
    out = st.replace(
        succ=torch.where(st.valid, take(succ_f, my_slots), st.succ),
        rank=torch.where(st.valid, take(r, my_slots), st.rank))
    z = torch.zeros(plan.p_local, dtype=torch.int32, device=plan.device)
    stats = {"pd_rounds": z + steps, "pd_msgs": z, "pd_undelivered": z}
    return out, stats
