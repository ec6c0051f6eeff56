"""Public API: distributed list ranking on PyTorch.

``rank_list(succ, rank, mesh, ...)`` runs the paper's engineered
pipeline:

  1. local contraction of PE-local sublists (§2.3, optional),
  2. sparse-ruling-set with spawning, ``srs_rounds`` recursion levels,
     pointer doubling base case (§2.1-2.2); or plain pointer doubling,
  3. direction handling: §2.5 terminal→initial postprocess (default) or
     the faithful Algorithm-1 reversal preprocessing,
  4. restoration of locally contracted elements.

Every capacity (mailboxes, queues, subproblem stores) is host-derived
from the instance parameters with configurable slack; runs that hit any
capacity report it in ``stats`` and the staged solve retries, doubling only
the capacity family whose fatal stat fired (tuner.escalate). Capacity
therefore affects only performance, never correctness.

The solve runs on the CUDA device unless the caller passes ``device``;
without CUDA it raises rather than carry on on the CPU. A ``tracer``
(:class:`repro_torch.obs.Tracer`) records the solve's span tree, and
``ListRankConfig(telemetry=True)`` its per-stage device telemetry
(:mod:`repro_torch.obs`).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.listrank import local as local_lib
from repro_torch.core.listrank import store as store_lib
from repro_torch.core.listrank import transport as transport_lib
from repro_torch.core.listrank import tuner
from repro_torch.core.listrank import exchange as exchange_lib
from repro_torch.core.listrank import resume as resume_lib
from repro_torch.core.listrank.batched import set_drop, take
from repro_torch.core.listrank.config import IndirectionSpec, ListRankConfig
from repro_torch.core.listrank.exchange import MeshPlan
from repro_torch.core.listrank.srs import (LevelSpec, _merge,
                                           default_perm_fn,
                                           gather_until_done,
                                           route_until_done)
from repro_torch.device import resolve_device
from repro_torch.obs import telemetry as tele_lib
from repro_torch.obs import trace as trace_lib


def chase_leaves(weight_dtype=torch.float32) -> dict:
    """Structure of a chase wave message for a given weight dtype (the
    weight leaf rides as the rank dtype; the wire format reinterprets
    its bits, so int32 and float32 weights round-trip exactly)."""
    return {"target": torch.int32, "ruler": torch.int32,
            "weight": canonical_weight_dtype(weight_dtype)}


def chase_wire_words(weight_dtype=torch.float32) -> int:
    """int32 words per chase message on the wire (payload leaves +
    routing destination + validity)."""
    return exchange_lib.WireFormat.for_leaves(
        {**chase_leaves(weight_dtype), "_dest": torch.int32}).width


def canonical_weight_dtype(dtype) -> torch.dtype:
    """The on-device dtype for a rank/weight input: 32-bit words,
    integer kinds to int32, float kinds to float32 (bool is rejected).
    Takes a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return torch.float32
        if dtype != torch.bool and not dtype.is_complex:
            return torch.int32
        raise TypeError(f"unsupported weight dtype {dtype}")
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return torch.float32
    if np.issubdtype(dt, np.integer):
        return torch.int32
    raise TypeError(f"unsupported weight dtype {dt}")


def build_specs(cfg: ListRankConfig, plan: MeshPlan, m: int, n: int,
                term_bound: int,
                scales=tuner.CapacityScales(),
                estimate: tuner.CapacityEstimate | None = None,
                ) -> tuple[LevelSpec, ...]:
    """Host-side derivation of every static capacity.

    Per-level ruler fractions come from :func:`tuner.level_plan`.
    ``scales`` carries the targeted retry multipliers — one
    :class:`tuner.CapacityScales` for every level or a per-level
    sequence. ``estimate`` (:func:`tuner.estimate_capacities`) replaces
    the static ``cfg.capacity_slack`` with the measured per-hop skew.
    """
    levels = tuner.level_plan(cfg, plan.p, plan.indirection.depth, n)
    level_scales = tuner.normalize_level_scales(scales, cfg.srs_rounds + 1)

    def hop_slack(hi: int) -> float:
        return (estimate.slack_for_hop(hi) if estimate is not None
                else cfg.capacity_slack)

    specs: list[LevelSpec] = []
    cap = m
    tb = term_bound
    p = plan.p
    logp = math.log2(max(p, 2))
    for li, lp in enumerate(levels):
        sc = level_scales[li]
        frac = lp.frac
        r_static = max(cfg.min_rulers_per_pe, int(math.ceil(frac * cap)))
        mail_caps = tuple(
            max(cfg.min_capacity,
                int(math.ceil(hop_slack(hi) * sc.chase * r_static
                              / plan.hop_size(hop))))
            for hi, hop in enumerate(plan.indirection.hops))
        inbox = sum(plan.hop_size(h) * c
                    for h, c in zip(plan.indirection.hops, mail_caps))
        queue_cap = int(max(cfg.queue_slack * r_static * sc.chase,
                            2 * inbox + cfg.spawn_window + 64))
        # rounds ~ n/r + log p; 1/frac is the per-PE n/r.
        max_rounds = int(cfg.max_round_slack * (1.0 / frac + logp) + 256)
        exp_sub = r_static * (1.0 + math.log(max(1.0 / frac, 2.0))) + tb + 64
        cap_sub = min(cap, int(math.ceil(cfg.sub_capacity_slack * sc.sub
                                         * exp_sub)))
        gcap = tuple(
            max(cfg.min_capacity,
                int(math.ceil(hop_slack(hi) * sc.gather * cap
                              / plan.hop_size(hop))))
            for hi, hop in enumerate(plan.indirection.hops))
        specs.append(LevelSpec(
            cap=cap, r_static=r_static, mail_caps=mail_caps,
            queue_cap=queue_cap, spawn_window=cfg.spawn_window,
            max_rounds=max_rounds, cap_sub=cap_sub,
            gather_req_cap=gcap, gather_resp_cap=gcap, base=False,
            ruler_frac=frac, max_restarts=cfg.max_restarts))
        cap = cap_sub
        tb = cap_sub  # every sub element may be a sub-terminal
    # base level (pointer doubling or all-gather)
    sc = level_scales[-1]
    gcap = tuple(
        max(cfg.min_capacity,
            int(math.ceil(hop_slack(hi) * sc.gather * cap
                          / plan.hop_size(hop))))
        for hi, hop in enumerate(plan.indirection.hops))
    specs.append(LevelSpec(
        cap=cap, r_static=0, mail_caps=(0,) * plan.indirection.depth,
        queue_cap=0, spawn_window=0,
        max_rounds=int(math.ceil(math.log2(max(n, 2)))) + 8, cap_sub=0,
        gather_req_cap=gcap, gather_resp_cap=gcap, base=True,
        ruler_frac=0.0, max_restarts=cfg.max_restarts))
    return tuple(specs)


# --------------------------------------------------------------------------
# pre- and post-processing of the staged solve
# --------------------------------------------------------------------------

def _reverse_instance(plan, spec, owner_of, st, stats):
    """Faithful Algorithm-1 preprocessing: build the reversed instance
    with one n-message exchange (the cost §2.5 avoids)."""
    cap = st.cap
    gid = st.ids
    nonterm = st.valid & (st.succ != gid)
    payload = {"target": st.succ, "src": gid, "w": st.rank}
    dest = owner_of(st.succ).to(torch.int32)

    got = torch.zeros_like(st.valid)
    succ_rev = torch.where(st.valid, gid, st.succ)
    rank_rev = torch.zeros_like(st.rank)

    def deliver(carry, delivered, dval):
        # each element has at most one predecessor: distinct slots
        got, succ_rev, rank_rev = carry
        slots, found = store_lib.slot_of(st, delivered["target"])
        idx = torch.where(dval & found, slots, cap)
        return (set_drop(got, idx, True),
                set_drop(succ_rev, idx, delivered["src"]),
                set_drop(rank_rev, idx, delivered["w"]))

    (got, succ_rev, rank_rev), pending, msgs, rtele = route_until_done(
        plan, spec.mail_caps, payload, dest, nonterm, deliver,
        (got, succ_rev, rank_rev))
    upd = {"reversal_msgs": msgs, "undelivered": pending}
    if plan.telemetry:
        # the reversal exchange rides the chase-family mail caps
        upd["telemetry"] = {"chase": rtele}
    stats = _merge(stats, upd)
    return st.replace(succ=succ_rev, rank=rank_rev), stats


def _restore_local(plan, spec, owner_of, st, aux, rep, succ_orig, rank_orig,
                   base, stats):
    """Restore locally contracted elements (§2.3 restoration).

    R1: every rep's solved succ points to a contracted-instance terminal
        l_t whose local chain continues to the true terminal — fetch the
        tail (terminal id, tail distance) from l_t's owner (aggregated).
    R2: interior elements splice their local-chain prefix onto the fixed
        final values of the rep their chain exits into.
    """
    m = succ_orig.shape[1]
    b = base[:, None]

    # ---- R1: tail fixup for reps
    resp, answered, g1 = gather_until_done(
        plan, st.succ, rep, owner_of, local_lib.tail_lookup(aux, base),
        spec.gather_req_cap, spec.gather_resp_cap, dedup=True)
    upd = answered & resp["found"] & rep
    final_succ = torch.where(upd, resp["succ"], st.succ)
    final_rank = torch.where(upd, st.rank + resp["rank"], st.rank)
    miss1 = plan.psum((rep & ~upd).sum(1, dtype=torch.int32))

    # ---- R2: interior elements
    S, D, stop_is_term = aux["S"], aux["D"], aux["stop_is_term"]
    interior = ~rep
    # chains ending at a true local terminal need no communication
    direct = interior & stop_is_term
    final_succ = torch.where(direct, b + S, final_succ)
    final_rank = torch.where(direct, D, final_rank)
    # chains exiting the PE: ask the rep the chain enters (aggregated)
    need = interior & ~stop_is_term
    exit_target = take(succ_orig, S)  # the remote rep
    fs, fr = final_succ, final_rank   # the fixed rep finals (owner side)

    def final_fn(gids, valid):
        slots = torch.clamp(gids - b, 0, m - 1).to(torch.int32)
        ok = valid & (gids >= b) & (gids < b + m)
        r = take(fr, slots)
        return {"succ": torch.where(ok, take(fs, slots), gids),
                "rank": torch.where(ok, r, torch.zeros_like(r)),
                "found": ok}

    resp2, answered2, g2 = gather_until_done(
        plan, exit_target, need, owner_of, final_fn,
        spec.gather_req_cap, spec.gather_resp_cap, dedup=True)
    upd2 = answered2 & resp2["found"] & need
    final_succ = torch.where(upd2, resp2["succ"], final_succ)
    final_rank = torch.where(upd2, D + take(rank_orig, S) + resp2["rank"],
                             final_rank)
    miss2 = plan.psum((need & ~upd2).sum(1, dtype=torch.int32))

    upd = {
        "fixup_msgs": g1["msgs"] + g2["msgs"],
        "undelivered": g1["undelivered"] + g2["undelivered"] + miss1 + miss2}
    if plan.telemetry:
        upd["telemetry"] = {"gather": tele_lib.merge(g1["telemetry"],
                                                     g2["telemetry"])}
    stats = _merge(stats, upd)
    return final_succ, final_rank, stats


def _solve_sharded(succ, rank, perm_fn, *, plan: MeshPlan,
                   cfg: ListRankConfig, specs, m: int, footprint=None):
    """One attempt of the whole solve on (p, m) tensors, no retry: the
    staged solve's stage bodies run back to back (the reference's
    monolithic in-mesh solve, which the graph pipeline composes twice).
    ``cfg.algorithm`` must be resolved. Returns (succ, rank, stats) with
    0-dim stat totals — and with ``plan.telemetry`` the attempt's per-PE
    telemetry record as a 4th element, one record threaded through every
    stage as the reference's solve accumulates it (never psum'd); a
    caller that finds a fatal stat escalates and reruns the whole
    attempt. ``footprint`` (a ``cut(label)`` recorder of transport calls)
    is cut after every stage."""
    state, tele = None, None
    for stage in resume_lib.schedule_for(cfg):
        state = resume_lib._run_stage(stage, state, succ, rank, perm_fn,
                                      plan=plan, cfg=cfg, specs=specs, m=m,
                                      tele=tele)
        if plan.telemetry and stage.kind != "post":
            tele = state.pop("_telemetry")
        if footprint is not None:
            footprint.cut(stage.label)
    return state


# --------------------------------------------------------------------------
# front door
# --------------------------------------------------------------------------

def make_plan(mesh, pe_axes: Sequence[str], cfg: ListRankConfig, device,
              indirection: IndirectionSpec | None = None) -> MeshPlan:
    """The routing plan of a solve or a tree/graph front door (``mesh``
    resolved by ``transport.resolve_backend``): the virtual-PE transport
    for a :class:`transport.SimMesh`, the ``torch.distributed`` one for
    a :class:`transport.DistMesh`, on ``device`` behind a call-counting
    wrapper, with the config's wire format, ``mailbox_pack`` and
    telemetry flags."""
    pe_axes = tuple(pe_axes)
    if isinstance(mesh, transport_lib.DistMesh):
        inner = transport_lib.DistTransport.for_mesh(mesh, pe_axes, device)
    else:
        inner = transport_lib.VirtualTransport(
            pe_axes, tuple(mesh.shape[a] for a in pe_axes), device)
    transport = transport_lib.CountingTransport(inner)
    return MeshPlan.from_mesh(mesh, pe_axes, indirection,
                              wire_packing=cfg.wire_packing,
                              pallas_pack=cfg.use_pallas_pack,
                              transport=transport,
                              telemetry=cfg.telemetry)


def _host_array(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(dtype, copy=False)


def local_block(plan: MeshPlan, x: np.ndarray, device) -> torch.Tensor:
    """The (p_local, m, ...) block of the whole host array ``x`` that
    this process's PEs own, on ``device``: every process holds the whole
    input and copies only its own block."""
    pes = plan.local_pes
    blocks = np.ascontiguousarray(x).reshape((plan.p, -1) + x.shape[1:])
    return torch.from_numpy(np.ascontiguousarray(
        blocks[pes.start:pes.stop])).to(device)


def rank_list_with_stats(succ, rank, mesh, pe_axes: Sequence[str] | None = None,
                         cfg: ListRankConfig | None = None,
                         indirection: IndirectionSpec | None = None,
                         seed: int = 0, max_retries: int = 3,
                         term_bound: int | None = None,
                         supervisor=None, inject=None,
                         stage_counters: bool = False, initial_scales=None,
                         tracer=None, device=None, perm_fn=None):
    """Rank lists distributed over ``mesh``. Returns (succ, rank, stats).

    ``succ``/``rank`` are numpy arrays or tensors of length n (divisible
    by the PE count), block-distributed over the PEs of ``mesh`` (a
    :class:`transport.SimMesh`, or a :class:`transport.DistMesh` over a
    process group: then the call is SPMD, every rank passes the same
    whole input and copies only its own block to its device). The result
    tensors lie on ``device`` (the CUDA device when None; on a DistMesh,
    ``cuda:{LOCAL_RANK % device_count}``), the whole ``(n,)`` outputs on
    every rank. The solve runs as the level-resumable
    stage loop (:mod:`.resume`). ``perm_fn(level, pe, cap)`` supplies
    the ruler permutations (default: :func:`srs.default_perm_fn` of
    ``seed``). ``stage_counters`` records per-stage collective counts.
    ``supervisor``
    (:class:`repro_torch.runtime.fault_tolerance.SolveSupervisor`) adds
    level-boundary checkpoints, preemption handling, and restore-on-
    restart, in the JAX package's checkpoint format; ``inject``
    (:class:`repro_torch.core.listrank.faults.FaultSpec` or a sequence)
    drives deterministic fault injection; ``stats["recovery"]`` carries
    their accounting. On a DistMesh both work as on one process: every
    rank passes a supervisor on the same directory (one every rank sees),
    or none; rank 0 writes the checkpoints, every decision is agreed over
    the ranks, and a rank's ``inject`` may differ from the others' (a
    preemption on one rank stops every rank at the same boundary), but
    without a supervisor every rank passes an injector or none.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records the flight-
    recorder span tree for the whole solve — the root ``solve`` span,
    the capacity-estimation pre-pass, every stage execution/retry with
    measured wall time, run-time collective footprint and §2.6
    predicted time, and checkpoint save/restore — and ingests the final
    ``host_stats`` into the tracer's metrics registry.
    ``cfg.telemetry`` adds ``stats["telemetry"]``: every committed
    stage's record, the headroom report and, with
    ``cfg.capacity_estimation``, the DKW back-test. Neither changes an
    output, a counter or a stage's collectives.
    """
    cfg = cfg or ListRankConfig()
    pe_axes = tuple(pe_axes) if pe_axes is not None else tuple(mesh.axis_names)
    backend, mesh = transport_lib.resolve_backend(cfg.backend, mesh, pe_axes)
    device = resolve_device(device, mesh)
    s_host = _host_array(succ, np.int32)
    n = s_host.shape[0]
    if indirection is None and cfg.auto_indirection:
        axis_sizes = tuple(mesh.shape[a] for a in pe_axes)
        indirection = tuner.choose_indirection(cfg, pe_axes, axis_sizes, n)
    plan = make_plan(mesh, pe_axes, cfg, device, indirection)
    p = plan.p
    if n % p != 0:
        raise ValueError(f"n={n} must be divisible by p={p} (pad the input)")
    m = n // p
    if cfg.algorithm == "auto":
        # Corollary-1 regime check: PD below the efficiency threshold.
        cfg = cfg.with_(algorithm=tuner.choose_algorithm(
            cfg, p, plan.indirection.depth, m))
    if term_bound is None:
        owners = np.arange(n) // m
        counts = np.bincount(owners[s_host == np.arange(n)], minlength=p)
        term_bound = int(counts.max()) if counts.size else 0

    tr = trace_lib.ensure(tracer)
    solve_span = tr.begin(
        "solve", cat="solve", n=n, p=p, backend=backend,
        algorithm=cfg.algorithm, machine=cfg.machine.name,
        indirection=[list(h) for h in plan.indirection.hops])
    try:
        estimate = None
        if cfg.capacity_estimation:
            # sampled-splitter pre-pass: size mailboxes for the measured
            # destination skew instead of the static slack guess.
            with tr.span("estimate_capacities", cat="tuner") as est_span:
                estimate = tuner.estimate_capacities(s_host, plan, m, cfg,
                                                     seed=seed)
                est_span.annotate(sample_size=estimate.sample_size,
                                  hop_slack=list(estimate.hop_slack),
                                  max_frac=list(estimate.max_frac))

        wdt = canonical_weight_dtype(rank.dtype if hasattr(rank, "dtype")
                                     else np.asarray(rank).dtype)
        r_host = _host_array(rank, np.float32 if wdt == torch.float32
                             else np.int32)
        succ_d = local_block(plan, s_host, device)
        rank_d = local_block(plan, r_host, device)

        def build_level_specs(level_scales):
            return build_specs(cfg, plan, m, n, term_bound,
                               scales=level_scales, estimate=estimate)

        if tr.enabled and cfg.algorithm == "srs":
            from repro_torch.obs import cost as cost_lib
            lp = tuner.level_plan(cfg, p, plan.indirection.depth, n)
            solve_span.annotate(predicted_solve_s=cost_lib.predict_solve(
                n, plan, cfg.machine, r_total=lp[0].r_total))

        succ_f, rank_f, host_stats = resume_lib.run_staged(
            succ_d, rank_d, plan=plan, cfg=cfg, m=m, n=n,
            perm_fn=perm_fn or default_perm_fn(seed),
            build_level_specs=build_level_specs, seed=seed,
            max_retries=max_retries, supervisor=supervisor, inject=inject,
            stage_counters=stage_counters, initial_scales=initial_scales,
            tracer=tracer)
    except BaseException as e:
        tr.end(solve_span, outcome=type(e).__name__)
        raise
    tr.end(solve_span, outcome="ok", attempts=host_stats["attempts"])
    if "telemetry" in host_stats and estimate is not None:
        # back-test the sampled-splitter DKW margins against the skew
        # the solve actually observed.
        recs = [tele_lib.StageRecord.from_json(d)
                for d in host_stats["telemetry"]["stages"]]
        host_stats["telemetry"]["dkw"] = tele_lib.dkw_backtest(
            list(estimate.max_frac), int(estimate.sample_size),
            [plan.hop_size(h) for h in plan.indirection.hops], recs)
    if tr.enabled:
        from repro_torch.obs import metrics as metrics_lib
        metrics_lib.ingest_host_stats(tr.metrics, host_stats)
    # the whole outputs on every process: one uncounted gather (none on
    # the virtual-PE transport), after the solve's counted stages
    succ_f = plan.transport.gather_pes(succ_f)
    rank_f = plan.transport.gather_pes(rank_f)
    return succ_f.reshape(n), rank_f.reshape(n), host_stats


def rank_list(succ, rank, mesh, **kw):
    """Convenience wrapper: returns (succ, rank) only."""
    succ_f, rank_f, _ = rank_list_with_stats(succ, rank, mesh, **kw)
    return succ_f, rank_f
