"""Staged solver: the SRS recursion as an explicit state machine.

The solve runs as a schedule of stages, with the state materialized at
every level boundary:

    prep -> descend@0 .. descend@L-1 -> base@L -> ascend@L-1 .. ascend@0 -> post
    prep -> pd@0 -> post                                   (plain doubling)

A fatal capacity overflow at stage k re-runs *only* stage k with that
capacity family escalated for levels >= k (``tuner.escalate_levels``);
completed levels' scales — and therefore their store shapes — are
untouched.

The boundary state is a dict; every tensor carries the leading PE axis:

    stores:   (store_0, ..., store_j)   recursion store stack
    takes:    per descended level, the sub-extraction slot map
    is_subs:  per descended level, the sub-membership mask
    is_terms: per descended level, the level's terminal mask
    stats:    per-PE (p,) stat counters (psum'd once, in post)
    forced:   [srs only, until descend@0] forced-ruler mask
    rep/aux:  [local_contraction only] restoration inputs (§2.3)

What the explicit boundary state buys besides level resume:

- **checkpoint/restart**: a :class:`~repro_torch.runtime.
  fault_tolerance.SolveSupervisor` checkpoints the boundary state
  (atomic keep-k, async); SIGTERM/SIGINT preemption writes a blocking
  checkpoint and raises ``Preempted``; a restarted solve restores and
  continues from the boundary. Checkpoints hold *global* (PE-major)
  arrays plus a manifest meta in the JAX package's format, so a
  checkpoint written by either package resumes in the other, on any
  device, bit for bit. Under the ``torch.distributed`` transport the
  boundary is gathered to rank 0 (one uncounted gather), which writes
  it, and a restore gives every rank its own PEs' rows of the global
  planes: the checkpoints are the virtual transport's, byte for byte, so
  either transport resumes the other's.
- **deterministic fault injection** (:mod:`.faults`): PE loss,
  corrupted state planes, forced overflows and preemption fire at named
  stage boundaries. Validation and corruption run only when an injector
  is given: the plain path gains no host synchronisation. Under the
  ``torch.distributed`` transport every decision that changes the
  schedule (a lost PE, a corrupted plane, a forced overflow, a
  preemption, a retry) is agreed over the ranks with one uncounted
  reduction, so every rank takes the same path; a fault located at a PE
  (``pe_loss``, ``corrupt``) fires on the rank that owns it.
- **the flight recorder** (:mod:`repro_torch.obs`): a ``tracer`` gets one
  ``stage`` span per schedule slot with one ``stage-attempt`` span per
  execution, closed after the stage's device synchronisation and
  annotated at its end with the collectives the stage made (the plan's
  counting transport) and their §2.6 price; fault, escalation and
  preemption instants; and, with ``cfg.telemetry``, each committed
  stage's per-PE telemetry record (seeded per stage, carried beside the
  boundary state as ``_telemetry`` and harvested with one copy before
  the commit — it never reaches a checkpoint).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.core.listrank import faults as faults_lib
from repro_torch.core.listrank import local as local_lib
from repro_torch.core.listrank import srs as srs_lib
from repro_torch.core.listrank import store as store_lib
from repro_torch.core.listrank import tuner
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.core.listrank.doubling import doubling_solve
from repro_torch.core.listrank.srs import STAT_KEYS, _merge, zero_stats
from repro_torch.obs import telemetry as tele_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.runtime.fault_tolerance import Preempted

#: stat keys whose nonzero value means the attempt is unusable.
FATAL_KEYS = ("dropped", "sub_overflow", "store_miss", "undelivered")

#: capacity family -> the fatal stat the stage loop synthesizes for an
#: injected overflow of that family (the inverse of tuner.FAMILY_OF
#: restricted to the capacity-exclusive solver families).
FAMILY_STAT = {"chase": "dropped", "sub": "sub_overflow",
               "gather": "undelivered"}


class SolveExhausted(RuntimeError):
    """The retry/escalation budget ran out.

    ``attempts`` (total), ``scales_log`` (the per-attempt escalation
    path), ``fatal`` (fatal stat -> its count in the failing attempt),
    ``families`` (the capacity families those stats implicate), and
    ``stats`` (the failing attempt's full host counter dict).
    """

    def __init__(self, attempts: int, scales_log, fatal: dict, stats=None):
        self.attempts = int(attempts)
        self.scales_log = tuple(scales_log)
        self.fatal = {k: int(v) for k, v in fatal.items()}
        self.families = tuple(sorted({
            f for k, v in self.fatal.items() if v
            for f in tuner.FAMILY_OF.get(k, ())}))
        self.stats = dict(stats or {})
        super().__init__(
            f"list ranking did not complete after {self.attempts} attempts")

    def __str__(self) -> str:
        lines = [f"list ranking did not complete after {self.attempts} "
                 f"attempts (capacity escalation exhausted)",
                 "  escalation path:"]
        for i, entry in enumerate(self.scales_log, start=1):
            lines.append(f"    attempt {i}: {entry}")
        lines.append("  fatal stats of the failing attempt:")
        for key, count in sorted(self.fatal.items()):
            if not count:
                continue
            fams = tuner.FAMILY_OF.get(key, ())
            fam_s = (f" -> escalates {', '.join(fams)}" if fams
                     else " (no capacity family)")
            lines.append(f"    {key}={count}{fam_s}")
        if not any(self.fatal.values()):
            lines.append("    (none recorded)")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage of the staged solve. ``level`` is the recursion level
    for descend/base/ascend (pd pins 0); -1 for prep/post."""
    kind: str      # prep | descend | base | ascend | pd | post
    level: int

    @property
    def label(self) -> str:
        return self.kind if self.level < 0 else f"{self.kind}@{self.level}"


def schedule_for(cfg: ListRankConfig) -> tuple[Stage, ...]:
    """The stage schedule for a resolved config (algorithm != auto)."""
    if cfg.algorithm == "doubling":
        return (Stage("prep", -1), Stage("pd", 0), Stage("post", -1))
    L = cfg.srs_rounds
    out = [Stage("prep", -1)]
    out += [Stage("descend", k) for k in range(L)]
    out += [Stage("base", L)]
    out += [Stage("ascend", k) for k in reversed(range(L))]
    out += [Stage("post", -1)]
    return tuple(out)


# --------------------------------------------------------------------------
# stage bodies (batched over the PE axis)
# --------------------------------------------------------------------------

def _owner_fn(m: int):
    def owner_of(g):
        return g // m
    return owner_of


def _stage_spec(stage: Stage, specs):
    """The LevelSpec whose capacities a stage routes under (its
    telemetry record's caps)."""
    if stage.kind in ("prep", "post", "pd"):
        return specs[0]
    if stage.kind == "base":
        return specs[-1]
    return specs[stage.level]


def _tele_seed(stats, plan, tele=None):
    """``stats`` (copied) with the stage's telemetry record seeded
    (cfg.telemetry): ``tele`` when given — the composed one-attempt solve
    threads one record through its stages — else a fresh
    ``stage_zero``, so the staged solve attributes telemetry per stage.
    :func:`_tele_pop` takes it out again before the stats re-enter the
    boundary state."""
    stats = dict(stats)
    if plan.telemetry:
        stats["telemetry"] = tele if tele is not None else \
            tele_lib.stage_zero(plan.p_local, plan.indirection.depth,
                                plan.device)
    return stats


def _tele_pop(stats, plan):
    """Split a stage's stats into (plain stats, telemetry record or
    None)."""
    if not plan.telemetry:
        return stats, None
    stats = dict(stats)
    return stats, stats.pop("telemetry")


def _with_tele(out, stats, plan):
    """``out`` with the stage's plain stats and, with cfg.telemetry, its
    record under ``_telemetry`` (beside, never inside, the boundary
    state)."""
    stats, tele = _tele_pop(stats, plan)
    out["stats"] = stats
    if tele is not None:
        out["_telemetry"] = tele
    return out


def _prep_body(succ, rank, *, plan, cfg, spec0, m, tele=None):
    """Everything before the recursion: contraction, store build, and
    (faithful Algorithm 1 only) the reversal preprocessing."""
    from repro_torch.core.listrank import api as api_lib
    base = plan.my_id() * m
    gid = base[:, None] + torch.arange(m, dtype=torch.int32,
                                       device=succ.device)
    stats = _tele_seed(zero_stats(plan.p_local, plan.device), plan, tele)

    if cfg.local_contraction:
        succ_w, rank_w, rep, aux = local_lib.contract(
            succ, rank, base, m, cfg.use_pallas)
        active = rep
    else:
        rep, aux = None, None
        succ_w, rank_w = succ, rank
        active = torch.ones_like(succ, dtype=torch.bool)

    is_term0 = active & (succ_w == gid)
    st = store_lib.make_dense_store(succ_w, rank_w, active, base)

    state = {}
    if cfg.algorithm == "srs":
        if cfg.avoid_reversal:
            state["forced"] = torch.zeros_like(active)
        else:
            st, stats = api_lib._reverse_instance(plan, spec0, _owner_fn(m),
                                                  st, stats)
            state["forced"] = is_term0
    state["stores"] = (st,)
    state["takes"] = ()
    state["is_subs"] = ()
    state["is_terms"] = ()
    if cfg.local_contraction:
        state["rep"] = rep
        state["aux"] = aux
    return _with_tele(state, stats, plan)


def _descend_body(state, perm_fn, *, plan, cfg, spec, level, m, tele=None):
    st = state["stores"][-1]
    forced = state.get("forced") if level == 0 else None
    st, sub, take, is_sub, is_term, stats = srs_lib.descend_level(
        plan, cfg, spec, _owner_fn(m), st, perm_fn, level,
        _tele_seed(state["stats"], plan, tele), forced)
    out = {k: v for k, v in state.items() if k != "forced"}
    out["stores"] = state["stores"][:-1] + (st, sub)
    out["takes"] = state["takes"] + (take,)
    out["is_subs"] = state["is_subs"] + (is_sub,)
    out["is_terms"] = state["is_terms"] + (is_term,)
    return _with_tele(out, stats, plan)


def _base_body(state, *, plan, cfg, spec, m, tele=None):
    st, stats = srs_lib.base_level(plan, cfg, spec, _owner_fn(m),
                                   state["stores"][-1],
                                   _tele_seed(state["stats"], plan, tele))
    out = dict(state)
    out["stores"] = state["stores"][:-1] + (st,)
    return _with_tele(out, stats, plan)


def _ascend_body(state, *, plan, cfg, spec, level, m, want_sink, tele=None):
    st, sub = state["stores"][-2], state["stores"][-1]
    st, stats = srs_lib.ascend_level(
        plan, cfg, spec, _owner_fn(m), st, sub,
        state["takes"][-1], state["is_subs"][-1], state["is_terms"][-1],
        _tele_seed(state["stats"], plan, tele), want_sink)
    out = dict(state)
    out["stores"] = state["stores"][:-2] + (st,)
    out["takes"] = state["takes"][:-1]
    out["is_subs"] = state["is_subs"][:-1]
    out["is_terms"] = state["is_terms"][:-1]
    return _with_tele(out, stats, plan)


def _pd_body(state, *, plan, cfg, spec0, spec_base, m, tele=None):
    st, pst = doubling_solve(plan, state["stores"][-1], _owner_fn(m),
                             spec0.gather_req_cap, spec0.gather_resp_cap,
                             spec_base.max_rounds, cfg.dedup_requests)
    out = dict(state)
    out["stores"] = state["stores"][:-1] + (st,)
    upd = {"pd_rounds": pst["pd_rounds"], "pd_msgs": pst["pd_msgs"],
           "undelivered": pst["pd_undelivered"]}
    if plan.telemetry:
        # PD requests ride the gather-family mailboxes (req/resp caps).
        upd["telemetry"] = {"gather": pst["telemetry"]}
    stats = _merge(_tele_seed(state["stats"], plan, tele), upd)
    return _with_tele(out, stats, plan)


def _post_body(state, succ, rank, *, plan, cfg, spec0, m, tele=None):
    """Everything after the recursion: §2.3 restoration and the final
    stat reduction (the one psum over the carried per-PE partials).
    Returns (succ, rank, stats) with stats reduced to 0-dim totals, and
    with cfg.telemetry the stage's per-PE record as a 4th element — popped
    before the reduction, so telemetry adds no collective."""
    from repro_torch.core.listrank import api as api_lib
    base = plan.my_id() * m
    stats = _tele_seed(state["stats"], plan, tele)
    st = state["stores"][0]
    if cfg.local_contraction:
        succ_f, rank_f, stats = api_lib._restore_local(
            plan, spec0, _owner_fn(m), st, state["aux"], state["rep"],
            succ, rank, base, stats)
    else:
        succ_f, rank_f = st.succ, st.rank
    stats, tele = _tele_pop(stats, plan)
    stats = {k: plan.psum(v)[0] for k, v in stats.items()}
    if tele is not None:
        return succ_f, rank_f, stats, tele
    return succ_f, rank_f, stats


def _run_stage(stage: Stage, state, succ_d, rank_d, perm_fn, *, plan, cfg,
               specs, m, tele=None):
    """Run one stage; ``tele`` seeds its telemetry record (see
    :func:`_tele_seed`)."""
    if stage.kind == "prep":
        return _prep_body(succ_d, rank_d, plan=plan, cfg=cfg,
                          spec0=specs[0], m=m, tele=tele)
    if stage.kind == "descend":
        return _descend_body(state, perm_fn, plan=plan, cfg=cfg,
                             spec=specs[stage.level], level=stage.level, m=m,
                             tele=tele)
    if stage.kind == "base":
        return _base_body(state, plan=plan, cfg=cfg, spec=specs[-1], m=m,
                          tele=tele)
    if stage.kind == "ascend":
        want_sink = stage.level > 0 or cfg.avoid_reversal
        return _ascend_body(state, plan=plan, cfg=cfg,
                            spec=specs[stage.level], level=stage.level, m=m,
                            want_sink=want_sink, tele=tele)
    if stage.kind == "pd":
        return _pd_body(state, plan=plan, cfg=cfg, spec0=specs[0],
                        spec_base=specs[-1], m=m, tele=tele)
    if stage.kind == "post":
        return _post_body(state, succ_d, rank_d, plan=plan, cfg=cfg,
                          spec0=specs[0], m=m, tele=tele)
    raise ValueError(f"unknown stage kind {stage.kind!r}")


# --------------------------------------------------------------------------
# boundary-state templates and the checkpoint layout
# --------------------------------------------------------------------------

def boundary_template(sched, idx: int, cfg: ListRankConfig, specs, m: int,
                      p: int, weight_dtype):
    """The boundary state after the first ``idx`` stages of ``sched`` as
    ``meta`` tensors (shapes and dtypes, no storage) in the port's
    (p, cap) layout."""
    if idx < 1:
        raise ValueError("no boundary state before the prep stage")
    caps = [m]                      # store-capacity stack
    take_caps: list[int] = []
    has_forced = cfg.algorithm != "doubling"
    for stage in sched[1:idx]:
        if stage.kind == "descend":
            take_caps.append(specs[stage.level].cap_sub)
            caps.append(specs[stage.level].cap_sub)
            if stage.level == 0:
                has_forced = False
        elif stage.kind == "ascend":
            caps.pop()
            take_caps.pop()
        # base / pd leave the structure unchanged

    def arr(cap, dtype):
        return torch.empty((p, cap), dtype=dtype, device="meta")

    def store_t(j, cap):
        return store_lib.Store(ids=arr(cap, torch.int32),
                               succ=arr(cap, torch.int32),
                               rank=arr(cap, weight_dtype),
                               valid=arr(cap, torch.bool), dense=(j == 0))

    state = {}
    if has_forced:
        state["forced"] = arr(m, torch.bool)
    state["stores"] = tuple(store_t(j, c) for j, c in enumerate(caps))
    state["takes"] = tuple(arr(c, torch.int32) for c in take_caps)
    # the level-k masks cover the store that was live when level k
    # descended: caps[k] for every descended-but-not-ascended level.
    state["is_subs"] = tuple(arr(c, torch.bool) for c in caps[:-1]) \
        if take_caps else ()
    state["is_terms"] = state["is_subs"]
    if cfg.local_contraction:
        state["rep"] = arr(m, torch.bool)
        state["aux"] = {"S": arr(m, torch.int32), "D": arr(m, weight_dtype),
                        "stop_is_term": arr(m, torch.bool)}
    state["stats"] = {k: torch.empty(p, dtype=torch.int32, device="meta")
                      for k in STAT_KEYS}
    return state


def _boundary_to_write(state, plan):
    """The checkpoint layout (:func:`global_layout`) of a boundary state
    over every PE: on one process the state's own; under the distributed
    transport every leaf's rows gathered in one uncounted gather (the
    leaves' bytes side by side), laid out on rank 0 and None on the other
    ranks, which write nothing."""
    if plan.p_local == plan.p:
        return global_layout(state)
    _, leaves, rebuild = flatten(state)
    k = plan.p_local
    parts = [x.reshape(k, x.numel() // k).contiguous().view(torch.uint8)
             for x in leaves]
    whole = plan.transport.gather_pes(torch.cat(parts, dim=1))
    if plan.transport.rank != 0:
        return None
    out, at = [], 0
    for x, part in zip(leaves, parts):
        width = part.shape[1]
        piece = whole[:, at:at + width].contiguous().view(x.dtype)
        out.append(piece.reshape((plan.p,) + tuple(x.shape[1:])))
        at += width
    return global_layout(rebuild(out))


def _rank_rows(state, plan):
    """A restored (p, ...) boundary state's rows of this rank's PEs, on
    the plan's device."""
    _, leaves, rebuild = flatten(state)
    return rebuild([plan.transport.local_rows(x).to(plan.device)
                    for x in leaves])


def global_layout(state):
    """The checkpoint layout of a boundary state (or template): every
    (p, cap) plane as one PE-major (p * cap,) array, as the JAX package
    stores its block-sharded leaves; the (p,) stats stay as they are."""
    _, leaves, rebuild = flatten(state)
    return rebuild([x.reshape(-1) if x.dim() == 2 else x for x in leaves])


def per_pe_layout(flat, like):
    """:func:`global_layout` undone: ``flat``'s leaves in the shapes and
    structure of the (p, cap) template ``like``."""
    _, leaves, rebuild = flatten(like)
    _, flat_leaves, _ = flatten(flat)
    return rebuild([x.reshape(t.shape) for x, t in zip(flat_leaves, leaves)])


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x)


def _whole_instance(succ_d, rank_d, plan):
    """(succ, rank) of every PE, (p, m): the rank's blocks gathered in
    one uncounted gather under the distributed transport (both planes
    side by side as int32 words), the blocks themselves on one
    process."""
    if plan.p_local == plan.p:
        return succ_d, rank_d
    m = succ_d.shape[1]
    both = plan.transport.gather_pes(torch.cat(
        [succ_d, rank_d.view(torch.int32)], dim=1))
    return both[:, :m], both[:, m:].contiguous().view(rank_d.dtype)


def solve_fingerprint(succ, rank, n: int, p: int, seed: int,
                      cfg: ListRankConfig) -> str:
    """Identity of a solve for restore validation: the instance bytes in
    global order plus the backend-independent config — the JAX package's
    fingerprint of the same solve. A checkpoint restores only into the
    same logical solve, with the kernels on or off."""
    h = hashlib.sha256()
    h.update(_host(succ).astype(np.int32, copy=False).tobytes())
    h.update(_host(rank).tobytes())
    key = (n, p, int(seed),
           cfg.with_(backend="auto", use_pallas=False, use_pallas_pack=False))
    h.update(repr(key).encode())
    return h.hexdigest()


# --------------------------------------------------------------------------
# host-side state validation + corruption
# --------------------------------------------------------------------------

def validate_state(state, n: int, plan=None) -> None:
    """Invariant check of a boundary state: every valid store slot must
    hold ids/succ inside [0, n). Catches the ``corrupt`` injection's
    sentinel (and real bit-rot) before it is checkpointed or consumed by
    the next stage. One host synchronisation; with ``plan`` the flags
    are summed over the ranks (``transport.rank_sum``), so that every
    rank raises or none does."""
    checks = [(j, plane, st.valid & ((getattr(st, plane) < 0)
                                     | (getattr(st, plane) >= n)))
              for j, st in enumerate(state["stores"])
              for plane in ("ids", "succ")]
    if not checks:
        return
    flags = torch.stack([bad.any() for _, _, bad in checks]).to(torch.int32)
    if plan is not None:
        flags = plan.transport.rank_sum(flags)
    for (j, plane, bad), any_bad in zip(checks, flags.tolist()):
        if any_bad:
            hits = torch.nonzero(bad.reshape(-1))
            if hits.numel() == 0:  # the bad slot is another rank's
                raise faults_lib.CorruptedState(
                    f"store {j} plane {plane!r}: invalid global id on "
                    f"another rank (n={n})")
            k = int(hits[0, 0])
            v = int(getattr(state["stores"][j], plane).reshape(-1)[k])
            raise faults_lib.CorruptedState(
                f"store {j} plane {plane!r}: invalid global id {v} at slot "
                f"{k} (n={n})")


def _local_row(plan, pe: int) -> int | None:
    """The row of global PE ``pe`` (mod p) on this process, or None when
    another rank holds it. ``plan``: a ``MeshPlan``, or any object with
    ``p`` for p PEs all on this process."""
    pes = getattr(plan, "local_pes", range(max(plan.p, 1)))
    pe %= max(plan.p, 1)
    return pe - pes.start if pe in pes else None


def _apply_corruption(state, spec: faults_lib.FaultSpec, plan):
    """Scribble the corrupt sentinel over PE ``spec.pe``'s row of the
    bottom store's ``spec.plane`` — a lost/garbled mailbox plane — on the
    process that holds that PE (the state unchanged elsewhere). Writes
    into a copy: the stage's output shares tensors with the committed
    boundary, which a recovery re-runs from."""
    row = _local_row(plan, spec.pe)
    if row is None:
        return state
    st = state["stores"][0]
    leaf = getattr(st, spec.plane).clone()
    leaf[row] = faults_lib.CORRUPT_SENTINEL
    out = dict(state)
    out["stores"] = (st.replace(**{spec.plane: leaf}),) + state["stores"][1:]
    return out


def _fatal_totals(stats, plan) -> dict:
    """Global fatal-stat totals from per-PE stats, summed over every
    rank (an uncounted ``transport.rank_sum``), or from post's totals,
    which the stage's psum already made equal on every rank."""
    tot = torch.stack([stats[k].reshape(-1).sum() for k in FATAL_KEYS])
    if stats[FATAL_KEYS[0]].dim() > 0:
        tot = plan.transport.rank_sum(tot)
    return dict(zip(FATAL_KEYS, (int(v) for v in tot.tolist())))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def attempt_prediction(plan, machine) -> dict:
    """Span annotations of the attempt that just ran: the collectives it
    made (the plan's counting transport, cleared at the attempt's
    start) and their §2.6 price — host arithmetic over counts the
    transport keeps anyway."""
    from repro_torch.obs import cost as cost_lib
    fprint = plan.transport.footprint()
    pred = cost_lib.predict_stage(fprint, plan, machine)
    count, nbytes = cost_lib.total_collectives(fprint)
    return {"predicted_s": pred["total_s"],
            "predicted_startup_s": pred["startup_s"],
            "predicted_volume_s": pred["volume_s"],
            "collective_count": count, "payload_bytes": nbytes,
            "footprint": cost_lib.footprint_summary(fprint)}


# --------------------------------------------------------------------------
# the stage loop
# --------------------------------------------------------------------------

def run_staged(succ_d, rank_d, *, plan, cfg: ListRankConfig, m: int, n: int,
               perm_fn, build_level_specs, seed: int = 0,
               max_retries: int = 3, supervisor=None, inject=None,
               stage_counters: bool = False, initial_scales=None,
               tracer=None):
    """Run the staged solve to completion. Returns (succ, rank, stats).

    ``succ_d``/``rank_d`` are (p, m) on the plan's device;
    ``build_level_specs(level_scales) -> tuple[LevelSpec]`` is the
    host-side capacity derivation; ``perm_fn(level, pe, cap)`` supplies
    the ruler permutations; ``seed`` enters the checkpoints' instance
    fingerprint. ``supervisor`` (a
    :class:`~repro_torch.runtime.fault_tolerance.SolveSupervisor`)
    enables checkpoint/restart + preemption; ``inject`` (a
    :class:`~repro_torch.core.listrank.faults.FaultInjector`, FaultSpec,
    or sequence of FaultSpecs) drives the recovery paths
    deterministically. ``stage_counters`` records each executed stage's
    collective counts in ``host_stats["stage_collectives"]`` (the plan's
    transport must be a ``transport.CountingTransport``, as it must for
    a ``tracer``). ``host_stats["stage_wall_s"]`` holds each committed
    stage's wall seconds, measured to a device synchronisation, and
    ``host_stats["recovery"]`` the supervisor's accounting and the
    faults injected. ``tracer`` (a :class:`repro_torch.obs.Tracer`)
    records the flight-recorder span tree: one ``stage`` span per
    schedule slot, one nested ``stage-attempt`` span per execution
    annotated with the collectives it made and their §2.6 price. With
    ``cfg.telemetry`` ``host_stats["telemetry"]`` holds every committed
    stage's :class:`~repro_torch.obs.telemetry.StageRecord` and the
    headroom report.
    """
    p = plan.p
    ranks = plan.p_local != p   # the PEs live on several ranks
    wdt = rank_d.dtype
    sched = schedule_for(cfg)
    n_levels = cfg.srs_rounds + 1
    tr = trace_lib.ensure(tracer)
    injector = inject
    if injector is not None and not isinstance(injector,
                                               faults_lib.FaultInjector):
        injector = faults_lib.FaultInjector(injector)
    if ranks and supervisor is not None and injector is None:
        # every supervised rank takes the same agreement steps, whether
        # or not it was given faults (a preemption on one rank only)
        injector = faults_lib.FaultInjector(())

    level_scales = tuner.normalize_level_scales(
        initial_scales if initial_scales is not None
        else tuner.CapacityScales(), n_levels)
    attempts = 1
    scales_log = [tuner.format_scales(level_scales[0])]
    stage_log: list[str] = []
    injected_log: list[str] = []
    stage_wall: list[tuple[str, float]] = []
    stage_collectives: list[tuple] = []
    tele_records: list[tele_lib.StageRecord] = []
    crashes = 0
    if supervisor is not None:
        supervisor.tracer = tr
        supervisor.bind(plan.transport)
    # the fingerprint reads the instance back to the host: only a
    # supervised solve, which checkpoints, pays for it
    fp = (solve_fingerprint(*_whole_instance(succ_d, rank_d, plan), n, p,
                            seed, cfg)
          if supervisor is not None else None)

    # one stage span per schedule slot stays open across its overflow
    # retries (attempts nest under it)
    stage_span, stage_span_idx, stage_attempt = None, -1, 0

    def close_stage_span(**kw):
        nonlocal stage_span
        if stage_span is not None:
            tr.end(stage_span, **kw)
            stage_span = None

    def make_meta(idx):
        return {"format": 1, "idx": idx, "fingerprint": fp, "n": n, "p": p,
                "m": m, "algorithm": cfg.algorithm, "attempts": attempts,
                "scales_log": list(scales_log),
                "scales": [dataclasses.asdict(s) for s in level_scales],
                "weight_dtype": str(wdt).removeprefix("torch.")}

    def try_restore():
        """(state, idx, prev_fatal) from the supervisor's latest valid
        checkpoint, or None."""
        if supervisor is None:
            return None
        # drain any in-flight async boundary write: the latest committed
        # boundary must be durable (and its failure surfaced) before we
        # decide where to resume from.
        supervisor.ckpt.wait()
        meta = supervisor.latest_meta()
        if not meta or meta.get("fingerprint") != fp:
            return None
        nonlocal level_scales, attempts, scales_log
        level_scales = tuple(tuner.CapacityScales(**d)
                             for d in meta["scales"])
        attempts = int(meta["attempts"])
        scales_log = list(meta["scales_log"])
        specs = build_level_specs(level_scales)
        like = boundary_template(sched, meta["idx"], cfg, specs, m, p,
                                 getattr(torch, meta["weight_dtype"]))
        if ranks:  # every rank reads the step, keeps its PEs' rows
            flat, _ = supervisor.restore(global_layout(like), "cpu")
            state = _rank_rows(per_pe_layout(flat, like), plan)
        else:
            flat, _ = supervisor.restore(global_layout(like), plan.device)
            state = per_pe_layout(flat, like)
        supervisor.stats["resumed_from"] = int(meta["idx"])
        return state, int(meta["idx"]), _fatal_totals(state["stats"], plan)

    state, idx = None, 0
    prev_fatal = {k: 0 for k in FATAL_KEYS}
    restored = try_restore()
    if restored is not None:
        state, idx, prev_fatal = restored

    while idx < len(sched):
        stage = sched[idx]
        if supervisor is not None and supervisor.preempt_agreed():
            if state is not None:
                supervisor.boundary(
                    idx, lambda: _boundary_to_write(state, plan),
                    make_meta(idx), blocking=True)
            supervisor.stats["preempted"] += 1
            raise Preempted(
                f"preempted at stage boundary {idx}/{len(sched)}")
        if stage_span_idx != idx:
            close_stage_span(outcome="abandoned")  # crash rewound idx
            stage_span = tr.begin(stage.label, cat="stage",
                                  stage=stage.kind, level=stage.level,
                                  schedule_idx=idx)
            stage_span_idx, stage_attempt = idx, 0
        stage_attempt += 1
        specs = build_level_specs(level_scales)
        att = tr.begin(f"{stage.label}#{stage_attempt}", cat="stage-attempt",
                       stage=stage.label, level=stage.level,
                       attempt=stage_attempt,
                       scales=tuner.format_scales(
                           level_scales[max(stage.level, 0)]))
        if stage_counters or tr.enabled:
            plan.transport.clear()
        try:
            if injector is not None:
                lost = injector.pe_loss_before(stage.kind, stage.level)
                here = lost is not None and _local_row(plan, lost.pe) \
                    is not None
                if plan.transport.agree([int(here)])[0]:
                    raise faults_lib.InjectedFault(
                        f"injected PE loss before stage "
                        f"{stage.kind}@L{stage.level}")
            _sync(plan.device)
            t0 = time.perf_counter()
            out = _run_stage(stage, state, succ_d, rank_d, perm_fn,
                             plan=plan, cfg=cfg, specs=specs, m=m)
            _sync(plan.device)
            dt = time.perf_counter() - t0
            if stage.kind == "post":
                out_state, fatal_src = state, out[2]
            else:
                out_state, fatal_src = out, out["stats"]
            if injector is not None:
                cspec = injector.corrupt_after(stage.kind, stage.level)
                if cspec is not None:
                    injected_log.append(f"corrupt:{stage.label}")
                    tr.instant(f"corrupt:{stage.label}", cat="fault",
                               stage=stage.label, plane=cspec.plane)
                    if stage.kind != "post":
                        out_state = out = _apply_corruption(out, cspec, plan)
                validate_state(out_state, n, plan)
        except (faults_lib.InjectedFault, faults_lib.CorruptedState) as e:
            crashes += 1
            if isinstance(e, faults_lib.InjectedFault):
                injected_log.append(f"pe_loss:{stage.label}")
                tr.instant(f"pe_loss:{stage.label}", cat="fault",
                           stage=stage.label)
            stage_log.append(f"{stage.label}!{type(e).__name__}")
            tr.end(att, outcome=type(e).__name__)
            close_stage_span(outcome="crashed")
            budget_ok = (supervisor.should_retry() if supervisor is not None
                         else crashes <= max_retries)
            if not budget_ok:
                raise
            restored = try_restore()
            if restored is not None:
                state, idx, prev_fatal = restored
            else:
                state, idx = None, 0
                prev_fatal = {k: 0 for k in FATAL_KEYS}
            stage_span_idx = -1  # reopen a fresh stage span after rewind
            continue

        if tr.enabled:
            att.annotate(**attempt_prediction(plan, cfg.machine))
        fatal = _fatal_totals(fatal_src, plan)
        delta = {k: fatal[k] - prev_fatal[k] for k in FATAL_KEYS}
        fam = None
        if injector is not None:
            fired = injector.overflow_after(stage.kind, stage.level)
            agreed = plan.transport.agree(
                [int(fired == f) for f in FAMILY_STAT])
            fam = next((f for f, a in zip(FAMILY_STAT, agreed) if a), None)
        if fam is not None:
            injected_log.append(f"overflow:{fam}:{stage.label}")
            tr.instant(f"overflow:{fam}:{stage.label}", cat="fault",
                       stage=stage.label, family=fam)
        if any(v > 0 for v in delta.values()) or fam is not None:
            # the failed attempt's output is discarded: the committed
            # boundary state (end of the previous stage) is the resume
            # point, with only the implicated families escalated at
            # levels >= the faulting level.
            esc_stats = ({k: v for k, v in delta.items() if v > 0}
                         if any(v > 0 for v in delta.values())
                         else {FAMILY_STAT[fam]: 1})
            stage_log.append(f"{stage.label}!overflow")
            tr.end(att, wall_s=dt, outcome="overflow",
                   fatal={k: int(v) for k, v in esc_stats.items()})
            attempts += 1
            if attempts > max_retries + 1:
                close_stage_span(outcome="exhausted")
                raise SolveExhausted(attempts - 1, scales_log, esc_stats,
                                     fatal)
            lvl = max(stage.level, 0)
            level_scales = tuner.escalate_levels(level_scales, stage.level,
                                                 esc_stats)
            entry = tuner.format_scales(level_scales[lvl])
            scales_log.append(entry + (f"@L{lvl}" if lvl > 0 else ""))
            tr.instant(f"escalate:{stage.label}", cat="retry",
                       stage=stage.label, scales=entry, level=lvl)
            continue

        # commit the boundary
        if stage_counters:
            stage_collectives.append((stage.label, tuple(sorted(
                plan.transport.counts.items()))))
        stage_log.append(stage.label)
        stage_wall.append((stage.label, dt))
        util = {}
        if plan.telemetry:
            # harvest the stage's per-PE record (one device-to-host copy)
            # before the state is committed/checkpointed: the boundary
            # state does not — and must not — carry it.
            tele_pe = (out[3] if stage.kind == "post"
                       else out_state.pop("_telemetry"))
            agg = tele_lib.aggregate(tele_lib.to_host(tele_pe,
                                                      plan.transport))
            util = tele_lib.utilization(agg)
            spec_u = _stage_spec(stage, specs)
            tele_records.append(tele_lib.StageRecord(
                label=stage.label, kind=stage.kind, level=stage.level,
                caps={"chase": tuple(spec_u.mail_caps),
                      "sub": (spec_u.cap_sub,),
                      "gather": tuple(
                          max(a, b) for a, b in zip(
                              spec_u.gather_req_cap,
                              spec_u.gather_resp_cap))},
                queue_cap=spec_u.queue_cap, tele=agg))
            tr.counter("telemetry/util_max", util["util_max"])
            tr.counter("telemetry/util_mean", util["util_mean"])
            tr.counter("telemetry/queue_hwm",
                       float(agg.get("queue_hwm", 0)))
        tr.end(att, wall_s=dt, outcome="committed", **util)
        close_stage_span()
        if tr.enabled:
            tr.metrics.histogram(
                "obs/stage_wall_s",
                "device-sync-bounded wall seconds per committed stage"
                ).observe(dt)
            if plan.telemetry:
                tr.metrics.histogram(
                    "telemetry/stage_util_max",
                    tele_lib.TELEMETRY_HELP["util_max"]
                    ).observe(util["util_max"])
        if stage.kind == "post":
            succ_f, rank_f, dev_stats = out[0], out[1], out[2]
            break
        state = out_state
        prev_fatal = fatal
        idx += 1
        if supervisor is not None:
            supervisor.note_stage_time(dt)
            supervisor.boundary(idx, lambda: _boundary_to_write(state, plan),
                                make_meta(idx))
        if injector is not None and plan.transport.agree([int(
                injector.preempt_after(stage.kind, stage.level))])[0]:
            injected_log.append(f"preempt:{stage.label}")
            tr.instant(f"preempt:{stage.label}", cat="fault",
                       stage=stage.label)
            if supervisor is not None:
                supervisor.preempt()
            else:
                raise Preempted(
                    f"injected preemption after stage {stage.label}")
    else:  # pragma: no cover - schedule always ends with post
        raise AssertionError("schedule ended without a post stage")

    # post's psum made every total equal on every rank: no further read
    keys = list(dev_stats)
    host_stats = dict(zip(keys, torch.stack(
        [dev_stats[k] for k in keys]).tolist()))
    host_stats["attempts"] = attempts
    host_stats["scales_log"] = ";".join(scales_log)
    host_stats["stage_log"] = tuple(stage_log)
    host_stats["stage_wall_s"] = tuple(stage_wall)
    rec = (dict(supervisor.stats) if supervisor is not None else
           {"restarts": crashes, "stragglers": 0, "checkpoints": 0,
            "preempted": 0, "resumed_from": -1})
    rec["injected"] = tuple(injected_log)
    host_stats["recovery"] = rec
    if stage_counters:
        host_stats["stage_collectives"] = tuple(stage_collectives)
    if plan.telemetry:
        host_stats["telemetry"] = {
            "stages": [r.to_json() for r in tele_records],
            "headroom": tele_lib.headroom_rows(tele_records,
                                               scales_log[-1]),
        }
    if supervisor is not None:
        supervisor.ckpt.wait()
    return succ_f, rank_f, host_stats
