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

Checkpointing, fault injection, telemetry and span tracing belong to
later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.listrank import local as local_lib
from repro_torch.core.listrank import srs as srs_lib
from repro_torch.core.listrank import store as store_lib
from repro_torch.core.listrank import tuner
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.core.listrank.doubling import doubling_solve
from repro_torch.core.listrank.srs import _merge, zero_stats

#: stat keys whose nonzero value means the attempt is unusable.
FATAL_KEYS = ("dropped", "sub_overflow", "store_miss", "undelivered")


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


def _prep_body(succ, rank, *, plan, cfg, spec0, m):
    """Everything before the recursion: contraction, store build, and
    (faithful Algorithm 1 only) the reversal preprocessing."""
    from repro_torch.core.listrank import api as api_lib
    base = plan.my_id() * m
    gid = base[:, None] + torch.arange(m, dtype=torch.int32,
                                       device=succ.device)
    stats = zero_stats(plan.p, plan.device)

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
    state["stats"] = stats
    return state


def _descend_body(state, perm_fn, *, plan, cfg, spec, level, m):
    st = state["stores"][-1]
    forced = state.get("forced") if level == 0 else None
    st, sub, take, is_sub, is_term, stats = srs_lib.descend_level(
        plan, cfg, spec, _owner_fn(m), st, perm_fn, level, state["stats"],
        forced)
    out = {k: v for k, v in state.items() if k != "forced"}
    out["stores"] = state["stores"][:-1] + (st, sub)
    out["takes"] = state["takes"] + (take,)
    out["is_subs"] = state["is_subs"] + (is_sub,)
    out["is_terms"] = state["is_terms"] + (is_term,)
    out["stats"] = stats
    return out


def _base_body(state, *, plan, cfg, spec, m):
    st, stats = srs_lib.base_level(plan, cfg, spec, _owner_fn(m),
                                   state["stores"][-1], state["stats"])
    out = dict(state)
    out["stores"] = state["stores"][:-1] + (st,)
    out["stats"] = stats
    return out


def _ascend_body(state, *, plan, cfg, spec, level, m, want_sink):
    st, sub = state["stores"][-2], state["stores"][-1]
    st, stats = srs_lib.ascend_level(
        plan, cfg, spec, _owner_fn(m), st, sub,
        state["takes"][-1], state["is_subs"][-1], state["is_terms"][-1],
        state["stats"], want_sink)
    out = dict(state)
    out["stores"] = state["stores"][:-2] + (st,)
    out["takes"] = state["takes"][:-1]
    out["is_subs"] = state["is_subs"][:-1]
    out["is_terms"] = state["is_terms"][:-1]
    out["stats"] = stats
    return out


def _pd_body(state, *, plan, cfg, spec0, spec_base, m):
    st, pst = doubling_solve(plan, state["stores"][-1], _owner_fn(m),
                             spec0.gather_req_cap, spec0.gather_resp_cap,
                             spec_base.max_rounds, cfg.dedup_requests)
    out = dict(state)
    out["stores"] = state["stores"][:-1] + (st,)
    out["stats"] = _merge(state["stats"], {
        "pd_rounds": pst["pd_rounds"], "pd_msgs": pst["pd_msgs"],
        "undelivered": pst["pd_undelivered"]})
    return out


def _post_body(state, succ, rank, *, plan, cfg, spec0, m):
    """Everything after the recursion: §2.3 restoration and the final
    stat reduction (the one psum over the carried per-PE partials).
    Returns (succ, rank, stats) with stats reduced to 0-dim totals."""
    from repro_torch.core.listrank import api as api_lib
    base = plan.my_id() * m
    stats = state["stats"]
    st = state["stores"][0]
    if cfg.local_contraction:
        succ_f, rank_f, stats = api_lib._restore_local(
            plan, spec0, _owner_fn(m), st, state["aux"], state["rep"],
            succ, rank, base, stats)
    else:
        succ_f, rank_f = st.succ, st.rank
    stats = {k: plan.psum(v)[0] for k, v in stats.items()}
    return succ_f, rank_f, stats


def _run_stage(stage: Stage, state, succ_d, rank_d, perm_fn, *, plan, cfg,
               specs, m):
    if stage.kind == "prep":
        return _prep_body(succ_d, rank_d, plan=plan, cfg=cfg,
                          spec0=specs[0], m=m)
    if stage.kind == "descend":
        return _descend_body(state, perm_fn, plan=plan, cfg=cfg,
                             spec=specs[stage.level], level=stage.level, m=m)
    if stage.kind == "base":
        return _base_body(state, plan=plan, cfg=cfg, spec=specs[-1], m=m)
    if stage.kind == "ascend":
        want_sink = stage.level > 0 or cfg.avoid_reversal
        return _ascend_body(state, plan=plan, cfg=cfg,
                            spec=specs[stage.level], level=stage.level, m=m,
                            want_sink=want_sink)
    if stage.kind == "pd":
        return _pd_body(state, plan=plan, cfg=cfg, spec0=specs[0],
                        spec_base=specs[-1], m=m)
    if stage.kind == "post":
        return _post_body(state, succ_d, rank_d, plan=plan, cfg=cfg,
                          spec0=specs[0], m=m)
    raise ValueError(f"unknown stage kind {stage.kind!r}")


def _fatal_totals(stats) -> dict:
    """Global fatal-stat totals from per-PE stats (or post's totals)."""
    tot = torch.stack([stats[k].reshape(-1).sum() for k in FATAL_KEYS])
    return dict(zip(FATAL_KEYS, (int(v) for v in tot.tolist())))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# the stage loop
# --------------------------------------------------------------------------

def run_staged(succ_d, rank_d, *, plan, cfg: ListRankConfig, m: int, n: int,
               perm_fn, build_level_specs, max_retries: int = 3,
               stage_counters: bool = False, initial_scales=None):
    """Run the staged solve to completion. Returns (succ, rank, stats).

    ``succ_d``/``rank_d`` are (p, m) on the plan's device;
    ``build_level_specs(level_scales) -> tuple[LevelSpec]`` is the
    host-side capacity derivation; ``perm_fn(level, pe, cap)`` supplies
    the ruler permutations. ``stage_counters`` records each executed
    stage's collective counts in ``host_stats["stage_collectives"]``
    (the plan's transport must be a ``transport.CountingTransport``).
    ``host_stats["stage_wall_s"]`` holds each committed stage's wall
    seconds, measured to a device synchronisation.
    """
    sched = schedule_for(cfg)
    n_levels = cfg.srs_rounds + 1
    level_scales = tuner.normalize_level_scales(
        initial_scales if initial_scales is not None
        else tuner.CapacityScales(), n_levels)
    attempts = 1
    scales_log = [tuner.format_scales(level_scales[0])]
    stage_log: list[str] = []
    stage_wall: list[tuple[str, float]] = []
    stage_collectives: list[tuple] = []

    state, idx = None, 0
    prev_fatal = {k: 0 for k in FATAL_KEYS}
    while idx < len(sched):
        stage = sched[idx]
        specs = build_level_specs(level_scales)
        if stage_counters:
            plan.transport.counts.clear()
        _sync(plan.device)
        t0 = time.perf_counter()
        out = _run_stage(stage, state, succ_d, rank_d, perm_fn, plan=plan,
                         cfg=cfg, specs=specs, m=m)
        _sync(plan.device)
        dt = time.perf_counter() - t0
        fatal_src = out[2] if stage.kind == "post" else out["stats"]
        fatal = _fatal_totals(fatal_src)
        delta = {k: fatal[k] - prev_fatal[k] for k in FATAL_KEYS}
        if any(v > 0 for v in delta.values()):
            # the failed attempt's output is discarded: the committed
            # boundary state (end of the previous stage) is the resume
            # point, with only the implicated families escalated at
            # levels >= the faulting level.
            esc_stats = {k: v for k, v in delta.items() if v > 0}
            stage_log.append(f"{stage.label}!overflow")
            attempts += 1
            if attempts > max_retries + 1:
                raise SolveExhausted(attempts - 1, scales_log, esc_stats,
                                     fatal)
            lvl = max(stage.level, 0)
            level_scales = tuner.escalate_levels(level_scales, stage.level,
                                                 esc_stats)
            entry = tuner.format_scales(level_scales[lvl])
            scales_log.append(entry + (f"@L{lvl}" if lvl > 0 else ""))
            continue

        # commit the boundary
        if stage_counters:
            stage_collectives.append((stage.label, tuple(sorted(
                plan.transport.counts.items()))))
        stage_log.append(stage.label)
        stage_wall.append((stage.label, dt))
        if stage.kind == "post":
            succ_f, rank_f, dev_stats = out
            break
        state = out
        prev_fatal = fatal
        idx += 1
    else:  # pragma: no cover - schedule always ends with post
        raise AssertionError("schedule ended without a post stage")

    keys = list(dev_stats)
    host_stats = dict(zip(keys, torch.stack(
        [dev_stats[k] for k in keys]).tolist()))
    host_stats["attempts"] = attempts
    host_stats["scales_log"] = ";".join(scales_log)
    host_stats["stage_log"] = tuple(stage_log)
    host_stats["stage_wall_s"] = tuple(stage_wall)
    if stage_counters:
        host_stats["stage_collectives"] = tuple(stage_collectives)
    return succ_f, rank_f, host_stats
