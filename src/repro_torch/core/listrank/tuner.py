"""Host-side parameter engine: the §2.6 cost model drives the solver.

The paper's engineering contribution beyond Sibeyn's algorithm is the
detailed parameter analysis (Observation 1 / Corollary 1) used to pick
the ruler count r, the indirection depth d, and the capacities. This
module turns :mod:`repro_torch.core.listrank.analysis` into the single source
of truth for those choices:

- :func:`level_plan` — per-recursion-level ruler fractions. With
  ``ListRankConfig.ruler_fraction=None`` each level's r comes from
  ``analysis.r_star`` applied to the *expected* instance size entering
  that level (``analysis.expected_subproblem`` shrinks it level by
  level); a fixed fraction is passed through unchanged. ``api.build_specs``
  sizes every capacity from this plan, and the fraction is carried into
  ``LevelSpec.ruler_frac`` so the in-program ruler target in
  ``srs.solve_store`` shares the exact same derivation (the dynamic
  ``r_target`` can therefore never exceed the static ``r_static``).

- :func:`choose_indirection` / :func:`choose_algorithm` — cost-model
  selection of the routing scheme (direct vs grid vs topology-aware,
  via :func:`analysis.t_hops` with intra-node constants for the
  topology hop) and the Corollary-1 regime check that falls back to
  plain pointer doubling when n/p is below
  ``analysis.efficiency_threshold``.

- :class:`CapacityScales` / :func:`escalate` — **targeted** capacity
  retries. Each fatal stat names the capacity family that overflowed
  (``dropped`` → chase mail/queue, ``sub_overflow`` → the recursion
  sub-store, ``undelivered`` → gather request/response); a retry
  doubles only that family instead of every capacity, bounding both the
  memory blowup and the number of recompiles.

Everything here is host-side python on static quantities — nothing is
traced.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.listrank import analysis
from repro_torch.core.listrank.config import IndirectionSpec, ListRankConfig

#: hard cap on the per-level ruler fraction: r*/n can exceed 1 for
#: small instances (r* is an asymptotic optimum); capping at 1/4 keeps
#: the expected subproblem r·ln(n/r) strictly shrinking (factor ≈ 0.35).
RULER_FRAC_CAP = 0.25


@dataclasses.dataclass(frozen=True)
class LevelParams:
    """Cost-model output for one recursion level (host-side)."""
    frac: float        #: ruler fraction of the live instance
    n_expected: int    #: expected global instance size entering the level
    r_total: int       #: modeled global ruler count


def level_plan(cfg: ListRankConfig, p: int, d: int,
               n: int) -> tuple[LevelParams, ...]:
    """Per-level ruler fractions for ``srs_rounds`` levels.

    The single shared derivation behind both ``api.build_specs``
    (capacity sizing) and ``srs.solve_store`` (the runtime ruler
    target, via ``LevelSpec.ruler_frac``).
    """
    out: list[LevelParams] = []
    n_level = max(int(n), 1)
    for _ in range(cfg.srs_rounds):
        if cfg.ruler_fraction is not None:
            # fixed fraction: passed through exactly (legacy behavior)
            frac = min(cfg.ruler_fraction, 1.0)
            r_tot = max(int(math.ceil(frac * n_level)), 1)
        else:
            floor_r = max(cfg.min_rulers_per_pe * p, 1)
            cap_r = max(int(math.ceil(RULER_FRAC_CAP * n_level)), 1)
            r_tot = analysis.r_star(n_level, p, d, cfg.machine)
            r_tot = min(max(r_tot, floor_r), max(cap_r, floor_r))
            frac = min(r_tot / n_level, 1.0)
        out.append(LevelParams(frac=frac, n_expected=n_level, r_total=r_tot))
        n_level = max(int(math.ceil(
            analysis.expected_subproblem(n_level, min(r_tot, n_level)))), 1)
    return tuple(out)


# --------------------------------------------------------------------------
# indirection / algorithm selection
# --------------------------------------------------------------------------

def _hop_models(cfg: ListRankConfig, spec: IndirectionSpec,
                intra_hop: tuple[str, ...] | None):
    """Machine model per hop: intra-node constants for the designated
    intra-node hop of a topology-aware spec, ``cfg.machine`` otherwise."""
    return tuple(analysis.INTRA_NODE if hop == intra_hop else cfg.machine
                 for hop in spec.hops)


def candidate_indirections(pe_axes: Sequence[str], axis_sizes: Sequence[int]):
    """The routing schemes the mesh shape admits, as
    ``(name, spec, intra_hop)`` triples. Size-1 axes are excluded from
    grid/topology hops — a hop over a one-PE group is a real collective
    that moves nothing (coordinate 0 needs no fixing). Topology-aware
    treats the minor (fastest-varying) non-trivial axis as intra-node,
    matching how production meshes map PEs onto pod factors
    (launch/mesh.py)."""
    pe_axes = tuple(pe_axes)
    cands = [("direct", IndirectionSpec.direct(pe_axes), None)]
    multi = tuple(a for a, s in zip(pe_axes, axis_sizes) if s > 1)
    if len(multi) > 1:
        grid = IndirectionSpec(hops=tuple((a,) for a in reversed(multi)))
        cands.append(("grid", grid, None))
        intra, inter = (multi[-1],), tuple(multi[:-1])
        cands.append(("topology",
                      IndirectionSpec.topology(intra, inter), intra))
    return cands


def choose_indirection(cfg: ListRankConfig, pe_axes: Sequence[str],
                       axis_sizes: Sequence[int], n: int) -> IndirectionSpec:
    """Pick the indirection scheme with the lowest modeled time.

    Each candidate is scored with its own r* (deeper indirection shifts
    the alpha/beta balance, so the optimal r moves with it)."""
    p = math.prod(axis_sizes)
    best, best_t = None, float("inf")
    for _, spec, intra_hop in candidate_indirections(pe_axes, axis_sizes):
        hop_sizes = tuple(
            math.prod(axis_sizes[list(pe_axes).index(a)] for a in hop)
            for hop in spec.hops)
        models = _hop_models(cfg, spec, intra_hop)
        r = analysis.r_star(n, p, spec.depth, cfg.machine)
        t = analysis.t_hops(n, p, r, hop_sizes, models)
        if t < best_t:
            best, best_t = spec, t
    return best


def choose_algorithm(cfg: ListRankConfig, p: int, d: int, m: int) -> str:
    """Resolve ``algorithm="auto"``: SRS in the Corollary-1 efficient
    regime, plain pointer doubling below it (n/p too small for the
    chase's alpha terms to amortize)."""
    if cfg.algorithm != "auto":
        return cfg.algorithm
    thr = analysis.efficiency_threshold(p, d, cfg.machine)
    return "doubling" if m < thr else "srs"


# --------------------------------------------------------------------------
# targeted capacity retries
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapacityScales:
    """Per-family capacity multipliers for the retry loop.

    ``chase`` scales the chase-phase mailbox and queue capacities,
    ``sub`` the recursion sub-store, ``gather`` the remote-gather
    request/response mailboxes, ``graph`` the graphalg hooking-round
    capacities (label/jump gathers, hook proposals and confirmations,
    adjacency reports, and the hooking-round budget itself — see
    ``graphalg.cc.GraphCaps.scaled``). All 1.0 on the first attempt.
    """
    chase: float = 1.0
    sub: float = 1.0
    gather: float = 1.0
    graph: float = 1.0


def format_scales(scales: CapacityScales) -> str:
    """Canonical one-line rendering of a scale vector — the golden
    bit-identity pins compare the per-attempt escalation path as text."""
    return ",".join(f"{f.name}={getattr(scales, f.name):g}"
                    for f in dataclasses.fields(scales))


#: fatal stat -> the capacity families whose overflow it signals.
#: ``store_miss`` has no capacity interpretation (it indicates routing
#: to the wrong owner), so it conservatively rescales everything.
#: The ``cc_*``/``tour_*``/``stats_*`` keys are the graphalg hooking
#: pipeline's overflow stats: destinations there follow the *dynamic*
#: label structure (hotspots concentrate on small labels), so their
#: caps are slack-based rather than host-exact and re-double under the
#: dedicated ``graph`` family; ``cc_unconverged`` additionally doubles
#: the hooking-round budget through the same scale.
FAMILY_OF = {
    "dropped": ("chase",),
    "sub_overflow": ("sub",),
    "undelivered": ("gather",),
    "store_miss": ("chase", "sub", "gather"),
    "cc_undelivered": ("graph",),
    "cc_unconverged": ("graph",),
    "tour_undelivered": ("graph",),
    "stats_undelivered": ("graph",),
}

_ALL_FAMILIES = ("chase", "sub", "gather", "graph")

#: stats that are NOT capacity-exclusive: ``undelivered`` also captures
#: chase coverage failures (restart-loop stragglers) and chase-mailbox
#: ``route_until_done`` pendings, which no amount of gather capacity
#: fixes. The exclusive stats (dropped, sub_overflow) always make
#: progress by re-doubling their own family.
AMBIGUOUS_STATS = ("undelivered",)


def normalize_level_scales(scales, n_levels: int) -> tuple[CapacityScales, ...]:
    """Broadcast a single :class:`CapacityScales` (or pass through a
    sequence) to one entry per recursion level (``srs_rounds`` chase
    levels + the base level). Per-level scales are what makes
    level-resume sound: escalating level k must not change the static
    shapes of the already-checkpointed levels < k."""
    if isinstance(scales, CapacityScales):
        return (scales,) * n_levels
    scales = tuple(scales)
    if len(scales) != n_levels:
        raise ValueError(
            f"expected {n_levels} per-level scales, got {len(scales)}")
    return scales


def escalate_levels(level_scales: Sequence[CapacityScales], level: int,
                    stats: dict, factor: float = 2.0
                    ) -> tuple[CapacityScales, ...]:
    """Level-resume escalation: rescale the implicated families at the
    faulting level and every level below it in the recursion (>= level),
    leaving completed levels' scales — and therefore their checkpointed
    store shapes — untouched."""
    level = max(level, 0)
    return tuple(escalate(s, stats, factor) if k >= level else s
                 for k, s in enumerate(level_scales))


def escalate(scales: CapacityScales, stats: dict,
             factor: float = 2.0) -> CapacityScales:
    """Rescale only the capacity families implicated by the fatal stats
    in ``stats`` (global rescale if none of the known keys fired).

    Widening ladder for the ambiguous stats only: when an
    ``AMBIGUOUS_STATS`` key persists after its own family was already
    rescaled, its mapping was evidently not the bottleneck, so that
    retry widens to a global rescale. Capacity-exclusive stats keep
    re-doubling their own family however often they fire — targeting
    is never permanently degraded."""
    bump = set()
    widen = False
    for key, fams in FAMILY_OF.items():
        if stats.get(key, 0) > 0:
            bump.update(fams)
            if key in AMBIGUOUS_STATS and \
                    all(getattr(scales, f) > 1.0 for f in fams):
                widen = True
    if not bump or widen:
        bump = set(_ALL_FAMILIES)
    return dataclasses.replace(
        scales, **{f: getattr(scales, f) * factor for f in bump})


# --------------------------------------------------------------------------
# sampled-splitter capacity estimation
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CapacityEstimate:
    """Measured per-hop destination skew, replacing the static slack
    guess (Robust-Massively-Parallel-Sorting-style splitter sampling).

    ``hop_slack[i]`` is the effective capacity-slack multiplier for hop
    i of the indirection: expected hottest-bucket load over the uniform
    load, plus a DKW sampling margin and an oversampling guard. With a
    uniform instance it collapses to ~``guard``; a skewed instance
    (hotspot owners) raises exactly the hops that will see the skew.
    """
    hop_slack: tuple[float, ...]
    max_frac: tuple[float, ...]   #: hottest-bucket sample fraction per hop
    sample_size: int

    def slack_for_hop(self, i: int) -> float:
        return self.hop_slack[i]


def estimate_capacities(succ, plan, m: int, cfg: ListRankConfig,
                        sample_size: int | None = None, seed: int = 0,
                        guard: float = 1.25) -> CapacityEstimate:
    """Estimate per-hop mailbox slack from a sample of the instance.

    Chase waves and gathers address the *owner of succ[x]* for (nearly)
    uniformly random x — the ruler set is a random sample of elements.
    So a host-side sample of ``succ`` destinations, bucketed by each
    hop's routing coordinate, estimates the per-hop load skew the solver
    will see. The hottest-bucket fraction f̂ plus an additive
    DKW/Hoeffding margin sqrt(ln(2s)/2k) bounds the true f w.h.p.;
    capacity is then sized for f·s times the uniform per-bucket load
    instead of a static ``capacity_slack`` guess.

    Deterministic (seeded numpy) and purely host-side: the estimate
    feeds ``api.build_specs`` before the first attempt.
    """
    succ = np.asarray(succ)
    n = succ.shape[0]
    k = min(int(sample_size or cfg.estimation_sample), n)
    rng = np.random.default_rng(np.uint32(seed) ^ np.uint32(0x5EED))
    idx = (rng.choice(n, size=k, replace=False) if k < n
           else np.arange(n, dtype=np.int64))
    owners = (succ[idx] // m).astype(np.int64)

    hop_slack, max_frac = [], []
    for hop in plan.indirection.hops:
        s = plan.hop_size(hop)
        coords = _hop_coord_np(plan, owners, hop)
        hist = np.bincount(coords, minlength=s)
        f_hat = float(hist.max()) / max(k, 1)
        margin = math.sqrt(math.log(2.0 * s + 2.0) / (2.0 * max(k, 1)))
        f_est = min(1.0, f_hat + margin)
        hop_slack.append(max(guard, f_est * s * guard))
        max_frac.append(f_hat)
    return CapacityEstimate(hop_slack=tuple(hop_slack),
                            max_frac=tuple(max_frac), sample_size=k)


def _hop_coord_np(plan, pe_ids: np.ndarray, hop: tuple[str, ...]) -> np.ndarray:
    """Host-side (numpy) mirror of ``MeshPlan.hop_coord``."""
    coord = np.zeros_like(pe_ids)
    for a in hop:
        i = plan.pe_axes.index(a)
        stride = 1
        for sz in plan.axis_sizes[i + 1:]:
            stride *= sz
        c = (pe_ids // stride) % plan.axis_sizes[i]
        coord = coord * plan.axis_sizes[i] + c
    return coord
