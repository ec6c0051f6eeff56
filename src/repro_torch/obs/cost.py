"""§2.6 model-vs-measured accounting: predicted time per stage.

The port's copy of the JAX package's ``repro.obs.cost``. Each traced
stage carries a collective footprint, ``{collective: (count, payload
bytes per PE)}``. The reference counts it statically from the stage's
jaxpr, which sees each ``while_loop`` body once; the port's loops run
on the host, so it counts the calls the stage actually made through the
plan's :class:`~repro_torch.core.listrank.transport.CountingTransport`
(``footprint()``), after the stage ran. This module prices a footprint
under the active
:class:`~repro_torch.core.listrank.analysis.MachineModel`, so every
span gets a §2.6 predicted time next to its measured wall time and a
solve can emit a predicted-vs-observed residual table. Priced on the
rounds that ran, the port's prediction is the alpha-beta price of the
executed schedule.

Pricing rule (the same alpha-beta decomposition as
:func:`analysis.t_all2all` / :func:`analysis.t_hops`):

- each counted ``all_to_all`` is one dense hop over its peer group.
  With a d-hop indirection the hops interleave, so a single counted hop
  is priced at the *mean* hop size
  ``mean_h = (1/d) * sum_h hop_size(h)``; summing the d counted hops of
  one routing round recovers exactly the round's
  ``t_all2all``-style startup ``alpha * sum_h hop_size(h)``
  (= ``alpha * d * p^(1/d)`` on a balanced grid). Formally, one
  counted hop costs ``analysis.t_all2all(mean_h, words, d=1)``.
- tree collectives (``psum``/``all_gather``) are priced as a log-depth
  tree: ``alpha * ceil(log2 p)`` startup plus ``beta * words`` volume.
- ``words = payload_bytes / 8`` (beta is per 8-byte word).
  ``per_pe_scale`` converts recorded bytes to per-PE bytes: the
  reference's simshard jaxpr records p x the per-PE payload and passes
  ``1/p``; both of the port's transports (virtual-PE and
  ``torch.distributed``) record per-PE bytes already, so every stage is
  priced at scale 1, as the reference prices a mesh stage.

Pricing is host arithmetic over counts the transport kept anyway: it
adds no collective and no device work.
"""
from __future__ import annotations

import math

#: primitives priced as one dense hop of the indirection.
DENSE_HOP_PRIMS = ("all_to_all",)


def hop_sizes_of(plan) -> tuple[int, ...]:
    """Peer-group size of each indirection hop of a ``MeshPlan``."""
    return tuple(plan.hop_size(hop) for hop in plan.indirection.hops)


def predict_footprint(footprint: dict, p: int,
                      hop_sizes: tuple[int, ...],
                      machine,
                      per_pe_scale: float = 1.0) -> dict:
    """Price a collective footprint under the alpha-beta model.

    Args:
      footprint: ``{prim: (count, payload_bytes)}``, e.g. from
        ``CountingTransport.footprint()``.
      p: total PE count (tree-collective depth is ``ceil(log2 p)``).
      hop_sizes: the indirection's per-hop peer-group sizes.
      machine: the active :class:`analysis.MachineModel`.
      per_pe_scale: multiply recorded bytes by this to get per-PE
        payload (1 for the port's transport footprints).

    Returns:
      ``{"total_s": float, "by_prim": {prim: seconds},
         "startup_s": float, "volume_s": float}``.
    """
    d = max(len(hop_sizes), 1)
    mean_hop = (sum(hop_sizes) / d) if hop_sizes else float(p)
    log_p = math.ceil(math.log2(max(p, 2)))
    by_prim: dict[str, float] = {}
    startup = volume = 0.0
    for prim, (count, nbytes) in sorted(footprint.items()):
        words = nbytes * per_pe_scale / 8.0
        if prim in DENSE_HOP_PRIMS:
            # one counted hop == t_all2all over its peer group at d=1
            t_s = machine.alpha * mean_hop * count
        else:
            t_s = machine.alpha * log_p * count
        t_v = machine.beta * words
        by_prim[prim] = t_s + t_v
        startup += t_s
        volume += t_v
    return {"total_s": startup + volume, "by_prim": by_prim,
            "startup_s": startup, "volume_s": volume}


def predict_stage(footprint: dict, plan, machine,
                  sim: bool = False) -> dict:
    """Stage prediction from a ``MeshPlan`` (hop sizes + p) — the form
    the resume-loop instrumentation uses. ``sim`` divides the recorded
    bytes by p, the reference's simshard normalization (see module
    doc); the port's footprints are per-PE already on both transports,
    so it prices every stage as the reference prices a mesh stage."""
    return predict_footprint(
        footprint, plan.p, hop_sizes_of(plan), machine,
        per_pe_scale=(1.0 / plan.p) if sim else 1.0)


def predict_solve(n: int, plan, machine,
                  r_total: int | None = None) -> float:
    """Whole-solve §2.6 prediction (``analysis.t_hops`` over the plan's
    actual hop decomposition) — annotated on the root solve span for a
    coarse end-to-end residual alongside the per-stage ones."""
    # lazy: repro_torch.obs must stay importable from anywhere in the
    # core without triggering the listrank package init
    # (fault_tolerance -> obs -> listrank -> resume -> fault_tolerance
    # would cycle)
    from repro_torch.core.listrank import analysis
    hop_sizes = hop_sizes_of(plan)
    machines = tuple(machine for _ in hop_sizes)
    if r_total is None:
        r_total = analysis.r_star(n, plan.p, max(len(hop_sizes), 1), machine)
    return analysis.t_hops(n, plan.p, max(r_total, 1), hop_sizes, machines)


# --------------------------------------------------------------------------
# measured-vs-modeled destination skew (telemetry plane)
# --------------------------------------------------------------------------

def skew_rows(hop_sizes, stage_records) -> list[dict]:
    """Measured-vs-modeled per-hop destination skew.

    The §2 capacity derivation models destinations as uniform: the
    hottest bucket of a hop with peer-group size ``s`` carries a
    ``1/s`` traffic fraction in expectation. The telemetry plane
    measures the worst ``dest_frac_max`` each hop actually saw — the
    ratio is the skew factor the capacity slack has to absorb, the
    residual-table counterpart for *capacities* instead of seconds.

    ``stage_records`` accepts both :class:`~repro_torch.obs.telemetry.
    StageRecord` objects and their ``to_json`` dicts (the
    ``host_stats["telemetry"]["stages"]`` form).
    """
    from repro_torch.obs import telemetry as tele_lib
    observed: dict[int, float] = {}
    for rec in stage_records:
        tele = rec.get("tele", {}) if isinstance(rec, dict) else rec.tele
        for fam in tele_lib.STAGE_FAMILIES:
            t = tele.get(fam)
            if not t or not int(t.get("rounds", 0)):
                continue
            for hop, frac in enumerate(t.get("dest_frac_max", [])):
                observed[hop] = max(observed.get(hop, 0.0), float(frac))
    rows = []
    for hop, s in enumerate(hop_sizes):
        modeled = 1.0 / max(int(s), 1)
        obs = observed.get(hop, 0.0)
        rows.append({"hop": hop, "hop_size": int(s),
                     "modeled_frac": modeled, "observed_frac": obs,
                     "skew": obs / modeled})
    return rows


def format_skew_table(rows, title: str | None = None) -> str:
    """Aligned text rendering of the per-hop skew rows."""
    header = ("hop", "size", "modeled", "observed", "skew")
    body = [(str(r["hop"]), str(r["hop_size"]),
             f"{r['modeled_frac']:.4f}", f"{r['observed_frac']:.4f}",
             f"{r['skew']:.2f}x") for r in rows]
    widths = [max(len(header[i]), *(len(b[i]) for b in body))
              if body else len(header[i]) for i in range(len(header))]
    lines = [] if title is None else [title]
    lines.append("  ".join(h.rjust(w) for h, w in zip(header, widths)))
    lines.append("  ".join("-" * w for w in widths))
    lines += ["  ".join(c.rjust(w) for c, w in zip(row, widths))
              for row in body]
    if not body:
        lines.append("(no telemetry recorded)")
    return "\n".join(lines)


def footprint_summary(footprint: dict) -> dict:
    """JSON-safe ``{prim: {"count": int, "bytes": int}}`` for span args."""
    return {prim: {"count": int(c), "bytes": int(b)}
            for prim, (c, b) in sorted(footprint.items())}


def total_collectives(footprint: dict) -> tuple[int, int]:
    """(total collective count, total payload bytes) of a footprint."""
    count = sum(int(c) for c, _ in footprint.values())
    nbytes = sum(int(b) for _, b in footprint.values())
    return count, nbytes


__all__ = ["DENSE_HOP_PRIMS", "hop_sizes_of", "predict_footprint",
           "predict_stage", "predict_solve", "footprint_summary",
           "total_collectives", "skew_rows", "format_skew_table"]
