"""Exporters: Chrome-trace JSON (Perfetto-loadable) and the residual
table — the port's copy of the JAX package's ``repro.obs.export``.

``chrome_trace`` serializes a :class:`~repro_torch.obs.trace.Tracer` into the
Chrome trace-event format (the JSON array-of-events "traceEvents" form
that chrome://tracing and https://ui.perfetto.dev load directly):

- every span -> one complete ("ph": "X") event, microsecond ``ts``
  relative to the tracer epoch, ``dur`` from the device-sync-bounded
  wall time, ``cat`` from the span taxonomy (DESIGN.md §12), and the
  span's annotations (level, attempt, scales, collective footprint,
  predicted time) under ``args``;
- every instant (fault injections, preemptions, escalations) -> an
  "i" event with thread scope — the recovery timeline;
- tracer ``meta`` -> process_name / metadata events.

``residual_rows`` / ``format_residual_table`` turn the same spans into
the §2.6 model-vs-measured artifact: one row per stage attempt with
measured wall seconds, predicted seconds, the residual, and the
counted collective footprint.
"""
from __future__ import annotations

import json

from repro_torch.obs.metrics import json_safe

_US = 1e6


def chrome_trace(tracer, pid: int = 0) -> dict:
    """The trace as a Chrome trace-event dict (``json.dump``-ready).

    Tolerates a :class:`~repro_torch.obs.trace.NullTracer` (or any tracer
    missing attributes): the result is a minimal but valid trace —
    exporters must never take down a solve."""
    meta = getattr(tracer, "meta", None) or {}
    spans = getattr(tracer, "spans", ()) or ()
    instants = getattr(tracer, "instants", ()) or ()
    events = [{
        "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
        "args": {"name": meta.get("name", "repro-solve")},
    }]
    if meta:
        events.append({"ph": "M", "name": "process_labels", "pid": pid,
                       "tid": 0,
                       "args": {"labels": json.dumps(json_safe(meta))}})
    end_fallback = max((s.t1 for s in spans if s.t1 is not None),
                       default=0.0)
    for s in spans:
        t1 = s.t1 if s.t1 is not None else end_fallback
        events.append({
            "ph": "X", "name": s.name, "cat": s.cat, "pid": pid,
            "tid": s.depth,
            "ts": round(s.t0 * _US, 3),
            "dur": round(max(t1 - s.t0, 0.0) * _US, 3),
            "args": json_safe(s.args),
        })
    for s in instants:
        events.append({
            "ph": "i", "name": s.name, "cat": s.cat, "pid": pid,
            "tid": s.depth, "s": "t",
            "ts": round(s.t0 * _US, 3),
            "args": json_safe(s.args),
        })
    # counter tracks (telemetry utilization / queue HWM series); sorted
    # by time so each track's series is monotone in ts regardless of
    # which driver emitted the sample.
    for name, t, value in sorted(getattr(tracer, "counters", ()) or (),
                                 key=lambda c: c[1]):
        events.append({
            "ph": "C", "name": name, "cat": "telemetry", "pid": pid,
            "tid": 0,
            "ts": round(t * _US, 3),
            "args": {"value": float(value)},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"epoch_unix": getattr(tracer, "epoch_unix", 0.0),
                          **json_safe(meta)}}


def write_chrome_trace(tracer, path: str, pid: int = 0) -> str:
    """Write the Chrome trace JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, pid=pid), f, indent=1)
    return path


# --------------------------------------------------------------------------
# model-vs-measured residuals
# --------------------------------------------------------------------------

def residual_rows(tracer) -> list[dict]:
    """One row per span carrying a §2.6 prediction (stage attempts and
    front-door pipeline attempts), in execution order."""
    rows = []
    for s in tracer.spans:
        if "predicted_s" not in s.args or s.t1 is None:
            continue
        measured = s.duration
        predicted = float(s.args["predicted_s"])
        rows.append({
            "stage": s.args.get("stage", s.name),
            "level": s.args.get("level", -1),
            "attempt": s.args.get("attempt", 1),
            "measured_s": measured,
            "predicted_s": predicted,
            "residual_s": measured - predicted,
            "ratio": (measured / predicted) if predicted > 0 else float("inf"),
            "collectives": s.args.get("collective_count", 0),
            "payload_bytes": s.args.get("payload_bytes", 0),
        })
    return rows


def format_residual_table(rows: list[dict], title: str | None = None) -> str:
    """Aligned text rendering of the per-stage residual table."""
    header = ("stage", "lvl", "try", "measured", "predicted", "residual",
              "ratio", "colls", "bytes")
    body = []
    for r in rows:
        body.append((
            str(r["stage"]), str(r["level"]), str(r["attempt"]),
            _fmt_s(r["measured_s"]), _fmt_s(r["predicted_s"]),
            _fmt_s(r["residual_s"]),
            ("inf" if r["ratio"] == float("inf") else f"{r['ratio']:.1f}x"),
            str(r["collectives"]), str(r["payload_bytes"])))
    widths = [max(len(header[i]), *(len(row[i]) for row in body))
              if body else len(header[i]) for i in range(len(header))]
    lines = [] if title is None else [title]
    lines.append("  ".join(h.ljust(w) for h, w in zip(header, widths)))
    lines.append("  ".join("-" * w for w in widths))
    for row in body:
        lines.append("  ".join(c.ljust(w) for c, w in zip(row, widths)))
    if not body:
        lines.append("(no predicted spans recorded)")
    return "\n".join(lines)


def _fmt_s(v: float) -> str:
    a = abs(v)
    if a >= 1.0:
        return f"{v:.3f}s"
    if a >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def residual_summary(rows: list[dict]) -> dict:
    """Headline numbers for trend records: totals and the worst
    per-stage over/under-prediction ratio."""
    if not rows:
        return {"stages": 0, "measured_s": 0.0, "predicted_s": 0.0}
    measured = sum(r["measured_s"] for r in rows)
    predicted = sum(r["predicted_s"] for r in rows)
    finite = [r["ratio"] for r in rows if r["ratio"] != float("inf")]
    return {
        "stages": len(rows),
        "measured_s": measured,
        "predicted_s": predicted,
        "total_ratio": (measured / predicted) if predicted > 0 else None,
        "max_ratio": max(finite) if finite else None,
        "min_ratio": min(finite) if finite else None,
    }


__all__ = ["chrome_trace", "write_chrome_trace", "residual_rows",
           "format_residual_table", "residual_summary"]
