"""Observability: span tracing, metrics, and §2.6 cost accounting.

The port's copy of the JAX package's ``repro.obs``: the flight recorder
for the solve path. Pass a :class:`Tracer` to
``rank_list_with_stats(..., tracer=...)`` (or the graphalg/treealg
front doors) and every stage execution, retry, checkpoint, and
capacity-estimation pre-pass is recorded as a span with its measured
wall time, its run-time collective footprint, and the §2.6 predicted
time; export with :func:`~repro_torch.obs.export.write_chrome_trace` and
:func:`~repro_torch.obs.export.format_residual_table`. With
``ListRankConfig(telemetry=True)`` the solve also reports per-stage
mailbox fill and destination skew (:mod:`.telemetry`).

Instrumentation never perturbs a solve: outputs, counters and
per-stage collective counts are the same with it on or off — pinned by
``tests/test_torch_obs.py`` and ``tests/test_torch_telemetry.py``.
"""
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Span, Tracer,
                                   ensure, span_tree_lines)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, Text,
                                     ingest_host_stats, json_safe,
                                     json_safe_stats)
from repro_torch.obs.cost import (footprint_summary, format_skew_table,
                                  predict_footprint, predict_solve,
                                  predict_stage, skew_rows,
                                  total_collectives)
from repro_torch.obs.export import (chrome_trace, format_residual_table,
                                    residual_rows, residual_summary,
                                    write_chrome_trace)
from repro_torch.obs.telemetry import (StageRecord, TELEMETRY_HELP,
                                       dkw_backtest, format_headroom_table,
                                       headroom_rows, utilization)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "ensure",
    "span_tree_lines",
    "Counter", "Gauge", "Histogram", "Text", "MetricsRegistry",
    "ingest_host_stats", "json_safe", "json_safe_stats",
    "predict_footprint", "predict_stage", "predict_solve",
    "footprint_summary", "total_collectives",
    "skew_rows", "format_skew_table",
    "chrome_trace", "write_chrome_trace", "residual_rows",
    "format_residual_table", "residual_summary",
    "StageRecord", "TELEMETRY_HELP", "dkw_backtest",
    "format_headroom_table", "headroom_rows", "utilization",
]
