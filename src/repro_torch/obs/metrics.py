"""Unified metrics registry: the typed schema behind ``host_stats``.

The port's copy of the JAX package's ``repro.obs.metrics``.

The solver's host-facing counters historically rode in ad-hoc dicts
(``host_stats`` from the resume driver, ``rec``/``recovery`` from the
supervisor, graphalg's ``cc_*`` keys, bench JSON blobs). This module
gives them one schema — :class:`Counter` / :class:`Gauge` /
:class:`Histogram` / :class:`Text` in a :class:`MetricsRegistry` — plus
``ingest_host_stats`` to lift any solver stats dict into it, with help
strings sourced from the owning modules (``srs.STAT_HELP``,
``graphalg.cc.GRAPH_STAT_HELP``, ``telemetry.TELEMETRY_HELP``).

Also home to :func:`json_safe` — the canonical "make this stats value
JSON-serializable" conversion used by the bench workers and the
Chrome-trace exporter (host_stats now carries tuples and nested dicts,
which ``int()``-casting bench code used to choke on).
"""
from __future__ import annotations

import dataclasses
import math

import torch


# --------------------------------------------------------------------------
# metric types
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Counter:
    """Monotone event count (messages sent, rounds run, retries)."""
    name: str
    help: str = ""
    value: int = 0

    kind = "counter"

    def inc(self, v: int = 1) -> "Counter":
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self.value += int(v)
        return self

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help, "value": self.value}


@dataclasses.dataclass
class Gauge:
    """Last-observed level (max queue depth, resume index, scale)."""
    name: str
    help: str = ""
    value: float = 0.0

    kind = "gauge"

    def set(self, v: float) -> "Gauge":
        self.value = float(v)
        return self

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help, "value": self.value}


@dataclasses.dataclass
class Histogram:
    """Streaming distribution summary (stage wall times, residuals).

    Keeps count/sum/min/max — enough for means and extremes without
    unbounded storage; the full per-span series lives in the trace.
    """
    name: str
    help: str = ""
    count: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    kind = "histogram"

    def observe(self, v: float) -> "Histogram":
        v = float(v)
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        return self

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help, "count": self.count,
                "sum": self.total, "mean": self.mean,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max}


@dataclasses.dataclass
class Text:
    """Non-numeric annotation (escalation path, stage log)."""
    name: str
    help: str = ""
    value: str = ""

    kind = "text"

    def set(self, v: str) -> "Text":
        self.value = str(v)
        return self

    def snapshot(self) -> dict:
        return {"kind": self.kind, "help": self.help, "value": self.value}


class MetricsRegistry:
    """Name -> typed metric, get-or-create per kind. Re-registering a
    name with a different kind is an error (the schema is the point)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name=name, help=help)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not "
                            f"{cls.kind}")
        elif help and not m.help:
            m.help = help
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def text(self, name: str, help: str = "") -> Text:
        return self._get(Text, name, help)

    def get(self, name: str):
        return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self):
        return iter(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def to_dict(self) -> dict:
        """The full registry as a JSON-safe ``{name: snapshot}`` dict."""
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}


# --------------------------------------------------------------------------
# host_stats ingestion
# --------------------------------------------------------------------------

#: host_stats keys that are levels, not event counts.
GAUGE_KEYS = ("max_queue", "sub_size", "rulers", "forest_edges")


def _stat_help() -> dict:
    """Help strings from the modules that own the stat keys (lazy to
    keep obs import-light and cycle-free)."""
    out: dict[str, str] = {}
    try:
        from repro_torch.core.listrank import srs as srs_lib
        out.update(getattr(srs_lib, "STAT_HELP", {}))
    except Exception:  # pragma: no cover - core always importable
        pass
    try:
        from repro_torch.core.graphalg import cc as cc_lib
        out.update(getattr(cc_lib, "GRAPH_STAT_HELP", {}))
    except Exception:  # pragma: no cover
        pass
    try:
        from repro_torch.obs import telemetry as tele_lib
        out.update(getattr(tele_lib, "TELEMETRY_HELP", {}))
    except Exception:  # pragma: no cover
        pass
    return out


def ingest_host_stats(registry: MetricsRegistry, stats: dict,
                      prefix: str = "solve/") -> MetricsRegistry:
    """Lift a solver ``host_stats`` dict into the typed registry.

    Ints become counters (or gauges for :data:`GAUGE_KEYS`), strings
    become text metrics, ``stage_log`` becomes a stages-run counter plus
    its text form, and the ``recovery`` sub-dict maps to
    ``recovery/<key>`` counters/gauges with the injected-event list as
    text. Unknown shapes fall back to text via :func:`json_safe` —
    ingestion never raises on a new stat key.
    """
    import json
    help_of = _stat_help()
    for key, val in stats.items():
        name = prefix + key
        h = help_of.get(key, "")
        if key == "stage_log":
            registry.counter(prefix + "stages_run",
                             "stage executions recorded in stage_log"
                             ).inc(len(val))
            registry.text(name, h).set(";".join(val))
        elif key == "stage_collectives":
            registry.counter(prefix + "stage_collectives_recorded",
                             "stages with traced collective counts"
                             ).inc(len(val))
        elif key == "telemetry":
            # the device-telemetry sub-dict (stage records + headroom
            # report) -> utilization histograms and worst-fill gauges;
            # the full report stays in host_stats / the trace.
            stages = val.get("stages", []) if isinstance(val, dict) else []
            registry.counter(prefix + "telemetry/stages",
                             "stage records carrying device telemetry"
                             ).inc(len(stages))
            for rec in stages:
                registry.histogram(prefix + "telemetry/stage_util_max",
                                   help_of.get("util_max", "")
                                   ).observe(float(rec.get("util_max", 0.0)))
                registry.histogram(prefix + "telemetry/stage_util_mean",
                                   help_of.get("util_mean", "")
                                   ).observe(float(rec.get("util_mean", 0.0)))
            rows = val.get("headroom", []) if isinstance(val, dict) else []
            if rows:
                registry.gauge(prefix + "telemetry/worst_fill",
                               help_of.get("fill_max", "")
                               ).set(max(float(r.get("fill_max", 0.0))
                                         for r in rows))
            dkw = val.get("dkw", []) if isinstance(val, dict) else []
            if dkw:
                registry.counter(
                    prefix + "telemetry/dkw_violations",
                    "hops whose observed skew exceeded the DKW bound"
                    ).inc(sum(1 for r in dkw if not r.get("ok", True)))
        elif key == "recovery":
            for rk, rv in val.items():
                rname = prefix + "recovery/" + rk
                if rk == "resumed_from":
                    registry.gauge(rname,
                                   "schedule index restored from (-1: fresh)"
                                   ).set(rv)
                elif isinstance(rv, (bool, int)):
                    registry.counter(rname).inc(int(rv))
                else:
                    registry.text(rname).set(json.dumps(json_safe(rv)))
        elif isinstance(val, bool):
            registry.counter(name, h).inc(int(val))
        elif isinstance(val, int):
            if key in GAUGE_KEYS:
                registry.gauge(name, h).set(val)
            else:
                registry.counter(name, h).inc(val)
        elif isinstance(val, float):
            registry.gauge(name, h).set(val)
        elif isinstance(val, str):
            registry.text(name, h).set(val)
        else:
            registry.text(name, h).set(json.dumps(json_safe(val)))
    return registry


# --------------------------------------------------------------------------
# JSON-safe conversion
# --------------------------------------------------------------------------

def json_safe(obj):
    """Recursively convert a stats/annotation value to plain JSON types.

    Handles numpy scalars/arrays, torch tensors (copied to the host; a
    one-element tensor becomes its scalar, as a one-element numpy array
    does), torch dtypes (their name, ``"float32"``), tuples, dataclasses
    (``CapacityScales`` in span args), and nested dicts. Unknown leaves
    degrade to ``repr`` rather than raising — exporters must never take
    down a solve.
    """
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu()
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return json_safe(dataclasses.asdict(obj))
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            v = item()
            if isinstance(v, (bool, int, float, str)):
                return v
        except Exception:
            pass
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        try:
            return json_safe(tolist())
        except Exception:
            pass
    return repr(obj)


def json_safe_stats(stats: dict) -> dict:
    """``host_stats`` -> a JSON-serializable dict (bench workers)."""
    return {str(k): json_safe(v) for k, v in stats.items()}


__all__ = ["Counter", "Gauge", "Histogram", "Text", "MetricsRegistry",
           "GAUGE_KEYS", "ingest_host_stats", "json_safe",
           "json_safe_stats"]
