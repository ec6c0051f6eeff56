"""Host-side span tracing for the solve path (the flight recorder).

The port's copy of the JAX package's ``repro.obs.trace``. A
:class:`Tracer` records a tree of :class:`Span`\\ s — one per stage
execution, attempt, checkpoint save/restore, capacity-estimation
pre-pass, or front-door pipeline — with wall timings bounded by the
driver's existing device synchronisations (``torch.cuda.synchronize``
on the card). Spans carry arbitrary JSON-safe annotations (recursion
level, attempt number, the active
:class:`~repro_torch.core.listrank.tuner.CapacityScales`, the stage's
run-time collective footprint, and the §2.6 predicted time).

The cardinal rule: **instrumentation never perturbs a solve.** The
tracer is pure host python; it never touches a device tensor and adds
no collective — a solve with tracing on reproduces the tracer-off
bytes, counters and per-stage collective counts exactly (pinned in
``tests/test_torch_obs.py``).

When tracing is off, every instrumentation site goes through
:data:`NULL_TRACER`, whose ``span``/``begin`` return one shared
:data:`NULL_SPAN` singleton — no Span objects are allocated, no clock
is read (also pinned by test).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Iterator


@dataclasses.dataclass
class Span:
    """One recorded interval. Times are ``perf_counter`` seconds
    relative to the tracer's epoch; ``t1 is None`` while open."""
    name: str
    cat: str
    index: int                 #: creation order (stable tie-break)
    parent: int                #: index of the enclosing span, -1 at root
    depth: int                 #: nesting depth at open time
    t0: float
    t1: float | None = None
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def annotate(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    # context-manager protocol is provided by the tracer-bound handle;
    # a bare Span is just the record.


class _SpanHandle:
    """A live span bound to its tracer — usable as a context manager
    (``with tracer.span(...) as sp``) or via explicit
    ``tracer.end(handle)``."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def annotate(self, **kw) -> "_SpanHandle":
        self.span.args.update(kw)
        return self

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and "outcome" not in self.span.args:
            self.span.args["outcome"] = exc_type.__name__
        self._tracer.end(self)
        return False


class _NullSpan:
    """The shared do-nothing span handle of :data:`NULL_TRACER`."""

    __slots__ = ()

    def annotate(self, **kw) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every operation is a no-op returning the shared
    :data:`NULL_SPAN`. ``enabled`` gates any instrumentation work with
    a measurable cost (collective footprints, registry updates).
    """

    enabled = False
    spans: tuple = ()
    counters: tuple = ()
    metrics = None

    def span(self, name: str, cat: str = "host", **args):
        return NULL_SPAN

    def begin(self, name: str, cat: str = "host", **args):
        return NULL_SPAN

    def end(self, handle, **args) -> None:
        pass

    def instant(self, name: str, cat: str = "host", **args) -> None:
        pass

    def counter(self, name: str, value, t: float | None = None) -> None:
        pass


NULL_TRACER = NullTracer()


def ensure(tracer) -> "Tracer | NullTracer":
    """Normalize an optional tracer argument: None -> the no-op
    singleton, anything else passed through."""
    return NULL_TRACER if tracer is None else tracer


class Tracer:
    """The recording tracer.

    ``meta`` rides into the Chrome-trace export as process metadata;
    ``metrics`` is an optional
    :class:`~repro_torch.obs.metrics.MetricsRegistry` the instrumented
    drivers feed (one is created lazily on first use if not supplied).
    """

    enabled = True

    def __init__(self, meta: dict | None = None, metrics=None,
                 clock=time.perf_counter):
        self.meta = dict(meta or {})
        self._clock = clock
        self.epoch = clock()
        #: wall-clock time of the epoch (for trend records / trace meta)
        self.epoch_unix = time.time()
        self.spans: list[Span] = []
        self.instants: list[Span] = []
        #: counter-track samples: (name, t_seconds, float value) — the
        #: telemetry plane's utilization series (Perfetto "C" events).
        self.counters: list[tuple[str, float, float]] = []
        self._stack: list[_SpanHandle] = []
        self._metrics = metrics

    # ------------------------------------------------------------ metrics
    @property
    def metrics(self):
        if self._metrics is None:
            from repro_torch.obs.metrics import MetricsRegistry
            self._metrics = MetricsRegistry()
        return self._metrics

    # -------------------------------------------------------------- spans
    def now(self) -> float:
        return self._clock() - self.epoch

    def begin(self, name: str, cat: str = "host", **args) -> _SpanHandle:
        parent = self._stack[-1].span.index if self._stack else -1
        span = Span(name=name, cat=cat, index=len(self.spans),
                    parent=parent, depth=len(self._stack), t0=self.now(),
                    args=dict(args))
        self.spans.append(span)
        handle = _SpanHandle(self, span)
        self._stack.append(handle)
        return handle

    def end(self, handle: _SpanHandle, **args) -> None:
        if isinstance(handle, _NullSpan):  # tolerate mixed call sites
            return
        handle.span.args.update(args)
        # close any forgotten children so the tree stays well-formed
        while self._stack:
            top = self._stack.pop()
            if top.span.t1 is None:
                top.span.t1 = self.now()
            if top is handle:
                return
        if handle.span.t1 is None:  # already off-stack (double end)
            handle.span.t1 = self.now()

    def span(self, name: str, cat: str = "host", **args) -> _SpanHandle:
        """``with tracer.span("base@2", cat="stage") as sp: ...``"""
        return self.begin(name, cat, **args)

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """A zero-duration event (fault injections, preemptions, ...)."""
        parent = self._stack[-1].span.index if self._stack else -1
        t = self.now()
        self.instants.append(Span(name=name, cat=cat, index=-1,
                                  parent=parent, depth=len(self._stack),
                                  t0=t, t1=t, args=dict(args)))

    def counter(self, name: str, value, t: float | None = None) -> None:
        """Sample a counter track (mailbox utilization, queue HWM) at
        ``t`` (tracer-relative seconds; now() when omitted). Exported
        as Chrome "C" events — one track per name."""
        self.counters.append((name, self.now() if t is None else float(t),
                              float(value)))

    # ------------------------------------------------------------ queries
    def find(self, cat: str | None = None,
             name: str | None = None) -> Iterator[Span]:
        for s in self.spans:
            if cat is not None and s.cat != cat:
                continue
            if name is not None and s.name != name:
                continue
            yield s

    def children(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent == span.index]

    def close_all(self) -> None:
        """Close every span still open (end-of-process safety)."""
        while self._stack:
            self.end(self._stack[-1])


def span_tree_lines(tracer: Tracer) -> list[str]:
    """Human-readable indented rendering of the span tree (debugging)."""
    out = []
    for s in tracer.spans:
        dur = f"{s.duration * 1e3:8.2f}ms" if s.t1 is not None else "    open"
        out.append(f"{'  ' * s.depth}{s.name} [{s.cat}] {dur}")
    return out


def maybe(tracer, cond: bool) -> "Tracer | NullTracer":
    """``tracer`` when ``cond`` else the no-op singleton — lets call
    sites gate nested instrumentation without branching."""
    return tracer if cond else NULL_TRACER


__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER", "NULL_SPAN",
           "ensure", "maybe", "span_tree_lines"]


_ = Any  # typing import kept for annotations above
