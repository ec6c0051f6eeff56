"""Device time from the profiler, checked: the benchmark's frozen copy of
the port's ``repro_torch/devtime.py`` window and its checks, and the
``mailbox_pack`` byte and bound arithmetic, with the readings of a
whole call that the benchmark adds (busy seconds as the union of device
intervals, idle gaps named by what the host was doing).

A window that missed launches reads nothing: :func:`window` absorbs the
activities the profiler loses at a window's start with primer launches,
:func:`complete` needs every counted kernel launch, and
:func:`repeat_check` needs another window with as many device events
and none with more.
"""
from __future__ import annotations

import json
import pathlib
import tempfile
import time
from typing import Callable, Iterable

#: NVIDIA H100 SXM data-sheet memory rate, at the full 700 W limit
HBM_BYTES_PER_S = 3.35e12

#: the Chrome trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")

#: launches a window makes before the call it measures: the profiler on
#: the H100 loses the first activities of a window
PRIMER_LAUNCHES = 64
#: the annotation that spans the measured call inside a window
SPAN = "perfbench.window"


def bound_ms(nbytes: float) -> float:
    """Least ms to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def pack_bytes(p: int, w: int, n_rows: int, shipping: int) -> int:
    """Bytes ``mailbox_pack`` must move for one hop: the (p, w, n_rows)
    int32 send buffer written once, and each of the ``shipping``
    messages' w - 1 payload words and its int64 index into the bucket
    sort's order read once."""
    return 4 * p * w * n_rows + shipping * (4 * (w - 1) + 8)


def kernel_counts(events: Iterable[dict],
                  names: Iterable[str]) -> dict[str, int]:
    """How many of ``events`` carry each of ``names`` in their name."""
    names = tuple(names)
    counts = dict.fromkeys(names, 0)
    for e in events:
        for k in names:
            if k in e["name"]:
                counts[k] += 1
    return counts


def device_us(events: Iterable[dict], name: str = "") -> float:
    """Summed microseconds of the ``events`` whose name holds ``name``."""
    return sum(float(e["dur"]) for e in events if name in e["name"])


def per_name(events: Iterable[dict]) -> dict[str, tuple[int, float]]:
    """{event name: (count, summed microseconds)} of ``events``."""
    out: dict = {}
    for e in events:
        count, us = out.get(e["name"], (0, 0.0))
        out[e["name"]] = (count + 1, us + float(e["dur"]))
    return out


def complete(events, expect_total: dict[str, int]) -> bool:
    """True when every kernel of ``expect_total`` ({name: launches})
    appears exactly that many times among ``events``."""
    return kernel_counts(events, expect_total) == dict(expect_total)


def trace_events(prof, cats) -> list[dict]:
    """The complete events of ``cats`` of a finished profiler, read from
    its Chrome trace, written to a temporary file and removed."""
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in cats]


def window(fn: Callable, torch, device):
    """(``fn()``'s result, the window's device events inside the call,
    the host's ``cpu_op`` events inside it, (start, end) of the call in
    trace microseconds, wall seconds): one profiler window of the CPU
    and CUDA, :data:`PRIMER_LAUNCHES` small launches and then one call
    of ``fn`` from an idle device to its end, spanned by :data:`SPAN`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize(device)
    primer = torch.zeros(1, device=device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            primer.add_(1)
        torch.cuda.synchronize(device)
        with record_function(SPAN):
            t = time.perf_counter()
            result = fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t
    events = trace_events(prof, DEVICE_CATS + ("user_annotation", "cpu_op"))
    (start, end), = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e["name"] == SPAN
                     and e["cat"] == "user_annotation"]

    def inside(e):
        return start <= float(e["ts"]) <= end

    device_ev = [e for e in events if e["cat"] in DEVICE_CATS and inside(e)]
    host_ev = [e for e in events if e["cat"] == "cpu_op" and inside(e)]
    return result, device_ev, host_ev, (start, end), wall


def repeat_check(check: Callable) -> Callable:
    """``check`` (None when a window's device events hold what they
    must, else why not), and also that the window holds as many device
    events as another window that passed it and no fewer than any: a
    call's device events are the same from one call to the next, and a
    window that dropped events no name counts holds fewer."""
    seen: list[int] = []

    def both(events):
        missed = check(events)
        if missed is not None:
            return missed
        seen.append(len(events))
        if len(events) < max(seen):
            return f"{len(events)} device events, another window {max(seen)}"
        if seen.count(len(events)) < 2:
            return (f"{len(events)} device events, no other window with as "
                    f"many yet")
        return None
    return both


def busy_intervals(events) -> list[tuple[float, float]]:
    """The union of the device events' intervals (microseconds), in
    order: a kernel on one stream and a copy on another count once."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events)
    merged: list[list[float]] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(busy, host_events, span, top: int = 10):
    """The ``top`` longest stretches of the call ``span`` (start, end in
    microseconds) in which the device ran nothing, each named by the
    host operation that overlapped it most: [[name, seconds], ...]."""
    start, end = span
    edges = [start] + [x for ab in busy for x in ab] + [end]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in host_events))
    out = []
    for a, b in gaps[:top]:
        best, name = 0.0, "host, no operation traced"
        for s, t, op in host:
            if s >= b:
                break
            over = min(t, b) - max(s, a)
            if over > best:
                best, name = over, op
        out.append([name, (b - a) / 1e6])
    return out


class PackRecorder:
    """Records every ``mailbox_pack`` launch of a call (the port's
    ``kernels/mailbox_pack/ops.py`` wrapper, patched while the recorder
    is entered) and the bytes it must move, each hop's shipping count
    summed on the device without a host sync. ``launches`` is the
    wrapper's own launch count over the call."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        from repro_torch.kernels.mailbox_pack import ops, ref
        self.ops, self.ref = ops, ref
        self.pack = ops.mailbox_pack
        self.reset()
        ops.mailbox_pack = self._recording
        return self

    def __exit__(self, *exc):
        self.ops.mailbox_pack = self.pack
        return False

    def reset(self):
        self.fixed, self.shipping = 0, []
        self.before = self.ops.LAUNCHES

    def _recording(self, cols, order, skey, n_buckets, cap):
        cols = list(cols)
        w = len(cols) + 1
        self.fixed += pack_bytes(skey.shape[0], w, n_buckets * cap, 0)
        self.shipping.append(self.torch.clamp(
            self.ref.bucket_runs(skey, n_buckets)[1], max=cap).sum()
            * (4 * (w - 1) + 8))
        return self.pack(cols, order, skey, n_buckets, cap)

    @property
    def launches(self) -> int:
        return self.ops.LAUNCHES - self.before

    def bound_ms(self) -> float:
        return bound_ms(self.fixed + sum(int(x) for x in self.shipping))
