"""Device time on the card, checked, and the bounds it is held against.

Every device time of the port's scripts comes from here, and none trusts
what it did not see:

- :func:`window` runs a callable once under a ``torch.profiler`` window
  that traces the CPU and CUDA, after launches that absorb the
  activities the profiler loses at a window's start, and reads the
  call's device events (kernels, fills, copies) from its Chrome trace
  (:func:`trace_events`, the one reader);
- :func:`checked_window` repeats windows until one passes a check, and
  reports none when none did: on the H100 single windows came back
  empty or with half the calls;
- :func:`count_window` is the check of ``reps`` calls of one wrapper:
  every expected kernel (:data:`EXPECT`) exactly ``reps`` times its
  launches per call and the window's events split evenly over the calls,
  otherwise the time is not measured (``None``), never a mean over the
  calls the profiler happened to catch; :func:`profiled_ms` applies it;
- :func:`repeat_check` adds to a check that another window passed it
  with as many device events and none with more, which covers the
  events no name counts
  (fills, copies, library kernels) in windows of a whole call;
  :func:`kernel_times_over` reads the two list-ranking kernels and the
  device's busy share over one call of a path through it;
- :func:`queued_ms` times ``reps`` calls with CUDA events after a device
  sleep long enough for the host to enqueue all of them, so the events
  bracket device work with no host gap; if the device reached the start
  event before the last call was enqueued, the time is not measured.
"""
from __future__ import annotations

import pathlib
import time
from typing import Callable, Iterable

#: NVIDIA H100 SXM data-sheet peaks (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

#: device kernels (name substrings) each wrapper call launches
EXPECT = {
    "local_chase": {"chase_persistent_kernel": 1},
    "mailbox_pack": {"mailbox_pack_kernel": 1},
    "flash_attention_prefill_bf16": {"flash_fwd_mma_kernel": 1},
    "flash_attention_decode_bf16": {"flash_decode_split_kernel": 1,
                                    "flash_decode_merge_kernel": 1},
    "flash_attention_f32": {"flash_fwd_kernel": 1},
    "ssd_scan_bf16": {"ssd_cb_kernel": 1, "ssd_state_kernel": 1,
                      "ssd_pass_kernel": 1, "ssd_chunk_scan_kernel": 1},
    "ssd_scan_f32": {"ssd_scan_kernel": 1},
}

#: the Chrome trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def bound_ms(nbytes: float, nops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """(least ms, what bounds it) of moving ``nbytes`` at the card's
    memory rate and doing ``nops`` at ``ops_per_s``: the larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pack_bytes(p: int, w: int, n_rows: int, shipping: int) -> int:
    """Bytes ``mailbox_pack`` must move for one hop: the (p, w, n_rows)
    int32 send buffer written once, and each of the ``shipping`` messages'
    w - 1 payload words and its int64 index into the bucket sort's order
    read once."""
    return 4 * p * w * n_rows + shipping * (4 * (w - 1) + 8)


def kernel_counts(events: Iterable[dict],
                  names: Iterable[str]) -> dict[str, int]:
    """How many of ``events`` (trace events: ``name``, ``dur`` in
    microseconds) carry each of ``names`` in their name."""
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


def count_window(events, expect: dict[str, int], reps: int):
    """(ms per call or None, counts seen) of a profiler window of ``reps``
    calls: ``events`` are every device event of the window, ``expect``
    the launches of each named kernel per call. The time is the window's
    summed device time over ``reps`` (fills and copies a call makes
    included); ``None`` unless the named kernels appear exactly ``reps``
    x ``expect`` times and the window's event count is a multiple of
    ``reps``."""
    events = list(events)
    counts = kernel_counts(events, expect)
    ok = (reps > 0 and len(events) > 0 and len(events) % reps == 0
          and complete(events, {k: reps * v for k, v in expect.items()}))
    if not ok:
        return None, counts
    return device_us(events) / reps / 1e3, counts


def trace_events(prof, cats=DEVICE_CATS) -> list[dict]:
    """The complete events of ``cats`` (by default the device's: kernels,
    fills, copies) of a finished ``torch.profiler.profile``, read from its
    Chrome trace, written to a temporary directory in this package's
    directory and removed."""
    import json
    import tempfile
    here = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=here) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in cats]


#: launches a window makes before the call it measures: the profiler on
#: the H100 loses the first activities of a window (the first three of a
#: whole call, most of a short one after large windows)
PRIMER_LAUNCHES = 64
#: the annotation that spans the measured call inside a window
SPAN = "devtime.window"


def window(fn: Callable, torch, cats=DEVICE_CATS):
    """(``fn()``'s result, the window's events of ``cats`` that start
    inside the call, wall seconds): one profiler window, tracing the CPU
    and CUDA, of :data:`PRIMER_LAUNCHES` small launches and then one call
    of ``fn`` from an idle device to its end, spanned by :data:`SPAN`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    primer = torch.zeros(1, device=torch.device(
        "cuda", torch.cuda.current_device()))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PRIMER_LAUNCHES):
            primer.add_(1)
        torch.cuda.synchronize()
        with record_function(SPAN):
            t = time.perf_counter()
            result = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    events = trace_events(prof, cats=tuple(cats) + ("user_annotation",))
    # the span's CPU range (a window that also reads GPU annotations
    # holds its GPU-side copy too)
    (start, end), = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                     for e in events if e["name"] == SPAN
                     and e["cat"] == "user_annotation"]
    return result, [e for e in events if e["cat"] in cats
                    and e["name"] != SPAN
                    and start <= float(e["ts"]) <= end], wall


def checked_window(run: Callable, check: Callable, windows: int = 5,
                   log: Callable[[str], None] = print):
    """(result, events, wall) of the first of up to ``windows`` calls of
    ``run()`` (each returns such a triple, as :func:`window` does) whose
    events pass ``check``: ``check(events)`` is None when the window
    holds what it must, else why not, which is logged. When no
    window passed, events is None (result and wall are the last
    window's)."""
    result = wall = None
    for w in range(windows):
        result, events, wall = run()
        missed = check(events)
        if missed is None:
            return result, events, wall
        log(f"  (profiler window {w + 1} of {windows} not read: {missed})")
    return result, None, wall


def repeat_check(check: Callable) -> Callable:
    """``check`` (see :func:`checked_window`), and also that the window
    holds as many device events as another window that passed it and
    no fewer than any: a call's device events are the same from one call
    to the next, and a window that dropped events no name counts holds
    fewer."""
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


def profiled_ms(fn: Callable, torch, expect: dict[str, int], reps: int = 10,
                windows: int = 5, log: Callable[[str], None] = print):
    """(device ms of one call of ``fn``, the window's events) from the
    first of up to ``windows`` windows of ``reps`` calls that
    :func:`count_window` accepts; (None, None) when none did."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    def check(events):
        ms, counts = count_window(events, expect, reps)
        if ms is not None:
            return None
        want = {k: reps * v for k, v in expect.items()}
        return (f"{len(events)} device events for {reps} calls, kernels "
                f"seen {counts}, expected {want}")

    _, events, _ = checked_window(lambda: window(calls, torch), check,
                                  windows, log)
    if events is None:
        return None, None
    return count_window(events, expect, reps)[0], events


def kernel_times_over(call: Callable, torch, windows: int = 3,
                      log: Callable[[str], None] = print):
    """``mailbox_pack`` and ``local_chase`` over one call of ``call`` (a
    path's front door, kernels on), under the profiler with every
    launch's shapes recorded without a host sync: the launches, their
    summed bounds (:func:`pack_bytes` per hop with its own shipping
    count; 16 bytes and one add per element per step run for
    ``local_chase``), their device time, and the call's device busy time
    and idle share under the profiler. The device numbers are None
    (not measured) unless a window holds every launch the wrappers
    counted, and another did too with as many device events and none
    with more (:func:`repeat_check`). Returns (that dict, the accepted window's
    events or None, the call's result)."""
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops, ref as mp_ref
    pack, chase = mp_ops.mailbox_pack, lc_ops.local_chase
    rec: dict = {}

    def recording_pack(cols, order, skey, n_buckets, cap):
        cols = list(cols)
        w = len(cols) + 1
        rec["fixed"] += pack_bytes(skey.shape[0], w, n_buckets * cap, 0)
        rec["shipping"].append(torch.clamp(
            mp_ref.bucket_runs(skey, n_buckets)[1], max=cap).sum()
            * (4 * (w - 1) + 8))
        return pack(cols, order, skey, n_buckets, cap)

    def recording_chase(succ, dist, steps):
        out = chase(succ, dist, steps)
        rec["chase"].append((succ.numel(), lc_ops.STEPS_RUN.max()))
        return out

    def run():
        rec.update(fixed=0, shipping=[], chase=[])
        before = mp_ops.LAUNCHES, lc_ops.LAUNCHES
        out = window(call, torch)
        rec["want"] = {"mailbox_pack_kernel": mp_ops.LAUNCHES - before[0],
                       "chase_persistent_kernel": lc_ops.LAUNCHES - before[1]}
        return out

    def named(events):
        if complete(events, rec["want"]):
            return None
        return (f"kernels seen {kernel_counts(events, rec['want'])} of "
                f"{rec['want']}")

    mp_ops.mailbox_pack, lc_ops.local_chase = recording_pack, recording_chase
    try:
        result, events, wall = checked_window(run, repeat_check(named),
                                              windows, log)
    finally:
        mp_ops.mailbox_pack, lc_ops.local_chase = pack, chase
    pack_b = rec["fixed"] + sum(int(x) for x in rec["shipping"])
    bounds = {"mailbox_pack": bound_ms(pack_b, 0)[0],
              "local_chase": sum(bound_ms(16 * e, int(r) * e)[0]
                                 for e, r in rec["chase"])}
    out = {"bound_ms": bounds, "profiled_wall_s": wall,
           "launches": rec["want"], "device_ms": None, "busy_ms": None,
           "idle_share": None}
    if events is not None:
        busy = device_us(events) / 1e3
        out["device_ms"] = {
            "mailbox_pack": device_us(events, "mailbox_pack_kernel") / 1e3,
            "local_chase": device_us(events, "chase_persistent_kernel") / 1e3}
        out["busy_ms"] = busy
        out["idle_share"] = 1 - busy / 1e3 / wall
    return out, events, result


def queued_ms(fn: Callable, torch, reps: int = 20, clock_hz: float = 2e9):
    """Device ms of one call of ``fn``: CUDA events around ``reps`` calls
    enqueued behind a device sleep that outlasts twice their enqueue
    time (at ``clock_hz`` or slower SM clocks). ``None`` if the device
    reached the first event before the host had enqueued the last call,
    or without ``torch.cuda._sleep``."""
    if not hasattr(torch.cuda, "_sleep"):
        return None
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * clock_hz) + 1_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued else None
