"""The profiler readings and the per-layer readers, on made-up traces."""
from __future__ import annotations

import pytest

from perfbench import devtrace, readers


def ev(name, ts, dur, cat="kernel"):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat, "ph": "X"}


def test_perfbench_busy_is_the_union_of_device_intervals():
    events = [ev("a", 0, 10), ev("b", 5, 10), ev("c", 30, 5),
              ev("nccl", 31, 2, "gpu_memcpy")]
    assert devtrace.busy_intervals(events) == [(0, 15), (30, 35)]


def test_perfbench_idle_gaps_are_named_by_the_host():
    busy = [(10.0, 20.0), (50.0, 60.0)]
    host = [ev("aten::item", 18, 40, "cpu_op"), ev("aten::add", 61, 5,
                                                   "cpu_op")]
    gaps = devtrace.idle_gaps(busy, host, (0.0, 100.0))
    assert gaps == [["aten::add", 40e-6], ["aten::item", 30e-6],
                    ["host, no operation traced", 10e-6]]


def test_perfbench_repeat_check_needs_two_windows_alike():
    check = devtrace.repeat_check(lambda events: None)
    assert check([1, 2, 3]) is not None
    assert check([1, 2]) is not None
    assert check([1, 2, 3]) is None


def test_perfbench_pack_bytes_and_bound():
    assert devtrace.pack_bytes(16, 5, 100, 7) == 4 * 16 * 5 * 100 + 7 * 24
    assert devtrace.bound_ms(3.35e9) == pytest.approx(1.0)


def window(events, wall=1.0, accepted=True, launches=2):
    busy = devtrace.busy_intervals(events)
    return {"events": events, "wall_s": wall, "accepted": accepted,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "launches": {"mailbox_pack_kernel": launches}}


def test_perfbench_readers():
    events = [ev("mailbox_pack_kernel<5>", 0, 400), ev("ncclDevKernel_x", 500,
                                                        100),
              ev("mailbox_pack_kernel<5>", 700, 400)]
    ctx = {"stats": {"stage_wall_s": (("prep", 1.0), ("descend@0", 2.0),
                                      ("descend@1", 0.5), ("post", 1.0)),
                     "rounds": 160},
           "pes": 16, "pack": {"bound_ms": 0.4, "launches": 2},
           "window": window(events, wall=0.01)}
    assert readers.chase_s(ctx) == 2.5
    assert readers.rounds(ctx) == 10
    assert readers.mailbox_pack_roofline(ctx) == pytest.approx(50.0)
    assert readers.nccl_ms(ctx) == pytest.approx(0.1)
    assert readers.idle_share(ctx) == pytest.approx(100 * (1 - 0.0009 / 0.01))
    # nothing to read: None, never 0
    assert readers.mailbox_pack_roofline(dict(ctx, pack={
        "bound_ms": 0.4, "launches": 3})) is None
    assert readers.idle_share(dict(ctx, window=window(
        events, accepted=False))) is None
    assert readers.nccl_ms(dict(ctx, window=window(events[:1]))) is None
    assert readers.chase_s({"stats": {}}) is None
    assert readers.tour_s({}) is None
