"""What the per-layer metrics read: the solver's counters and stage
walls, the tracer's spans, and the profiler window of a traced run.

Each ``perfbench/metrics/<name>.py`` is a ``read(ctx)`` that calls one of
these; each returns None when the run holds nothing for it to read.
``ctx`` is the traced run's: ``stats`` (the call's solver counters),
``tracer`` (its ``repro_torch.obs.Tracer``), ``pes``, ``pack`` (the
``mailbox_pack`` bound and launches recorded over that call) and
``window`` (the accepted profiler window of a later call, or one whose
``accepted`` is False).
"""
from __future__ import annotations

from perfbench import devtrace

#: the staged driver's chase stages (SRS descend levels)
CHASE_STAGE = "descend"


def chase_s(ctx):
    """Seconds of a call's chase stages, each bounded by a device sync
    on both sides (``stats["stage_wall_s"]``)."""
    walls = ctx.get("stats", {}).get("stage_wall_s")
    if not walls:
        return None
    chase = [dt for label, dt in walls if label.startswith(CHASE_STAGE)]
    return sum(chase) if chase else None


def rounds(ctx):
    """Host rounds a call: the solver's chase rounds over its PEs."""
    total = ctx.get("stats", {}).get("rounds")
    return None if total is None else total // ctx["pes"]


def tour_s(ctx):
    """Wall seconds of the committed Euler-tour build attempt."""
    tracer = ctx.get("tracer")
    if tracer is None:
        return None
    spans = [s for s in tracer.find(cat="stage-attempt")
             if s.name.startswith("build_tour#")
             and s.args.get("outcome") == "committed"]
    return spans[-1].args["wall_s"] if spans else None


def _window(ctx):
    win = ctx.get("window")
    return win if win is not None and win["accepted"] else None


def mailbox_pack_roofline(ctx):
    """% of its bound that ``mailbox_pack`` reached over a call: the
    summed bound of the launches recorded in one call over the summed
    device time of as many launches in the profiled call."""
    win, pack = _window(ctx), ctx.get("pack")
    if win is None or not pack or not pack["launches"] or \
            win["launches"].get("mailbox_pack_kernel") != pack["launches"]:
        return None
    device_ms = devtrace.device_us(win["events"], "mailbox_pack_kernel") / 1e3
    return 100.0 * pack["bound_ms"] / device_ms if device_ms > 0 else None


def nccl_ms(ctx):
    """Device ms of the NCCL kernels in the profiled call."""
    win = _window(ctx)
    if win is None:
        return None
    nccl = [e for e in win["events"] if "nccl" in e["name"].lower()]
    return devtrace.device_us(nccl) / 1e3 if nccl else None


def idle_share(ctx):
    """% of the profiled call's wall in which the card ran nothing."""
    win = _window(ctx)
    if win is None or win["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - win["busy_s"] / win["wall_s"])
