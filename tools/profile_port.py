#!/usr/bin/env python3
"""Device-side profile of the port on one CUDA card (torch.profiler).

Run from the root of the repository, after or beside ``chip_smoke.py``:

    python3 tools/profile_port.py [--n 16777216] [--p 16]

It prints, from the profiler's CUDA trace:

- each kernel's device time per call at the main path's shapes (the
  same inputs as ``chip_smoke.py`` phase 2), which CUDA-event timing
  cannot separate from the wrapper's host overhead;
- for one warm main-path solve (List(n, gamma=1), kernels on): the
  wall time, the summed device time of all kernels, memsets and copies,
  the device's busy and idle share, and the top device-time consumers;
- the peak device memory of that solve;
- ``mailbox_pack`` over every hop of that solve: its launches, its summed
  kernel device time, the summed bound of each call (the bytes that call
  must move at the card's memory rate, counted as ``chip_smoke.py``
  counts them for one hop: the buffer written once, and each shipping
  message's payload words and 8-byte index read once, with each hop's
  own shipping count) and their difference, launches x (time - bound)
  per solve. The shipping counts come from an unprofiled run of the
  same solve (it is deterministic), so that counting them adds no device
  work to the profiled one;
- ``local_chase`` alone on List(n, gamma) for gamma 1 (the main path's
  input) and 0 (every doubling step changes something): device time per
  call and the steps each row ran.

The profile is read from a Chrome trace written to a temporary directory
inside the repository and removed afterwards.
"""
from __future__ import annotations

import argparse
import collections
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import HBM_BYTES_PER_S, pack_bytes  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def device_events(prof) -> list[dict]:
    """The device-side events (kernels, memsets, copies) of a profile."""
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        trace = json.loads(path.read_text())
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def per_name(events) -> dict[str, tuple[int, float]]:
    out: dict = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        out[e["name"]][0] += 1
        out[e["name"]][1] += float(e["dur"])
    return {k: (c, t) for k, (c, t) in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--p", type=int, default=16)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        sys.exit("profile_port: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.listrank import (ListRankConfig, instances,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.core.listrank import api, exchange, local
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops, ref as mp_ref

    dev = torch.device("cuda", 0)
    n, p = args.n, args.p
    m = n // p
    succ_np, rank_np = instances.gen_list(n, gamma=1.0, seed=1)
    plan = exchange.MeshPlan.from_mesh(sim_mesh(p), ("pe",), device=dev)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)

    # ---- kernels alone, at the main path's shapes
    def profile_calls(name, fn, reps=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = per_name(device_events(prof))
        for kname, (count, us) in sorted(per.items()):
            print(f"{name}: device {kname[:60]}: {count} events, "
                  f"{us / reps / 1e3:.4f} ms per call")
        return sum(us for _, us in per.values()) / reps / 1e3

    elems = p * m
    for gamma in (1.0, 0.0):
        s_np, r_np = (succ_np, rank_np) if gamma == 1.0 else \
            instances.gen_list(n, gamma=gamma, seed=1)
        succ_l, dist0, steps, _ = local.chase_input(
            torch.from_numpy(s_np).reshape(p, m).to(dev),
            torch.from_numpy(r_np).reshape(p, m).to(dev),
            plan.my_id() * m, m)
        ms = profile_calls(f"local_chase gamma={gamma}",
                           lambda: lc_ops.local_chase(succ_l, dist0, steps))
        run = lc_ops.local_chase.steps_run.tolist()
        bound = 16 * elems / HBM_BYTES_PER_S * 1e3
        print(f"  local_chase gamma={gamma}: {ms:.4f} ms of device time, "
              f"bound {bound:.4f} ms; steps run per row {run} of {steps}")
        del succ_l, dist0

    term_bound = int(np.bincount((np.arange(n) // m)[
        succ_np == np.arange(n)], minlength=p).max())
    spec0 = api.build_specs(cfg, plan, m, n, term_bound)[0]
    cap = spec0.mail_caps[0]
    n_rows = p * cap
    q = spec0.queue_cap + n_rows + spec0.spawn_window
    g = torch.Generator(device=dev).manual_seed(7)
    valid = torch.rand((p, q), device=dev, generator=g) < spec0.r_static / q
    target = torch.randint(0, n, (p, q), device=dev, generator=g,
                           dtype=torch.int32)
    payload = {"target": target, "ruler": target.flip(1).contiguous(),
               "weight": torch.rand((p, q), device=dev, generator=g),
               "_dest": (target // m).to(torch.int32)}
    order, _, _, fits, _, skey = exchange._bucket_indices(
        payload["_dest"], valid, p, cap)
    cols = [c.contiguous() for c in exchange.WireFormat.from_payload(
        payload).payload_columns(payload)]
    ms = profile_calls("mailbox_pack", lambda: mp_ops.mailbox_pack(
        cols, order, skey, p, cap))
    bound = pack_bytes(p, len(cols) + 1, n_rows, int(fits.sum())) \
        / HBM_BYTES_PER_S * 1e3
    print(f"  mailbox_pack level-0 hop: {ms:.4f} ms of device time, bound "
          f"{bound:.4f} ms ({int(fits.sum())} shipping messages)")
    del payload, cols, valid, target, order, skey, fits

    # ---- one warm main-path solve
    def solve():
        return rank_list_with_stats(succ_np, rank_np, sim_mesh(p), cfg=cfg,
                                    device=dev)

    # an unprofiled run counts each hop's shipping messages and bound
    pack, pack_bounds = mp_ops.mailbox_pack, []

    def recording_pack(cols, order, skey, n_buckets, cap):
        cols = list(cols)
        shipping = torch.clamp(mp_ref.bucket_runs(skey, n_buckets)[1],
                               max=cap).sum()
        pack_bounds.append((skey.shape[0], len(cols) + 1, n_buckets * cap,
                            shipping))
        return pack(cols, order, skey, n_buckets, cap)

    recording_pack.launches = 0  # the wrapper counts on its module name
    mp_ops.mailbox_pack = recording_pack
    try:
        solve()
    finally:
        mp_ops.mailbox_pack = pack
    pack_bounds = [pack_bytes(pe, w, rows, int(ship)) / HBM_BYTES_PER_S * 1e3
                   for pe, w, rows, ship in pack_bounds]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, stats = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    events = device_events(prof)
    busy_us = sum(float(e["dur"]) for e in events)
    print(f"solve n={n} p={p}: wall {wall:.3f} s under the profiler; device "
          f"busy {busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"idle {100 - 100 * busy_us / 1e6 / wall:.1f} %; "
          f"{len(events)} device events; peak memory {peak / 2**30:.2f} GiB")
    print(f"  stages: {stats['stage_wall_s']}")
    pack_us = [float(e["dur"]) for e in events
               if "mailbox_pack_kernel" in e["name"]]
    chase_us = [float(e["dur"]) for e in events
                if "chase_persistent_kernel" in e["name"]]
    print(f"  local_chase in the solve: {len(chase_us)} kernels, device "
          f"{sum(chase_us) / 1e3:.4f} ms")
    print(f"  mailbox_pack over the solve: {len(pack_bounds)} calls, "
          f"{len(pack_us)} kernels, device {sum(pack_us) / 1e3:.4f} ms, "
          f"summed bound {sum(pack_bounds):.4f} ms, launches x (time - "
          f"bound) {sum(pack_us) / 1e3 - sum(pack_bounds):.4f} ms per solve")
    top = sorted(per_name(events).items(), key=lambda kv: -kv[1][1])[:12]
    for kname, (count, us) in top:
        print(f"  {us / 1e3:9.2f} ms  {count:7d} x  {kname[:90]}")


if __name__ == "__main__":
    main()
