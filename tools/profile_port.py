#!/usr/bin/env python3
"""Device-side profile of the port on one CUDA card (torch.profiler).

Run from the root of the repository, after or beside ``chip_smoke.py``:

    python3 tools/profile_port.py [--path list|tree|graph] [--n N] [--p 16]

It prints, from the profiler's CUDA trace:

- each list-ranking kernel's device time per call at the main path's
  shapes (the same inputs as ``chip_smoke.py`` phase 2), which CUDA-event
  timing cannot separate from the wrapper's host overhead;
- for one warm call of the path (``--path list``: ``rank_list_with_stats``
  on List(n, gamma=1), n = 2^24 by default; ``tree``: ``tree_stats`` on
  ``gen_tree_parents(n)``, n = 2^22; ``graph``: ``graph_stats`` on
  ``gen_graph_edges(n, 4n, num_components=4)``, n = 2^20; kernels on):
  the wall time and its per-stage split, the summed device time of all
  kernels, memsets and copies, the device's busy and idle share, and the
  top device-time consumers;
- the peak device memory of that call;
- ``mailbox_pack`` and ``local_chase`` over every launch of that call
  (``repro_torch.devtime.kernel_times_over``): launches, summed kernel device
  time, the summed bound of each launch (for ``mailbox_pack`` the bytes
  that hop must move at the card's memory rate, counted as
  ``chip_smoke.py`` counts them: the buffer written once, and each
  shipping message's payload words and 8-byte index read once, with each
  hop's own shipping count, recorded on the device without a host sync)
  and launches x (time - bound) per call;
- ``local_chase`` alone on List(n, gamma) for gamma 1 (the main path's
  input) and 0 (every doubling step changes something): device time per
  call and the steps each row ran.

A device time is printed only when a window caught every launch the
wrappers counted (``repro_torch.devtime``): the kernel windows need each
call's kernels, the path's window as many ``mailbox_pack`` and
``local_chase`` kernels as the wrappers launched, and as many device
events as another such window and no fewer than any
(``devtime.repeat_check``); otherwise it says "not measured".
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import devtime  # noqa: E402


#: the default size of each path (nodes for tree and graph)
DEFAULT_N = {"list": 1 << 24, "tree": 1 << 22, "graph": 1 << 20}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=tuple(DEFAULT_N), default="list")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--p", type=int, default=16)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_port: needs a CUDA device")
    from repro_torch.core import graphalg, treealg
    from repro_torch.core.listrank import (ListRankConfig, instances,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.core.listrank import api, exchange, local
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops

    dev = torch.device("cuda", 0)
    p = args.p
    n_path = args.n or DEFAULT_N[args.path]
    n = DEFAULT_N["list"] if args.path != "list" else n_path
    m = n // p
    succ_np, rank_np = instances.gen_list(n, gamma=1.0, seed=1)
    plan = exchange.MeshPlan.from_mesh(sim_mesh(p), ("pe",), device=dev)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    print(f"card {torch.cuda.get_device_name(0)}; path {args.path}, "
          f"n {n_path}, p {p}")

    # ---- kernels alone, at the main path's shapes
    def profile_calls(name, fn, expect, reps=20):
        ms, events = devtime.profiled_ms(fn, torch, expect, reps=reps)
        if ms is None:
            print(f"{name}: not measured")
            return None
        for kname, (count, us) in sorted(devtime.per_name(events).items()):
            print(f"{name}: device {kname[:60]}: {count} events, "
                  f"{us / reps / 1e3:.4f} ms per call")
        return ms

    def fmt(ms):
        return "not measured" if ms is None else f"{ms:.4f} ms"

    elems = p * m
    for gamma in (1.0, 0.0):
        s_np, r_np = (succ_np, rank_np) if gamma == 1.0 else \
            instances.gen_list(n, gamma=gamma, seed=1)
        succ_l, dist0, steps, _ = local.chase_input(
            torch.from_numpy(s_np).reshape(p, m).to(dev),
            torch.from_numpy(r_np).reshape(p, m).to(dev),
            plan.my_id() * m, m)
        ms = profile_calls(f"local_chase gamma={gamma}",
                           lambda: lc_ops.local_chase(succ_l, dist0, steps),
                           devtime.EXPECT["local_chase"])
        run = lc_ops.STEPS_RUN.tolist()
        bound = devtime.bound_ms(16 * elems, 0)[0]
        print(f"  local_chase gamma={gamma}: {fmt(ms)} of device time, "
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
        cols, order, skey, p, cap), devtime.EXPECT["mailbox_pack"])
    bound = devtime.bound_ms(devtime.pack_bytes(
        p, len(cols) + 1, n_rows, int(fits.sum())), 0)[0]
    print(f"  mailbox_pack level-0 hop: {fmt(ms)} of device time, bound "
          f"{bound:.4f} ms ({int(fits.sum())} shipping messages)")
    del payload, cols, valid, target, order, skey, fits

    # ---- one warm call of the path
    mesh = sim_mesh(p)
    if args.path == "list":
        def call():
            return rank_list_with_stats(succ_np, rank_np, mesh, cfg=cfg,
                                        device=dev)[2]
    elif args.path == "tree":
        parent = instances.gen_tree_parents(n_path, seed=0)

        def call():
            return treealg.tree_stats(parent, mesh, cfg=cfg,
                                      device=dev).stats
    else:
        edges = instances.gen_graph_edges(n_path, 4 * n_path, seed=0,
                                          num_components=4)

        def call():
            return graphalg.graph_stats(edges, n_path, mesh, cfg=cfg,
                                        device=dev).stats

    call()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kt, events, stats = devtime.kernel_times_over(call, torch)
    peak = torch.cuda.max_memory_allocated(dev)
    wall = kt["profiled_wall_s"]
    print(f"{args.path} n={n_path} p={p}: wall {wall:.3f} s under the "
          f"profiler; peak memory {peak / 2**30:.2f} GiB; launches "
          f"{kt['launches']}")
    print(f"  stages: {stats['stage_wall_s']}")
    if kt["device_ms"] is None:
        print("  device time not measured: no two windows held every "
              "launch and the most device events")
        return
    dm, bd = kt["device_ms"], kt["bound_ms"]
    print(f"  device busy {kt['busy_ms'] / 1e3:.3f} s "
          f"({100 - 100 * kt['idle_share']:.1f} %), idle "
          f"{100 * kt['idle_share']:.1f} %; {len(events)} device events")
    print(f"  local_chase: device {dm['local_chase']:.4f} ms, summed bound "
          f"{bd['local_chase']:.4f} ms")
    print(f"  mailbox_pack: device {dm['mailbox_pack']:.4f} ms, summed bound "
          f"{bd['mailbox_pack']:.4f} ms, launches x (time - bound) "
          f"{dm['mailbox_pack'] - bd['mailbox_pack']:.4f} ms per call")
    top = sorted(devtime.per_name(events).items(), key=lambda kv: -kv[1][1])
    for kname, (count, us) in top[:12]:
        print(f"  {us / 1e3:9.2f} ms  {count:7d} x  {kname[:90]}")

if __name__ == "__main__":
    main()
