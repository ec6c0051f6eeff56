#!/usr/bin/env python3
"""What torch.profiler windows lose on one CUDA card, and what
``repro_torch.devtime.window`` does about it.

Run from the root of the repository, after or beside ``chip_smoke.py``:

    python3 tools/profile_windows.py [--windows 25] [--n 4194304]

It prints the device events each window caught, for:

1. windows of 10 bf16 ``flash_attention`` prefill calls (tinyllama's
   heads, Lq 1024 over 2048 keys; 10 kernels each), opened plainly
   (CPU and CUDA traced) and through ``devtime.window`` (primer
   launches first, the call's events read inside its span);
2. three windows of one whole warm ``tree_stats`` call
   (``gen_tree_parents(n, seed=0)``, p = 16, kernels on) each way, with
   the events by (category, name) that differ from the first window;
3. the windows of 1. again after the large windows of 2.

A whole call launches the same device events every time, so windows
that differ lost events.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import devtime  # noqa: E402


def plain_window(fn, torch):
    """(result, device events, wall) of a window without primer or span."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    return result, devtime.trace_events(prof), None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=25)
    ap.add_argument("--n", type=int, default=1 << 22)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_windows: needs a CUDA device")
    from repro_torch.core import treealg
    from repro_torch.core.listrank import ListRankConfig, instances, sim_mesh
    from repro_torch.kernels.flash_attention import ops as fa_ops

    dev = torch.device("cuda", 0)
    print(f"card {torch.cuda.get_device_name(0)}")
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((1, 32, 1024, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((1, 4, 2048, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((1, 4, 2048, 64), generator=g, device=dev).bfloat16()

    def calls():
        for _ in range(10):
            fa_ops.flash_attention(q, k, v, causal=True)

    def short_windows(when):
        calls()
        for name, win in (("plain", plain_window),
                          ("devtime.window", devtime.window)):
            got = [len(win(calls, torch)[1]) for _ in range(args.windows)]
            print(f"10 prefill calls, {when}, {name}: {got}; short "
                  f"{sum(x != 10 for x in got)} of {args.windows}")

    short_windows("first")
    parent = instances.gen_tree_parents(args.n, seed=0, locality=False)
    mesh = sim_mesh(16)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)

    def call():
        treealg.tree_stats(parent, mesh, cfg=cfg, seed=0, device=dev)

    call()
    for name, win in (("plain", plain_window),
                      ("devtime.window", devtime.window)):
        counts = []
        for w in range(3):
            events = win(call, torch)[1]
            counts.append(collections.Counter(
                (e["cat"], e["name"][:60]) for e in events))
            print(f"tree_stats n={args.n}, {name}, window {w + 1}: "
                  f"{len(events)} device events, "
                  f"{devtime.device_us(events) / 1e3:.1f} ms busy")
        for w in (1, 2):
            diff = {key: counts[0][key] - counts[w][key]
                    for key in counts[0] | counts[w]
                    if counts[0][key] != counts[w][key]}
            print(f"  events of window 1 less window {w + 1}: {diff}")
    short_windows("after the tree windows")


if __name__ == "__main__":
    main()
