#!/usr/bin/env python3
"""Where a solve over NCCL at world size 1 spends the time the
virtual-PE solve does not: warm walls of the same solve, in turns.

Run from the root of the repository on a machine with one card:

    python3 tools/profile_dist.py [--n 16777216] [--reps 3]

Variants, each a warm ``rank_list_with_stats`` of List(n, gamma=1) on 16
PEs with both kernels on, alternated ``reps`` times:

- ``virtual``: the virtual-PE transport (``sim_mesh``);
- ``nccl``: the ``torch.distributed`` transport over NCCL at world size
  1 in this process (``dist_mesh``);
- ``nccl-no-a2a``: the same with ``all_to_all_single`` skipped — at
  world size 1 every hop's rows move by index and the call carries no
  bytes, so the outputs are unchanged;
- ``nccl-no-reduce``: the same with ``all_reduce`` skipped — a sum over
  one rank is the identity.

Every variant's outputs are checked against the virtual solve's. It
prints the card, each variant's walls, median and spread.
"""
from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    import torch.distributed as dist
    from repro_torch.core.listrank import (ListRankConfig, dist_mesh,
                                           instances, rank_list_with_stats,
                                           sim_mesh)
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        sys.exit("profile_dist: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card {card}, torch {torch.__version__}", flush=True)
    build.load_library()
    dev = torch.device("cuda", 0)
    succ, rank = instances.gen_list(args.n, gamma=1.0, seed=1)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    skipped = {"nccl-no-a2a": "all_to_all_single",
               "nccl-no-reduce": "all_reduce"}

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            meshes = {"virtual": sim_mesh(16), "nccl": dist_mesh(16),
                      "nccl-no-a2a": dist_mesh(16),
                      "nccl-no-reduce": dist_mesh(16)}

            def solve(name):
                saved = None
                if name in skipped:
                    saved = getattr(dist, skipped[name])
                    setattr(dist, skipped[name], lambda *a, **k: None)
                try:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    s, r, _ = rank_list_with_stats(succ, rank, meshes[name],
                                                   cfg=cfg, seed=0,
                                                   device=dev)
                    torch.cuda.synchronize()
                    return s, r, time.perf_counter() - t
                finally:
                    if saved is not None:
                        setattr(dist, skipped[name], saved)

            ref = solve("virtual")
            for name in meshes:
                s, r, _ = solve(name)  # warm-up, and the check
                if not (torch.equal(s, ref[0]) and torch.equal(r, ref[1])):
                    sys.exit(f"profile_dist: {name}'s outputs differ")
            walls = {name: [] for name in meshes}
            for _ in range(args.reps):
                for name in meshes:
                    walls[name].append(solve(name)[2])
        finally:
            dist.destroy_process_group()
    for name, w in walls.items():
        print(f"{name:15s} median {statistics.median(w):.3f} s, spread "
              f"{min(w):.3f}-{max(w):.3f} s ({', '.join(f'{x:.3f}' for x in w)})"
              f" [{card}]")


if __name__ == "__main__":
    main()
