#!/usr/bin/env python3
"""``chip_smoke.py`` phase 16 alone: the ``torch.distributed`` transport
on one CUDA card, after phase 3's solve that it is held against.

Run from the root of the repository on a machine with one card:

    python3 tools/dist_phase.py [n]

It builds the kernel library, solves List(n, gamma=1) (default 2^24) on
16 virtual PEs with both kernels on (cold, then warm with per-stage
collectives), and runs ``chip_smoke.dist_phase`` against that solve:
NCCL at world size 1, gloo with CUDA tensors in 4 processes sharing the
card, and the tree and graph paths under gloo. It prints phase 16's
lines and exits non-zero on any failure.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import torch
    import chip_smoke
    from repro_torch.core.listrank import (ListRankConfig, instances,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.kernels import build
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card {card}, torch {torch.__version__}", flush=True)
    build.load_library()
    dev = torch.device("cuda", 0)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else chip_smoke.N_MAIN
    succ, rank = instances.gen_list(n, gamma=1.0, seed=1)
    cfg_on = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    mesh = sim_mesh(chip_smoke.P_MAIN)
    lc_ops.LAUNCHES = mp_ops.LAUNCHES = 0
    rank_list_with_stats(succ, rank, mesh, cfg=cfg_on, seed=chip_smoke.SEED,
                         device=dev)
    launches = {"local_chase": lc_ops.LAUNCHES,
                "mailbox_pack": mp_ops.LAUNCHES}
    torch.cuda.synchronize()
    t = time.perf_counter()
    s, r, st = rank_list_with_stats(succ, rank, mesh, cfg=cfg_on,
                                    seed=chip_smoke.SEED, device=dev,
                                    stage_counters=True)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    print(f"phase 3's solve: warm {warm:.3f} s, launches {launches}",
          flush=True)
    chip_smoke.dist_phase(dev, card, succ, rank,
                          (s, r, chip_smoke.int_counters(st)), cfg_on,
                          launches, st["stage_collectives"], warm)
    print(f"total {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
