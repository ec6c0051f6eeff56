#!/usr/bin/env python3
"""One of ``chip_smoke.py``'s phases alone, on one CUDA card.

Run from the root of the repository on a machine with one card:

    python3 tools/phase.py N [n]

It builds the kernel library, prints the card and the ptxas report of the
attention kernels, runs phase ``N`` and exits non-zero on any failure:

- 6: the tree path (``tree_stats`` at ``n`` nodes, default
  ``chip_smoke.N_TREE``, kernels on and off, against the host oracle);
- 7: the graph path (``graph_stats`` at ``n`` nodes and 4n edges, default
  ``chip_smoke.N_GRAPH``, kernels on and off);
- 16: the ``torch.distributed`` transport (NCCL at world size 1, gloo in 4
  processes sharing the card, the tree and graph paths under gloo), held
  against phase 3's solve of List(n, gamma=1) (``n`` default 2^24) on 16
  virtual PEs with both kernels on, which it runs first;
- 17: the SSM serving path: the kernels at hymba's shapes, mamba2-130m and
  hymba-1.5b served at full width, the engine against ``forward``;
- 18: the MoE FFN and the encoder-decoder: ``flash_attention`` at their
  shapes, granite-moe-1b served at full width, seamless-m4t-medium's
  encode, prefill and cross-attention decode, float32 exactness;
- 19: the mesh context and the expert-parallel MoE (``moe_ffn_ep``);
- 20: per-rank recovery under the ``torch.distributed`` transport, the
  int8 runtime and remat;
- 21: the shape-only dry run held against the card (it first measures
  granite-moe-1b's launcher steps, as phase 20 (c) does);
- 22: the port's examples and gemma2-2b's path: ``flash_attention`` at its
  heads (D 256, soft-cap 50, a 4096-key window), gemma2-2b served at full
  width, the list examples with and without ``--kernels``, llama-100m
  trained and resumed, float32 exactness;
- 23: the solver's configurations (the paper's Figs 2-4 and the other
  switches), each solved with both kernels on and off against the
  sequential oracle: groups (a) and (b) at ``n`` elements (default
  ``chip_smoke.CONFIG_N``, 2^22), (c) at n / 4, (d) at n / 8;
- 24: the head-dim-128 decoders: ``flash_attention`` at their heads,
  qwen2.5-14b, phi4-mini-3.8b and pixtral-12b served at full width,
  pixtral's patch-embedding prefill and decode, float32 exactness;
- 25: kimi-k2 at full width: ``flash_attention`` at its heads (GQA group
  8, D 112), one layer of its 384-expert top-8 MoE served, float32
  exactness with its experts cut to 64.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def dist(dev, card: str, n: int) -> None:
    """Phase 3's solve (cold, then warm with per-stage collectives), then
    phase 16 against it."""
    import torch
    import chip_smoke
    from repro_torch.core.listrank import (ListRankConfig, instances,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.kernels.local_chase import ops as lc_ops
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
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


def list_cfgs():
    """The main path's configurations: both kernels on, both off."""
    from repro_torch.core.listrank import ListRankConfig
    return (ListRankConfig(use_pallas=True, use_pallas_pack=True),
            ListRankConfig(use_pallas=False, use_pallas_pack=False))


def ssm(dev, card: str) -> None:
    import chip_smoke
    chip_smoke.ssm_kernels_phase(dev)
    for arch, max_seq, max_prompt, _ in chip_smoke.SSM_SERVE:
        chip_smoke.ssm_serve_phase(dev, arch, max_seq, max_prompt)
    chip_smoke.ssm_exactness_phase(dev)


def moe(dev, card: str) -> None:
    import chip_smoke
    chip_smoke.moe_encdec_kernels_phase(dev)
    chip_smoke.moe_serve_phase(dev)
    chip_smoke.encdec_phase(dev)
    chip_smoke.moe_exactness_phase(dev)


def main() -> None:
    import torch
    import chip_smoke
    from repro_torch.kernels import build

    def size(default: int) -> int:
        return int(sys.argv[2]) if len(sys.argv) > 2 else default

    phases = {
        6: lambda dev, card: chip_smoke.tree_phase(
            dev, size(chip_smoke.N_TREE), *list_cfgs())[0],
        7: lambda dev, card: chip_smoke.graph_phase(
            dev, size(chip_smoke.N_GRAPH), *list_cfgs())[0],
        16: lambda dev, card: dist(dev, card, size(chip_smoke.N_MAIN)),
        17: ssm,
        18: moe,
        19: lambda dev, card: chip_smoke.moe_ep_phase(dev),
        20: chip_smoke.recovery_dist_phase,
        21: chip_smoke.dryrun_phase,
        22: chip_smoke.examples_phase,
        23: lambda dev, card: chip_smoke.configs_phase(
            dev, card, size(chip_smoke.CONFIG_N)),
        24: chip_smoke.d128_phase,
        25: chip_smoke.kimi_phase,
    }
    if len(sys.argv) < 2 or int(sys.argv[1]) not in phases:
        chip_smoke.fail(f"usage: tools/phase.py N [n], N one of "
                        f"{sorted(phases)}")
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    n = int(sys.argv[1])
    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card {card}, torch {torch.__version__}", flush=True)
    build.load_library()
    print(f"kernel library loaded in {time.time() - t0:.1f} s", flush=True)
    for line in chip_smoke.ptxas_summary(build.build_info.get("log", "")):
        if "flash" in line:
            print("  " + line, flush=True)
    t_phase = time.time()
    res = phases[n](torch.device("cuda", 0), card)
    launches = f"; launches {res['launches']}" if isinstance(
        res, dict) and "launches" in res else ""
    print(f"phase {n} {time.time() - t_phase:.1f} s; total "
          f"{time.time() - t0:.1f} s [{card}]{launches}")


if __name__ == "__main__":
    main()
