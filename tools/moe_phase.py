#!/usr/bin/env python3
"""``chip_smoke.py`` phase 18 alone: the MoE FFN and the encoder-decoder
on one CUDA card.

Run from the root of the repository on a machine with one card:

    python3 tools/moe_phase.py

It builds the kernel library and runs phase 18's parts in order: (a)
``flash_attention`` at every attention shape of (b) and (c) against its
plain version, (b) granite-moe-1b served at full width through
the engine, (c) seamless-m4t-medium's encode, prefill and cross-attention
decode at full width, (d) kernels on against off in float32 at SMOKE width
(granite-moe, kimi-k2, seamless) and granite-moe's engine tokens against
its own greedy forward. It prints phase 18's lines and exits non-zero on
any failure.
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
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    t0 = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card {card}, torch {torch.__version__}", flush=True)
    build.load_library()
    print(f"kernel library loaded in {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    t_phase = time.time()
    chip_smoke.moe_encdec_kernels_phase(dev)
    chip_smoke.moe_serve_phase(dev)
    chip_smoke.encdec_phase(dev)
    chip_smoke.moe_exactness_phase(dev)
    print(f"phase 18 {time.time() - t_phase:.1f} s; total "
          f"{time.time() - t0:.1f} s [{card}]")


if __name__ == "__main__":
    main()
