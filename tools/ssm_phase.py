#!/usr/bin/env python3
"""``chip_smoke.py`` phase 17 alone: the SSM serving path (mamba2-130m and
hymba-1.5b) on one CUDA card.

Run from the root of the repository on a machine with one card:

    python3 tools/ssm_phase.py

It builds the kernel library and runs phase 17's parts in order: (a) the
kernels at hymba's shapes against their plain versions, (b) and (c)
mamba2-130m and hymba-1.5b served at full width through the engine, (d)
the engine's path against ``forward`` in float32. It prints phase 17's
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
    chip_smoke.ssm_kernels_phase(dev)
    for arch, max_seq, max_prompt, _ in chip_smoke.SSM_SERVE:
        chip_smoke.ssm_serve_phase(dev, arch, max_seq, max_prompt)
    chip_smoke.ssm_exactness_phase(dev)
    print(f"total {time.time() - t0:.1f} s [{card}]")


if __name__ == "__main__":
    main()
