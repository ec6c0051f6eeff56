#!/usr/bin/env python3
"""``chip_smoke.py`` phase 21 alone: the shape-only dry run held against
one CUDA card.

Run from the root of the repository on a machine with one card:

    python3 tools/dryrun_phase.py

It builds the kernel library, measures what phase 20 (c) measures for
granite-moe-1b (its launcher steps at 4 x 512 tokens with remat on and
off, and one forward and backward alone each way), then runs phase 21:
(a) the dry run's predicted peaks against those, (b) tinyllama-1.1b's
prefill against the dry run's argument bytes and peak, (c)
``examples/torch_trace_solve.py`` on the card. It prints phase 21's lines
and exits non-zero on any failure.
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
    res = chip_smoke.dryrun_phase(torch.device("cuda", 0), card)
    print(f"phase 21 {res['phase_s']:.1f} s (with the measured rows); total "
          f"{time.time() - t0:.1f} s [{card}]")


if __name__ == "__main__":
    main()
