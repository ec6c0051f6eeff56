#!/usr/bin/env python3
"""``chip_smoke.py`` phase 20 alone: per-rank recovery under the
``torch.distributed`` transport, the int8 runtime and remat, on one CUDA
card.

Run from the root of the repository on a machine with one card:

    python3 tools/recovery_dist_phase.py

It builds the kernel library and runs phase 20's parts in order: (a) the
supervised and fault-injected List(2^22) solves over 2 gloo ranks on the
card against the virtual transport (outputs, counters, checkpoints byte
for byte, resumes both ways), (b) ``compressed_psum`` on the card against
the CPU, ``examples/dp_compression.py``'s loop and one granite-moe-1b step
with int8 AdamW state, (c) granite-moe-1b with remat on and off and
hymba-1.5b with remat and int8 state at full width, (d) float32 SMOKE
gradients bit-equal with remat on and off. It prints phase 20's lines and
exits non-zero on any failure.
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
    t_phase = time.time()
    res = chip_smoke.recovery_dist_phase(torch.device("cuda", 0), card)
    print(f"phase 20 {time.time() - t_phase:.1f} s; total "
          f"{time.time() - t0:.1f} s [{card}]; launches a rank "
          f"{res['launches']}")


if __name__ == "__main__":
    main()
