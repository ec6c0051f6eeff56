#!/usr/bin/env python3
"""``chip_smoke.py`` phase 19 alone: the mesh context and the
expert-parallel MoE (``moe_ffn_ep``) on one CUDA card.

Run from the root of the repository on a machine with one card:

    python3 tools/moe_ep_phase.py

It builds the kernel library and runs phase 19's parts in order: (a) one
granite-moe-1b MoE layer at full width under virtual meshes (1, 1), (4, 1)
and (2, 2) against the dense dispatch, (b) the same layer under a
``DistMesh`` (1, 1) over NCCL at world size 1, (c) ``launch/train.py``
under its (1, 1) mesh against the same steps without a context, (d)
float32 SMOKE exactness. It prints phase 19's lines and exits non-zero on
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
    t_phase = time.time()
    res = chip_smoke.moe_ep_phase(torch.device("cuda", 0))
    print(f"phase 19 {time.time() - t_phase:.1f} s; total "
          f"{time.time() - t0:.1f} s [{card}]; launches {res['launches']}")


if __name__ == "__main__":
    main()
