#!/usr/bin/env python3
"""Time two versions of the ``flash_attention`` CUDA kernel in turns on one
card.

Run from the root of the repository:

    python3 tools/ab_flash_attention.py --other PATH/flash_attention.cu [--rounds 5]

Builds the kernel library twice with ``kernels/build.py`` (same flags):
"tree" from ``src/repro_torch/kernels/csrc/``, "other" with
``flash_attention.cu`` replaced by ``--other``. Both are checked against
the plain version, then timed in turns (tree, other, other, tree in each
round; median of 20 CUDA-event timings per turn) through the same
wrapper, in bfloat16 with tinyllama's heads (Hq = 32, Hkv = 4, D = 64)
over a 2048-key cache:

- prefill: B = 1, Lq = 1024, offset 0 (the serving path's 1024 bucket);
- decode: B = 8, Lq = 1, per-slot offsets from seed 3 (as chip_smoke.py);
- decode at one offset for every slot, 63, 511 and 2047.

Both versions must export the launch functions ``kernels/build.py``
declares; ``csrc/`` is on the include path of both builds.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import statistics
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=pathlib.Path)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("ab_flash_attention: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    tree_srcs = build._sources()
    other_srcs = [args.other.resolve() if s.name == "flash_attention.cu"
                  else s for s in tree_srcs]
    libs = {"tree": build.declare(ctypes.CDLL(str(build.build(tree_srcs)))),
            "other": build.declare(ctypes.CDLL(str(build.build(
                other_srcs))))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}; other = {args.other}")

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(11)
    hq, hkv, d, lk = 32, 4, 64, 2048
    cases = {"prefill Lq=1024": (1, 1024, [0])}
    cases["decode per-slot"] = (8, 1, np.random.default_rng(3).integers(
        0, lk, 8).tolist())
    for off in (63, 511, 2047):
        cases[f"decode offset {off}"] = (8, 1, [off] * 8)

    for name, (b, lq, offs) in cases.items():
        q = torch.randn((b, hq, lq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, hkv, lk, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, hkv, lk, d), generator=g, device=dev).bfloat16()
        off = offs[0] if b == 1 else torch.tensor(offs, dtype=torch.int32,
                                                  device=dev)
        want = fa_ref.attention_ref(q, k, v, q_offset=off).float()
        times: dict = {"tree": [], "other": []}
        for who in ("tree", "other"):
            build._lib = libs[who]
            got = fa_ops.flash_attention(q, k, v, q_offset=off).float()
            if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
                sys.exit(f"{who} differs from the plain version on {name}")
        for _ in range(args.rounds):
            for who in ("tree", "other", "other", "tree"):
                build._lib = libs[who]
                times[who].append(time_ms(
                    lambda: fa_ops.flash_attention(q, k, v, q_offset=off),
                    torch))
        print(f"{name}: " + "; ".join(
            f"{who} median {statistics.median(t):.4f} ms (min {min(t):.4f},"
            f" max {max(t):.4f}, n={len(t)})" for who, t in times.items()))
    build._lib = None


if __name__ == "__main__":
    main()
