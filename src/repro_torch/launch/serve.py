"""Serving entry point: batched generation with continuous batching.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --smoke --requests 12 --max-new 32 --device cpu

Serves every decoder-only family: the dense decoders, the MoE decoders
(``--arch granite-moe-1b-a400m`` / ``kimi-k2-1t-a32b``), mamba2-130m and
hymba-1.5b. The encdec family (seamless-m4t-medium) exits with a message,
as the JAX package's entry point does: it serves through
``model.encode`` and ``model.decode_step(..., enc_out=)``, not the
engine. Runs on the CUDA device unless ``--device`` says otherwise;
``--use-kernels`` sends attention through the ``flash_attention`` kernel
(its plain version on the CPU). The SSM branches serve through plain
torch, as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-kernels", action="store_true")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke).with_(
        use_kernels=args.use_kernels)
    device = resolve_device(args.device)
    params = M.init(cfg, torch.Generator(device).manual_seed(0), device)
    scfg = ServeConfig(slots=args.slots, max_seq=args.max_seq,
                       temperature=args.temperature,
                       max_new_tokens=args.max_new)
    try:
        eng = ServingEngine(params, cfg, scfg, device=device)
    except ValueError as err:  # the engine refuses the encdec family
        raise SystemExit(str(err)) from None
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = int(rng.integers(4, 32))
        eng.submit(Request(uid=uid, prompt=rng.integers(
            2, cfg.vocab_size, plen).astype(np.int32)))
    t0 = time.time()
    out = eng.run_to_completion()
    dt = time.time() - t0
    total = sum(len(v) for v in out.values())
    print(json.dumps({
        "arch": cfg.name, "device": str(device), "requests": len(out),
        "generated_tokens": total, "wall_s": round(dt, 2),
        "tok_per_s": round(total / max(dt, 1e-9), 1),
        "sample": {str(k): v[:8] for k, v in list(out.items())[:2]},
    }))
    return out


if __name__ == "__main__":
    main()
