"""Training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --smoke --steps 20 --batch 8 --seq 128 --device cpu

A plain loop of ``train_step`` over ``pipeline.global_batch`` (packed by
list ranking), AdamW with cosine warmup, random weights from seed 0. Runs
on the CUDA device unless ``--device`` says otherwise; ``--use-kernels``
sends attention through ``flash_attention`` and the Mamba-2 scan through
``ssd_scan`` (their plain versions on the CPU). Prints a line per logged
step and a final JSON summary. Checkpointing and crash restart (the JAX
entry point's ``Supervisor``) are not ported.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import configs
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import steps as train_steps


def main(argv=None):
    """Run the loop; returns one record per logged step: step, loss,
    grad_norm, lr, and the host-clock ms of the step and of its batch."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--use-kernels", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    tcfg = train_steps.TrainConfig(
        optimizer=adamw.AdamWConfig(lr=args.lr),
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    cfg = configs.get_config(args.arch, smoke=args.smoke).with_(
        use_kernels=args.use_kernels)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               global_batch=args.batch)
    params = M.init(cfg, torch.Generator(device).manual_seed(0), device)
    opt = adamw.init(params, tcfg.optimizer)

    history = []
    t0 = time.time()
    for step in range(args.steps):
        t_step = time.perf_counter()
        batch = pipeline.device_batch(dcfg, step, device)
        t_batch = time.perf_counter()
        params, opt, metrics = train_steps.train_step(params, opt, batch, cfg,
                                                      tcfg)
        done = step + 1
        if done % args.log_every == 0 or done == args.steps:
            loss = float(metrics["loss"])  # waits for the step
            gnorm = float(metrics["grad_norm"])
            lr = float(metrics["lr"])
            t_end = time.perf_counter()
            history.append({"step": done, "loss": loss, "grad_norm": gnorm,
                            "lr": lr, "ms": (t_end - t_step) * 1e3,
                            "batch_ms": (t_batch - t_step) * 1e3})
            print(f"step {done:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {lr:.2e}", flush=True)
    dt = time.time() - t0
    print(json.dumps({"arch": cfg.name, "steps": args.steps,
                      "wall_s": round(dt, 1),
                      "first_loss": history[0]["loss"] if history else None,
                      "last_loss": history[-1]["loss"] if history else None}))
    return history


if __name__ == "__main__":
    main()
