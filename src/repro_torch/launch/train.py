"""Training entry point.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --smoke --steps 20 --batch 8 --seq 128 --device cpu \
      --ckpt-dir ckpt --ckpt-every 5

``train_step`` over ``pipeline.global_batch`` (packed by list ranking),
AdamW with cosine warmup, random weights from seed 0, the loop run by the
fault-tolerant ``Supervisor``: periodic async checkpoints of (params,
optimizer state) into ``--ckpt-dir`` every ``--ckpt-every`` steps and at
the end, in the JAX package's format; a run started on a directory that
holds a checkpoint resumes from its latest one; a failed step restores
the latest checkpoint and replays (the batches regenerate from the
step); SIGTERM/SIGINT write a checkpoint and stop. Without
``--ckpt-dir`` nothing is written and a failed step replays from step 0.
Under a process group every rank runs the loop on the same state, and
the ``Supervisor`` is the group's: rank 0 alone writes into
``--ckpt-dir`` (a directory every rank sees), every rank restarts from
rank 0's latest step, and a preemption or a failed step on one rank is
one on every rank.

Every step runs under the mesh context (``runtime.context.use_mesh``),
as the reference's launcher runs it: the mesh of ``launch/mesh.py``'s
``make_host_mesh()`` over the ranks when a process group is initialised,
else a (1, 1) ``("data", "model")`` virtual mesh on the run's device
(:func:`host_mesh`). So an MoE model trains through the expert-parallel
``moe_ffn_ep`` even on one card; the other families read no context.

Runs on the CUDA device unless ``--device`` says otherwise;
``--use-kernels`` sends attention through ``flash_attention`` and the
Mamba-2 scan through ``ssd_scan`` (their plain versions on the CPU).
Every family trains: an MoE model adds its aux loss, and an encdec model's
batch carries ``enc_embeds``, the stubbed frontend's frames (normals drawn
on the device from the step, :func:`enc_embeds`).
Prints a line per logged step and a final JSON summary.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import signal
import time

import torch

from repro_torch import configs
from repro_torch.core.listrank.transport import (DistMesh, DistTransport,
                                                 sim_mesh)
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as M
from repro_torch.models.params import map_tree
from repro_torch.optim import adamw
from repro_torch.runtime import context as runtime_context
from repro_torch.runtime.fault_tolerance import Supervisor, SupervisorConfig
from repro_torch.train import steps as train_steps


def host_mesh():
    """The mesh the launcher's steps run under: ``make_host_mesh()``,
    (world, 1) over the ranks, when a process group is initialised, else
    a (1, 1) virtual mesh whose one PE is the run's device."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return mesh_lib.make_host_mesh()
    return sim_mesh((1, 1), ("data", "model"))


def initial_state(cfg, tcfg: train_steps.TrainConfig, device):
    """((params, optimizer state), 0): random weights from seed 0."""
    params = M.init(cfg, torch.Generator(device).manual_seed(0), device)
    return (params, adamw.init(params, tcfg.optimizer)), 0


def state_like(cfg, tcfg: train_steps.TrainConfig):
    """The (params, optimizer state) checkpoint layout as ``meta``
    tensors: shapes and dtypes, no storage."""
    params = map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                            device="meta"),
                      M.param_specs(cfg))
    return params, adamw.init(params, tcfg.optimizer)


def enc_embeds(cfg, dcfg: pipeline.DataConfig, step: int, device):
    """An encdec batch's encoder input: (global_batch, seq_len,
    prefix_embed_dim) float32 normals drawn on ``device`` from a generator
    seeded by (``dcfg.seed``, ``step``), so a replayed step draws them
    again."""
    gen = torch.Generator(device).manual_seed(dcfg.seed * 1_000_003 + step)
    return torch.randn((dcfg.global_batch, dcfg.seq_len, cfg.prefix_embed_dim),
                       generator=gen, device=device)


def step_fn(cfg, dcfg: pipeline.DataConfig, tcfg: train_steps.TrainConfig,
            device, mesh=None):
    """``one_step(state, step) -> (state, metrics)``: batch ``step`` and
    one optimizer step, under ``use_mesh(mesh)`` when ``mesh`` is given;
    ``metrics["t0"]`` is the host clock (``time.perf_counter``) at the
    step's start, ``metrics["batch_s"]`` the seconds its batch took."""
    def one_step(state, step):
        params, opt = state
        t0 = time.perf_counter()
        batch = pipeline.device_batch(dcfg, step, device)
        if cfg.family == "encdec":
            batch["enc_embeds"] = enc_embeds(cfg, dcfg, step, device)
        batch_s = time.perf_counter() - t0
        with (runtime_context.use_mesh(mesh) if mesh is not None
              else contextlib.nullcontext()):
            params, opt, metrics = train_steps.train_step(params, opt, batch,
                                                          cfg, tcfg)
        return (params, opt), {**metrics, "t0": t0, "batch_s": batch_s}
    return one_step


def main(argv=None):
    """Run the loop; returns one record per logged step: step, loss,
    grad_norm, lr, and the host-clock ms of the step and of its batch (a
    replayed step's record replaces the first)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=configs.list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (none: no checkpoints)")
    ap.add_argument("--ckpt-every", type=int, default=25)
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
    mesh = host_mesh()
    ranks = (DistTransport.for_mesh(mesh, mesh.axis_names, device)
             if isinstance(mesh, DistMesh) else None)
    sup = Supervisor(SupervisorConfig(ckpt_dir=args.ckpt_dir,
                                      ckpt_every=args.ckpt_every),
                     lambda: initial_state(cfg, tcfg, device),
                     lambda: state_like(cfg, tcfg), device=device,
                     ranks=ranks)
    one_step = step_fn(cfg, dcfg, tcfg, device, mesh=mesh)

    records: dict[int, dict] = {}

    def on_metrics(done, metrics):
        if done % args.log_every == 0 or done == args.steps:
            loss = float(metrics["loss"])  # waits for the step
            gnorm = float(metrics["grad_norm"])
            lr = float(metrics["lr"])
            t_end = time.perf_counter()
            records[done] = {"step": done, "loss": loss, "grad_norm": gnorm,
                             "lr": lr, "ms": (t_end - metrics["t0"]) * 1e3,
                             "batch_ms": metrics["batch_s"] * 1e3}
            print(f"step {done:5d} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"lr {lr:.2e}", flush=True)

    old_handlers = sup.install_signal_handlers()
    t0 = time.time()
    try:
        _, step = sup.run(one_step, args.steps, on_metrics)
    finally:
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
    dt = time.time() - t0
    history = [records[k] for k in sorted(records)]
    print(json.dumps({"arch": cfg.name, "steps": step,
                      "wall_s": round(dt, 1), "supervisor": sup.stats,
                      "first_loss": history[0]["loss"] if history else None,
                      "last_loss": history[-1]["loss"] if history else None}))
    return history


if __name__ == "__main__":
    main()
