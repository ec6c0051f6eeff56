#!/usr/bin/env python3
"""Device-side profile of one training step of the port on one CUDA card.

Run from the root of the repository, after or beside ``chip_smoke.py``:

    python3 tools/profile_train.py [--arch mamba2-130m] [--batch 8] [--seq 1024]

It builds ``chip_smoke.py`` phase 12's configuration (full width and
depth, bfloat16, random weights from seed 0, the kernels on, a batch of
``pipeline.global_batch``), runs one warm-up step, then:

1. one step without the profiler, synchronised at the boundaries of the
   forward (``loss_fn``), the backward (``torch.autograd.grad``) and the
   AdamW update, with the host time spent inside the ``ssd_scan``
   backward (the recompute through ``ssd_ref``) summed apart;
2. one step under torch.profiler with the same windows marked (read
   from the first of up to three steps whose trace holds every
   ``ssd_scan`` kernel the wrapper launched and as many device events as
   another such step's; otherwise "not measured"), reporting for each window its wall time, the device's busy and idle share, the
   device events (launches) it issued, the device time by class and the
   top device-time consumers; for the backward also the share of its
   device time and of its launches spent in the ``ssd_ref`` recompute.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
from repro_torch import devtime  # noqa: E402
from profile_serve import FLASH_KERNELS  # noqa: E402

GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")
#: the port's SSD kernels (ssd_scan.cu): CUDA cores (float32), and the
#: bf16 chunk-parallel four: C B^T, chunk states, state pass, chunk scan
SSD_KERNELS = ("ssd_scan_kernel", "ssd_cb_kernel", "ssd_state_kernel",
               "ssd_pass_kernel", "ssd_chunk_scan_kernel")
WINDOWS = ("forward", "backward", "optimizer")
RECOMPUTE = "ssd_ref recompute"


def kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in SSD_KERNELS):
        return "ssd_scan kernels"
    if any(k in low for k in FLASH_KERNELS):
        return "flash_attention kernels"
    if any(g in low for g in GEMM_NAMES):
        return "matrix products"
    return "other (elementwise, reductions, copies)"


def split_trace(events):
    """(device events, annotation windows {name: [(ts, end), ...]}) of a
    window's trace events."""
    device, marks = [], collections.defaultdict(list)
    for e in events:
        if e.get("cat") in devtime.DEVICE_CATS:
            device.append(e)
        elif e["name"] in WINDOWS + (RECOMPUTE,):
            ts = float(e["ts"])
            marks[e["name"]].append((ts, ts + float(e["dur"])))
    return device, marks


def inside(events, spans):
    """Device events that start inside one of ``spans`` (disjoint)."""
    spans = sorted(spans)
    starts = [a for a, _ in spans]
    out = []
    for e in events:
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ts < spans[i][1]:
            out.append(e)
    return out


def report(what, events, wall_us):
    busy = devtime.device_us(events)
    print(f"{what}: wall {wall_us / 1e3:.2f} ms under the profiler; device "
          f"busy {busy / 1e3:.2f} ms ({100 * busy / wall_us:.1f} %), idle "
          f"{100 - 100 * busy / wall_us:.1f} %; {len(events)} device events")
    by_kind: dict = collections.defaultdict(float)
    for e in events:
        by_kind[kind(e["name"])] += float(e["dur"])
    for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3:10.3f} ms ({100 * us / max(busy, 1e-9):5.1f} % of "
              f"device time)  {k}")
    top = sorted(devtime.per_name(events).items(), key=lambda kv: -kv[1][1])
    for kname, (count, us) in top[:8]:
        print(f"  {us / 1e3:10.3f} ms  {count:7d} x  {kname[:90]}")
    return busy


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args()

    import torch
    from torch.profiler import record_function
    if not torch.cuda.is_available():
        sys.exit("profile_train: needs a CUDA device")
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.optim import adamw, schedule
    from repro_torch.train import steps

    dev = torch.device("cuda", 0)
    cfg = configs.get_config(args.arch).with_(use_kernels=True)
    tcfg = steps.TrainConfig()
    params = M.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adamw.init(params, tcfg.optimizer)
    batch = pipeline.device_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch), 0, dev)
    params, opt, _ = steps.train_step(params, opt, batch, cfg, tcfg)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, batch {args.batch} x {args.seq}; card "
          f"{torch.cuda.get_device_name(0)}")

    recompute_s = [0.0]
    backward = ssd_ops._SSDScan.backward

    def marked_backward(ctx, gy):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function(RECOMPUTE):
            out = backward(ctx, gy)
            torch.cuda.synchronize()
        recompute_s[0] += time.perf_counter() - t0
        return out

    ssd_ops._SSDScan.backward = staticmethod(marked_backward)

    def step(params, opt):
        """One train step in three synchronised windows; their seconds."""
        walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("forward"), torch.enable_grad():
            p_req = map_tree(lambda p: p.detach().requires_grad_(), params)
            loss, _ = steps.loss_fn(p_req, batch, cfg, tcfg)
            torch.cuda.synchronize()
        walls["forward"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with record_function("backward"):
            flat = torch.autograd.grad(loss, leaves(p_req))
            torch.cuda.synchronize()
        walls["backward"] = time.perf_counter() - t0
        it = iter(flat)
        grads = map_tree(lambda _: next(it), params)
        t0 = time.perf_counter()
        with record_function("optimizer"):
            lr = schedule.cosine_warmup(opt["step"] + 1,
                                        warmup_steps=tcfg.warmup_steps,
                                        total_steps=tcfg.total_steps)
            params, opt, _ = adamw.update(grads, opt, params, tcfg.optimizer,
                                          lr)
            torch.cuda.synchronize()
        walls["optimizer"] = time.perf_counter() - t0
        return params, opt, walls, float(loss.detach())

    launches = ssd_ops.LAUNCHES
    params, opt, walls, loss = step(params, opt)
    launches = ssd_ops.LAUNCHES - launches
    total = sum(walls.values())
    print(f"without the profiler: step {total * 1e3:.1f} ms (loss "
          f"{loss:.4f}): " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                        for k, v in walls.items())
          + f"; inside the ssd_scan backward (ssd_ref recompute) "
          f"{recompute_s[0] * 1e3:.1f} ms = "
          f"{100 * recompute_s[0] / walls['backward']:.1f} % of the backward;"
          f" ssd_scan launches {launches}")

    # a window counts only if it caught every ssd_scan kernel launched
    kinds = devtime.EXPECT["ssd_scan_bf16" if cfg.dtype == torch.bfloat16
                           else "ssd_scan_f32"]
    state, want = [params, opt], {}

    def run():
        launches = ssd_ops.LAUNCHES
        out = devtime.window(lambda: step(*state), torch,
                             cats=devtime.DEVICE_CATS + ("user_annotation",))
        state[:] = out[0][:2]
        want.update({k: v * (ssd_ops.LAUNCHES - launches)
                     for k, v in kinds.items()})
        return out

    def check(events):
        device = split_trace(events)[0]
        if devtime.complete(device, want):
            return None
        return (f"the profiler caught "
                f"{devtime.kernel_counts(device, want)} of {want}")

    _, events, _ = devtime.checked_window(run, devtime.repeat_check(check),
                                          windows=3)
    if events is None:
        print("profiled step: device time not measured")
        return
    device, marks = split_trace(events)
    busy = {}
    for name in WINDOWS:
        (a, b), = marks[name]
        busy[name] = report(name, inside(device, [(a, b)]), b - a)
    rec = inside(device, marks[RECOMPUTE])
    rec_busy = sum(float(e["dur"]) for e in rec)
    rec_wall = sum(b - a for a, b in marks[RECOMPUTE])
    n_bwd = len(inside(device, marks["backward"]))
    print(f"backward: the ssd_ref recompute ({len(marks[RECOMPUTE])} layers) "
          f"takes {rec_wall / 1e3:.1f} ms of wall, {rec_busy / 1e3:.2f} ms of "
          f"device time ({100 * rec_busy / max(busy['backward'], 1e-9):.1f} %"
          f" of the backward's) and {len(rec)} of its {n_bwd} device events")
    print(f"device events (launches) per step: {len(device)}")


if __name__ == "__main__":
    main()
