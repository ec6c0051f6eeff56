#!/usr/bin/env python3
"""Device-side profile of the port's serving path on one CUDA card.

Run from the root of the repository, after or beside ``chip_smoke.py``:

    python3 tools/profile_serve.py [--arch tinyllama-1.1b] [--ticks 16] \
        [--prefill 1024] [--max-seq N] [--layers N]

It builds the ``ServingEngine`` of ``chip_smoke.py`` phase 9 (full width,
bfloat16, random weights from seed 0, 8 slots of 2048 positions or twice
the local window where that is longer, the ``flash_attention`` kernel on;
``--arch mamba2-130m`` or ``hymba-1.5b`` for phase 17's models, ``--arch
granite-moe-1b-a400m`` for phase 18's, ``--arch gemma2-2b`` for phase
22's, over 8192 positions; ``--max-seq 8192`` with ``--arch qwen2.5-14b``,
``phi4-mini-3.8b`` or ``pixtral-12b`` for phase 24's slots; ``--arch
kimi-k2-1t-a32b --layers 1 --max-seq 8192`` for phase 25's model, cut to
the depth that fits the card), fills every slot with a 512-token prompt,
and profiles with torch.profiler:

- one prefill of a ``--prefill``-token bucket (``ServingEngine._prefill``,
  as an admission of a prompt of that length);
- ``--ticks`` decode ticks with all slots active (``ServingEngine.step``);
- for an MoE model, one MoE FFN layer (``layers.moe_ffn`` on the first
  layer's experts) at a tick's tokens (one a slot) and at a 1024-token
  prefill's, on random normal inputs: its matrix products (the router and
  the three batched expert products) against the rest, which is the
  dispatch (top-k, the sort by expert, the capacity scatter, the gather
  and combine) and the SwiGLU's elementwise work.

From the first of up to four windows of each that caught every
attention kernel the wrapper launched and as many device events as
another such window (``repro_torch.devtime``; otherwise "not measured")
it prints the wall
time, the summed device time of all
kernels, memsets and copies, the device's busy and idle share, the device
time by class (the attention kernel, matrix products, the rest) and the
top device-time consumers.
"""
from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import devtime  # noqa: E402

GEMM_NAMES = ("gemm", "gemv", "xmma", "cutlass", "nvjet", "cublas")
#: the port's attention kernels (flash_attention.cu): CUDA cores (float32),
#: tensor cores (bf16 prefill), split-K decode and its merge
FLASH_KERNELS = ("flash_fwd_kernel", "flash_fwd_mma_kernel",
                 "flash_decode_split_kernel", "flash_decode_merge_kernel")


def kind(name: str) -> str:
    low = name.lower()
    if any(k in low for k in FLASH_KERNELS):
        return "flash_attention kernels"
    if any(g in low for g in GEMM_NAMES):
        return "matrix products"
    return "other (elementwise, norms, rope, cache writes, copies)"


def report(what: str, events, wall: float, n: int) -> None:
    """Print a window's device time (``events``; None when no window
    caught every attention kernel launched) over ``n`` calls."""
    if events is None:
        print(f"{what}: device time not measured")
        return
    busy_us = devtime.device_us(events)
    print(f"{what}: wall {wall * 1e3 / n:.3f} ms per call under the profiler "
          f"({n} calls); device busy {busy_us / 1e3 / n:.3f} ms per call "
          f"({100 * busy_us / 1e6 / wall:.1f} %), idle "
          f"{100 - 100 * busy_us / 1e6 / wall:.1f} %; "
          f"{len(events) / n:.0f} device events per call")
    by_kind: dict = collections.defaultdict(float)
    for e in events:
        by_kind[kind(e["name"])] += float(e["dur"])
    for k, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / n:9.4f} ms per call ({100 * us / busy_us:5.1f} %"
              f" of device time)  {k}")
    top = sorted(devtime.per_name(events).items(), key=lambda kv: -kv[1][1])
    for kname, (count, us) in top[:10]:
        print(f"  {us / 1e3 / n:9.4f} ms per call  {count // n:5d} x  "
              f"{kname[:90]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--prefill", type=int, default=1024)
    ap.add_argument("--max-seq", type=int, default=None,
                    help="positions a slot (default: 2048, or twice the "
                         "local window where that is longer)")
    ap.add_argument("--layers", type=int, default=None,
                    help="layers of the model (default: the config's)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_serve: needs a CUDA device")
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.params import map_tree
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    dev = torch.device("cuda", 0)
    cfg = configs.get_config(args.arch).with_(use_kernels=True)
    if args.layers:
        cfg = cfg.with_(num_layers=args.layers)
    params = M.init(cfg, torch.Generator(dev).manual_seed(0), dev)
    # a slot long enough that a windowed layer's window binds
    max_seq = args.max_seq or max(2048, 2 * (cfg.local_window or 0))
    scfg = ServeConfig(slots=8, max_seq=max_seq, eos_id=-1,
                       max_new_tokens=4 * args.ticks + 16)
    eng = ServingEngine(params, cfg, scfg, device=dev)
    rng = np.random.default_rng(0)
    for uid in range(scfg.slots):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            2, cfg.vocab_size, 512).astype(np.int32)))
    for _ in range(4):  # admits every slot, then warm decode ticks
        eng.step()
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                         (1, args.prefill))
                            .astype(np.int32)).to(dev)
    plen = toks.shape[1]
    # warm the prefill's bucket (slot 0 is rewritten below and decodes on)
    eng._prefill(0, toks, plen - 1)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.dtype}, {scfg.slots} slots, max_seq {scfg.max_seq}; card "
          f"{torch.cuda.get_device_name(0)}")

    kinds = "bf16" if cfg.dtype == torch.bfloat16 else "f32"

    def counted(fn, expect):
        """Up to four windows of ``fn``, read from one that holds
        ``expect`` ({kernel: launches per wrapper call}) per call it
        launched and as many device events as another such window
        (``devtime.repeat_check``)."""
        want = {}

        def run():
            launched = fa_ops.LAUNCHES
            out = devtime.window(fn, torch)
            want.update({k: v * (fa_ops.LAUNCHES - launched)
                         for k, v in expect.items()})
            return out

        def check(events):
            if devtime.complete(events, want):
                return None
            return (f"the profiler caught "
                    f"{devtime.kernel_counts(events, want)} of {want}")
        _, events, wall = devtime.checked_window(
            run, devtime.repeat_check(check), windows=4)
        return events, wall

    events, wall = counted(lambda: eng._prefill(0, toks, plen - 1),
                           devtime.EXPECT[
        f"flash_attention_prefill_{kinds}" if kinds == "bf16"
        else "flash_attention_f32"])
    report(f"prefill, bucket {plen}", events, wall, 1)

    def ticks():
        for _ in range(args.ticks):
            eng.step()
    events, wall = counted(ticks, devtime.EXPECT[
        f"flash_attention_decode_{kinds}" if kinds == "bf16"
        else "flash_attention_f32"])
    report(f"decode tick, {int(eng.active.sum())} active slots", events,
           wall, args.ticks)
    t0 = time.perf_counter()
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    print(f"decode tick without the profiler: "
          f"{(time.perf_counter() - t0) * 1e3 / 4:.3f} ms")
    if cfg.moe:
        ffn = map_tree(lambda a: a[0], params["layers"]["ffn"])
        gen = torch.Generator(dev).manual_seed(1)
        for what, (b, l) in (("a tick's", (scfg.slots, 1)),
                             ("a 1024-token prefill's", (1, 1024))):
            h = torch.randn((b, l, cfg.d_model), generator=gen,
                            device=dev).to(cfg.dtype)
            L.moe_ffn(ffn, h, cfg)
            _, events, wall = devtime.checked_window(
                lambda: devtime.window(lambda: L.moe_ffn(ffn, h, cfg), torch),
                devtime.repeat_check(
                    lambda ev: None if ev else "no device events"),
                windows=4)
            report(f"one MoE FFN layer at {what} {b * l} tokens", events,
                   wall, 1)


if __name__ == "__main__":
    main()
