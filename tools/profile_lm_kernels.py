#!/usr/bin/env python3
"""Device time of the port's two LM kernels beside SDPA, on one CUDA card.

Run from the root of the repository, after or beside ``chip_smoke.py``:

    python3 tools/profile_lm_kernels.py

For bf16 inputs it prints, from torch.profiler's CUDA trace (10 calls
each; "not measured" unless the window caught every call's kernels,
``repro_torch.devtime``), every device kernel a wrapper call launched
with its time per call, the device time of calls queued behind a device
sleep (``devtime.queued_ms``), the host's time to enqueue one call (50 calls, no synchronisation
inside), and for attention the rate in TFLOP/s over the unmasked pairs
(4 D operations each):

- ``flash_attention`` with tinyllama's heads (Hq 32, Hkv 4, D 64): the
  serving prefill (Lq 1024 over 2048 keys, causal), the same without the
  mask, a causal 4096 x 4096 prefill, and the serving decode (8 slots at
  per-slot offsets), each beside ``scaled_dot_product_attention`` on the
  same inputs (its backend's kernels are named);
- ``ssd_scan`` at mamba2-130m's training shape (Bt 8, L 1024, H 24, P 64,
  G 1, N 128, chunk 256) and at Bt 1, each of its four kernels apart;
- the library call beside ``flash_attention`` at gemma2-2b's heads (Hq 8,
  Hkv 4, D 256, soft-cap 50) over its 8192-key slot, every case of
  ``GEMMA2_ATTN_CASES`` in bf16 and f32 (``chip_smoke.py`` phase 22 (a)'s
  shapes): one call of torch's compiled ``flex_attention``
  (:func:`flex_yardstick`), held to the kernel's tolerance against the
  plain version, its compile seconds and its CUDA-event ms beside the
  kernel's;
- the library call beside ``flash_attention`` at the heads of the
  head-dim-128 decoders (``D128_HEADS``: qwen2.5-14b, phi4-mini-3.8b,
  pixtral-12b), every case of ``D128_ATTN_CASES`` in bf16 and f32
  (``chip_smoke.py`` phase 24 (a)'s shapes): ``scaled_dot_product_attention``
  with ``enable_gqa`` (upper-left ``is_causal`` for a prefill at offset 0,
  a boolean mask of each slot's keys for a decode), held to the kernel's
  tolerance against the plain version, its CUDA-event ms beside the
  kernel's (:func:`d128_library`);
- the same at kimi-k2's heads (``K2_HEADS``: Hq 64, Hkv 8, D 112,
  ``chip_smoke.py`` phase 25 (a)'s shapes).
"""
from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch import devtime  # noqa: E402


def profile_calls(fn, torch, expect: dict, reps: int = 10):
    """{device kernel name: ms per call} over ``reps`` calls of ``fn``, or
    None unless a window holds ``reps`` x ``expect`` ({kernel name:
    launches per call}) of the named kernels and a whole number of
    events per call (``devtime.profiled_ms``)."""
    ms, events = devtime.profiled_ms(fn, torch, expect, reps=reps)
    if ms is None:
        return None
    return {k: us / reps / 1e3
            for k, (_, us) in devtime.per_name(events).items()}


def host_us(fn, torch, reps: int = 50) -> float:
    """The host's time to enqueue one call of ``fn`` (microseconds)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def report(what: str, fn, torch, expect: dict,
           flops: float | None = None) -> None:
    """One line per call kind: the profiled device time (checked against
    ``expect``; SDPA's kernels are another library's, so its ``expect``
    is empty and only whole calls are checked), the device time of calls
    queued behind a device sleep (``devtime.queued_ms``), and the host's
    enqueue time."""
    times = profile_calls(fn, torch, expect)
    queued = devtime.queued_ms(fn, torch)
    q = "not measured" if queued is None else f"{queued:.4f} ms"
    if times is None:
        print(f"{what}: device time not measured (the profiler missed "
              f"launches); queued {q}; host enqueue "
              f"{host_us(fn, torch):.1f} us")
        return
    total = sum(times.values())
    rate = f", {flops / total / 1e9:.1f} TFLOP/s" if flops else ""
    print(f"{what}: device {total:.4f} ms per call{rate}; queued {q}; host "
          f"enqueue {host_us(fn, torch):.1f} us")
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:.4f} ms  {name[:100]}")


def flex_yardstick(q, k, v, *, q_offset, window, softcap, scale):
    """One call of torch's ``flex_attention`` computing what
    ``flash_attention`` computes on (q, k, v): the soft-cap as its
    ``score_mod``, the causal mask, the window and the per-slot offsets as
    a block mask (built here, once, as a user builds it for every layer),
    GQA by ``enable_gqa``. On the card its Triton kernel through
    ``torch.compile``; on the CPU the unfused eager version, which checks
    the masks there. Returns the zero-argument call."""
    import os
    import torch
    from torch.nn.attention import flex_attention as fx
    b, _, lq, _ = q.shape
    lk = k.shape[2]
    pos0 = torch.as_tensor(q_offset, device=q.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    # no window as a window past every key: one mask function, so the
    # kernel compiles once a shape and dtype
    win = torch.tensor(window or 1 << 30, dtype=torch.int32, device=q.device)

    def mask_mod(bi, h, qi, ki):
        pos = pos0[bi] + qi
        return (ki <= pos) & (pos - ki < win)

    def score_mod(s, bi, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    mask = fx.create_block_mask(mask_mod, b, None, lq, lk, device=q.device)
    fn = fx.flex_attention
    if q.is_cuda:
        # in this process (no pool of compile workers), its caches beside
        # the kernel library's build
        from torch._inductor import config as inductor_config
        from repro_torch.kernels import build
        inductor_config.compile_threads = 1
        # every case's shape and dtype compiled, none left to eager
        dyn = torch._dynamo.config
        setattr(dyn, "recompile_limit" if hasattr(dyn, "recompile_limit")
                else "cache_size_limit", 64)
        for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                         ("TRITON_CACHE_DIR", "triton")):
            os.environ.setdefault(var, str(build.BUILD_DIR / sub))
        fn = torch.compile(fx.flex_attention, dynamic=False)
    return lambda: fn(q, k, v, score_mod=score_mod, block_mask=mask,
                      scale=scale, enable_gqa=True)


def gemma2_library(dev, torch) -> None:
    """flex_attention beside the kernel at every ``GEMMA2_ATTN_CASES``
    case in bf16 and f32, each held to ``ATTN_TOL`` against the plain
    version; a case flex does not run prints why."""
    from _torch_kernel_inputs import (ATTN_TOL, GEMMA2_ATTN_CASES,
                                      GEMMA2_HEADS)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    hq, hkv, d, scale, cap = GEMMA2_HEADS
    for name, b, lq, lk, offs, window in GEMMA2_ATTN_CASES:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(22)
            q = torch.randn((b, hq, lq, d), generator=g, device=dev).to(dt)
            k = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
            v = torch.randn((b, hkv, lk, d), generator=g, device=dev).to(dt)
            off = offs[0] if b == 1 else torch.tensor(
                offs, dtype=torch.int32, device=dev)
            kw = dict(q_offset=off, window=window, softcap=cap, scale=scale)
            key = f"{name}_{str(dt).removeprefix('torch.')}"
            want = fa_ref.attention_ref(q, k, v, **kw).float()
            t = time.perf_counter()
            try:
                call = flex_yardstick(q, k, v, **kw)
                got = call().float()
                torch.cuda.synchronize()
            except Exception as exc:
                print(f"flex_attention {key}: does not run this case "
                      f"({type(exc).__name__}: "
                      f"{str(exc).splitlines()[0]})")
                continue
            compile_s = time.perf_counter() - t
            err = float((got - want).abs().max())
            if not torch.allclose(got, want, **ATTN_TOL[dt]):
                sys.exit(f"profile_lm_kernels: flex_attention {key} computes "
                         f"another function (max |err| {err})")
            del got, want
            lib = time_ms(call, torch, reps=10)
            ker = time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                          torch, reps=10)
            print(f"flex_attention {key} B {b} Lq {lq} Lk {lk} window "
                  f"{window}: max |err| {err:.3g} (tolerance {ATTN_TOL[dt]});"
                  f" compiled in {compile_s:.1f} s; {lib:.4f} ms, the kernel "
                  f"{ker:.4f} ms (CUDA events, median of 10)")
            del q, k, v, call
        torch.cuda.empty_cache()


def sdpa_yardstick(q, k, v, *, q_offset, window, softcap, scale):
    """One call of ``scaled_dot_product_attention`` computing what
    ``flash_attention`` computes on (q, k, v) without a window or a
    soft-cap: GQA by ``enable_gqa``, the causal mask upper-left aligned
    (``is_causal``) at an int offset of 0, else a boolean mask of the keys
    at or before each slot's position. Returns the zero-argument call."""
    import torch
    import torch.nn.functional as F
    if window is not None or softcap is not None:
        raise ValueError("the SDPA yardstick takes no window or soft-cap")
    b, _, lq, _ = q.shape
    if not isinstance(q_offset, torch.Tensor) and q_offset == 0:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True)
    pos = torch.as_tensor(q_offset, device=q.device).reshape(-1).expand(b)
    keys = torch.arange(k.shape[2], device=q.device)
    mask = (keys[None, None, :] <= pos[:, None, None]
            + torch.arange(lq, device=q.device)[None, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)


def d128_library(dev, torch, heads: dict | None = None) -> None:
    """SDPA beside the kernel at every ``D128_ATTN_CASES`` case of every
    layout of ``heads`` ({arch: (Hq, Hkv, D, scale, soft-cap)};
    ``D128_HEADS`` unless given) in bf16 and f32, each held to
    ``ATTN_TOL`` against the plain version."""
    from _torch_kernel_inputs import ATTN_TOL, D128_ATTN_CASES, D128_HEADS
    sys.path.insert(0, str(ROOT))
    from chip_smoke import time_ms
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    for arch, (hq, hkv, d, scale, cap) in (heads or D128_HEADS).items():
        for name, b, lq, lk, offs, window in D128_ATTN_CASES:
            for dt in (torch.bfloat16, torch.float32):
                g = torch.Generator(device=dev).manual_seed(22)
                q = torch.randn((b, hq, lq, d), generator=g,
                                device=dev).to(dt)
                k = torch.randn((b, hkv, lk, d), generator=g,
                                device=dev).to(dt)
                v = torch.randn((b, hkv, lk, d), generator=g,
                                device=dev).to(dt)
                off = offs[0] if b == 1 else torch.tensor(
                    offs, dtype=torch.int32, device=dev)
                kw = dict(q_offset=off, window=window, softcap=cap,
                          scale=scale)
                key = f"{arch} {name}_{str(dt).removeprefix('torch.')}"
                want = fa_ref.attention_ref(q, k, v, **kw).float()
                call = sdpa_yardstick(q, k, v, **kw)
                got = call().float()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not torch.allclose(got, want, **ATTN_TOL[dt]):
                    sys.exit(f"profile_lm_kernels: SDPA {key} computes "
                             f"another function (max |err| {err})")
                del got, want
                lib = time_ms(call, torch, reps=10)
                ker = time_ms(lambda: fa_ops.flash_attention(q, k, v, **kw),
                              torch, reps=10)
                print(f"SDPA {key} Hq {hq} Hkv {hkv} D {d} B {b} Lq {lq} "
                      f"Lk {lk}: max |err| {err:.3g} (tolerance "
                      f"{ATTN_TOL[dt]}); {lib:.4f} ms, the kernel "
                      f"{ker:.4f} ms (CUDA events, median of 10)")
                del q, k, v, call
            torch.cuda.empty_cache()


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("profile_lm_kernels: needs a CUDA device")
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_kernel_inputs import K2_HEADS, ssd_inputs
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    dev = torch.device("cuda", 0)
    import subprocess
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card {torch.cuda.get_device_name(0)} ({smi})")
    g = torch.Generator(device=dev).manual_seed(11)
    hq, hkv, d = 32, 4, 64
    for b, lq, lk, causal in ((1, 1024, 2048, True), (1, 1024, 2048, False),
                              (1, 4096, 4096, True)):
        q = torch.randn((b, hq, lq, d), generator=g, device=dev).bfloat16()
        k = torch.randn((b, hkv, lk, d), generator=g, device=dev).bfloat16()
        v = torch.randn((b, hkv, lk, d), generator=g, device=dev).bfloat16()
        pairs = (b * sum(min(i + 1, lk) for i in range(lq)) if causal
                 else b * lq * lk)
        flops = 4 * d * hq * pairs
        what = f"B {b} Lq {lq} Lk {lk} {'causal' if causal else 'no mask'}"
        report(f"flash_attention {what}", lambda: fa_ops.flash_attention(
            q, k, v, causal=causal), torch,
            devtime.EXPECT["flash_attention_prefill_bf16"], flops)
        # SDPA's causal mask is aligned upper left: offset 0 over Lk keys
        report(f"SDPA {what}", lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True), torch, {}, flops)

    lk = 2048
    offs = np.random.default_rng(3).integers(0, lk, 8).tolist()
    q = torch.randn((8, hq, 1, d), generator=g, device=dev).bfloat16()
    k = torch.randn((8, hkv, lk, d), generator=g, device=dev).bfloat16()
    v = torch.randn((8, hkv, lk, d), generator=g, device=dev).bfloat16()
    off = torch.tensor(offs, dtype=torch.int32, device=dev)
    mask = (torch.arange(lk, device=dev)[None, :] <= off[:, None])[
        :, None, None, :]
    report("flash_attention decode B 8 at per-slot offsets",
           lambda: fa_ops.flash_attention(q, k, v, q_offset=off), torch,
           devtime.EXPECT["flash_attention_decode_bf16"])
    report("SDPA decode B 8 at per-slot offsets",
           lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, enable_gqa=True), torch, {})

    for bt in (8, 1):
        args = [t.to(dev) for t in ssd_inputs(bt, 1024, 24, 1, 128, 64,
                                               seed=1, dtype=torch.bfloat16)]
        report(f"ssd_scan bf16 Bt {bt} L 1024 H 24 P 64 N 128 chunk 256",
               lambda: ssd_ops.ssd_scan(*args, 256), torch,
               devtime.EXPECT["ssd_scan_bf16"])

    gemma2_library(dev, torch)
    d128_library(dev, torch)
    d128_library(dev, torch, {"kimi-k2-1t-a32b": K2_HEADS})


if __name__ == "__main__":
    main()
