"""Serving demo on the PyTorch port: continuous batching over
heterogeneous requests (the port of ``examples/serve_demo.py``).

  PYTHONPATH=src python examples/torch_serve_demo.py [--kernels] \\
      [--device cpu]

Spins up the serving engine on a smoke-size gemma2-family model
(sliding-window + softcap attention exercised in the decode path),
submits a burst of requests larger than the slot pool, and reports
throughput + per-request latency percentiles. Sampling is greedy; a
temperature above 0 samples from the engine's seeded ``generator``
(the engine takes no PRNG key per tick). ``--kernels`` sends attention
through ``flash_attention`` (its plain version on the CPU). Runs on the
CUDA device unless ``--device`` says otherwise. :func:`serve` is the
demo's body, which ``chip_smoke.py`` phase 22 calls at full width.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import (Request, ServeConfig,  # noqa: E402
                                      ServingEngine)


def demo_requests(vocab_size: int) -> list:
    """The demo's 10 requests with prompts of 4..47 tokens, drawn from
    ``default_rng(0)`` as the reference example draws them."""
    rng = np.random.default_rng(0)
    out = []
    for uid in range(10):
        plen = int(rng.integers(4, 48))
        out.append(Request(uid=uid, prompt=rng.integers(
            2, vocab_size, plen).astype(np.int32)))
    return out


def serve(cfg, scfg: ServeConfig, requests, device, params=None,
          on_engine=None) -> dict:
    """Serve ``requests`` through an engine of ``scfg`` with ``cfg``
    (``params``, or random weights from seed 0) on ``device``; print and
    return the throughput and latency figures with every request's
    tokens. ``on_engine(engine)`` runs before the first tick (a caller's
    timers)."""
    if params is None:
        params = M.init(cfg, torch.Generator(device).manual_seed(0), device)
    eng = ServingEngine(params, cfg, scfg, device=device)
    if on_engine is not None:
        on_engine(eng)
    t_submit, t_done = {}, {}
    for req in requests:
        eng.submit(req)
        t_submit[req.uid] = time.time()

    done_before = set()
    t0 = time.time()
    ticks = 0
    while eng.queue or eng.active.any():
        eng.step()
        ticks += 1
        active = {eng.uid[s] for s in range(scfg.slots) if eng.active[s]}
        finished = {u for u, v in eng.out.items()
                    if v and u not in done_before and u not in active}
        for u in finished:
            t_done[u] = time.time()
        done_before |= finished
    dt = time.time() - t0
    total = sum(len(v) for v in eng.out.values())
    lats = sorted(t_done.get(u, time.time()) - t_submit[u] for u in t_submit)
    p50, p90 = lats[len(lats) // 2], lats[int(len(lats) * 0.9)]
    print(f"requests: {len(eng.out)}  tokens: {total}  wall: {dt:.2f}s  "
          f"throughput: {total / dt:.1f} tok/s")
    print(f"latency p50/p90: {p50:.2f}s / {p90:.2f}s  ticks: {ticks}")
    return {"out": {u: list(v) for u, v in eng.out.items()}, "ticks": ticks,
            "tokens": total, "wall_s": dt, "tokens_per_s": total / dt,
            "p50_s": p50, "p90_s": p90}


def main(argv=None, params=None) -> dict:
    """Run the demo on gemma2-2b's SMOKE config; ``params`` replaces the
    random weights (e.g. the JAX package's, ``params.from_reference``)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="attention through flash_attention")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = configs.get_config("gemma2-2b", smoke=True).with_(
        use_kernels=args.kernels)
    scfg = ServeConfig(slots=4, max_seq=192, max_new_tokens=24,
                       temperature=0.0)
    return serve(cfg, scfg, demo_requests(cfg.vocab_size), device,
                 params=params)


if __name__ == "__main__":
    main()
