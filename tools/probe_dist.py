#!/usr/bin/env python3
"""What ``torch.distributed`` does on one CUDA card: the facts the
distributed transport (``repro_torch.core.listrank.transport.
DistTransport``) rests on.

Run from the root of the repository on a machine with one card:

    python3 tools/probe_dist.py

It prints, each in processes of its own that the parent joins with a
timeout:

1. gloo at world size 2 with CUDA tensors on the one card:
   ``all_to_all_single`` with unequal splits, an int32 ``all_reduce``
   that wraps, ``all_gather_into_tensor``, an empty ``all_to_all_single``
   and a bool one; each "ok" or the error it raised;
2. NCCL at world size 2 with both ranks on the one card: the error (or
   the hang) of its first collective;
3. NCCL at world size 1: the same collectives as 1., and the device
   events (kernels, copies) a ``torch.profiler`` window sees for each.

Nothing of the list-ranking code runs here.
"""
from __future__ import annotations

import os
import queue as queue_lib
import subprocess
import sys
import tempfile
import time
import traceback

TIMEOUT_S = 120


def _collectives(dist, torch, dev, rank, world):
    """Run each collective once; {name: "ok" | error text}."""
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize(dev)
            out[name] = "ok"
        except Exception as exc:  # the probe reports every refusal
            out[name] = f"{type(exc).__name__}: {str(exc).splitlines()[0]}"

    def a2a_unequal():
        # rank r sends r + 1 + j rows to rank j
        send_splits = [rank + 1 + j for j in range(world)]
        recv_splits = [j + 1 + rank for j in range(world)]
        send = torch.arange(sum(send_splits), dtype=torch.int32,
                            device=dev) + 1000 * rank
        recv = torch.empty(sum(recv_splits), dtype=torch.int32, device=dev)
        dist.all_to_all_single(recv, send, recv_splits, send_splits)
        off = 0
        for j in range(world):
            want = torch.arange(sum(j + 1 + i for i in range(rank)),
                                sum(j + 1 + i for i in range(rank + 1)),
                                dtype=torch.int32, device=dev) + 1000 * j
            got = recv[off:off + recv_splits[j]]
            if not torch.equal(got, want):
                raise AssertionError(f"from rank {j}: {got.tolist()} "
                                     f"!= {want.tolist()}")
            off += recv_splits[j]

    def reduce_wrap():
        x = torch.full((4,), 2**31 - 1, dtype=torch.int32, device=dev)
        dist.all_reduce(x)
        want = ((2**31 - 1) * world + 2**31) % 2**32 - 2**31
        if x.tolist() != [want] * 4:
            raise AssertionError(f"{x.tolist()} != {[want] * 4}")

    def gather_into():
        x = torch.full((3, 2), rank, dtype=torch.int32, device=dev)
        out_t = torch.empty((3 * world, 2), dtype=torch.int32, device=dev)
        getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(
            out_t, x)
        want = torch.arange(world, device=dev, dtype=torch.int32
                            ).repeat_interleave(3)[:, None].expand(-1, 2)
        if not torch.equal(out_t, want):
            raise AssertionError(str(out_t.tolist()))

    def a2a_empty():
        e = torch.empty(0, dtype=torch.int32, device=dev)
        dist.all_to_all_single(e, e.clone(), [0] * world, [0] * world)

    def a2a_bool():
        send = torch.ones(world, dtype=torch.bool, device=dev)
        recv = torch.empty(world, dtype=torch.bool, device=dev)
        dist.all_to_all_single(recv, send)

    attempt("all_to_all_single unequal splits", a2a_unequal)
    attempt("all_reduce int32 wraps", reduce_wrap)
    attempt("all_gather_into_tensor", gather_into)
    attempt("all_to_all_single empty", a2a_empty)
    attempt("all_to_all_single bool", a2a_bool)
    return out


def _device_events(torch, fn):
    """Names of the device events of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type.name == "CUDA":
            names[ev.name] = names.get(ev.name, 0) + 1
    return names


def _rank(rank, world, backend, init, queue):
    if backend == "nccl" and world > 1:
        os.environ["NCCL_DEBUG"] = "WARN"  # NCCL's own reason, on stdout
    import torch
    import torch.distributed as dist
    res = {"rank": rank}
    try:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        res["collectives"] = _collectives(dist, torch, dev, rank, world)
        if backend == "nccl" and world == 1:
            x = torch.arange(1 << 20, dtype=torch.int32, device=dev)
            out = torch.empty_like(x)
            g = torch.empty(1 << 20, dtype=torch.int32, device=dev)
            res["events"] = {
                "all_to_all_single (1 MiB)": _device_events(
                    torch, lambda: dist.all_to_all_single(out, x)),
                "all_reduce int32 (1 MiB)": _device_events(
                    torch, lambda: dist.all_reduce(out)),
                "all_gather_into_tensor (1 MiB)": _device_events(
                    torch, lambda: dist.all_gather_into_tensor(g, x)),
                "all_to_all_single empty": _device_events(
                    torch, lambda: dist.all_to_all_single(
                        x[:0], x[:0].clone(), [0], [0])),
            }
        dist.destroy_process_group()
    except Exception as exc:  # a rank's error is the probe's finding
        res["error"] = "".join(traceback.format_exception_only(exc)).strip()
    queue.put(res)


def probe(backend: str, world: int) -> list[dict]:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank, args=(r, world, backend, init,
                                                 queue))
                 for r in range(world)]
        for pr in procs:
            pr.start()
        results, deadline = [], time.monotonic() + TIMEOUT_S
        while len(results) < world:
            try:
                results.append(queue.get(timeout=1.0))
            except queue_lib.Empty:
                dead = [pr.exitcode for pr in procs if pr.exitcode]
                if dead or time.monotonic() > deadline:
                    results.append({"error": f"a rank exited with {dead}"
                                    if dead else f"no result within "
                                    f"{TIMEOUT_S} s (hung)"})
                    break
        for pr in procs:
            pr.join(timeout=10)
            if pr.is_alive():
                pr.kill()
                pr.join()
    return sorted(results, key=lambda r: r.get("rank", world))


def main() -> None:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}")
    if not torch.cuda.is_available():
        print("probe_dist: no CUDA device", file=sys.stderr)
        sys.exit(1)
    nccl = ".".join(map(str, torch.cuda.nccl.version()))
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, nccl "
          f"{nccl}, devices {torch.cuda.device_count()}", flush=True)
    for backend, world in (("gloo", 2), ("nccl", 2), ("nccl", 1)):
        print(f"== {backend} at world size {world} on one card", flush=True)
        for res in probe(backend, world):
            print(f"  {res}", flush=True)


if __name__ == "__main__":
    main()
