"""The benchmark of the PyTorch and CUDA port: one run of one cell.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything that belongs to
one configuration, traffic mix or metric sits in a file of its own, found
by the name ``BENCHMARK.json`` gives it:

- ``perfbench/configs/<config>.json``: the deployment: the front door
  (``path``), the PEs and ranks, the solver's settings;
- ``perfbench/paths/<path>.py``: how the instance is drawn from the
  traffic file and ``--seed`` (``make``), how a call of that front door
  is made, what of its outputs is kept, and how they are held to the
  reference;
- ``perfbench/traffic/<traffic>.json``: the instance's parameters;
- ``perfbench/metrics/<metric>.py``: ``read(ctx)`` of one metric, or None
  when the run holds nothing for it to read.

A run builds the port's CUDA library in the checkout (its seconds are
the line's ``build_s``, within ``setup_s``), makes the instance,
makes one untimed warm call, then with ``--trace 0`` runs whole calls back
to back until ``--seconds`` have passed (the window ends with its last
call), and with ``--trace 1`` one call with the solver's counters and
tracer and then profiler windows of one call each. After the window it
holds what the calls returned to the plain reference, and prints one JSON
line. A configuration with ``ranks`` > 1 runs one process a card over
``torch.distributed``; the parent builds the library before it spawns
them.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import socket
import sys
import time

import numpy as np

from perfbench import devtrace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no process of a run may hold: JAX and the
#: JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: elements of each list call's outputs kept for the check, drawn from
#: the seed (the last call of a window is kept whole)
SAMPLE = 1 << 20
#: profiler windows a traced run tries before it gives up
WINDOWS = 5
#: characters of a device operation's name kept in the breakdown
NAME_CHARS = 120
#: torch's intra-op threads in each process of a run
THREADS = 4


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of the loaded modules that :data:`FORBIDDEN`
    holds, compared whole: ``repro_torch`` is not ``repro``."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def seed_u64(seed: int) -> int:
    """A non-negative 64-bit seed for numpy from any whole number."""
    return seed & ((1 << 64) - 1)


def load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(name: str, root: pathlib.Path = ROOT) -> dict:
    """Everything a run of cell ``name`` needs, from ``BENCHMARK.json``
    and the files it names: the workload, its configuration and traffic,
    and the metrics it reports with and without ``--trace``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]
    return {
        "cell": cell,
        "root": str(root),
        "config": load_json(root / config["file"]),
        "traffic": load_json(root / "perfbench" / "traffic"
                             / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def read_metrics(metrics: list[dict], ctx: dict, root=ROOT) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader
    (``perfbench/metrics/<name>.py`` under ``root``) finds something to
    read in ``ctx``."""
    out = {}
    for m in metrics:
        reader = load_module(
            pathlib.Path(root) / "perfbench" / "metrics" / f"{m['name']}.py",
            f"perfbench_metric_{m['name']}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


class Rank:
    """One process's part of a run: its card (or the CPU in the tests),
    its share of the mesh, the front door's program, and the instance."""

    def __init__(self, spec: dict, seed: int, device, rank: int = 0,
                 world: int = 1, variant: str = "Program"):
        import torch
        self.torch = torch
        self.spec = spec
        self.device, self.rank, self.world = device, rank, world
        self.call_s: list[float] = []  # each timed call's wall seconds
        cfg = spec["config"]
        self.path = load_module(
            pathlib.Path(spec["root"]) / "perfbench" / "paths"
            / f"{cfg['path']}.py", f"perfbench_path_{cfg['path']}")
        from repro_torch.core.listrank import dist_mesh, sim_mesh
        mesh = dist_mesh(cfg["pes"]) if world > 1 else sim_mesh(cfg["pes"])
        self.inst, self.units = self.path.make(spec["traffic"],
                                               seed_u64(seed))
        # "Program" is the system under test; "Control" (control.py)
        # the path's control in its place
        self.program = getattr(self.path, variant)(self.inst, mesh, cfg,
                                                   device)
        rng = np.random.default_rng([seed_u64(seed), 1])
        self.sample_idx = self.path.sample_index(self.units, SAMPLE, rng,
                                                 device)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def agree(self, flag: bool, op: str = "min") -> bool:
        """``flag`` agreed over the ranks: every rank's (min) or rank
        0's (``op="rank0"``)."""
        if self.world == 1:
            return flag
        import torch.distributed as dist
        t = self.torch.tensor([int(flag)], device=self.device)
        if op == "rank0":
            dist.broadcast(t, 0)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return bool(t.item())

    def reduce(self, values: list[float], op: str) -> list[float]:
        """``values`` summed or maxed over the ranks."""
        if self.world == 1:
            return list(values)
        import torch.distributed as dist
        t = self.torch.tensor(values, dtype=self.torch.float64,
                              device=self.device)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op])
        return t.tolist()

    def warm(self) -> None:
        out, _ = self.program.call()
        self.sync()
        del out

    def timed(self, seconds: float):
        """Whole calls back to back until ``seconds`` have passed: (kept
        outputs, the last call's whole outputs, calls, window seconds,
        the error that stopped the window or None)."""
        kept, last, calls, error = [], None, 0, None
        self.sync()
        self.agree(True)  # every rank starts the window together
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            try:
                out, _ = self.program.call()
                self.sync()
            except Exception as e:  # a failed call ends the window
                error = f"{type(e).__name__}: {e}"
                calls += 1
                break
            calls += 1
            self.call_s.append(time.perf_counter() - t)
            kept.append(self.path.sample(out, self.sample_idx))
            go = time.perf_counter() - t0 < seconds
            if not self.agree(go, op="rank0"):
                last = out
                break
            del out
        return kept, last, calls, time.perf_counter() - t0, error

    def traced(self):
        """One call with the solver's counters, the tracer and every
        ``mailbox_pack`` launch recorded, then profiler windows of one
        call each until one passes the launch and repeat checks on every
        rank: (kept, last, calls, reader context)."""
        from repro_torch import obs
        from repro_torch.kernels.mailbox_pack import ops as mp_ops
        torch = self.torch
        tracer = obs.Tracer()
        with devtrace.PackRecorder(torch) as rec:
            out, stats = self.program.call(tracer=tracer)
            self.sync()
            pack = {"bound_ms": rec.bound_ms(), "launches": rec.launches}
        kept = [self.path.sample(out, self.sample_idx)]
        del out
        ctx = {"stats": stats, "tracer": tracer, "pes": self.spec["config"]
               ["pes"], "pack": pack, "window": None}
        want: dict = {}

        def named(events):
            if not events:
                return "no device events"
            if devtrace.complete(events, want):
                return None
            return (f"kernels seen {devtrace.kernel_counts(events, want)} "
                    f"of {want}")
        check = devtrace.repeat_check(named)
        calls, last = 1, None
        for w in range(WINDOWS):
            before = mp_ops.LAUNCHES
            (out, _), dev_ev, host_ev, span, wall = devtrace.window(
                self.program.call, torch, self.device)
            calls += 1
            want.clear()
            want["mailbox_pack_kernel"] = mp_ops.LAUNCHES - before
            missed = check(dev_ev)
            ok = self.agree(missed is None)
            kept.append(self.path.sample(out, self.sample_idx))
            if missed is not None:
                log(f"profiler window {w + 1} not read: {missed}")
            # the whole outputs of the last window's call are checked
            last = out if ok or w + 1 == WINDOWS else None
            del out
            busy = devtrace.busy_intervals(dev_ev)
            ctx["window"] = {
                "events": dev_ev, "span": span, "wall_s": wall,
                "busy_s": sum(b - a for a, b in busy) / 1e6,
                "gaps": devtrace.idle_gaps(busy, host_ev, span),
                "launches": dict(want), "accepted": ok}
            if ok:
                break
        return kept, last, calls, ctx

    def check(self, kept, last) -> dict:
        """{name: {"value", "limit"}} of every number compared with the
        reference, summed over the ranks."""
        numbers = self.path.check(self.inst, kept, last, self.sample_idx,
                                  self.device)
        names = sorted(numbers)
        totals = self.reduce([float(numbers[k][0]) for k in names], "sum")
        return {k: {"value": v, "limit": numbers[k][1]}
                for k, v in zip(names, totals)}


def run_rank(spec: dict, seed: int, seconds: float, trace: bool,
             t_start: float, device, rank: int = 0, world: int = 1,
             variant: str = "Program", warm: bool = True) -> dict:
    """One rank's run: set-up, the window, the check. Rank 0's dict holds
    the result line; every rank's holds the forbidden modules it saw."""
    import torch
    torch.set_num_threads(THREADS)
    if device.type == "cuda":
        torch.zeros(1, device=device)  # the allocator's stats exist from here
    r = Rank(spec, seed, device, rank, world, variant)
    kept, last, calls, error, ctx = [], None, 0, None, {}
    try:
        if warm:
            r.warm()
    except Exception as e:  # a program that fails its warm call is wrong
        error, calls = f"{type(e).__name__}: {e}", 1
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_first = time.time()
    if error is None and trace:
        try:
            kept, last, calls, ctx = r.traced()
        except Exception as e:
            error, calls = f"{type(e).__name__}: {e}", calls + 1
    elif error is None:
        kept, last, calls, window_s, error = r.timed(seconds)
        ctx = {"window_s": window_s}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    found = forbidden_modules()
    ctx.update(units=r.units, calls=calls, setup_s=t_first - t_start,
               peak_bytes=r.reduce([peak], "max")[0])
    checks = r.check(kept, last) if error is None else {}
    del kept, last
    failed = int(error is not None or any(
        c["value"] > c["limit"] for c in checks.values()))
    failed = int(r.reduce([failed], "max")[0])
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": world, "memory_peak_bytes": int(ctx["peak_bytes"])}
    result = {"correct": failed == 0, "attempted": calls, "failed": failed,
              "metrics": {}, "device": device_info,
              "call_s": r.call_s}
    if error is not None:
        log(f"a call failed: {error}")
    elif trace:
        win = ctx["window"]
        busy, wall = r.reduce([win["busy_s"], win["wall_s"]], "sum")
        device_info["busy_s"] = busy / world
        device_info["window_s"] = wall / world
        top = sorted(devtrace.per_name(win["events"]).items(),
                     key=lambda kv: -kv[1][1])[:10]
        result["breakdown"] = {
            "device_ops": [[k[:NAME_CHARS], us / 1e6] for k, (_, us) in top],
            "idle_gaps": win["gaps"]}
        if not win["accepted"]:
            log("no profiler window passed its checks: the device "
                "metrics are not measured")
        result["metrics"] = read_metrics(spec["per_layer"], ctx,
                                         spec["root"])
    else:
        result["metrics"] = read_metrics(spec["end_to_end"], ctx,
                                         spec["root"])
    result["checks"] = {k: {"value": _number(c["value"]),
                            "limit": c["limit"]} for k, c in checks.items()}
    return {"rank": rank, "forbidden": found,
            "result": result if rank == 0 else None}


def _number(x: float):
    return int(x) if float(x).is_integer() else x


def _rank_main(rank, world, port, backend, device_type, spec, seed, seconds,
               trace, t_start, queue, prelude, variant, warm):
    """A spawned rank: join the group, run, hand the result to the
    parent."""
    import torch
    import torch.distributed as dist
    if prelude is not None:
        prelude()
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        out = run_rank(spec, seed, seconds, trace, t_start, device, rank,
                       world, variant, warm)
    except BaseException as e:
        queue.put({"rank": rank, "error": f"{type(e).__name__}: {e}"})
        raise
    finally:
        dist.destroy_process_group()
    queue.put(out)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(spec, seed, seconds, trace, t_start, world, backend,
              device_type="cuda", prelude=None, variant="Program",
              warm=True, timeout=330.0) -> list[dict]:
    """Spawn ``world`` ranks, wait for each, stop any that is left."""
    import multiprocessing as mp
    import queue as queue_lib
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, port, backend, device_type, spec, seed, seconds, trace,
        t_start, q, prelude, variant, warm)) for r in range(world)]
    for p in procs:
        p.start()
    outs, deadline = [], time.time() + timeout
    try:
        while len(outs) < world:
            try:
                out = q.get(timeout=max(1.0, deadline - time.time()))
            except queue_lib.Empty:
                raise RuntimeError("a rank gave no result in time")
            if "error" in out:
                raise RuntimeError(f"rank {out['rank']}: {out['error']}")
            outs.append(out)
    finally:
        for p in procs:
            p.join(timeout=30)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return sorted(outs, key=lambda o: o["rank"])


def run_cell(spec, seed, seconds, trace, t_start, device_type="cuda",
             prelude=None, variant="Program", warm=True) -> dict:
    """The result line of one run (or raises), on the card or, for the
    tests, on the CPU. ``prelude`` runs first in each spawned rank (the
    tests break the program there); ``variant`` and ``warm`` are
    control.py's."""
    cfg = spec["config"]
    world = cfg["ranks"]
    if world == 1:
        import torch
        device = (torch.device("cuda", 0) if device_type == "cuda"
                  else torch.device("cpu"))
        outs = [run_rank(spec, seed, seconds, trace, t_start, device,
                         variant=variant, warm=warm)]
    else:
        backend = cfg["backend"] if device_type == "cuda" else "gloo"
        outs = run_ranks(spec, seed, seconds, trace, t_start, world,
                         backend, device_type, prelude, variant, warm)
    found = sorted({m for o in outs for m in o["forbidden"]}
                   | set(forbidden_modules()))
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: "
                           f"{found}")
    return outs[0]["result"]


def emit(result: dict) -> None:
    """The checks as the last lines of standard error, then the result
    as the last line of standard output (its ``checks`` key last)."""
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']:g} (limit {c['limit']:g})")
    print(json.dumps(result), flush=True)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    import torch
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card")
        return 2
    if torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} cards, {torch.cuda.device_count()} "
            f"seen")
        return 2
    # built once, here, before any rank needs it
    from repro_torch.kernels import build
    t_build = time.time()
    build.build()
    build_s = time.time() - t_build
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      t_start)
    checks = result.pop("checks")
    result.update(build_s=build_s, checks=checks)
    emit(result)
    return 0
