#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

Run from the root of the repository (it imports ``src/repro_torch``):

    python3 chip_smoke.py [--out results.json]

Phases, each fatal on failure:

1. the card's name and power limit, torch and CUDA versions; build the
   kernel library from ``src/repro_torch/kernels/csrc`` and time it;
2. each CUDA kernel against its plain torch version on the card, at the
   main path's shapes (exact equality), with kernel, plain-version and
   library-call times (median of CUDA-event timings) and the kernel's
   memory/compute bound;
3. the main path: ``rank_list_with_stats`` on List(2^24, gamma=1) over 16
   virtual PEs with both kernels on — exact against the sequential
   oracle, both kernels launched (counts reset just before the solve),
   then the same instance with float32 0/1 weights, then a warm rerun
   with per-stage wall times;
4. the same solve with both kernels off: identical outputs and counters;
5. two-hop grid routing: n = 2^20 on a 4x4 virtual mesh, kernels on.

The last line of standard output is a one-line JSON verdict; the line
before it lists each kernel's launches and times. Without CUDA, or
without the repository next to it, the script exits non-zero and prints
no verdict.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: NVIDIA H100 SXM data-sheet peaks (at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_MAIN, P_MAIN, SEED = 1 << 24, 16, 0
N_GRID = 1 << 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, torch, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(a, b, torch) -> float:
    if torch.equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository")
    sys.path.insert(0, str(SRC))
    run(torch.device("cuda", 0), N_MAIN, N_GRID, args.out)


def run(dev, n_main: int, n_grid: int, out_path=None) -> None:
    """Phases 1-5 on device ``dev`` at ``n_main`` / ``n_grid`` elements."""
    import torch
    from repro_torch.core.listrank import (IndirectionSpec, ListRankConfig,
                                           instances, rank_list_seq,
                                           rank_list_with_stats, sim_mesh)
    from repro_torch.core.listrank import api, exchange, local
    from repro_torch.kernels import build
    from repro_torch.kernels.local_chase import ops as lc_ops, ref as lc_ref
    from repro_torch.kernels.mailbox_pack import ops as mp_ops
    from repro_torch.kernels.mailbox_pack import ref as mp_ref

    results: dict = {}

    # ---------------------------------------------------------- phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    build.load_library()
    results["build_s"] = time.time() - t0
    log(f"phase 1: kernel library built and loaded in "
        f"{results['build_s']:.1f} s")
    log(build.build_info.get("log", "(library found prebuilt)"))

    # the main path's instance and capacities (host side)
    t0 = time.time()
    succ_np, rank_np = instances.gen_list(n_main, gamma=1.0, seed=1)
    s_ref, r_ref = rank_list_seq(succ_np, rank_np)
    log(f"instance List({n_main}, gamma=1) and its oracle: "
        f"{time.time() - t0:.1f} s on the host")
    m = n_main // P_MAIN
    mesh = sim_mesh(P_MAIN)
    plan = exchange.MeshPlan.from_mesh(mesh, ("pe",), device=dev)
    cfg_on = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    owners = np.arange(n_main) // m
    term_bound = int(np.bincount(owners[succ_np == np.arange(n_main)],
                                 minlength=P_MAIN).max())
    spec0 = api.build_specs(cfg_on, plan, m, n_main, term_bound)[0]

    # ---------------------------------------------------------- phase 2
    kernels = []
    succ_d = torch.from_numpy(succ_np).reshape(P_MAIN, m).to(dev)
    rank_d = torch.from_numpy(rank_np).reshape(P_MAIN, m).to(dev)
    base = plan.my_id() * m
    succ_l, dist0, steps, _ = local.chase_input(succ_d, rank_d, base, m)
    errs, times = [], {}
    for dt in (torch.int32, torch.float32):
        d = dist0.to(dt).contiguous()
        s_k, d_k = lc_ops.local_chase(succ_l, d, steps)
        s_p, d_p = lc_ref.local_chase_ref(succ_l, d, steps)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_p) and torch.equal(
                d_k.view(torch.int32), d_p.view(torch.int32))):
            fail(f"local_chase ({dt}) differs from its plain version")
        errs.append(max(max_abs_err(s_k, s_p, torch),
                        max_abs_err(d_k, d_p, torch)))
        times[dt] = (time_ms(lambda: lc_ops.local_chase(succ_l, d, steps),
                             torch),
                     time_ms(lambda: lc_ref.local_chase_ref(succ_l, d, steps),
                             torch))
        log(f"phase 2: local_chase {dt} B={P_MAIN} m={m} steps={steps}: "
            f"equal; kernel {times[dt][0]:.3f} ms, plain {times[dt][1]:.3f} ms")
    elems = P_MAIN * m
    lc_bound, lc_by = bound_ms(16 * elems, steps * elems)
    log(f"local_chase bound (inputs read once, outputs written once): "
        f"{lc_bound:.4f} ms by {lc_by}; per-step traffic model "
        f"(24 B/element/step): {24 * elems * steps / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms")
    kernels.append({
        "name": "local_chase", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/local_chase.cu",
        "replaces": "src/repro/kernels/local_chase/kernel.py:27",
        "launches": 0, "max_abs_err": max(errs),
        "ms": times[torch.int32][0], "plain_ms": times[torch.int32][1],
        "ms_float32": times[torch.float32][0],
        "plain_ms_float32": times[torch.float32][1],
        "bound_ms": lc_bound, "bound_by": lc_by, "library_ms": None})

    # one chase-round hop at level 0: Q = queue + inbox + spawn window
    s_hop = P_MAIN
    cap = spec0.mail_caps[0]
    n_rows = s_hop * cap
    q = spec0.queue_cap + n_rows + spec0.spawn_window
    g = torch.Generator(device=dev).manual_seed(7)
    valid = torch.rand((P_MAIN, q), device=dev, generator=g) < (
        spec0.r_static / q)
    target = torch.randint(0, n_main, (P_MAIN, q), device=dev, generator=g,
                           dtype=torch.int32)
    payload = {"target": target,
               "ruler": torch.randint(0, n_main, (P_MAIN, q), device=dev,
                                      generator=g, dtype=torch.int32),
               "weight": torch.rand((P_MAIN, q), device=dev, generator=g),
               "_dest": (target // m).to(torch.int32)}
    order, row, col, fits, _, _ = exchange._bucket_indices(
        payload["_dest"], valid, s_hop, cap)
    slots = exchange.unpermute(order, row * cap + col).to(
        torch.int32).contiguous()
    wf = exchange.WireFormat.from_payload(payload)
    cols = [c.contiguous() for c in wf.columns(payload, valid)]
    out_k = mp_ops.mailbox_pack(cols, slots, n_rows)
    out_p = mp_ref.mailbox_pack_ref(cols, slots, n_rows)
    torch.cuda.synchronize()
    if not torch.equal(out_k, out_p):
        fail("mailbox_pack differs from its plain version")
    w = len(cols)
    stacked = torch.stack(cols, 1)
    keep = (slots >= 0) & (slots < n_rows)
    lib_idx = (torch.arange(P_MAIN, device=dev)[:, None, None],
               torch.arange(w, device=dev)[None, :, None],
               torch.where(keep, slots, n_rows).long()[:, None, :])
    lib_buf = torch.empty((P_MAIN, w, n_rows + 1), dtype=torch.int32,
                          device=dev)

    def library_call():
        lib_buf.zero_()
        lib_buf.index_put_(lib_idx, stacked)

    library_call()
    if not torch.equal(lib_buf[:, :, :n_rows], out_p):
        fail("the index_put_ yardstick computes another function")
    mp_ms = time_ms(lambda: mp_ops.mailbox_pack(cols, slots, n_rows), torch)
    mp_plain = time_ms(lambda: mp_ref.mailbox_pack_ref(cols, slots, n_rows),
                       torch)
    mp_lib = time_ms(library_call, torch)
    mp_bound, mp_by = bound_ms(4 * P_MAIN * (w * n_rows + (w + 1) * q), 0)
    log(f"phase 2: mailbox_pack p={P_MAIN} W={w} Q={q} n_rows={n_rows} "
        f"shipping={int(fits.sum())}: equal; kernel {mp_ms:.3f} ms, plain "
        f"{mp_plain:.3f} ms, zero fill + index_put_ {mp_lib:.3f} ms, "
        f"bound {mp_bound:.4f} ms")
    kernels.append({
        "name": "mailbox_pack", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mailbox_pack.cu",
        "replaces": "src/repro/kernels/mailbox_pack/kernel.py:30",
        "launches": 0, "max_abs_err": max_abs_err(out_k, out_p, torch),
        "ms": mp_ms, "plain_ms": mp_plain, "bound_ms": mp_bound,
        "bound_by": mp_by, "library_ms": mp_lib})
    del valid, target, payload, order, row, col, fits, cols, out_k, out_p
    del stacked, lib_buf, lib_idx, succ_l, dist0

    # ---------------------------------------------------------- phase 3
    def solve(rank, cfg, mesh=mesh, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s, r, st = rank_list_with_stats(succ_np, rank, mesh, cfg=cfg,
                                        seed=SEED, device=dev, **kw)
        torch.cuda.synchronize()
        return s, r, st, time.perf_counter() - t

    def check_oracle(s, r, s_ref, r_ref, what):
        if not (np.array_equal(s.cpu().numpy(), s_ref)
                and r.cpu().numpy().tobytes() == r_ref.tobytes()):
            fail(f"{what}: output differs from the sequential oracle")

    lc_ops.local_chase.launches = 0
    mp_ops.mailbox_pack.launches = 0
    s_on, r_on, st_on, wall_cold = solve(rank_np, cfg_on)
    launches = {"local_chase": lc_ops.local_chase.launches,
                "mailbox_pack": mp_ops.mailbox_pack.launches}
    check_oracle(s_on, r_on, s_ref, r_ref, "main path (int32)")
    ints_on = {k: v for k, v in st_on.items() if isinstance(v, int)}
    log(f"phase 3: n={n_main} p={P_MAIN} kernels on: exact; attempts "
        f"{st_on['attempts']}, scales_log {st_on['scales_log']}")
    log(f"  counters {ints_on}")
    log(f"  launches {launches}; cold wall {wall_cold:.3f} s")
    if launches["local_chase"] < 1:
        fail("local_chase was not launched on the main path")
    # every PE counts each chase round; the post stage sums over PEs
    rounds = st_on["rounds"] // P_MAIN
    if launches["mailbox_pack"] < rounds:
        fail(f"mailbox_pack launched {launches['mailbox_pack']} times for "
             f"{rounds} chase rounds")
    for kern in kernels:
        kern["launches"] = launches[kern["name"]]

    rank_f = rank_np.astype(np.float32)  # 0/1 weights: sums < 2^24, exact
    s_ref_f, r_ref_f = rank_list_seq(succ_np, rank_f)
    s_f, r_f, st_f, _ = solve(rank_f, cfg_on)
    check_oracle(s_f, r_f, s_ref_f, r_ref_f, "main path (float32 0/1)")
    log("phase 3: float32 0/1 weights: exact")

    s_w, r_w, st_w, wall_warm = solve(rank_np, cfg_on)
    check_oracle(s_w, r_w, s_ref, r_ref, "main path (warm rerun)")
    results["main_path"] = {
        "n": n_main, "p": P_MAIN, "cold_wall_s": wall_cold,
        "warm_wall_s": wall_warm, "stage_wall_s": dict(st_w["stage_wall_s"]),
        "counters": ints_on, "launches": launches}
    log(f"phase 3: warm wall {wall_warm:.3f} s; per stage "
        + ", ".join(f"{k} {v:.3f} s" for k, v in st_w["stage_wall_s"]))

    # ---------------------------------------------------------- phase 4
    cfg_off = ListRankConfig(use_pallas=False, use_pallas_pack=False)
    s_off, r_off, st_off, wall_off = solve(rank_np, cfg_off)
    ints_off = {k: v for k, v in st_off.items() if isinstance(v, int)}
    if not (torch.equal(s_off, s_on) and torch.equal(r_off, r_on)):
        fail("kernels off: outputs differ from the kernels-on solve")
    if ints_off != ints_on:
        fail(f"kernels off: counters differ: {ints_off} vs {ints_on}")
    results["main_path"]["kernels_off_wall_s"] = wall_off
    log(f"phase 4: kernels off: identical outputs and counters; wall "
        f"{wall_off:.3f} s; per stage "
        + ", ".join(f"{k} {v:.3f} s" for k, v in st_off["stage_wall_s"]))

    # ---------------------------------------------------------- phase 5
    succ_g, rank_g = instances.gen_list(n_grid, gamma=1.0, seed=2)
    s_ref_g, r_ref_g = rank_list_seq(succ_g, rank_g)
    grid = sim_mesh((4, 4), ("row", "col"))
    s_g, r_g, st_g = rank_list_with_stats(
        succ_g, rank_g, grid, cfg=cfg_on, seed=SEED, device=dev,
        indirection=IndirectionSpec.grid(("row", "col")))
    check_oracle(s_g, r_g, s_ref_g, r_ref_g, "two-hop grid routing")
    log(f"phase 5: n={n_grid} on a 4x4 grid, two hops, kernels on: exact; "
        f"rounds {st_g['rounds']}, attempts {st_g['attempts']}")

    results["card"] = card
    results["kernels"] = kernels
    if out_path:
        pathlib.Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(out_path).write_text(json.dumps(results, indent=1))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
