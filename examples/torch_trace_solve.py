"""Flight recorder demo on the PyTorch port: one traced list-ranking
solve, end to end (the port of ``examples/trace_solve.py``).

  PYTHONPATH=src python examples/torch_trace_solve.py [trace.json] \\
      [--n 16384] [--p 8] [--device cpu]

Runs sparse-ruling-set over the virtual transport with the span tracer
attached and telemetry on, checks the result against the sequential
oracle, then prints what the observability layer produces for a solve:

  1. the span tree: prep/descend@k/base/ascend@k/post stage spans with
     their per-attempt children and wall times;
  2. the model-vs-measured residual table: each stage's measured wall
     beside its predicted time (alpha/beta under the active
     MachineModel, priced from the collectives the attempt made, counted
     at run time by ``CountingTransport``);
  3. the capacity headroom report and the measured-vs-modeled skew
     table: the telemetry plane's observed mailbox fill against the cap
     per stage, family and hop, and each hop's destination skew against
     the uniform model;
  4. the metrics registry: the solver's host stats as typed counters and
     gauges;

and writes a Chrome-trace-event JSON (open it at https://ui.perfetto.dev
or chrome://tracing). Runs on the CUDA device unless ``--device`` says
otherwise.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.listrank import (ListRankConfig, instances,  # noqa: E402
                                       rank_list_seq, rank_list_with_stats,
                                       sim_mesh)
from repro_torch.core.listrank.exchange import MeshPlan  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.obs import cost as cost_lib  # noqa: E402


def main(argv=None) -> dict:
    """Run the demo; returns the stats, the tracer and the trace's path."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="trace.json",
                    help="where the Chrome trace goes")
    ap.add_argument("--n", type=int, default=1 << 14)
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p, n = args.p, args.n
    succ, rank = instances.gen_list(n, gamma=1.0, seed=0)
    cfg = ListRankConfig(algorithm="srs", srs_rounds=2,
                         local_contraction=True, telemetry=True)
    mesh = sim_mesh(p)

    tracer = obs.Tracer(meta={"name": "trace_solve", "n": n, "p": p,
                              "device": str(device)})
    succ_out, rank_out, stats = rank_list_with_stats(
        succ, rank, mesh, cfg=cfg, seed=1, tracer=tracer, device=device)

    s_ref, r_ref = rank_list_seq(succ, rank)
    assert np.array_equal(np.asarray(succ_out.cpu()), s_ref)
    assert np.array_equal(np.asarray(rank_out.cpu()), r_ref)
    print(f"ranked n={n} on p={p} virtual PEs on {device} "
          f"({stats['attempts']} attempt(s)); matches the oracle\n")

    print("span tree:")
    for line in obs.span_tree_lines(tracer):
        print("  " + line)

    rows = obs.residual_rows(tracer)
    print()
    print(obs.format_residual_table(
        rows, title="model-vs-measured (§2.6, "
                    f"{cfg.machine.name} constants)"))
    summ = obs.residual_summary(rows)
    print(f"  total measured {summ['measured_s'] * 1e3:.2f}ms vs "
          f"predicted {summ['predicted_s'] * 1e6:.1f}us: large ratios "
          f"are expected here: the model prices network time on the "
          f"paper's machine, the measurement is one device's launches")

    tele = stats.get("telemetry", {})
    print()
    print(obs.format_headroom_table(tele.get("headroom", [])))

    plan = MeshPlan.from_mesh(mesh, tuple(mesh.axis_names))
    print()
    print(obs.format_skew_table(
        obs.skew_rows(cost_lib.hop_sizes_of(plan), tele.get("stages", [])),
        title="measured-vs-modeled destination skew (uniform model)"))

    print("\nmetrics registry:")
    for metric in sorted(tracer.metrics, key=lambda m: m.name):
        snap = metric.snapshot()
        snap.pop("help", None)
        print(f"  {metric.name:<40} {metric.kind:<9} {snap}")

    obs.write_chrome_trace(tracer, args.out)
    print(f"\nwrote {args.out}; open it at https://ui.perfetto.dev")
    return {"stats": stats, "tracer": tracer, "out": args.out}


if __name__ == "__main__":
    main()
