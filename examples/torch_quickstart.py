"""Quickstart on the PyTorch port: rank a distributed list with the
paper's algorithm (the port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py [--n 65536] \\
      [--kernels] [--device cpu]

Builds the paper's List(n, gamma) instance, runs sparse-ruling-set with
spawning (2 rounds + pointer-doubling base case, local contraction on,
reversal avoided via the §2.5 postprocess) over a (2, 4) grid of 8
virtual PEs with two-hop grid indirection, verifies against the
sequential oracle, and prints the stats that reproduce the paper's
analytical predictions; then reruns with the parameters derived from the
§2.6 cost model (``ruler_fraction=None`` -> per-level r*,
``tuner.level_plan``). ``--kernels`` turns on the ``local_chase`` and
``mailbox_pack`` kernels (the reference's defaults leave both off). Runs
on the CUDA device unless ``--device`` says otherwise.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.listrank import (IndirectionSpec,  # noqa: E402
                                       ListRankConfig, analysis, instances,
                                       rank_list_seq, rank_list_with_stats,
                                       sim_mesh, tuner)
from repro_torch.device import resolve_device  # noqa: E402

#: virtual PEs (the reference example's 8 host devices)
P = 8


def main(argv=None, perm_fn=None) -> dict:
    """Run the demo; returns both runs' outputs (numpy), stats and the
    auto-tuned level plan's ruler fractions. ``perm_fn`` supplies the
    ruler permutations of both solves (the port's own when None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--kernels", action="store_true",
                    help="launch local_chase and mailbox_pack")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p, n = P, args.n
    mesh = sim_mesh((2, p // 2), ("row", "col"))
    grid = IndirectionSpec.grid(("row", "col"))
    print(f"ranking a {n}-element random list on {p} PEs "
          f"(grid indirection 2x{p // 2}) on {device}")
    succ, rank = instances.gen_list(n, gamma=1.0, seed=0)

    cfg = ListRankConfig(srs_rounds=2, local_contraction=True,
                         ruler_fraction=1 / 32, use_pallas=args.kernels,
                         use_pallas_pack=args.kernels)
    succ_out, rank_out, stats = rank_list_with_stats(
        succ, rank, mesh, cfg=cfg, indirection=grid, device=device,
        perm_fn=perm_fn)

    s_ref, r_ref = rank_list_seq(succ, rank)
    succ_out, rank_out = succ_out.cpu().numpy(), rank_out.cpu().numpy()
    assert np.array_equal(succ_out, s_ref)
    assert np.array_equal(rank_out, r_ref)
    print("matches the sequential oracle")

    r_total = p * max(4, int(n / p / 32))
    print(f"chase rounds:    {stats['rounds'] // p} "
          f"(paper predicts ~n/r+1 = {n / r_total + 1:.0f})")
    print(f"subproblem size: {stats['sub_size']} "
          f"(paper predicts ~r ln(n/r) = "
          f"{r_total * math.log(n / r_total):.0f})")
    print(f"chase messages:  {stats['chase_msgs']} "
          f"(2 hops x ~one per element)")
    r_star = analysis.r_star(n, p, 2, analysis.SUPERMUC)
    print(f"r* from the cost model (SuperMUC constants): {r_star}")

    # same run, parameters derived from the §2.6 cost model instead of
    # hand-set: ruler_fraction=None -> per-level r* (tuner.level_plan)
    auto = cfg.with_(ruler_fraction=None)
    plan = tuner.level_plan(auto, p, grid.depth, n)
    _, rank_auto, stats_auto = rank_list_with_stats(
        succ, rank, mesh, cfg=auto, indirection=grid, device=device,
        perm_fn=perm_fn)
    rank_auto = rank_auto.cpu().numpy()
    assert np.array_equal(rank_auto, r_ref)
    print(f"auto-tuned (ruler_fraction=None): level plan r* "
          f"{[lp.r_total for lp in plan]}; "
          f"rounds {stats_auto['rounds'] // p} vs {stats['rounds'] // p} "
          f"fixed, rulers {stats_auto['rulers']} vs {stats['rulers']}")
    return {"succ": succ_out, "rank": rank_out, "stats": stats,
            "rank_auto": rank_auto, "stats_auto": stats_auto,
            "level_fracs": [lp.frac for lp in plan], "r_star": r_star}


if __name__ == "__main__":
    main()
