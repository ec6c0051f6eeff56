"""Distributed tree statistics via the treealg subsystem, on the PyTorch
port (the port of ``examples/tree_stats.py``).

  PYTHONPATH=src python examples/torch_tree_stats.py [--kernels] \\
      [--device cpu]

Builds a forest of five random trees of mixed size and model, builds the
Euler tours on the device (two packed exchange rounds over 8 virtual
PEs), ranks both tour weightings in one batched solve, and reads depth,
subtree size, preorder and postorder for every node of every tree; then
re-roots the largest tree at its deepest node, and verifies everything
against a DFS oracle. ``--kernels`` turns on the ``local_chase`` and
``mailbox_pack`` kernels (the reference's defaults leave both off). Runs
on the CUDA device unless ``--device`` says otherwise.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core import treealg  # noqa: E402
from repro_torch.core.listrank import (ListRankConfig,  # noqa: E402
                                       instances, sim_mesh)
from repro_torch.device import resolve_device  # noqa: E402

#: the forest's tree sizes (the reference example's); virtual PEs (its 8
#: host devices)
SIZES = (257, 1024, 93, 511, 2048)
P = 8


def dfs_stats(parent: np.ndarray):
    """(depth, subtree size, preorder, postorder) of a rooted forest,
    children visited in ascending id order, without recursion."""
    n = len(parent)
    children = [[] for _ in range(n)]
    for c in range(n):
        if parent[c] != c:
            children[parent[c]].append(c)
    depth = np.zeros(n, np.int64)
    size = np.ones(n, np.int64)
    pre = np.zeros(n, np.int64)
    post = np.zeros(n, np.int64)
    for r in [c for c in range(n) if parent[c] == c]:
        n_pre = n_post = 0
        stack = [(r, 0, False)]
        while stack:
            u, d, done = stack.pop()
            if done:
                for v in children[u]:
                    size[u] += size[v]
                post[u] = n_post
                n_post += 1
                continue
            depth[u], pre[u] = d, n_pre
            n_pre += 1
            stack.append((u, d, True))
            stack.extend((v, d + 1, False) for v in reversed(children[u]))
    return depth, size, pre, post


def main(argv=None, perm_fn=None) -> dict:
    """Run the demo; returns the per-tree statistics (``TreeStats``), the
    re-rooted parent array and which tree and node it was rooted at.
    ``perm_fn`` supplies the ruler permutations of both solves (the
    port's own when None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="launch local_chase and mailbox_pack")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p = P
    mesh = sim_mesh(p)
    cfg = ListRankConfig(srs_rounds=2, local_contraction=True,
                         use_pallas=args.kernels,
                         use_pallas_pack=args.kernels)

    # a batch of independent trees of mixed size/model — the serving
    # scenario: many small queries, one solver invocation
    parents = [instances.gen_tree_parents(n, seed=i, locality=bool(i % 2))
               for i, n in enumerate(SIZES)]
    print(f"forest of {len(SIZES)} trees, {sum(SIZES)} nodes, p={p} on "
          f"{device}")

    stats_list = treealg.solve_forest(parents, mesh, cfg=cfg, device=device,
                                      perm_fn=perm_fn)
    solve = stats_list[0].stats
    print(f"one batched solve: attempts={solve['attempts']}, "
          f"chase rounds={solve['rounds'] // p}, "
          f"messages={solve['chase_msgs']}")
    for i, (q, st) in enumerate(zip(parents, stats_list)):
        d, s, pre, post = dfs_stats(q)
        assert np.array_equal(st.depth, d), f"depth mismatch tree {i}"
        assert np.array_equal(st.subtree_size, s), f"size mismatch {i}"
        assert np.array_equal(st.preorder, pre), f"preorder mismatch {i}"
        assert np.array_equal(st.postorder, post), f"postorder mismatch {i}"
        print(f"  tree {i}: n={q.shape[0]:5d} max depth={st.depth.max():3d} "
              f"mean subtree={st.subtree_size.mean():7.1f}  verified")

    # re-root the largest tree at its deepest node (edge orientation)
    big = int(np.argmax(SIZES))
    deepest = int(np.argmax(stats_list[big].depth))
    newp = treealg.root_tree(parents[big], deepest, mesh, cfg=cfg,
                             device=device, perm_fn=perm_fn)
    d2, _, _, _ = dfs_stats(newp)
    assert d2[deepest] == 0
    assert d2.max() >= stats_list[big].depth.max()
    print(f"re-rooted tree {big} at node {deepest}: new height {d2.max()} "
          f"(was {stats_list[big].depth.max()})  verified")
    print("tree_stats example OK")
    return {"forest": stats_list, "rerooted": np.asarray(newp),
            "big": big, "deepest": deepest}


if __name__ == "__main__":
    main()
