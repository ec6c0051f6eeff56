"""Euler-tour tree computations on top of distributed list ranking, on
the PyTorch port (the port of ``examples/euler_tour.py``).

  PYTHONPATH=src python examples/torch_euler_tour.py [--kernels] \\
      [--device cpu]

Generates a random tree of 4097 nodes, builds its Euler tour (one list
element per arc), ranks the tour with SRS over 8 virtual PEs, and
derives from the ranks alone each node's depth, each node's subtree size
and a rooting of the tree (parent pointers) w.r.t. node 0, checked
against a BFS.
``--kernels`` turns on the ``local_chase`` and ``mailbox_pack`` kernels
(the reference's defaults leave both off). Runs on the CUDA device
unless ``--device`` says otherwise.
"""
import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.listrank import (ListRankConfig,  # noqa: E402
                                       instances, rank_list_with_stats,
                                       sim_mesh)
from repro_torch.device import resolve_device  # noqa: E402

#: virtual PEs (the reference example's 8 host devices); the tree's nodes
P, N_NODES = 8, 4097


def bfs_depth(parent: np.ndarray) -> np.ndarray:
    """Depth of every node of the tree ``parent`` (root 0) by BFS."""
    adj = collections.defaultdict(list)
    for c in range(1, parent.shape[0]):
        adj[int(parent[c])].append(c)
    depth = np.zeros(parent.shape[0], np.int64)
    q = collections.deque([0])
    while q:
        u = q.popleft()
        for w in adj[u]:
            depth[w] = depth[u] + 1
            q.append(w)
    return depth


def main(argv=None, perm_fn=None) -> dict:
    """Run the demo; returns the tour's ranks, depth, subtree size and
    parent (numpy) and the solve's stats. ``perm_fn`` supplies the ruler
    permutations (the port's own when None)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="launch local_chase and mailbox_pack")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    p, n_nodes = P, N_NODES
    succ, rank, arcs = instances.gen_euler_tour(n_nodes, seed=3,
                                                locality=True)
    succ, rank = instances.pad_to_multiple(succ, rank, p)
    n_arcs = arcs.shape[0]
    print(f"tree with {n_nodes} nodes -> Euler tour of {n_arcs} arcs, "
          f"{p} PEs on {device}")

    cfg = ListRankConfig(srs_rounds=2, local_contraction=True,
                         use_pallas=args.kernels,
                         use_pallas_pack=args.kernels)
    _, rank_out, stats = rank_list_with_stats(
        succ, rank, sim_mesh(p), cfg=cfg, device=device, perm_fn=perm_fn)
    rank_out = rank_out.cpu().numpy()
    # rank = #arcs after this arc in the tour; position from the front:
    pos = (n_arcs - 1) - rank_out[:n_arcs].astype(np.int64)

    # arc ids: down(c) = 2(c-1), up(c) = 2(c-1)+1 (instances.py layout)
    c = np.arange(1, n_nodes)
    down_pos, up_pos = pos[2 * (c - 1)], pos[2 * (c - 1) + 1]
    # subtree size: arcs strictly between down(c) and up(c) are the
    # subtree's internal arcs: (up - down - 1) arcs = 2*(size-1)
    size = np.full(n_nodes, n_nodes, np.int64)
    size[1:] = (up_pos - down_pos - 1) // 2 + 1
    # depth: the number of down-arcs minus up-arcs up to and including
    # down(c) in tour order
    order = np.argsort(pos)
    depth_at = np.cumsum(np.where(order % 2 == 0, 1, -1))
    depth = np.zeros(n_nodes, np.int64)
    depth[1:] = depth_at[down_pos]
    # rooting: parent = the other endpoint of the down arc
    parent = np.zeros(n_nodes, np.int64)
    parent[1:] = arcs[2 * (c - 1), 0]

    assert np.array_equal(depth, bfs_depth(parent)), "depth mismatch"
    assert size[0] == n_nodes and (size >= 1).all()
    print(f"depth/subtree-size verified (max depth {depth.max()}, "
          f"mean subtree {size.mean():.1f})")
    print(f"list-ranking rounds: {stats['rounds'] // p}, "
          f"messages: {stats['chase_msgs']}")
    return {"rank": rank_out, "depth": depth, "size": size,
            "parent": parent, "stats": stats}


if __name__ == "__main__":
    main()
