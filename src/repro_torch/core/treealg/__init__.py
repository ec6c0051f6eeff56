"""Euler-tour tree algorithms on top of distributed list ranking — the
port of ``repro.core.treealg``.

- :mod:`~repro_torch.core.treealg.euler` — device-side tour construction
  from a sharded parent array (two packed exchange rounds),
- :mod:`~repro_torch.core.treealg.ops` — ``root_tree``, ``node_depth``,
  ``subtree_size``, ``preorder``/``postorder`` via closed-form
  arc-position arithmetic over ranked tours,
- :mod:`~repro_torch.core.treealg.batch` — the batched multi-instance
  front door (``rank_lists`` / ``solve_forest``): B independent
  instances, one solve.
"""
from repro_torch.core.treealg.euler import build_tour, oracle_tour, tour_caps
from repro_torch.core.treealg.ops import (TreeStats, is_ancestor, node_depth,
                                          postorder, preorder, root_tree,
                                          roots_and_sizes, subtree_interval,
                                          subtree_size, tree_stats)
from repro_torch.core.treealg.batch import (pack_instances, rank_lists,
                                            rank_lists_with_stats,
                                            solve_forest, unpack_results)

__all__ = [
    "build_tour", "oracle_tour", "tour_caps",
    "TreeStats", "is_ancestor", "node_depth", "postorder", "preorder",
    "root_tree", "roots_and_sizes", "subtree_interval", "subtree_size",
    "tree_stats",
    "pack_instances", "rank_lists", "rank_lists_with_stats",
    "solve_forest", "unpack_results",
]
