"""The benchmark's instance generators: frozen copies of the port's.

``gen_list`` and ``gen_tree_parents`` are copied from
``repro_torch.core.listrank.instances`` as they stood when the benchmark
was written, so that a later change to the program cannot move the
inputs the benchmark measures it on. ``tests/test_perfbench_instances.py``
holds them equal to the port's at the same seed.

Both are the paper's §3 input families: List(n, gamma), an identity
chain with a gamma-fraction of labels permuted (gamma = 1: no locality),
and random rooted trees whose Euler tours mimic the GNM (random
attachment, no locality) and RGG2D (windowed attachment, index-close
arcs) BFS-tree instances.
"""
from __future__ import annotations

import numpy as np


def gen_list(n: int, gamma: float, seed: int = 0, num_lists: int = 1):
    """List(n, gamma) as (succ, rank) int32 arrays: succ[terminal] is
    the terminal itself, rank is 1 on every other element."""
    if not 0.0 <= gamma <= 1.0:
        raise ValueError("gamma must be in [0,1]")
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    rng = np.random.default_rng(seed)
    labels = np.arange(n, dtype=np.int64)
    k = int(round(gamma * n))
    if k > 1:
        pos = rng.choice(n, size=k, replace=False)
        labels[pos] = labels[rng.permutation(pos)]
    succ = np.empty(n, dtype=np.int64)
    succ[labels[:-1]] = labels[1:]
    succ[labels[-1]] = labels[-1]
    cuts = np.linspace(0, n, num_lists + 1).astype(np.int64)[1:]
    ends = cuts - 1
    ends = ends[(ends >= 0) & (ends < n)]
    succ[labels[ends]] = labels[ends]
    rank = (succ != np.arange(n)).astype(np.int64)
    return succ.astype(np.int32), rank.astype(np.int32)


def _random_tree_parents(n: int, rng: np.random.Generator,
                         locality: bool) -> np.ndarray:
    """parent[i] for i >= 1 (node 0 is the root): a uniformly random
    earlier node, or with ``locality`` one of the n / 64 nodes before."""
    parent = np.zeros(n, dtype=np.int64)
    if locality:
        window = max(1, n // 64)
        lo = np.maximum(0, np.arange(1, n) - window)
        parent[1:] = lo + (rng.random(n - 1)
                           * (np.arange(1, n) - lo)).astype(np.int64)
    else:
        parent[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    return parent


def gen_tree_parents(n_nodes: int, seed: int = 0, locality: bool = False,
                     num_trees: int = 1) -> np.ndarray:
    """A random rooted tree (or a forest of ``num_trees``) as a parent
    array with ``parent[root] == root``."""
    rng = np.random.default_rng(seed)
    parent = _random_tree_parents(n_nodes, rng, locality)
    if not 1 <= num_trees <= max(n_nodes, 1):
        raise ValueError("num_trees must be in [1, n_nodes]")
    if num_trees > 1:
        extra = rng.choice(np.arange(1, n_nodes), size=num_trees - 1,
                           replace=False)
        parent[extra] = extra
    return parent

