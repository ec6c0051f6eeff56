"""The plain references against sequential walks, at small sizes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import instances
from perfbench.reference import listrank, treestats


def walk_lists(succ, weight):
    """Each element's terminal and distance, one list at a time."""
    n = len(succ)
    pred = np.full(n, -1)
    for i in range(n):
        if succ[i] != i:
            pred[succ[i]] = i
    term = np.empty(n, np.int64)
    dist = np.empty(n, np.int64)
    for t in range(n):
        if succ[t] != t:
            continue
        d, i = 0, t
        while i != -1:
            term[i], dist[i] = t, d
            d += int(weight[pred[i]]) if pred[i] != -1 else 0
            i = pred[i]
    return term, dist


def walk_trees(parent):
    """Each node's statistics by a depth-first walk, children in
    ascending id order."""
    n = len(parent)
    kids = [[] for _ in range(n)]
    for c in range(n):
        if parent[c] != c:
            kids[parent[c]].append(c)
    out = {k: np.zeros(n, np.int64) for k in treestats.KEYS}
    for r in range(n):
        if parent[r] != r:
            continue
        pre = post = 0
        stack = [(r, 0, False)]
        while stack:
            v, d, done = stack.pop()
            if done:
                out["postorder"][v] = post
                post += 1
                out["size"][v] = 1 + sum(out["size"][c] for c in kids[v])
                continue
            out["root"][v], out["depth"][v] = r, d
            out["preorder"][v] = pre
            pre += 1
            stack.append((v, d, True))
            stack.extend((c, d + 1, False) for c in reversed(kids[v]))
    return out


@pytest.mark.parametrize("gamma,num_lists,seed", [
    (1.0, 1, 0), (0.5, 3, 1), (0.0, 2, 2), (1.0, 7, 2**33 + 5)])
def test_perfbench_list_reference_matches_walk(gamma, num_lists, seed):
    succ, rank = instances.gen_list(3000, gamma, seed=seed,
                                    num_lists=num_lists)
    rng = np.random.default_rng(seed)
    weight = np.where(succ != np.arange(succ.size),
                      rng.integers(-5, 100, succ.size), 0)
    for w in (rank, weight):
        term, dist = listrank.rank_list(torch.from_numpy(succ),
                                        torch.from_numpy(w))
        want_t, want_d = walk_lists(succ, w)
        assert np.array_equal(term.numpy(), want_t)
        assert np.array_equal(dist.numpy(), want_d)


@pytest.mark.parametrize("locality,num_trees,seed", [
    (False, 1, 0), (True, 1, 1), (False, 5, 2), (True, 9, 3)])
def test_perfbench_tree_reference_matches_walk(locality, num_trees, seed):
    parent = instances.gen_tree_parents(2500, seed=seed, locality=locality,
                                        num_trees=num_trees)
    got = treestats.tree_stats(torch.from_numpy(parent))
    want = walk_trees(parent)
    for k in treestats.KEYS:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_perfbench_references_refuse_a_cycle():
    with pytest.raises(ValueError):
        listrank.rank_list(torch.tensor([1, 2, 0, 3]),
                           torch.tensor([1, 1, 1, 0]))
    with pytest.raises(ValueError):
        treestats.tree_stats(torch.tensor([1, 0, 2]))
