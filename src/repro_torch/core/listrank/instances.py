"""Input-instance generators (paper §3, Input Instances).

All generators return ``(succ, rank)`` numpy arrays over ``n`` elements,
with terminals pointing to themselves and carrying weight 0. All are
fully vectorized (paper-scale instances, n >= 10^7, build in seconds);
``tests/test_instances.py`` keeps the original loop implementations as
the equality oracle.

- :func:`gen_list`: the paper's List(n/p, gamma) — an identity chain
  with a gamma-fraction of labels randomly permuted. gamma=0 gives each
  PE a contiguous sublist (perfect locality); gamma=1 a fully random
  permutation (no locality).
- :func:`gen_random_lists`: a forest of random lists (multi-list case).
- :func:`gen_euler_tour`: the Euler tour of a random tree (or, with
  ``num_trees``, a forest); two tree models mimic the paper's GNM (no
  locality) and RGG2D (high locality) BFS-tree instances, and
  ``weighted=True`` gives the ±1 depth weights consumed by
  ``repro.core.treealg``.
"""
from __future__ import annotations

import numpy as np


def _as_succ_dtype(a: np.ndarray) -> np.ndarray:
    return a.astype(np.int32)


def gen_list(n: int, gamma: float, seed: int = 0, num_lists: int = 1):
    """Paper instance List(n, gamma): chain succ[i]=i+1 with a random
    relabeling applied to a gamma-fraction of positions.

    ``num_lists`` splits the chain into that many independent lists by
    cutting at evenly spaced points (each cut creates a terminal).
    """
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
    # chain over labels: labels[j] -> labels[j+1], self-loop at cuts
    succ = np.empty(n, dtype=np.int64)
    succ[labels[:-1]] = labels[1:]
    succ[labels[-1]] = labels[-1]
    cuts = np.linspace(0, n, num_lists + 1).astype(np.int64)[1:]
    ends = cuts - 1
    ends = ends[(ends >= 0) & (ends < n)]
    succ[labels[ends]] = labels[ends]
    idx = np.arange(n)
    rank = (succ != idx).astype(np.int64)
    return _as_succ_dtype(succ), rank.astype(np.int32)


def gen_random_lists(n: int, num_lists: int, seed: int = 0, weighted: bool = False):
    """A forest of ``num_lists`` random lists over a random permutation."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    succ = np.empty(n, dtype=np.int64)
    cuts = np.sort(rng.choice(np.arange(1, n), size=num_lists - 1, replace=False)) if num_lists > 1 else np.array([], dtype=np.int64)
    bounds = np.concatenate([[0], cuts, [n]])
    # chain the whole permutation, then self-loop every segment end
    succ[perm[:-1]] = perm[1:]
    seg_ends = perm[bounds[1:].astype(np.int64) - 1]
    succ[seg_ends] = seg_ends
    idx = np.arange(n)
    if weighted:
        rank = rng.integers(0, 100, size=n).astype(np.int64)
        rank[succ == idx] = 0
    else:
        rank = (succ != idx).astype(np.int64)
    return _as_succ_dtype(succ), rank.astype(np.int32)


def _random_tree_parents(n: int, rng: np.random.Generator, locality: bool) -> np.ndarray:
    """parent[i] for i>=1; node 0 is the root.

    ``locality=False``: random attachment (GNM-BFS-like, no locality).
    ``locality=True``: attach to a recent node (RGG2D-BFS-like: tree
    edges connect index-close nodes, so a block-distributed Euler tour
    has high locality).
    """
    parent = np.zeros(n, dtype=np.int64)
    if locality:
        window = max(1, n // 64)
        lo = np.maximum(0, np.arange(1, n) - window)
        parent[1:] = lo + (rng.random(n - 1) * (np.arange(1, n) - lo)).astype(np.int64)
    else:
        parent[1:] = (rng.random(n - 1) * np.arange(1, n)).astype(np.int64)
    return parent


def gen_tree_parents(n_nodes: int, seed: int = 0, locality: bool = False,
                     num_trees: int = 1) -> np.ndarray:
    """A random rooted tree (or ``num_trees`` forest) as a parent array
    with ``parent[root] == root`` — the input shape of
    ``repro.core.treealg``. Same tree models as :func:`gen_euler_tour`
    (which consumes exactly this array: same seed, same tree)."""
    rng = np.random.default_rng(seed)
    parent = _random_tree_parents(n_nodes, rng, locality)
    if not 1 <= num_trees <= max(n_nodes, 1):
        raise ValueError("num_trees must be in [1, n_nodes]")
    if num_trees > 1:
        # cut the tree into a forest: extra roots detach their subtree.
        # Drawn after the parent array so the num_trees=1 RNG stream is
        # unchanged (same backward-compat discipline as gen_list).
        extra = rng.choice(np.arange(1, n_nodes), size=num_trees - 1,
                           replace=False)
        parent[extra] = extra
    return parent


def adjacency_links(parent: np.ndarray):
    """(first_child, next_sib) per node (−1 = none) under the
    ascending-child-id adjacency order: a stable argsort of the
    non-root parent entries groups children by parent with ascending
    child id inside each run. The single definition of the tour's
    adjacency order — shared by :func:`gen_euler_tour` and the
    device-construction oracle ``treealg.euler.oracle_tour``."""
    n = parent.shape[0]
    nodes = np.arange(n, dtype=np.int64)
    cand = nodes[parent != nodes]
    order = np.argsort(parent[cand], kind="stable")
    childs = cand[order]
    cpar = parent[childs]
    first_child = np.full(n, -1, dtype=np.int64)
    next_sib = np.full(n, -1, dtype=np.int64)
    if childs.size:
        is_first = np.ones(childs.size, dtype=bool)
        is_first[1:] = cpar[1:] != cpar[:-1]
        first_child[cpar[is_first]] = childs[is_first]
        same = cpar[1:] == cpar[:-1]
        next_sib[childs[:-1][same]] = childs[1:][same]
    return first_child, next_sib


def gen_euler_tour(n_nodes: int, seed: int = 0, locality: bool = False,
                   weighted: bool = False, num_trees: int = 1):
    """Euler tour of a random tree (or forest) as a list-ranking instance.

    The tour has one element per arc; arc (u,v) is followed by the next
    arc around v after (v,u) in the circular adjacency order. Each tree
    is rooted (node 0, plus ``num_trees - 1`` random extra roots for
    forests) by cutting the arc returning to its root; roots' own arc
    slots become weight-0 self-loops, so the layout stays
    down(c) = 2(c-1), up(c) = 2(c-1)+1 regardless of the forest shape.

    ``weighted=True`` assigns the depth weights: +1 on down-arcs, -1 on
    up-arcs (terminals and root dummies carry 0 as the solver requires),
    so a node's depth is recoverable from the weighted rank of its
    down-arc alone (``treealg.ops``: depth = 2 - rank±(down)).

    Returns (succ, rank, arcs): arcs[i] = (u, v) for tour element i
    (roots' dummy slots hold (r, r)).
    """
    parent = gen_tree_parents(n_nodes, seed=seed, locality=locality,
                              num_trees=num_trees)
    # arcs: for each non-root node c with parent q: down-arc (q->c) id 2k,
    # up-arc (c->q) id 2k+1 where k = c-1.
    n_arcs = 2 * (n_nodes - 1)
    if n_arcs == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 2), np.int64)
    nodes = np.arange(n_nodes, dtype=np.int64)
    is_root = parent == nodes
    cand = nodes[~is_root]
    first_child, next_sib = adjacency_links(parent)

    # next arc after entering node v via arc a: standard Euler tour:
    #   after down-arc (q->c): first child arc of c, else up-arc (c->q)
    #   after up-arc (c->q): next sibling down-arc, else up-arc (q->pq)
    c = cand
    down = 2 * (c - 1)
    up = down + 1
    q = parent[c]
    fc = first_child[c]
    ns = next_sib[c]
    idx = np.arange(n_arcs)
    succ = np.empty(n_arcs, dtype=np.int64)
    succ[idx] = idx  # roots' dummy arc slots self-loop
    succ[down] = np.where(fc >= 0, 2 * (fc - 1), up)
    succ[up] = np.where(ns >= 0, 2 * (ns - 1),
                        np.where(is_root[q], up,  # tour ends at its root
                                 2 * (q - 1) + 1))
    if weighted:
        rank = np.where(idx % 2 == 0, 1, -1).astype(np.int64)
        rank[succ == idx] = 0
    else:
        rank = (succ != idx).astype(np.int64)
    arcs = np.empty((n_arcs, 2), dtype=np.int64)
    r_extra = nodes[1:][is_root[1:]]
    arcs[2 * (r_extra - 1), 0] = r_extra
    arcs[2 * (r_extra - 1), 1] = r_extra
    arcs[2 * (r_extra - 1) + 1, 0] = r_extra
    arcs[2 * (r_extra - 1) + 1, 1] = r_extra
    arcs[down, 0] = q
    arcs[down, 1] = c
    arcs[up, 0] = c
    arcs[up, 1] = q
    return _as_succ_dtype(succ), rank.astype(np.int32), arcs


def gen_graph_edges(n_nodes: int, n_edges: int, seed: int = 0,
                    locality: bool = False,
                    num_components: int = 1) -> np.ndarray:
    """Random undirected edge list with a controlled component count
    (the ``repro.core.graphalg`` input families).

    Nodes split into ``num_components`` contiguous blocks; each block
    gets a random spanning tree (the same two attachment models as
    :func:`gen_tree_parents`: uniform = GNM-BFS-like, windowed =
    RGG2D-like) plus ``n_edges - (n_nodes - num_components)`` extra
    random intra-block edges, so the edge list has *exactly*
    ``num_components`` connected components. ``locality=True`` draws
    every edge between index-close nodes, mimicking an RGG2D graph's
    block-distribution locality. Fully vectorized; RNG discipline
    matches the list generators (one ``default_rng(seed)`` stream,
    extra-edge draws strictly after the tree draws).

    Returns an ``(n_edges, 2)`` int64 array in randomized order and
    orientation (self-loops never occur, parallel edges may).
    """
    if n_nodes <= 0:
        raise ValueError("n_nodes must be positive")
    if not 1 <= num_components <= n_nodes:
        raise ValueError("num_components must be in [1, n_nodes]")
    tree_edges = n_nodes - num_components
    if n_edges < tree_edges:
        raise ValueError(
            f"n_edges={n_edges} cannot connect {n_nodes} nodes into "
            f"{num_components} components (need >= {tree_edges})")
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n_nodes, num_components + 1).astype(np.int64)
    starts, ends = bounds[:-1], bounds[1:]
    # block id and block start per node (blocks are contiguous)
    blk = np.searchsorted(ends, np.arange(n_nodes), side="right")
    lo_of = starts[blk]
    hi_of = ends[blk]

    edges = np.empty((n_edges, 2), dtype=np.int64)
    # spanning trees: node i attaches to a strictly-earlier node of its
    # own block (so block starts are the roots) — uniform over the
    # block prefix, or over a trailing window for the RGG2D-like model.
    child = np.arange(n_nodes)[np.arange(n_nodes) != lo_of]
    lo = lo_of[child]
    if locality:
        window = max(1, n_nodes // 64)
        lo = np.maximum(lo, child - window)
    edges[:tree_edges, 0] = child
    edges[:tree_edges, 1] = lo + (rng.random(tree_edges)
                                  * (child - lo)).astype(np.int64)
    # extra edges: first endpoint uniform over non-singleton blocks,
    # second a distinct node of the same block (windowed if locality)
    extra = n_edges - tree_edges
    if extra:
        cand = np.arange(n_nodes)[(hi_of - lo_of) > 1]
        if cand.size == 0:
            raise ValueError("extra edges require a block with >= 2 nodes")
        u = cand[rng.integers(0, cand.size, size=extra)]
        lo2, hi2 = lo_of[u], hi_of[u]
        if locality:
            window = max(1, n_nodes // 64)
            lo2 = np.maximum(lo2, u - window)
            hi2 = np.minimum(hi2, u + window + 1)
        # draw from the block minus u itself: sample [lo2, hi2-1) and
        # shift values >= u up by one
        v = lo2 + (rng.random(extra) * (hi2 - lo2 - 1)).astype(np.int64)
        v = np.where(v >= u, v + 1, v)
        edges[tree_edges:, 0] = u
        edges[tree_edges:, 1] = v
    # randomized order and orientation (inputs must not leak the
    # construction's child->parent structure)
    flip = rng.random(n_edges) < 0.5
    edges[flip] = edges[flip, ::-1]
    return edges[rng.permutation(n_edges)]


def pad_to_multiple(succ: np.ndarray, rank: np.ndarray, p: int):
    """Pad with self-loop singletons so n is divisible by p."""
    n = succ.shape[0]
    pad = (-n) % p
    if pad == 0:
        return succ, rank
    extra = np.arange(n, n + pad, dtype=succ.dtype)
    return np.concatenate([succ, extra]), np.concatenate([rank, np.zeros(pad, rank.dtype)])


def locality_fraction(succ: np.ndarray, p: int) -> float:
    """Fraction of elements whose successor lives on the same PE
    (block distribution) — the paper's delta."""
    n = succ.shape[0]
    m = n // p
    owner = np.arange(n) // m
    return float(np.mean(owner == (np.asarray(succ) // m)))
