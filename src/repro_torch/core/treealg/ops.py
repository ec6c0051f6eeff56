"""Tree statistics from ranked Euler tours (treealg operations layer).

Every operation reduces to list ranking of the device-built tour
(:mod:`repro_torch.core.treealg.euler`) plus closed-form arc-position
arithmetic (DESIGN.md §8), in int64 on the host. With the tour cut at
each root, the solver's sink-ranking gives, per arc ``a``, the weighted distance ``rank(a)``
from ``a`` to its tree's terminal; writing ``pos`` for the position
from the tour start and ``L = 2(size-1)`` for the tree's arc count:

  - unit weights:  ``pos(a) = L - 1 - rank1(a)``
  - ±1 weights:    ``depth(c) = 2 - rank±(down(c))``   (the +1 corrects
    the terminal arc's zeroed weight; see gen_euler_tour)
  - ``subtree_size(c) = (rank1(down(c)) - rank1(up(c)) + 1) // 2`` —
    position-difference only, so no per-tree constants needed
  - ``preorder(c)  = (pos(down(c)) + 1 + depth(c)) // 2``
  - ``postorder(c) = (pos(up(c)) + 2 - depth(c)) // 2 - 1``

``preorder``/``postorder`` are 0-based per tree (roots at 0 and
size-1), with children visited in ascending-id order — the tour's
adjacency order. ``tree_stats`` needs both weightings and gets them
from ONE mesh solve by batching the two instances through
:func:`repro_torch.core.treealg.batch.rank_lists_with_stats`;
``node_depth`` and ``subtree_size`` are single-solve fast paths.

Every front door takes the solve's keywords (``device``, ``perm_fn``,
``stage_counters``, ``seed``, ...) through ``**kw``; it runs on the
CUDA device unless ``device`` says otherwise.

``root_tree`` is the edge-orientation application: build the tree's
*circular* tour, cut it at the new root (``euler.build_tour(cut_at=)``),
rank, and orient every edge toward the smaller tour position.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.listrank.api import rank_list_with_stats
from repro_torch.core.listrank.config import ListRankConfig
from repro_torch.core.treealg import euler


@dataclasses.dataclass(frozen=True)
class TreeStats:
    """Per-node statistics of a rooted tree or forest."""
    parent: np.ndarray        #: the input rooting
    root_of: np.ndarray       #: each node's tree root
    depth: np.ndarray         #: depth[root] == 0
    subtree_size: np.ndarray  #: subtree_size[root] == tree size
    preorder: np.ndarray      #: 0-based per tree, ascending-id children
    postorder: np.ndarray     #: 0-based per tree; root == size - 1
    stats: dict               #: solver stats of the underlying solve(s)

    @property
    def n_nodes(self) -> int:
        return self.parent.shape[0]

    def is_ancestor(self, u, v) -> np.ndarray:
        """True iff ``u`` is an (inclusive) ancestor of ``v`` — the
        closed-form pre/postorder interval test, no solves."""
        return is_ancestor(self.preorder, self.postorder, self.root_of,
                           u, v)

    def subtree_interval(self, u):
        """Preorder interval [lo, hi] covered by ``u``'s subtree."""
        return subtree_interval(self.preorder, self.subtree_size, u)


def is_ancestor(preorder, postorder, root_of, u, v) -> np.ndarray:
    """Closed-form ancestor test from pre/postorder numbers.

    ``u`` is an ancestor of ``v`` (every node is its own ancestor) iff
    they share a tree and ``v``'s DFS visit nests inside ``u``'s:
    ``pre[u] <= pre[v]`` and ``post[v] <= post[u]``. Pre/postorder are
    0-based *per tree*, so the same-tree check (``root_of`` — or a
    component labeling) is part of the test. Vectorizes over ``u``/``v``
    (numpy broadcasting); used by both :meth:`TreeStats.is_ancestor`
    and the graphalg query layer. No communication — pure arithmetic.
    """
    u = np.asarray(u)
    v = np.asarray(v)
    preorder = np.asarray(preorder)
    postorder = np.asarray(postorder)
    root_of = np.asarray(root_of)
    return (root_of[u] == root_of[v]) & (preorder[u] <= preorder[v]) \
        & (postorder[v] <= postorder[u])


def subtree_interval(preorder, subtree_size, u):
    """The preorder numbers of ``u``'s subtree form the contiguous
    interval ``[pre[u], pre[u] + size[u] - 1]`` (per tree) — returns
    (lo, hi), vectorized over ``u``."""
    u = np.asarray(u)
    lo = np.asarray(preorder)[u]
    return lo, lo + np.asarray(subtree_size)[u] - 1


def roots_and_sizes(parent: np.ndarray):
    """(root_of, tree_size_of) per node, by vectorized pointer jumping
    on the parent array (host-side, O(n log depth))."""
    parent = np.asarray(parent, np.int64)
    n = parent.shape[0]
    is_root = parent == np.arange(n)
    root_of = parent.copy()
    for _ in range(max(int(n).bit_length(), 1) + 1):
        if np.all(is_root[root_of]):
            break
        root_of = root_of[root_of]
    # jumping collapses even-length cycles to spurious fixed points, so
    # convergence must be judged against the ORIGINAL self-parented set
    # (same rule as rank_list_seq's cycle check).
    if not np.all(is_root[root_of]):
        raise ValueError("parent pointers contain a cycle")
    sizes = np.bincount(root_of, minlength=n)
    return root_of, sizes[root_of]


def _check_parent(parent) -> np.ndarray:
    parent = euler._host_parent(parent)
    n = parent.shape[0]
    if n == 0 or not ((parent >= 0) & (parent < n)).all():
        raise ValueError("parent must be a nonempty array of node ids")
    return parent


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _ranked_tour(parent, mesh, pe_axes, cfg, weighted, **kw):
    """Build the device tour, rank it, return host rank values trimmed
    to the 2n real arc slots."""
    succ, w, n_pad = euler.build_tour(parent, mesh, pe_axes=pe_axes,
                                      cfg=cfg, weighted=weighted,
                                      tracer=kw.get("tracer"),
                                      device=kw.get("device"))
    _, rank, stats = rank_list_with_stats(succ, w, mesh, pe_axes=pe_axes,
                                          cfg=cfg, **kw)
    n = parent.shape[0]
    return _host(rank)[:2 * n].astype(np.int64), stats


def node_depth(parent, mesh, pe_axes=None, cfg: ListRankConfig | None = None,
               **kw) -> np.ndarray:
    """Every node's depth (0 at its root), one ±1-weighted solve."""
    parent = _check_parent(parent)
    rpm, _ = _ranked_tour(parent, mesh, pe_axes, cfg, weighted=True, **kw)
    nodes = np.arange(parent.shape[0])
    nonroot = parent != nodes
    depth = np.zeros(parent.shape[0], np.int64)
    depth[nonroot] = 2 - rpm[euler.down(nodes[nonroot])]
    return depth


def subtree_size(parent, mesh, pe_axes=None,
                 cfg: ListRankConfig | None = None, **kw) -> np.ndarray:
    """Every node's subtree size, one unit-weighted solve."""
    parent = _check_parent(parent)
    r1, _ = _ranked_tour(parent, mesh, pe_axes, cfg, weighted=False, **kw)
    nodes = np.arange(parent.shape[0])
    nonroot = parent != nodes
    _, tree_size = roots_and_sizes(parent)
    size = tree_size.astype(np.int64).copy()  # roots: whole tree
    c = nodes[nonroot]
    size[c] = (r1[euler.down(c)] - r1[euler.up(c)] + 1) // 2
    return size


def tree_stats(parent, mesh, pe_axes=None, cfg: ListRankConfig | None = None,
               **kw) -> TreeStats:
    """All per-node statistics from ONE batched mesh solve.

    The unit- and ±1-weighted tours share the successor structure, so
    they ride as two instances of the batched front door — a single
    jitted solver invocation covers both weightings.
    """
    from repro_torch.core.treealg import batch as batch_lib
    parent = _check_parent(parent)
    n = parent.shape[0]
    nodes = np.arange(n)
    nonroot = parent != nodes
    root_of, tree_size = roots_and_sizes(parent)

    succ_d, wpm_d, _ = euler.build_tour(parent, mesh, pe_axes=pe_axes,
                                        cfg=cfg, weighted=True,
                                        tracer=kw.get("tracer"),
                                        device=kw.get("device"))
    succ = _host(succ_d)[:2 * n]
    wpm = _host(wpm_d)[:2 * n]
    w1 = np.abs(wpm)  # unit weights: same tour, same zeroed terminals
    ranked, stats = batch_lib.rank_lists_with_stats(
        [(succ, w1), (succ, wpm)], mesh, pe_axes=pe_axes, cfg=cfg, **kw)
    r1 = ranked[0][1].astype(np.int64)
    rpm = ranked[1][1].astype(np.int64)

    depth = np.zeros(n, np.int64)
    size = tree_size.astype(np.int64).copy()
    pre = np.zeros(n, np.int64)
    post = np.maximum(tree_size.astype(np.int64) - 1, 0)
    c = nodes[nonroot]
    rd, ru = r1[euler.down(c)], r1[euler.up(c)]
    depth[c] = 2 - rpm[euler.down(c)]
    size[c] = (rd - ru + 1) // 2
    arcs_of_tree = 2 * (tree_size[c].astype(np.int64) - 1)
    pos_down = arcs_of_tree - 1 - rd
    pos_up = arcs_of_tree - 1 - ru
    pre[c] = (pos_down + 1 + depth[c]) // 2
    post[c] = (pos_up + 2 - depth[c]) // 2 - 1
    return TreeStats(parent=parent, root_of=root_of, depth=depth,
                     subtree_size=size, preorder=pre, postorder=post,
                     stats=stats)


def preorder(parent, mesh, **kw) -> np.ndarray:
    """0-based per-tree preorder numbers (ascending-id child order)."""
    return tree_stats(parent, mesh, **kw).preorder


def postorder(parent, mesh, **kw) -> np.ndarray:
    """0-based per-tree postorder numbers (ascending-id child order)."""
    return tree_stats(parent, mesh, **kw).postorder


def root_tree(parent, new_root: int, mesh, pe_axes=None,
              cfg: ListRankConfig | None = None, **kw) -> np.ndarray:
    """Re-orient a rooted tree's edges toward ``new_root``.

    The circular Euler tour is cut at ``down(new_root)``
    (``euler.build_tour(cut_at=new_root)``); after ranking, edge
    {c, q=parent[c]} keeps its orientation iff the (q→c) arc precedes
    (c→q) in the new tour — i.e. ``rank1(down(c)) > rank1(up(c))`` —
    and flips otherwise. Exactly the edges on the old-root→new-root
    path flip.
    """
    parent = _check_parent(parent)
    n = parent.shape[0]
    nodes = np.arange(n)
    roots = nodes[parent == nodes]
    if roots.size != 1:
        raise ValueError("root_tree requires a single-tree input")
    if not 0 <= new_root < n:
        raise ValueError("new_root out of range")
    if new_root == int(roots[0]):
        return parent.copy()
    succ, w, _ = euler.build_tour(parent, mesh, pe_axes=pe_axes, cfg=cfg,
                                  cut_at=int(new_root),
                                  tracer=kw.get("tracer"),
                                  device=kw.get("device"))
    _, rank, _ = rank_list_with_stats(succ, w, mesh, pe_axes=pe_axes,
                                      cfg=cfg, **kw)
    r1 = _host(rank)[:2 * n].astype(np.int64)
    out = np.full(n, -1, np.int64)
    c = nodes[parent != nodes]
    q = parent[c]
    keep = r1[euler.down(c)] > r1[euler.up(c)]
    out[c[keep]] = q[keep]
    out[q[~keep]] = c[~keep]
    out[new_root] = new_root
    if (out < 0).any():
        raise AssertionError("re-rooting left unoriented nodes")
    return out
