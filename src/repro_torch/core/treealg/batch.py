"""Batched multi-instance front door (the serving-side scenario).

Many small list-ranking or tree queries must not each pay a solver
invocation (host round trips, p collective startups per round):
:func:`rank_lists` packs B independent instances into ONE
block-sharded instance — ids offset-relabelled per instance, the tail
padded with weight-0 singletons (``instances.pad_to_multiple``) — and
runs a single solve. Lists never cross instance boundaries (every id is
relabelled into its own offset window), so the packed solve makes one
collective per hop of a chase round, as a single-instance solve of the
same total size does: batching costs volume, never startups
(``tests/test_torch_treealg.py`` pins it with the counting transport).

:func:`solve_forest` is the tree-level door: B independent trees pack
into one forest (euler.py handles multi-root inputs natively), one
device tour build + one batched solve yields every tree's
:class:`~repro_torch.core.treealg.ops.TreeStats`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.listrank import instances
from repro_torch.core.listrank.api import rank_list_with_stats
from repro_torch.core.listrank.config import ListRankConfig

#: largest packed id the offset relabeling may produce. Ids ride the
#: int32 wire format, and the front door pads the packed instance up to a
#: PE multiple *after* packing, so leave 2^16 headroom below 2^31-1
#: instead of wrapping silently at the ``astype(np.int32)``.
PACKED_ID_LIMIT = 2**31 - 2**16


def _check_packed_size(total: int, what: str, limit: int = PACKED_ID_LIMIT):
    """Host-side int32-overflow guard for offset relabeling: ``total``
    is the largest id the packed instance can produce (before PE
    padding). Runs on shapes only — callers invoke it before touching
    any element data."""
    if total > limit:
        raise ValueError(
            f"{what}: packed instance needs ids up to {total}, which "
            f"overflows the int32 wire format (limit {limit} with "
            f"PE-padding headroom); split the batch")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pack_instances(batch: Sequence[tuple[np.ndarray, np.ndarray]]):
    """Offset-relabel and concatenate B (succ, rank) instances.

    Returns (succ, rank, offsets): instance b occupies the id window
    ``[offsets[b], offsets[b+1])``. Weight dtypes are promoted to their
    common numpy result type (int stays int32 on the wire, float
    float32 — see ``api.chase_leaves``).
    """
    if not batch:
        raise ValueError("empty instance batch")
    sizes = np.array([np.asarray(s).shape[0] for s, _ in batch], np.int64)
    # shape-only overflow check BEFORE any elementwise validation: the
    # relabeled ids must fit the int32 wire format
    _check_packed_size(int(sizes.sum()), "pack_instances")
    for b, (s, r) in enumerate(batch):
        s = np.asarray(s)
        if np.asarray(r).shape != s.shape:
            raise ValueError("succ/rank shape mismatch in batch")
        # ids must stay inside the instance: an out-of-range id would
        # silently alias into a neighbor's offset window after packing
        if s.size and not ((s >= 0) & (s < s.shape[0])).all():
            raise ValueError(f"instance {b}: succ ids out of range")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    succ = np.concatenate(
        [np.asarray(s, np.int64) + off
         for (s, _), off in zip(batch, offsets)]) if sizes.sum() else \
        np.zeros(0, np.int64)
    wdt = np.result_type(*[np.asarray(r).dtype for _, r in batch])
    rank = np.concatenate(
        [np.asarray(r).astype(wdt) for _, r in batch]) if sizes.sum() else \
        np.zeros(0, wdt)
    return succ.astype(np.int32), rank, offsets


def unpack_results(succ: np.ndarray, rank: np.ndarray,
                   offsets: np.ndarray):
    """Inverse of :func:`pack_instances` on solver output (padding
    beyond ``offsets[-1]`` is dropped, ids shift back per window)."""
    out = []
    for b in range(offsets.shape[0] - 1):
        lo, hi = int(offsets[b]), int(offsets[b + 1])
        out.append((succ[lo:hi] - lo, rank[lo:hi]))
    return out


def rank_lists_with_stats(batch, mesh, pe_axes=None,
                          cfg: ListRankConfig | None = None, **kw):
    """Rank B independent instances in ONE solve.

    Args:
      batch: sequence of (succ, rank) pairs (numpy arrays or tensors),
        each a self-contained instance with terminals pointing to
        themselves.
      **kw: passed to :func:`rank_list_with_stats` (``device``,
        ``perm_fn``, ``stage_counters``, ``seed``, ...).

    Returns:
      (results, stats): ``results[b]`` is instance b's (succ, rank) in
      its own id space (host numpy); ``stats`` the single solve's
      counters.
    """
    batch = [(_host(s), _host(r)) for s, r in batch]
    succ, rank, offsets = pack_instances(batch)
    p = 1
    axes = tuple(pe_axes) if pe_axes is not None else tuple(mesh.axis_names)
    for a in axes:
        p *= mesh.shape[a]
    succ, rank = instances.pad_to_multiple(succ, rank, p)
    s_out, r_out, stats = rank_list_with_stats(succ, rank, mesh,
                                               pe_axes=pe_axes, cfg=cfg, **kw)
    return unpack_results(_host(s_out), _host(r_out), offsets), stats


def rank_lists(batch, mesh, **kw):
    """Convenience wrapper: the per-instance (succ, rank) results only."""
    results, _ = rank_lists_with_stats(batch, mesh, **kw)
    return results


def solve_forest(parents: Sequence[np.ndarray], mesh, pe_axes=None,
                 cfg: ListRankConfig | None = None, **kw):
    """Tree statistics for B independent trees in one batched solve.

    Packs the parent arrays into one forest (offset-relabelled roots
    stay self-parented), builds a single device tour, ranks both
    weightings through the batched front door, and splits the
    :class:`~repro_torch.core.treealg.ops.TreeStats` back per tree.
    """
    from repro_torch.core.treealg import ops
    if not parents:
        raise ValueError("empty forest batch")
    # shape-only overflow guard BEFORE any conversion touches element
    # data: arc ids of the packed forest's tour reach 2 * n_packed
    _check_packed_size(
        2 * sum(q.shape[0] if hasattr(q, "shape") else len(q)
                for q in parents), "solve_forest")
    parents = [_host(q).astype(np.int64) for q in parents]
    for b, q in enumerate(parents):
        # validate per tree BEFORE packing: an out-of-range parent
        # would become a valid pointer into a neighbor's id window
        if q.shape[0] == 0 or not ((q >= 0) & (q < q.shape[0])).all():
            raise ValueError(f"tree {b}: parent pointers out of range")
    sizes = np.array([q.shape[0] for q in parents], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    packed = np.concatenate(
        [q + off for q, off in zip(parents, offsets)])
    st = ops.tree_stats(packed, mesh, pe_axes=pe_axes, cfg=cfg, **kw)
    out = []
    for b in range(len(parents)):
        lo, hi = int(offsets[b]), int(offsets[b + 1])
        out.append(ops.TreeStats(
            parent=st.parent[lo:hi] - lo, root_of=st.root_of[lo:hi] - lo,
            depth=st.depth[lo:hi], subtree_size=st.subtree_size[lo:hi],
            preorder=st.preorder[lo:hi], postorder=st.postorder[lo:hi],
            stats=st.stats))
    return out
