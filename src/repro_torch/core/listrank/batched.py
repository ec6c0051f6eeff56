"""Indexing helpers for per-PE tensors with a leading PE axis.

Every per-PE array in the port is ``(p, n, *trail)``. These helpers are
the batched forms of the reference's per-PE ``x[idx]`` gathers and
``x.at[idx].set(v, mode="drop")`` scatters, so the solver code reads
like the per-PE original.
"""
from __future__ import annotations

import torch

INT_MAX = torch.iinfo(torch.int32).max


def _expand_index(idx: torch.Tensor, like_trail: tuple[int, ...]):
    """(p, q) index -> (p, q, *trail), for gather/scatter on trailing dims."""
    if not like_trail:
        return idx
    return idx.reshape(idx.shape + (1,) * len(like_trail)).expand(
        idx.shape + tuple(like_trail))


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-PE gather ``x[pe][idx[pe]]``: x (p, n, *trail), idx (p, q)
    with every index in [0, n) -> (p, q, *trail)."""
    trail = tuple(x.shape[2:])
    return torch.gather(x, 1, _expand_index(idx.long(), trail))


def set_drop(base: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """Per-PE ``base[pe].at[idx[pe]].set(vals[pe], mode="drop")``.

    Indices outside [0, n) are dropped by routing them to a sentinel
    column that is sliced off. Callers only pass indices that are unique
    among the kept ones (each call site says why), so the result does not
    depend on the scatter's write order — on CUDA, a scatter with
    duplicate indices keeps an arbitrary one of the values.
    """
    n = base.shape[1]
    trail = tuple(base.shape[2:])
    idx = torch.where((idx >= 0) & (idx < n), idx, n).long()
    out = torch.cat([base, base.new_zeros((base.shape[0], 1) + trail)], 1)
    if isinstance(vals, torch.Tensor):
        out.scatter_(1, _expand_index(idx, trail), vals.to(base.dtype))
    else:
        out.scatter_(1, _expand_index(idx, trail), vals)
    return out[:, :n]


def unpermute(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[pe][order[pe]] = vals[pe]`` for a per-PE permutation
    ``order`` (every slot written exactly once, so deterministic)."""
    return torch.empty_like(vals).scatter_(1, order, vals)


def arange(n: int, p: int, device) -> torch.Tensor:
    """(p, n) int32 ``arange(n)`` on every PE (a broadcast view)."""
    return torch.arange(n, dtype=torch.int32, device=device).expand(p, n)
