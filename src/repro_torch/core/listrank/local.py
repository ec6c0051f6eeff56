"""Local sublist contraction (paper §2.3) and its restoration.

Runs entirely PE-locally (no communication). The paper chases local
chains sequentially in O(n/p); here the chase is pointer doubling
restricted to local links, O((n/p)·log(chain)) vector work. The doubling
runs through the ``local_chase`` CUDA kernel with ``use_pallas``
(:mod:`repro_torch.kernels.local_chase`), the plain torch loop otherwise.

Definitions (per PE with local index range [0, m), global base b):
  stop element: local element whose successor is non-local or itself
  S[i]: local index of the stop element ending i's local chain
  D[i]: weighted distance from i to S[i] (sum of weights of links
        i -> ... -> S[i], excluding S[i]'s own outgoing link)
  rep:  local elements with no local predecessor (local-initial) —
        the contracted instance consists exactly of the reps.

Contracted instance (only reps active):
  succ_c[l] = succ[S[l]]  (remote, or l itself if S[l] is terminal)
  rank_c[l] = D[l] + rank[S[l]]  (0 if S[l] is terminal)

All tensors carry the leading PE axis: (p, m); ``base`` is (p,).
"""
from __future__ import annotations

import torch

from repro_torch.core.listrank.batched import set_drop, take


def _doubling(succ_l: torch.Tensor, dist: torch.Tensor, steps: int,
              use_pallas: bool):
    """Wyllie iterations over local links with self-absorbing stops."""
    if use_pallas:
        from repro_torch.kernels.local_chase import ops as lc_ops
        return lc_ops.local_chase(succ_l.contiguous(), dist.contiguous(),
                                  steps)
    s, d = succ_l, dist
    for _ in range(steps):
        s, d = take(s, s), d + take(d, s)
    return s, d


def chase_input(succ: torch.Tensor, rank: torch.Tensor, base: torch.Tensor,
                m: int):
    """The doubling input of :func:`contract`: local successor indices
    (stops as self-loops) and link weights (0 at stops), plus the masks
    contract reuses. Returns (succ_l, dist0, steps, masks)."""
    lidx = torch.arange(m, dtype=torch.int32, device=succ.device)
    gid = base[:, None] + lidx
    is_term = succ == gid
    succ_local = succ - base[:, None]
    is_local = (succ_local >= 0) & (succ_local < m)
    stop = (~is_local) | is_term
    succ_l = torch.where(stop, lidx, torch.clamp(succ_local, 0, m - 1)
                         ).to(torch.int32)
    dist0 = torch.where(stop, torch.zeros_like(rank), rank)
    steps = max(1, (m - 1).bit_length())
    return succ_l, dist0, steps, (gid, is_term, succ_local, is_local)


def contract(succ: torch.Tensor, rank: torch.Tensor, base: torch.Tensor,
             m: int, use_pallas: bool = False):
    """Contract local sublists. Returns (succ_c, rank_c, rep, aux) where
    aux = dict(S, D, stop_is_term) is needed by the restoration."""
    succ_l, dist0, steps, (gid, is_term, succ_local, is_local) = \
        chase_input(succ, rank, base, m)
    S, D = _doubling(succ_l, dist0, steps, use_pallas)

    # rep = no local predecessor (self-loops don't count as local preds);
    # every kept index is written with the same value, so duplicates
    # could not change the result either.
    has_local_pred = set_drop(
        torch.zeros_like(succ, dtype=torch.bool),
        torch.where(is_local & ~is_term, succ_local, m), True)
    rep = ~has_local_pred

    stop_is_term = take(is_term, S)
    succ_c = torch.where(stop_is_term, gid, take(succ, S))
    rank_c = torch.where(stop_is_term, torch.zeros_like(rank),
                         D + take(rank, S))
    # non-reps are parked as inert self-loops; the `rep` mask excludes
    # them from the distributed instance entirely.
    succ_c = torch.where(rep, succ_c, gid)
    rank_c = torch.where(rep, rank_c, torch.zeros_like(rank_c))
    aux = dict(S=S, D=D, stop_is_term=stop_is_term)
    return succ_c, rank_c, rep, aux


def tail_lookup(aux, base: torch.Tensor):
    """Owner-side data for restore: for a queried element x (a rep whose
    chain ends at a true terminal), return (terminal gid, distance)."""
    def fn(gids: torch.Tensor, valid: torch.Tensor):
        m = aux["S"].shape[1]
        b = base[:, None]
        slot = torch.clamp(gids - b, 0, m - 1).to(torch.int32)
        ok = valid & (gids >= b) & (gids < b + m)
        t_gid = b + take(aux["S"], slot)
        d = take(aux["D"], slot)
        return {
            "succ": torch.where(ok, t_gid, gids),
            "rank": torch.where(ok, d, torch.zeros_like(d)),
            "found": ok,
        }
    return fn
