"""Sequential list-ranking oracle (vectorized numpy pointer jumping).

Used as the correctness reference for every distributed algorithm and
for the kernels' plain versions. The original
per-terminal Python walk (an O(n) interpreter loop per list) is kept in
``tests/test_sequential.py`` as the oracle-of-oracles; this vectorized
version must match it exactly on integer weights and to float tolerance
on float weights (the accumulation order differs: backward walk vs
pairwise jumping).
"""
from __future__ import annotations

import numpy as np


def rank_list_seq(succ: np.ndarray, rank: np.ndarray | None = None):
    """Rank all lists by vectorized pointer jumping. O(n log L) work for
    maximum list length L, with no Python-level per-element loops.

    Args:
      succ: int array of successor indices; terminals satisfy succ[i]==i.
      rank: optional link weights; terminals must hold 0. Defaults to the
        unweighted instance (1 for non-terminals, 0 for terminals).

    Returns:
      (succ_out, rank_out): succ_out[i] is the terminal of i's list,
      rank_out[i] the weighted distance from i to that terminal.
    """
    succ = np.asarray(succ)
    n = succ.shape[0]
    idx = np.arange(n, dtype=succ.dtype)
    if rank is None:
        rank = (succ != idx).astype(np.int64)
    rank = np.asarray(rank)
    is_term = succ == idx
    if not np.all(rank[is_term] == 0):
        raise ValueError("terminal elements must carry weight 0")
    # a set of lists has in-degree <= 1 everywhere: merged successors
    # (trees/rho shapes) must fail loudly — jumping would happily rank
    # them, and this function is the oracle everything else trusts.
    targets = succ[~is_term]
    if np.unique(targets).size != targets.size:
        raise ValueError(
            "an element has two predecessors (not a set of lists)")

    # Pointer jumping: after k steps s[i] is 2^k links ahead (clamped at
    # the terminal) and w[i] the weight sum over the links traversed —
    # terminals are fixed points contributing 0, so both converge to the
    # answer once 2^k exceeds every list length.
    s = succ.astype(np.int64)
    w = rank.copy()
    for _ in range(max(int(n).bit_length(), 1) + 1):
        if np.all(is_term[s]):
            break
        w = w + w[s]
        s = s[s]
    # A set of lists converges within ceil(log2 n)+1 jumps; anything
    # still short of a true terminal is on a cycle. (Cycles of even
    # length collapse to spurious fixed points under jumping, so the
    # check must consult the *original* terminal set.)
    if not np.all(is_term[s]):
        raise ValueError("input contains a cycle (not a set of lists)")
    return s.astype(succ.dtype), w.astype(rank.dtype)
