"""Plain versions of the ``local_chase`` kernel.

Wyllie pointer doubling over a PE-local index space with self-absorbing
stop elements:
  dist <- dist + dist[succ];  succ <- succ[succ]   (x ``steps``)

With stop elements encoded as self-loops carrying dist 0, after
ceil(log2(max chain length)) steps every element holds
  succ = index of its chain's stop element,
  dist = weighted distance to that stop element.
"""
from __future__ import annotations

import numpy as np
import torch


def local_chase_ref(succ: torch.Tensor, dist: torch.Tensor, steps: int):
    """succ: (..., m) int32 local indices; dist: (..., m) weights. Each
    step reads the old succ and dist before it writes."""
    s, d = succ, dist
    for _ in range(steps):
        idx = s.long()
        s, d = torch.gather(s, -1, idx), d + torch.gather(d, -1, idx)
    return s, d


def sequential_chase_ref(succ, dist):
    """O(m) numpy pointer chasing oracle (ground truth for both the
    kernel and the doubling)."""
    succ = np.asarray(succ)
    dist = np.asarray(dist)
    m = succ.shape[-1]
    out_s = np.empty_like(succ)
    out_d = np.empty_like(dist)
    flat_s = succ.reshape(-1, m)
    flat_d = dist.reshape(-1, m)
    fo_s = out_s.reshape(-1, m)
    fo_d = out_d.reshape(-1, m)
    for b in range(flat_s.shape[0]):
        s, d = flat_s[b], flat_d[b]
        for i in range(m):
            cur, acc = i, d.dtype.type(0)
            while s[cur] != cur:
                acc += d[cur]
                cur = s[cur]
            fo_s[b, i] = cur
            fo_d[b, i] = acc
    return out_s.reshape(succ.shape), out_d.reshape(dist.shape)
