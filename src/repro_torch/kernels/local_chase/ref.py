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


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The raw 32-bit pattern: -0.0 differs from +0.0, a NaN equals itself."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def local_chase_fixed_point_ref(succ: torch.Tensor, dist: torch.Tensor,
                                steps: int, group_rows: int | None = None):
    """The CUDA kernel's schedule, in plain torch: rows are walked in
    groups of ``group_rows`` (all rows by default), and a group stops
    after the first step that changes no bit of its (succ, dist), or
    after ``steps`` steps.

    A step is a deterministic function of the state, so once a step
    leaves every bit as it was, so does every later one: the result is
    :func:`local_chase_ref`'s bit for bit. Returns (succ, dist,
    steps_run), ``steps_run`` a (B,) int32 count of the steps each row's
    group ran, the unchanged one included.
    """
    m = succ.shape[-1]
    s_all = succ.reshape(-1, m)
    d_all = dist.reshape(-1, m)
    b = s_all.shape[0]
    g = b if group_rows is None else max(1, group_rows)
    out_s, out_d = s_all.clone(), d_all.clone()
    steps_run = torch.zeros(b, dtype=torch.int32)
    for r0 in range(0, b, g):
        s, d = s_all[r0:r0 + g], d_all[r0:r0 + g]
        k = 0
        while k < steps:
            ns, nd = local_chase_ref(s, d, 1)
            k += 1
            same = torch.equal(ns, s) and torch.equal(_bits(nd), _bits(d))
            s, d = ns, nd
            if same:
                break
        out_s[r0:r0 + g], out_d[r0:r0 + g] = s, d
        steps_run[r0:r0 + g] = k
    return out_s.reshape(succ.shape), out_d.reshape(dist.shape), steps_run


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
