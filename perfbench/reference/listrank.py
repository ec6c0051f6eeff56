"""Plain list ranking: pointer doubling (Wyllie) in PyTorch.

The benchmark's reference for every list cell. It shares nothing with
the program: no sparse ruling set, no exchange, no kernel. After k
jumps ``nxt[i]`` is 2^k links ahead of ``i`` (held at its terminal) and
``dist[i]`` the weight summed over the links passed, so both are the
answer once 2^k passes the longest list. ``dtype`` is the type the
distances are summed in: the exact ``torch.int64``, or a narrower one
for the control.
"""
from __future__ import annotations

import torch


def rank_list(succ: torch.Tensor, weight: torch.Tensor,
              dtype: torch.dtype = torch.int64):
    """(terminal, distance) of every element of the lists ``succ``
    (terminals point to themselves and weigh 0), on ``succ``'s device."""
    n = succ.shape[0]
    nxt = succ.to(torch.int64)
    dist = weight.to(dtype)
    term = nxt == torch.arange(n, device=succ.device)
    for _ in range(max(n, 1).bit_length() + 1):
        if bool(term[nxt].all()):
            break
        dist = dist + dist[nxt]
        nxt = nxt[nxt]
    if not bool(term[nxt].all()):
        raise ValueError("the instance holds a cycle: not a set of lists")
    return nxt, dist
