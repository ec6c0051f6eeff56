"""Plain tree statistics from a parent array, in PyTorch.

The benchmark's reference for every tree cell. It never builds an Euler
tour and ranks no list: each statistic follows from the parent array
alone.

- ``root`` and ``depth``: pointer doubling up the parent links.
- ``size``: levels from the deepest up, each adding its nodes' sizes
  into their parents.
- ``preorder`` and ``postorder``, with children in ascending id order:
  a child's ``offset`` is the summed size of its smaller siblings, and
  ``before[c]``, the sum of ``offset`` over ``c`` and its ancestors, counts
  the nodes that precede ``c``'s subtree in both orders. Then
  ``preorder = before + depth`` (the ancestors come first) and
  ``postorder = before + size - 1`` (the subtree comes first).

``dtype`` is the type the sums run in: the exact ``torch.int64``, or a
narrower one for the control.
"""
from __future__ import annotations

import torch

KEYS = ("root", "depth", "size", "preorder", "postorder")


def _up_sums(parent: torch.Tensor, value: torch.Tensor):
    """(root of each node, ``value`` summed over the node and its
    ancestors, the root's own value left out): pointer doubling."""
    n = parent.shape[0]
    idx = torch.arange(n, device=parent.device)
    is_root = parent == idx
    anc = parent.clone()
    acc = torch.where(is_root, torch.zeros_like(value), value)
    for _ in range(max(n, 1).bit_length() + 1):
        if bool(is_root[anc].all()):
            break
        acc = acc + acc[anc]
        anc = anc[anc]
    if not bool(is_root[anc].all()):
        raise ValueError("the parent array holds a cycle")
    return anc, acc


def tree_stats(parent: torch.Tensor, dtype: torch.dtype = torch.int64):
    """{key: (n,) tensor} for every key of :data:`KEYS`."""
    parent = parent.to(torch.int64)
    n = parent.shape[0]
    dev = parent.device
    idx = torch.arange(n, device=dev)
    nonroot = parent != idx
    root, depth = _up_sums(parent, nonroot.to(dtype))

    # sizes, deepest level first
    size = torch.ones(n, dtype=dtype, device=dev)
    by_depth = torch.argsort(depth.to(torch.int64), descending=True,
                             stable=True)
    levels = torch.bincount(depth.to(torch.int64), minlength=1).flip(0)
    start = 0
    for count in levels.tolist()[:-1]:  # the roots' level adds to no one
        nodes = by_depth[start:start + count]
        size.index_add_(0, parent[nodes], size[nodes])
        start += count

    # each child's smaller siblings: children in (parent, id) order
    kids = idx[nonroot]
    order = torch.sort(parent[kids], stable=True).indices
    kids = kids[order]
    ksize = size[kids]
    before_in_run = torch.cumsum(ksize, 0) - ksize
    first = torch.ones(kids.shape[0], dtype=torch.bool, device=dev)
    first[1:] = parent[kids[1:]] != parent[kids[:-1]]
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    offset = torch.zeros(n, dtype=dtype, device=dev)
    offset[kids] = before_in_run - before_in_run[first][run]
    _, before = _up_sums(parent, offset)
    return {"root": root, "depth": depth, "size": size,
            "preorder": before + depth, "postorder": before + size - 1}
