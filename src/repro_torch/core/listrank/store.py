"""Element stores: addressable per-PE views of a (sub-)instance.

Level 0 of the recursion owns a *dense* contiguous block of element ids
(direct indexing); deeper SRS levels operate on *sparse* stores — the
extracted ruler subproblem whose global ids are scattered — addressed
via binary search over the per-PE sorted id array.

Every field carries the leading PE axis: ``(p, cap)``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.listrank.batched import set_drop, take


@dataclasses.dataclass
class Store:
    """Per-PE view of a (sub-)instance.

    ids   (p, cap) int32  global element ids (ascending among valid
                          slots; invalid slots hold INT32_MAX for sparse
                          stores)
    succ  (p, cap) int32  current successor (global id)
    rank  (p, cap)        current weight/rank
    valid (p, cap) bool   slot occupancy
    dense bool            ids are the contiguous range base..base+cap
    """
    ids: torch.Tensor
    succ: torch.Tensor
    rank: torch.Tensor
    valid: torch.Tensor
    dense: bool = False

    @property
    def cap(self) -> int:
        return self.ids.shape[1]

    def replace(self, **kw) -> "Store":
        return dataclasses.replace(self, **kw)


def make_dense_store(succ: torch.Tensor, rank: torch.Tensor,
                     active: torch.Tensor, base: torch.Tensor) -> Store:
    m = succ.shape[1]
    ids = base[:, None] + torch.arange(m, dtype=torch.int32,
                                       device=succ.device)
    return Store(ids=ids, succ=succ, rank=rank, valid=active, dense=True)


def slot_of(store: Store, gids: torch.Tensor):
    """Map global ids to local slots. Returns (slot, found)."""
    cap = store.cap
    if store.dense:
        slot = (gids - store.ids[:, :1]).to(torch.int32)
        inr = (slot >= 0) & (slot < cap)
        slot = torch.clamp(slot, 0, cap - 1)
        return slot, inr & take(store.valid, slot)
    # sparse: ids ascending among valid slots; invalid slots hold INT32_MAX
    slot = torch.searchsorted(store.ids, gids.contiguous(), out_int32=True)
    slot = torch.clamp(slot, 0, cap - 1)
    found = (take(store.ids, slot) == gids) & take(store.valid, slot)
    return slot, found


def lookup(store: Store, gids: torch.Tensor, valid: torch.Tensor):
    """Owner-side lookup for remote_gather: (succ, rank) at global ids."""
    slot, found = slot_of(store, gids)
    ok = found & valid
    succ = take(store.succ, slot)
    rank = take(store.rank, slot)
    return {
        "succ": torch.where(ok, succ, gids),
        "rank": torch.where(ok, rank, torch.zeros_like(rank)),
        "found": ok,
    }


def scatter_update(store: Store, slots: torch.Tensor, upd_valid: torch.Tensor,
                   **fields: torch.Tensor) -> Store:
    """Set fields at slots (masked; the kept slots must be distinct —
    every call site updates each element at most once). Returns the
    updated store."""
    idx = torch.where(upd_valid, slots, store.cap)
    kw = {k: set_drop(getattr(store, k), idx, v) for k, v in fields.items()}
    return store.replace(**kw)
