"""Plain PyTorch version of the ``mailbox_pack`` kernel: one scatter of
every wire word-plane into the plane-major send buffer. The CPU path of
:func:`repro_torch.kernels.mailbox_pack.ops.mailbox_pack` and its oracle
on the card (pure data movement, so results are byte-identical)."""
from __future__ import annotations

import torch


def mailbox_pack_ref(cols, slots: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(p, Q) int32 word-planes ``cols`` and slots -> (p, W, n_rows).

    ``out[pe, w, slots[pe, i]] = cols[w][pe, i]`` where
    ``0 <= slots[pe, i] < n_rows``, zero everywhere else. Shipping slots
    are unique per PE, so the scatter's write order does not matter.
    """
    p, q = slots.shape
    w = len(cols)
    keep = (slots >= 0) & (slots < n_rows)
    idx = torch.where(keep, slots, n_rows).long()
    out = torch.zeros((p, w, n_rows + 1), dtype=torch.int32,
                      device=slots.device)
    out.scatter_(2, idx[:, None, :].expand(p, w, q), torch.stack(cols, 1))
    return out[:, :, :n_rows].contiguous()
