"""Plain PyTorch versions of the ``mailbox_pack`` kernel.

:func:`mailbox_pack_sorted_ref` computes what the card's kernel does,
from the hop's bucket sort, as a gather over the send buffer's cells: the
CPU path of :func:`repro_torch.kernels.mailbox_pack.ops.mailbox_pack`
and its oracle on the card. :func:`mailbox_pack_ref` is the same buffer
as one scatter of every wire word-plane to input-aligned slots, the
exchange's path with ``pallas_pack=False``. Both are pure data movement,
so the two are byte-identical.
"""
from __future__ import annotations

import torch


def mailbox_pack_ref(planes: torch.Tensor, slots: torch.Tensor,
                     n_rows: int) -> torch.Tensor:
    """(p, W, Q) int32 word-planes and slots -> (p, W, n_rows).

    ``out[pe, w, slots[pe, i]] = planes[pe, w, i]`` where
    ``0 <= slots[pe, i] < n_rows``, zero everywhere else. Shipping slots
    are unique per PE, so the scatter's write order does not matter.
    """
    p, q = slots.shape
    w = planes.shape[1]
    keep = (slots >= 0) & (slots < n_rows)
    idx = torch.where(keep, slots, n_rows).long()
    out = torch.zeros((p, w, n_rows + 1), dtype=torch.int32,
                      device=slots.device)
    out.scatter_(2, idx[:, None, :].expand(p, w, q), planes)
    return out[:, :, :n_rows].contiguous()


def bucket_runs(skey: torch.Tensor, n_buckets: int):
    """(start, run), each (p, n_buckets) int64: where bucket b's messages
    begin in the sorted keys ``skey`` (the first key >= b) and how many
    there are."""
    keys = torch.arange(n_buckets + 1, dtype=skey.dtype, device=skey.device)
    bounds = torch.searchsorted(skey.contiguous(),
                                keys.expand(skey.shape[0], -1).contiguous())
    return bounds[:, :-1], bounds[:, 1:] - bounds[:, :-1]


def mailbox_pack_sorted_ref(cols, order: torch.Tensor, skey: torch.Tensor,
                            n_buckets: int, cap: int) -> torch.Tensor:
    """Payload planes in input order, the bucket sort's ``order`` and
    sorted keys ``skey`` -> the (p, W, n_buckets * cap) send buffer, W =
    len(cols) + 1 with the validity plane last.

    Bucket b's messages are the run of ``order`` from the first sorted key
    >= b to the first >= b + 1; cell (b, c) holds run element c while
    ``c < min(run_b, cap)`` (validity word 1), zeros otherwise.
    """
    p, q = skey.shape
    dev = skey.device
    if q == 0:
        return torch.zeros((p, len(cols) + 1, n_buckets * cap),
                           dtype=torch.int32, device=dev)
    start, run = bucket_runs(skey, n_buckets)
    fill = torch.clamp(run, max=cap)
    c = torch.arange(cap, device=dev)
    shipped = (c < fill[:, :, None]).reshape(p, -1)
    src = torch.where(shipped, (start[:, :, None] + c).reshape(p, -1), 0)
    msg = torch.gather(order, 1, src)
    planes = [torch.where(shipped, torch.gather(col, 1, msg), 0)
              for col in cols]
    planes.append(shipped.to(torch.int32))
    return torch.stack(planes, 1)
