"""Public wrapper for ``mailbox_pack``: the CUDA kernel on the card, the
plain torch version for CPU tensors.

On a CUDA tensor the kernel is launched or the call raises; it never
gives way to the plain version. :data:`LAUNCHES` counts kernel launches
(one per call on the card with a non-empty buffer).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.mailbox_pack import ref as _ref

#: kernel launches so far (callers may reset it to 0)
LAUNCHES = 0

#: most word-planes one launch writes, the validity plane included (the
#: kernel's pointer table)
MAX_COLS = 16


def mailbox_pack(cols, order: torch.Tensor, skey: torch.Tensor,
                 n_buckets: int, cap: int) -> torch.Tensor:
    """Build the packed (p, W, n_buckets * cap) int32 mailbox send buffer
    from the bucket sort of one hop (``exchange._bucket_indices``).

    ``cols``: the W - 1 payload word-planes, each (p, Q) int32 in input
    order; ``order``: (p, Q) int64 sort permutation; ``skey``: (p, Q)
    int32 sorted bucket keys, ``n_buckets`` for messages that never ship.
    Cell c of bucket b holds message ``order[pe, start_b + c]`` while
    ``c < min(run_b, cap)``, with its validity word 1; every other word
    is zero. Equal to :func:`ref.mailbox_pack_sorted_ref`.
    """
    global LAUNCHES
    if skey.device.type == "cpu":
        return _ref.mailbox_pack_sorted_ref(cols, order, skey, n_buckets, cap)
    if skey.device.type != "cuda":
        raise ValueError(f"mailbox_pack: unsupported device {skey.device}")
    cols = list(cols)
    if len(cols) + 1 > MAX_COLS:
        raise ValueError(f"mailbox_pack: {len(cols)} payload planes, the "
                         f"kernel takes at most {MAX_COLS - 1}")
    if skey.dim() != 2 or skey.dtype != torch.int32 \
            or not skey.is_contiguous():
        raise ValueError("mailbox_pack: skey must be a contiguous (p, Q) "
                         "int32 tensor")
    if order.shape != skey.shape or order.dtype != torch.int64 \
            or order.device != skey.device or not order.is_contiguous():
        raise ValueError("mailbox_pack: order must be a contiguous int64 "
                         "tensor shaped like skey, on the same device")
    for c in cols:
        if c.shape != skey.shape or c.dtype != torch.int32 \
                or c.device != skey.device or not c.is_contiguous():
            raise ValueError("mailbox_pack: every payload plane must be a "
                             "contiguous int32 tensor shaped like skey, on "
                             "the same device")
    p, q = skey.shape
    w = len(cols) + 1
    if n_buckets < 0 or cap < 0 or w * n_buckets * cap >= 2 ** 31 \
            or q >= 2 ** 31 or p > 65535:
        raise ValueError(f"mailbox_pack: p={p}, Q={q}, n_buckets="
                         f"{n_buckets}, cap={cap} out of range")
    out = torch.empty((p, w, n_buckets * cap), dtype=torch.int32,
                      device=skey.device)
    if out.numel() == 0:
        return out
    lib = _build.load_library()
    ptrs = (ctypes.c_void_p * max(1, len(cols)))(
        *(c.data_ptr() for c in cols))
    stream = torch.cuda.current_stream(skey.device).cuda_stream
    _build.check(lib.mailbox_pack_launch(
        ptrs, len(cols), order.data_ptr(), skey.data_ptr(), p, q, n_buckets,
        cap, out.data_ptr(), stream), "mailbox_pack")
    LAUNCHES += 1
    return out
