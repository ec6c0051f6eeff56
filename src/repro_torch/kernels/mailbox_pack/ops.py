"""Public wrapper for ``mailbox_pack``: the CUDA kernel on the card, the
plain torch version for CPU tensors.

On a CUDA tensor the kernel is launched or the call raises; it never
gives way to the plain version. ``mailbox_pack.launches`` counts kernel
launches (one per call on the card).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.mailbox_pack import ref as _ref

#: most word-planes one launch takes (the kernel's pointer table)
MAX_COLS = 16


def mailbox_pack(cols, slots: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Build the packed (p, W, n_rows) int32 mailbox send buffer.

    ``cols``: W word-planes, each (p, Q) int32; ``slots``: (p, Q) int32.
    ``out[pe, w, slots[pe, i]] = cols[w][pe, i]`` where
    ``0 <= slots[pe, i] < n_rows``; every other word is zero. Shipping
    slots must be unique per PE (the exchange's bucket sort makes them so).
    """
    if slots.device.type == "cpu":
        return _ref.mailbox_pack_ref(cols, slots, n_rows)
    if slots.device.type != "cuda":
        raise ValueError(f"mailbox_pack: unsupported device {slots.device}")
    cols = list(cols)
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"mailbox_pack: {len(cols)} word-planes, the "
                         f"kernel takes 1..{MAX_COLS}")
    if slots.dim() != 2 or slots.dtype != torch.int32 \
            or not slots.is_contiguous():
        raise ValueError("mailbox_pack: slots must be a contiguous (p, Q) "
                         "int32 tensor")
    for c in cols:
        if c.shape != slots.shape or c.dtype != torch.int32 \
                or c.device != slots.device or not c.is_contiguous():
            raise ValueError("mailbox_pack: every word-plane must be a "
                             "contiguous int32 tensor shaped like slots, "
                             "on the same device")
    if not 0 <= n_rows < 2 ** 31:
        raise ValueError(f"mailbox_pack: n_rows={n_rows} out of range")
    p, q = slots.shape
    out = torch.empty((p, len(cols), n_rows), dtype=torch.int32,
                      device=slots.device)
    lib = _build.load_library()
    ptrs = (ctypes.c_void_p * len(cols))(*(c.data_ptr() for c in cols))
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    _build.check(lib.mailbox_pack_launch(
        ptrs, len(cols), slots.data_ptr(), p, q, n_rows, out.data_ptr(),
        stream), "mailbox_pack")
    mailbox_pack.launches += 1
    return out


mailbox_pack.launches = 0
