"""Public wrapper for ``flash_attention``: the CUDA kernel on the card, the
plain torch version for CPU tensors, and a backward that recomputes
through :func:`ref.attention_ref` (the JAX package's custom vjp,
``src/repro/kernels/flash_attention/ops.py``).

On a CUDA tensor the forward launches the kernel or raises; it never
gives way to the plain version. By dtype and query length:

- bfloat16, Lq > 1: the tensor-core kernel (``flash_fwd_mma_kernel``);
- bfloat16, Lq = 1 (decode): split-K, ``flash_decode_split_kernel`` over
  :func:`decode_splits` splits of the keys, then
  ``flash_decode_merge_kernel``, with float32 partials in scratch
  allocated here;
- float32: the CUDA-core kernel (``flash_fwd_kernel``).

:data:`LAUNCHES` counts wrapper calls that launched: one per
forward on the card, the decode's two kernels counting once (the backward
launches none). Differentiable in q, k and v; a ``q_offset`` tensor is not.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.flash_attention import ref as _ref

#: head dims the kernel is instantiated for (every config of the repo)
HEAD_DIMS = (16, 24, 32, 64, 112, 128, 256)
#: most query heads that share one kv head (rows of the kernel's tile)
MAX_GROUP = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: wrapper calls that launched so far (callers may reset it to 0)
LAUNCHES = 0
#: keys a decode tile; a decode part is a whole number of them
DECODE_TILE = 64
#: parts (warps) a decode split (CTA) has: flash_attention.cu's kDecWarps
PARTS_PER_SPLIT = 4


def decode_splits(b: int, hkv: int, group: int, lk: int, n_sm: int) -> int:
    """Key splits (CTAs along the keys) of a decode launch: enough that the
    grid (splits, Hkv x 16-row tiles of the group, B) puts two CTAs on each
    of ``n_sm`` SMs, but no more than leave each of a split's
    ``PARTS_PER_SPLIT`` parts one tile of keys."""
    ctas = b * hkv * -(-group // 16)
    want = -(-2 * n_sm // max(ctas, 1))
    most = -(-lk // (PARTS_PER_SPLIT * DECODE_TILE))
    return max(1, min(want, most))


def decode_part_len(lk: int, splits: int) -> int:
    """Keys each decode part covers: a multiple of ``DECODE_TILE``, so the
    ``splits * PARTS_PER_SPLIT`` parts cover all ``lk`` keys."""
    parts = splits * PARTS_PER_SPLIT
    return max(1, -(-lk // (parts * DECODE_TILE))) * DECODE_TILE


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    q_offset=0) -> torch.Tensor:
    """Attention with GQA, causal/window masks and softcap.

    q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D), float32 or bfloat16,
    contiguous. ``q_offset``: the absolute position of q[:, :, 0], an int
    or a (B,) integer tensor on q's device. Returns (B, Hq, Lq, D) in q's
    dtype; see :func:`ref.attention_ref` for the semantics.
    """
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 q_offset)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or ``attention_ref`` (CPU). Backward:
    autograd through ``attention_ref`` recomputed on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset)
        return _forward(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _ref.attention_ref(*leaves, **ctx.kw)
            grads = torch.autograd.grad(out, leaves, g)
        return grads + (None,) * 5


def _forward(q, k, v, *, causal, window, softcap, scale, q_offset):
    global LAUNCHES
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q must be (B, Hq, Lq, D) and k, v "
                         "(B, Hkv, Lk, D)")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"flash_attention: Hq={hq}, Hkv={hkv}: the group "
                         f"must be a whole number up to {MAX_GROUP}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention: q, k, v must share one dtype, "
                         f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                         f"{v.dtype})")
    for t in (q, k, v):
        if t.device != q.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v must be contiguous, "
                             "16-byte aligned and on one device")
    if b > 65535 or hkv > 65535 or max(lq, lk) >= 2 ** 31:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} out of the kernel's range")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window={window} < 0")
    if isinstance(q_offset, torch.Tensor):
        if q_offset.shape != (b,) or q_offset.device != q.device:
            raise ValueError("flash_attention: a q_offset tensor must be "
                             "(B,) on q's device")
        offsets = q_offset.to(torch.int32).contiguous()
        off_ptr, off_scalar = offsets.data_ptr(), 0
    else:
        off_ptr, off_scalar = None, int(q_offset)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty_like(q)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16 and lq == 1:
        splits = decode_splits(b, hkv, hq // hkv, lk, torch.cuda
                               .get_device_properties(q.device)
                               .multi_processor_count)
        rows = b * hq * splits * PARTS_PER_SPLIT
        # one scratch: (m, l) of every part, then its float32 acc
        part = torch.empty(rows * (2 + d), dtype=torch.float32,
                           device=q.device)
        _build.check(lib.flash_attention_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), off_ptr,
            off_scalar, b, hq, hkv, lk, d, int(causal),
            -1 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap), float(scale), splits,
            PARTS_PER_SPLIT, decode_part_len(lk, splits), part.data_ptr(),
            part.data_ptr() + 4 * 2 * rows, stream), "flash_attention")
        LAUNCHES += 1
        return out
    _build.check(lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), off_ptr,
        off_scalar, b, hq, hkv, lq, lk, d, _DTYPES[q.dtype], int(causal),
        -1 if window is None else int(window), int(softcap is not None),
        0.0 if softcap is None else float(softcap), float(scale), stream),
        "flash_attention")
    LAUNCHES += 1
    return out
