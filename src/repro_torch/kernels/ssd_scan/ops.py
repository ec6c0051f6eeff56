"""Public wrapper for ``ssd_scan``: the CUDA kernel on the card, the plain
sequential scan for CPU tensors, and a backward that recomputes through
:func:`ref.ssd_ref` (the JAX package's custom vjp,
``src/repro/kernels/ssd_scan/ops.py``).

On a CUDA tensor the forward launches the kernel or raises; it never gives
way to the plain version, and a ragged last chunk (L % chunk != 0) is
masked by the kernel. By dtype:

- bfloat16: the chunk-parallel tensor-core kernels (C B^T, chunk states,
  state pass, chunk scan; four launches) with float32 scratch allocated
  here; N and P must be multiples of 8 (N <= 256);
- float32: the CUDA-core kernel, one launch.

:data:`LAUNCHES` counts wrapper calls that launched (one per forward
on the card, whatever the number of kernels). The backward goes through
the sequential ``ssd_ref`` and never through ``ssd_chunked_ref``, whose
masked exponentials give NaN gradients at long sequences.

:func:`ssd_decode_step`, the serving path's one-token state update, is
plain torch, as it is plain jnp in the JAX package: no kernel reaches it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.ssd_scan import ref as _ref

#: largest head dim P the kernel is instantiated for
MAX_HEAD_DIM = 128
#: shared memory a block may use on Hopper (bytes)
MAX_SMEM = 232_448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: wrapper calls that launched so far (callers may reset it to 0)
LAUNCHES = 0


def _check(x, dt, A, B, C, D, chunk):
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError("ssd_scan: x must be (Bt, L, H, P) and B, C "
                         "(Bt, L, G, N)")
    bt, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if B.shape[:2] != (bt, l) or dt.shape != (bt, l, h):
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}"
                         f" and B {tuple(B.shape)} disagree")
    if A.shape != (h,) or (D is not None and D.shape != (h,)):
        raise ValueError(f"ssd_scan: A and D must be ({h},)")
    if h % g:
        raise ValueError(f"ssd_scan: H={h} is not a multiple of G={g}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError("ssd_scan: x, B and C must share one dtype, float32 "
                         f"or bfloat16 (got {x.dtype}, {B.dtype}, {C.dtype})")
    for t in (dt, A) + ((D,) if D is not None else ()):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: dt, A and D must be float32 (got "
                             f"{t.dtype})")
    if chunk < 1:
        raise ValueError(f"ssd_scan: chunk={chunk} < 1")


def _launch(x, dt, A, B, C, D, chunk):
    """The CUDA kernel on validated inputs; raises on what it cannot take."""
    global LAUNCHES
    bt, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    tensors = (x, dt, A, B, C) + ((D,) if D is not None else ())
    for t in tensors:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("ssd_scan: x, dt, A, B, C and D must be "
                             "contiguous and on one device")
    if p > MAX_HEAD_DIM:
        raise ValueError(f"ssd_scan: head dim {p} > {MAX_HEAD_DIM}")
    if bt > 65535:
        raise ValueError(f"ssd_scan: shape {tuple(x.shape)} out of the "
                         "kernel's range")
    if x.numel() == 0:
        return torch.empty_like(x)  # nothing to launch, nothing to count
    lib = _build.load_library()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if D is None else D.data_ptr(), y.data_ptr())
    if x.dtype == torch.bfloat16:
        if n % 8 or p % 8 or n > 256:
            raise ValueError(f"ssd_scan: bfloat16 needs N and P multiples of "
                             f"8 and N <= 256 (got N={n}, P={p})")
        if any(t.data_ptr() % 16 for t in (x, B, C)):
            raise ValueError("ssd_scan: bfloat16 x, B and C must be 16-byte "
                             "aligned")
        smem = lib.ssd_scan_bf16_smem_bytes(n, p, chunk)
        if not 0 < smem <= MAX_SMEM:
            raise ValueError(f"ssd_scan: N={n}, P={p}, chunk={chunk} need "
                             f"{smem} bytes of shared memory (at most "
                             f"{MAX_SMEM})")
        nc, qp = -(-l // chunk), lib.ssd_scan_bf16_chunk_pad(chunk)
        # one float32 scratch: C B^T (Bt, nc, G, the 16 x 16 blocks of the
        # lower block triangle of qp x qp), the chunk states (Bt, H, nc, N,
        # P) then as many bf16 entering states (half the floats), and the
        # decays (Bt, H, nc), each 16-byte aligned
        blocks = qp // 16 * (qp // 16 + 1) // 2
        n_cb, n_st = bt * nc * g * blocks * 256, bt * h * nc * n * p * 3 // 2
        scratch = torch.empty(n_cb + n_st + bt * h * nc, dtype=torch.float32,
                              device=x.device)
        base = scratch.data_ptr()
        err = lib.ssd_scan_bf16_launch(
            *ptrs, base, base + 4 * n_cb, base + 4 * (n_cb + n_st), bt, l,
            h, g, n, p, chunk, qp, stream)
    else:
        smem = lib.ssd_scan_smem_bytes(n, p, chunk)
        if smem > MAX_SMEM:
            raise ValueError(f"ssd_scan: N={n}, P={p}, chunk={chunk} need "
                             f"{smem} bytes of shared memory (at most "
                             f"{MAX_SMEM})")
        err = lib.ssd_scan_launch(*ptrs, bt, l, h, g, n, p, chunk, stream)
    _build.check(err, "ssd_scan")
    LAUNCHES += 1
    return y


class _SSDScan(torch.autograd.Function):
    """Forward: the kernel (CUDA) or ``ssd_ref`` (CPU). Backward: autograd
    through ``ssd_ref`` recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, chunk):
        ctx.save_for_backward(x, dt, A, B, C, D)
        if x.device.type == "cpu":
            return _ref.ssd_ref(x, dt, A, B, C, D)
        if x.device.type != "cuda":
            raise ValueError(f"ssd_scan: unsupported device {x.device}")
        return _launch(x, dt, A, B, C, D, chunk)

    @staticmethod
    def backward(ctx, gy):
        x, dt, A, B, C, D = ctx.saved_tensors
        inputs = (x, dt, A, B, C) + ((D,) if D is not None else ())
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in inputs]
            y = _ref.ssd_ref(*leaves[:5], leaves[5] if D is not None else None)
            grads = torch.autograd.grad(y, leaves, gy)
        if D is None:
            grads = grads + (None,)
        return grads + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None,
             chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD: returns y of shape (Bt, L, H, P) in x's dtype.

    x: (Bt, L, H, P) float32 or bfloat16; dt: (Bt, L, H) float32; A, D:
    (H,) float32; B, C: (Bt, L, G, N) in x's dtype. ``chunk`` is the
    kernel's chunk length (``min(chunk, L)``; L need not be a multiple).
    Differentiable in x, dt, A, B, C and D.
    """
    _check(x, dt, A, B, C, D, chunk)
    return _SSDScan.apply(x, dt, A, B, C, D, min(chunk, max(x.shape[1], 1)))


def ssd_decode_step(x, dt, A, B, C, D, state):
    """Single-token decode: update the (Bt, H, N, P) float32 state and emit
    y, as ``repro.kernels.ssd_scan.ops.ssd_decode_step``.

    x: (Bt, H, P); dt: (Bt, H); A, D: (H,); B, C: (Bt, G, N). Returns
    (y in x's dtype, the new float32 state)."""
    h = x.shape[1]
    rep = h // B.shape[1]
    xf = x.float()
    dtf = dt.float()
    Bf = B.float().repeat_interleave(rep, dim=1)
    Cf = C.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dtf * A.float())[..., None, None]
    upd = (dtf[..., None] * Bf)[..., None] * xf[..., None, :]
    state = decay * state.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", Cf, state)
    if D is not None:
        y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), state
