"""Blockwise int8 compression: optimizer-state quantization and
error-feedback compressed all-reduce, as the JAX package's
``repro.runtime.compression``.

``QInt8`` holds an int8 payload and one float32 scale per block of
``BLOCK`` = 256 contiguous elements (bitsandbytes style), and the shape it
came from as metadata: in a checkpoint its leaves are ``.q`` and
``.scale``, the reference's keys. It serves

- AdamW's ``state_dtype="int8"`` (``repro_torch.optim.adamw``): a quarter
  of float32's moment bytes, plus the scales;
- :func:`compressed_psum`, the error-feedback int8 all-reduce over the
  port's transports (the reference's over a ``shard_map`` axis name).

The arithmetic is the reference's as XLA compiles it (under ``jit`` and
``shard_map``, where the reference's callers run it): the scale is the
block's absolute maximum times the float32 reciprocal of 127 (XLA's
rewrite of the division by the constant), the payload is the block over
its scale (1 where the scale is 0) rounded half to even and clipped to
+-127, dequantization multiplies the payload by its scale, and the
residual ``x - dequantize(q)`` is one fused multiply-add (XLA contracts
the two). So ``q``, ``scale``, the dequantized values and the residual
equal the compiled reference's bit for bit. Run op by op, the reference
divides by 127 and rounds the residual twice, which moves a scale or a
residual by one unit in the last place in a few blocks in a hundred.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

BLOCK = 256
#: 1/127 in float32, exactly representable as a Python float
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _blocks(flat: torch.Tensor) -> torch.Tensor:
    """(..., n) float32 -> (..., nblocks, BLOCK), zero-padded at the end."""
    n = flat.shape[-1]
    pad = -(-n // BLOCK) * BLOCK - n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(flat.shape[:-1] + (-1, BLOCK))


def _quantize_blocks(blocks: torch.Tensor):
    """(..., nb, BLOCK) float32 -> (q int8, scale float32 (..., nb))."""
    scale = blocks.abs().amax(dim=-1) * _INV_127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def _unblock(blocks: torch.Tensor, shape) -> torch.Tensor:
    """:func:`_blocks` undone: the first ``prod(shape)`` elements of each
    leading row, reshaped to ``shape``."""
    lead = blocks.shape[:-2]
    flat = blocks.reshape(lead + (-1,))
    n = _numel(shape) // max(_numel(lead), 1)
    return flat[..., :n].reshape(shape)


def _residual(blocks: torch.Tensor):
    """(blocks minus their dequantized int8 blocks, rounded once as a fused
    multiply-add rounds it, and the dequantized blocks).

    The difference is taken in float64, where it is exact: ``q * scale``
    has at most 8 + 24 significant bits, and where ``q`` is not 0 the
    block element is within a factor of 256 of ``scale``, so the
    difference needs at most 33 bits. Its one rounding to float32 is then
    the fused multiply-add's, on every device (CUDA's ``addcmul`` rounds
    the product first)."""
    q, scale = _quantize_blocks(blocks)
    exact = blocks.double() - q.double() * scale.double()[..., None]
    return exact.to(torch.float32), _dequantize_blocks(q, scale)


@dataclasses.dataclass
class QInt8:
    q: torch.Tensor        # (nblocks, BLOCK) int8
    scale: torch.Tensor    # (nblocks,) float32
    #: the quantized tensor's shape: metadata, not a checkpoint leaf
    shape: tuple[int, ...] = dataclasses.field(metadata={"static": True})

    @staticmethod
    def zeros(shape: Sequence[int], device=None) -> "QInt8":
        nb = -(-_numel(shape) // BLOCK)
        return QInt8(q=torch.zeros((nb, BLOCK), dtype=torch.int8,
                                   device=device),
                     scale=torch.zeros((nb,), dtype=torch.float32,
                                       device=device),
                     shape=tuple(shape))

    @staticmethod
    def quantize(x: torch.Tensor) -> "QInt8":
        q, scale = _quantize_blocks(_blocks(x.to(torch.float32).reshape(-1)))
        return QInt8(q=q, scale=scale, shape=tuple(x.shape))

    def dequantize(self) -> torch.Tensor:
        return _unblock(_dequantize_blocks(self.q, self.scale), self.shape)


def quantization_error(x: torch.Tensor) -> torch.Tensor:
    """``x - dequantize(quantize(x))`` in float32: the residual error
    feedback keeps."""
    err, _ = _residual(_blocks(x.to(torch.float32).reshape(-1)))
    return _unblock(err, tuple(x.shape))


def compressed_psum(x: torch.Tensor, transport, error: torch.Tensor,
                    axes: Sequence[str] | None = None):
    """Error-feedback int8 all-reduce over the port's transport.

    ``x`` and ``error`` are per-PE tensors with the transport's leading PE
    axis, (p_local, ...); each PE quantizes its own ``x + error`` in blocks
    of its own elements, as each device does in the reference's
    ``shard_map``. Returns ``(reduced, new_error)``: the dequantized blocks
    summed over every PE (``transport.psum``), or over the mesh ``axes``
    only (``transport.psum_axes``), in float32, and each PE's residual
    ``x + error - dequantized``, which the next call adds back, so the
    bias vanishes over steps (Karimireddy et al., error feedback)."""
    xc = x.to(torch.float32) + error
    err, deq = _residual(_blocks(xc.reshape(xc.shape[0], -1)))
    new_error = _unblock(err, tuple(xc.shape))
    deq = _unblock(deq, tuple(xc.shape))
    reduced = (transport.psum(deq) if axes is None
               else transport.psum_axes(deq, tuple(axes)))
    return reduced, new_error
