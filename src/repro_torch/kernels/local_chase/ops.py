"""Public wrapper for ``local_chase``: the CUDA kernel on the card, the
plain torch version for CPU tensors.

On a CUDA tensor the kernel is launched or the call raises; it never
gives way to the plain version. ``local_chase.launches`` counts kernel
launches: one per call on the card (the call runs ``steps`` grid-wide
doubling steps).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.local_chase import ref as _ref

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def local_chase(succ: torch.Tensor, dist: torch.Tensor, steps: int):
    """Wyllie doubling with self-absorbing stops; returns (succ, dist).

    ``succ``: (..., m) int32 local indices in [0, m); ``dist``: same
    shape, int32 or float32. Bit-equal to
    :func:`repro_torch.kernels.local_chase.ref.local_chase_ref`.
    """
    if succ.device.type == "cpu":
        return _ref.local_chase_ref(succ, dist, steps)
    if succ.device.type != "cuda":
        raise ValueError(f"local_chase: unsupported device {succ.device}")
    if succ.dtype != torch.int32 or dist.dtype not in _DTYPE_CODE:
        raise ValueError("local_chase: succ must be int32 and dist int32 "
                         f"or float32, got {succ.dtype}, {dist.dtype}")
    if succ.shape != dist.shape or succ.dim() < 1 \
            or dist.device != succ.device:
        raise ValueError("local_chase: succ and dist must have one shape "
                         "(..., m) on one device")
    if not (succ.is_contiguous() and dist.is_contiguous()):
        raise ValueError("local_chase: inputs must be contiguous")
    if steps < 0:
        raise ValueError(f"local_chase: steps={steps} < 0")
    m = succ.shape[-1]
    b = succ.numel() // m if m else 0
    out_s, out_d = torch.empty_like(succ), torch.empty_like(dist)
    tmp_s, tmp_d = torch.empty_like(succ), torch.empty_like(dist)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(succ.device).cuda_stream
    _build.check(lib.local_chase_launch(
        succ.data_ptr(), dist.data_ptr(), _DTYPE_CODE[dist.dtype], b, m,
        steps, out_s.data_ptr(), out_d.data_ptr(), tmp_s.data_ptr(),
        tmp_d.data_ptr(), stream), "local_chase")
    local_chase.launches += 1
    return out_s, out_d


local_chase.launches = 0
