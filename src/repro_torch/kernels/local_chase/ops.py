"""Public wrapper for ``local_chase``: the CUDA kernel on the card, the
plain torch version for CPU tensors.

On a CUDA tensor the kernel is launched or the call raises; it never
gives way to the plain version. :data:`LAUNCHES` counts kernel launches:
one per call on the card (one cooperative launch runs every doubling
step, and stops at the first step that changes nothing).
:data:`STEPS_RUN` is a (B,) int32 device tensor, set by every
call on the card, of the steps each row's group ran (zeros for a call
that runs no step); the solve never reads it (that would add a host
sync), the tools do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.local_chase import ref as _ref

#: kernel launches so far (callers may reset it to 0)
LAUNCHES = 0
#: the steps each row's group ran in the last call on the card
STEPS_RUN = None

_DTYPE_CODE = {torch.int32: 0, torch.float32: 1}

#: share of the card's L2 that one group's two ping-pong buffer pairs may
#: take (the rest holds the gathers' other traffic)
L2_SHARE = 0.75


def l2_group_rows(b: int, m: int, itemsize: int, l2_bytes: int) -> int:
    """Rows a group walks together: as many as keep both buffer pairs
    (2 x (4 + itemsize) bytes per element) within ``L2_SHARE`` of the L2,
    at least one, and fewer than 2^31 elements."""
    per_row = 2 * m * (4 + itemsize)
    g = max(1, int(L2_SHARE * l2_bytes) // max(1, per_row))
    g = min(g, max(1, (2 ** 31 - 1) // max(1, m)))
    return min(b, g)


def rows_per_group(b: int, m: int, itemsize: int, device) -> int:
    """The rows a call on the CUDA ``device`` walks together by default:
    :func:`l2_group_rows` for the device's L2."""
    return l2_group_rows(
        b, m, itemsize, torch.cuda.get_device_properties(device).L2_cache_size)


def local_chase(succ: torch.Tensor, dist: torch.Tensor, steps: int):
    """Wyllie doubling with self-absorbing stops; returns (succ, dist).

    ``succ``: (..., m) int32 local indices in [0, m); ``dist``: same
    shape, int32 or float32. Bit-equal to
    :func:`repro_torch.kernels.local_chase.ref.local_chase_ref`. The
    kernel walks the rows in groups of :func:`rows_per_group`.
    """
    global LAUNCHES, STEPS_RUN
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
    if b >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"local_chase: (B, m) = ({b}, {m}) out of range")
    if steps == 0 or succ.numel() == 0:
        STEPS_RUN = torch.zeros(b, dtype=torch.int32, device=succ.device)
        return succ.clone(), dist.clone()
    g = rows_per_group(b, m, dist.element_size(), succ.device)
    n_groups = -(-b // g)
    out_s, out_d = torch.empty_like(succ), torch.empty_like(dist)
    tmp_s, tmp_d = torch.empty_like(succ), torch.empty_like(dist)
    ctrl = torch.zeros(n_groups + b, dtype=torch.int32, device=succ.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(succ.device).cuda_stream
    _build.check(lib.local_chase_launch(
        succ.data_ptr(), dist.data_ptr(), _DTYPE_CODE[dist.dtype], b, m,
        steps, g, out_s.data_ptr(), out_d.data_ptr(), tmp_s.data_ptr(),
        tmp_d.data_ptr(), ctrl.data_ptr(), stream), "local_chase")
    LAUNCHES += 1
    STEPS_RUN = ctrl[n_groups:]
    return out_s, out_d
