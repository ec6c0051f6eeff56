"""Where the port runs: the CUDA device unless the caller says otherwise."""
from __future__ import annotations

import os

import torch


def resolve_device(device=None, mesh=None) -> torch.device:
    """``None`` means the CUDA device; without CUDA that raises. On a
    ``DistMesh`` (a process per rank) ``None`` means this process's
    card, ``cuda:{LOCAL_RANK % device_count}`` (the mesh's rank when the
    launcher set no ``LOCAL_RANK``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the card; pass "
                "device='cpu' to run on the CPU explicitly")
        rank = getattr(mesh, "rank", None)
        if rank is None:
            return torch.device("cuda")
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
