"""Meshes over the processes of a ``torch.distributed`` job: the port's
counterpart of the reference's ``launch/mesh.py``.

Both functions read the initialised default process group (the caller
runs ``torch.distributed.init_process_group`` first, with its address,
world size and rank) and never touch a device. The reference's TPU pod
shapes and its hardware constants describe TPUs and are not carried
over: a rank here holds ``pes_per_rank`` list-ranking PEs, one per card
across cards, or several on one card.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.listrank.transport import DistMesh, dist_mesh


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def make_host_mesh(shape: Sequence[int] | None = None,
                   axes: Sequence[str] = ("data", "model")) -> DistMesh:
    """A mesh over every rank of the job (tests, smoke runs): ``(world,
    1)`` on ``axes`` unless ``shape`` says otherwise."""
    if shape is None:
        shape = (_world(), 1)
    return dist_mesh(tuple(shape), tuple(axes))


def make_listrank_mesh(pes_per_rank: int = 1,
                       shape: Sequence[int] | None = None,
                       axis_names: Sequence[str] | None = None) -> DistMesh:
    """The list-ranking core's PE grid over the job: a flat axis
    ``"pe"`` of ``world * pes_per_rank`` PEs, or ``shape`` (and
    ``axis_names``) when given, the factorisation that grid indirection
    routes over. Rank r holds PEs ``[r * k, (r + 1) * k)``, ``k`` the
    mesh's ``pes_per_rank``."""
    if shape is None:
        shape = (_world() * pes_per_rank,)
    return dist_mesh(tuple(shape), axis_names)
