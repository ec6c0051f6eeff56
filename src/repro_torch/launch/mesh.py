"""Meshes: the port's counterpart of the reference's ``launch/mesh.py``.

:func:`make_production_mesh` is the shape-only mesh of the dry run
(``launch/dryrun.py``): H100 SXM nodes of eight cards, (32, 8) on
``("data", "model")`` for 256 cards and (2, 32, 8) on ``("pod", "data",
"model")`` for 512, where the reference's describe TPU v5e pods ((16, 16)
and (2, 16, 16)). It is a ``transport.SimMesh``: axis names and sizes, no
process group and no device. The constants below are the card's for the
dry run's roofline.

:func:`make_host_mesh` and :func:`make_listrank_mesh` read the
initialised default process group (the caller runs
``torch.distributed.init_process_group`` first, with its address, world
size and rank) and never touch a device: a rank holds ``pes_per_rank``
list-ranking PEs, one per card across cards, or several on one card.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch import devtime
from repro_torch.core.listrank.transport import (DistMesh, SimMesh,
                                                 dist_mesh, sim_mesh)

#: The card the roofline prices, and its datasheet rates: "NVIDIA H100
#: 80GB HBM3, 700.00 W" (the SXM card). Nothing on a one-card machine
#: measures the two link rates.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = devtime.BF16_OPS_PER_S   # per card, dense
HBM_BW = devtime.HBM_BYTES_PER_S           # bytes/s per card
HBM_BYTES = 80e9                           # device memory per card
NVLINK_BW = 450e9    # bytes/s a direction a card, inside a node (NVLink 4)
IB_BW = 50e9         # bytes/s a card between nodes (InfiniBand NDR, 400 Gb/s)
#: cards a node: the ``"model"`` axis stays inside one
NODE_CARDS = 8


def make_production_mesh(*, multi_pod: bool = False) -> SimMesh:
    """The dry run's mesh: (32, 8) ``("data", "model")``, 256 cards, or
    with ``multi_pod`` (2, 32, 8) ``("pod", "data", "model")``, 512."""
    if multi_pod:
        return sim_mesh((2, 32, NODE_CARDS), ("pod", "data", "model"))
    return sim_mesh((32, NODE_CARDS), ("data", "model"))


def link_bandwidth(mesh, axes: Sequence[str]) -> float:
    """Bytes/s a card for a collective over mesh ``axes``: NVLink when
    the group stays inside a node (the axes are among the innermost,
    row-major, and those span at most a node's cards), else InfiniBand."""
    sizes = mesh.shape
    inner, span = set(), 1
    for a in reversed(tuple(mesh.axis_names)):
        if a not in axes and sizes[a] > 1:
            break
        inner.add(a)
        span *= sizes[a]
    within = set(axes) <= inner and span <= NODE_CARDS
    return NVLINK_BW if within else IB_BW


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
