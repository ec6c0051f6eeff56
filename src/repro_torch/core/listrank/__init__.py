"""Distributed list ranking on PyTorch — the port of
``repro.core.listrank``.

Implements the sparse-ruling-set (SRS) algorithm with ruler spawning,
pointer doubling (Wyllie) as baseline and base case, local contraction
for locality exploitation, and direct / grid / topology-aware message
indirection, over a virtual-PE transport on one device (``sim_mesh``) or
the ``torch.distributed`` transport across processes (``dist_mesh``).
"""
from repro_torch.core.listrank.config import ListRankConfig, IndirectionSpec
from repro_torch.core.listrank.api import rank_list, rank_list_with_stats
from repro_torch.core.listrank.faults import (FaultSpec, FaultInjector,
                                              InjectedFault, CorruptedState)
from repro_torch.core.listrank.resume import SolveExhausted
from repro_torch.core.listrank.sequential import rank_list_seq
from repro_torch.core.listrank.srs import default_perm_fn, perm_fn_from_numpy
from repro_torch.core.listrank.transport import (DistMesh, SimMesh,
                                                 dist_mesh, sim_mesh)
from repro_torch.core.listrank import instances, analysis, tuner

__all__ = [
    "ListRankConfig",
    "IndirectionSpec",
    "rank_list",
    "rank_list_with_stats",
    "rank_list_seq",
    "SolveExhausted",
    "FaultSpec",
    "FaultInjector",
    "InjectedFault",
    "CorruptedState",
    "SimMesh",
    "sim_mesh",
    "DistMesh",
    "dist_mesh",
    "default_perm_fn",
    "perm_fn_from_numpy",
    "instances",
    "analysis",
    "tuner",
]
