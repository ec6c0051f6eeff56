"""Run-time services of the port: fault tolerance (``fault_tolerance``)
and the ambient mesh context (``context``: ``MeshCtx``, ``current``,
``use_mesh``)."""
from repro_torch.runtime.context import MeshCtx, current, use_mesh

__all__ = ["MeshCtx", "current", "use_mesh"]
