"""Ambient mesh context for layers that run over the port's transports,
as the JAX package's ``repro.runtime.context``.

Model code takes no mesh argument, so a driver (the training launcher)
activates the mesh around its steps:

    with context.use_mesh(mesh):
        train_step(...)

``layers.moe_ffn`` takes the expert-parallel ``moe_ffn_ep`` when a
context is active; without one it takes the single-program dispatch
(single-device tests, serving, smoke configs).

The mesh is a ``transport.SimMesh`` (every PE in this process, on the
device of the layer's input) or a ``transport.DistMesh`` (the ranks of a
process group). It names axes and sizes only: no devices and no
sharding, so the reference's logits-layout constraint in ``unembed``
has no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from contextvars import ContextVar
from typing import Any

import torch

from repro_torch.core.listrank import transport as transport_lib


@dataclasses.dataclass(frozen=True)
class MeshCtx:
    mesh: Any                     # transport.SimMesh or transport.DistMesh
    dp_axes: tuple[str, ...]      # batch-parallel axes ("pod", "data")
    ep_axis: str                  # expert-parallel axis ("data")
    tp_axis: str | None           # tensor-parallel axis ("model")
    #: the transports over the mesh's PEs, one per device, built once
    _transports: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    @property
    def all_axes(self) -> tuple[str, ...]:
        return tuple(self.mesh.axis_names)

    def transport(self, device) -> transport_lib.CountingTransport:
        """The transport over every PE of the mesh (flattened row-major
        over :attr:`all_axes`) on ``device``, counted: a
        ``VirtualTransport`` for a SimMesh, a ``DistTransport`` for a
        DistMesh. Built once per device, so its hop maps and subgroups
        are too; its ``counts`` accumulate over the context's calls."""
        device = torch.device(device)
        key = str(device)
        if key not in self._transports:
            axes, sizes = self.all_axes, tuple(self.mesh.axis_sizes)
            if isinstance(self.mesh, transport_lib.DistMesh):
                inner = transport_lib.DistTransport.for_mesh(self.mesh, axes,
                                                             device)
            else:
                inner = transport_lib.VirtualTransport(axes, sizes, device)
            self._transports[key] = transport_lib.CountingTransport(inner)
        return self._transports[key]


_CTX: ContextVar[MeshCtx | None] = ContextVar("repro_torch_mesh_ctx",
                                              default=None)


def current() -> MeshCtx | None:
    return _CTX.get()


@contextlib.contextmanager
def use_mesh(mesh, dp_axes=None, ep_axis="data", tp_axis="model"):
    """Activate ``mesh`` for the block and yield its :class:`MeshCtx`:
    ``dp_axes`` default to the mesh's ``"pod"`` and ``"data"``, the
    expert axis falls back to the mesh's last axis, and the tensor axis
    is None when the mesh has no ``tp_axis``."""
    names = tuple(mesh.axis_names)
    if dp_axes is None:
        dp_axes = tuple(a for a in ("pod", "data") if a in names)
    tp = tp_axis if tp_axis in names else None
    ep = ep_axis if ep_axis in names else names[-1]
    ctx = MeshCtx(mesh=mesh, dp_axes=tuple(dp_axes), ep_axis=ep, tp_axis=tp)
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)


@contextlib.contextmanager
def entered(ctx: MeshCtx | None):
    """Make ``ctx`` (a context :func:`use_mesh` yielded, or None) the
    current one for the block: a layer's recompute, which autograd may run
    on another thread, runs under the context its forward ran under."""
    tok = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(tok)
