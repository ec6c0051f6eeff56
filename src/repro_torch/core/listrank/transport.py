"""Transports: how the per-PE program reaches the other PEs.

The solver is written over *batched* per-PE tensors: every per-PE array
carries a leading PE axis of size ``p`` (PE ids flattened row-major over
the mesh axes), and every collective goes through a transport object.

:class:`VirtualTransport` is the virtual-PE transport — all ``p`` PEs
live on one device, and each collective is plain data movement on the
PE axis:

- ``axis_index`` is an ``arange`` over the PE axis,
- ``all_to_all`` over a hop is an index permutation of the mailbox axis
  (mailbox row ``b`` of PE ``i`` lands in row ``coord_hop(i)`` of the PE
  whose hop coordinate is ``b`` and whose other coordinates are ``i``'s),
- ``psum`` is a sum over the PE axis, broadcast back to every PE,
- ``all_gather`` is a reshape and broadcast.

Because the PE axis is an ordinary batch dimension, the CUDA kernels take
it as their batch axis and run under this transport unchanged.

:class:`CountingTransport` wraps a transport and counts its calls and
per-PE payload bytes per collective, so ``resume.run_staged`` can report
how many collectives each stage issued and price them (the run-time
counterpart of counting collectives in a traced program).

:class:`SimMesh` is the device-free mesh description (axis names and
sizes) every front door accepts.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SimMesh:
    """Device-free virtual mesh: axis names and sizes only."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("axis_names and axis_sizes length mismatch")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError("axis sizes must be positive")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out


def sim_mesh(shape: int | Sequence[int],
             axis_names: Sequence[str] | None = None) -> SimMesh:
    """A virtual mesh of any shape — no devices required.

    ``sim_mesh(256)`` is a flat 256-PE mesh on axis ``"pe"``;
    ``sim_mesh((2, 128), ("row", "col"))`` a 2D grid for indirection.
    """
    if isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if axis_names is None:
        axis_names = ("pe",) if len(shape) == 1 else tuple(
            f"pe{i}" for i in range(len(shape)))
    return SimMesh(axis_names=tuple(axis_names), axis_sizes=shape)


def is_sim(mesh) -> bool:
    return isinstance(mesh, SimMesh)


def resolve_backend(backend: str, mesh, pe_axes: Sequence[str]):
    """Resolve a ``ListRankConfig.backend`` against the mesh object.

    Returns ``(backend, mesh)``, with any mesh-like object (``axis_names``
    and ``shape``) swapped for its SimMesh twin when simshard is forced.
    The ``torch.distributed`` transport (``"mesh"``) is not ported yet.
    """
    pe_axes = tuple(pe_axes)
    if backend == "auto":
        backend = "simshard" if is_sim(mesh) else "mesh"
    if backend == "mesh":
        raise NotImplementedError(
            "the torch.distributed transport (backend='mesh') is not "
            "ported yet; pass a SimMesh or backend='simshard'")
    if backend != "simshard":
        raise ValueError(f"unknown transport backend {backend!r}")
    if not is_sim(mesh):
        mesh = SimMesh(axis_names=pe_axes,
                       axis_sizes=tuple(mesh.shape[a] for a in pe_axes))
    return backend, mesh


def _strides(sizes: Sequence[int]) -> list[int]:
    out, acc = [], 1
    for s in reversed(sizes):
        out.append(acc)
        acc *= s
    return out[::-1]


@dataclasses.dataclass(frozen=True, eq=False)
class VirtualTransport:
    """All PEs on one device; collectives are moves on the PE axis."""

    pe_axes: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    #: per-hop device index maps, built once per hop
    _perm: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def p(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    def axis_index(self) -> torch.Tensor:
        """(p,) int32: every PE's own flat id."""
        return torch.arange(self.p, dtype=torch.int32, device=self.device)

    def _hop_sources(self, hop: Sequence[str]):
        """Static maps of one hop: ``src[j, b]`` is the PE whose mailbox
        row ``coord[j]`` lands in row ``b`` of PE ``j``'s receive buffer
        (the peer with hop coordinate ``b`` and ``j``'s other coords)."""
        strides = _strides(self.axis_sizes)
        pe = np.arange(self.p, dtype=np.int64)
        coord = np.zeros_like(pe)
        rest = pe.copy()
        s = 1
        for a in hop:
            i = self.pe_axes.index(a)
            c = (pe // strides[i]) % self.axis_sizes[i]
            coord = coord * self.axis_sizes[i] + c
            rest -= c * strides[i]
            s *= self.axis_sizes[i]
        # hop coordinate b -> its contribution to the flat PE id
        b = np.arange(s, dtype=np.int64)
        contrib = np.zeros(s, np.int64)
        for a in reversed(hop):
            i = self.pe_axes.index(a)
            contrib += (b % self.axis_sizes[i]) * strides[i]
            b = b // self.axis_sizes[i]
        src = rest[:, None] + contrib[None, :]
        return src, coord

    def all_to_all(self, x: torch.Tensor, hop: Sequence[str],
                   axis: int) -> torch.Tensor:
        """Tiled all_to_all over the axis group ``hop``: ``x`` is
        (p, ...) and its per-PE axis ``axis`` (of size hop_size) is both
        split and concatenated, as ``lax.all_to_all(..., tiled=True)``."""
        hop = tuple(hop)
        if hop not in self._perm:
            src, coord = self._hop_sources(hop)
            s = src.shape[1]
            # receive row (j, b) <- send row (src[j, b], coord[j])
            flat = (src * s + coord[:, None]).reshape(-1)
            self._perm[hop] = (s, torch.as_tensor(flat, device=self.device))
        s, flat = self._perm[hop]
        ax = axis + 1
        if x.shape[ax] != s:
            raise ValueError(f"mailbox axis has size {x.shape[ax]}, hop "
                             f"{hop} has {s} peers")
        xm = x.movedim(ax, 1)                       # (p, s, ...)
        out = xm.reshape((self.p * s,) + xm.shape[2:]).index_select(0, flat)
        return out.reshape(xm.shape).movedim(1, ax)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the PE axis, broadcast back to every PE (dtype kept:
        int32 sums wrap like the reference's)."""
        tot = x.sum(dim=0, keepdim=True, dtype=x.dtype)
        return tot.expand_as(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather over every PE: (p, c, ...) -> (p, p*c, ...)."""
        flat = x.reshape((1, -1) + tuple(x.shape[2:]))
        return flat.expand((self.p,) + tuple(flat.shape[1:]))


class CountingTransport:
    """Wraps a transport; counts every collective call by name.

    ``counts`` is a ``collections.Counter`` over ``all_to_all``,
    ``psum`` and ``all_gather`` (``axis_index`` is not a collective);
    ``nbytes`` the same over each call's payload bytes per PE, the
    input's ``numel() * element_size() // p`` (the reference's simshard
    normalization). Both read tensor metadata only: no device work, no
    synchronisation. ``resume.run_staged`` clears them per stage."""

    def __init__(self, inner):
        self.inner = inner
        self.counts: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()

    p = property(lambda self: self.inner.p)
    device = property(lambda self: self.inner.device)

    def _count(self, prim: str, x) -> None:
        self.counts[prim] += 1
        self.nbytes[prim] += x.numel() * x.element_size() // self.inner.p

    def clear(self) -> None:
        self.counts.clear()
        self.nbytes.clear()

    def footprint(self) -> dict[str, tuple[int, int]]:
        """``{collective: (count, payload bytes per PE)}`` since the last
        :meth:`clear`, in the shape of the reference's
        ``introspect.collective_footprint``."""
        return {k: (c, self.nbytes[k]) for k, c in sorted(self.counts.items())}

    def axis_index(self):
        return self.inner.axis_index()

    def all_to_all(self, x, hop, axis):
        self._count("all_to_all", x)
        return self.inner.all_to_all(x, hop, axis)

    def psum(self, x):
        self._count("psum", x)
        return self.inner.psum(x)

    def all_gather(self, x):
        self._count("all_gather", x)
        return self.inner.all_gather(x)
