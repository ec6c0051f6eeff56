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
- ``all_gather`` is a reshape and broadcast,
- ``psum_axes`` (a sum over some mesh axes only, the reference's
  ``lax.psum(x, axes)``) is a reshape to the axis grid and a sum.

Because the PE axis is an ordinary batch dimension, the CUDA kernels take
it as their batch axis and run under this transport unchanged.

:class:`DistTransport` is the ``torch.distributed`` transport, the
counterpart of the reference's mesh backend: PEs live in separate
processes (ranks). Rank ``r`` of a world of ``w`` owns the ``k = p / w``
global PEs ``[r*k, (r+1)*k)`` (flattened row-major, as the reference's
mesh flattens them), so every per-PE tensor's leading axis has size
``k`` (``p_local``) instead of ``p``. ``k = 1`` is the reference's
layout, one PE per device; ``k > 1`` is what fits on one card. Each
collective is one ``torch.distributed`` call:

- ``axis_index`` is the rank's own global ids;
- ``all_to_all`` over a hop is ONE ``all_to_all_single`` with static
  split sizes from the hop's peer map, the rows put into place by one
  ``index_select`` on each side; peers on the same rank move by index,
  not over the wire;
- ``psum`` is a local sum over the ``k`` PEs, then one ``all_reduce``
  (int32 sums wrap, as the reference's do; a float sum gathers every
  PE's value and sums in PE order, as the virtual transport does);
- ``all_gather`` is one ``all_gather_into_tensor``, broadcast to the
  ``k`` local PEs;
- ``psum_axes`` is one ``all_gather_into_tensor`` over the subgroup of
  ranks that hold the PEs of the rank's reduction groups (built once per
  axis set), then the virtual transport's sum in PE order; none when
  those PEs all live on the rank (one card: a sum by index).

Both transports also carry *uncounted* host reads, which are not
collectives of the algorithm (the reference reads a global array on the
host, which is no collective in its program): :meth:`gather_pes` (every
PE's rows on every rank: outputs, telemetry records, a checkpoint's
boundary state), :meth:`rank_sum` (a host-read total equal on every
rank), :meth:`agree` (small integers summed over the ranks, read on the
host: the flags every rank acts on, so that every rank takes the same
branch) and :meth:`from_rank0` (rank 0's small integer on every rank,
and a barrier: the step to restore, a retry decision). :meth:`local_rows` is no collective: the
rank's PEs' rows of a whole (p, ...) tensor, as a restored checkpoint
holds them. For training over the ranks,
:meth:`gather_pes` passes gradients (a rank's rows of the cotangent),
and :meth:`replicated` marks an input that every rank holds whole: its
backward sums the cotangent over the ranks (uncounted as well).

:class:`CountingTransport` wraps a transport and counts its calls and
per-PE payload bytes per collective, so ``resume.run_staged`` can report
how many collectives each stage issued and price them (the run-time
counterpart of counting collectives in a traced program).

:class:`SimMesh` is the device-free mesh description (axis names and
sizes) every front door accepts; :class:`DistMesh` (:func:`dist_mesh`)
the same over an initialised process group.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Sequence

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


@dataclasses.dataclass(frozen=True)
class DistMesh:
    """A mesh over the ranks of a ``torch.distributed`` process group:
    axis names and sizes of the ``p`` PEs, the group (``None``: the
    default group), the world size and this process's rank in it.
    Rank ``r`` owns the ``pes_per_rank`` global PEs starting at
    ``r * pes_per_rank``."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    world: int
    rank: int
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        SimMesh(self.axis_names, self.axis_sizes)  # the same checks
        if self.size % self.world != 0:
            raise ValueError(f"{self.size} PEs do not split over "
                             f"{self.world} ranks")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside world {self.world}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    @property
    def pes_per_rank(self) -> int:
        return self.size // self.world


def dist_mesh(shape: int | Sequence[int],
              axis_names: Sequence[str] | None = None,
              group=None) -> DistMesh:
    """The PE mesh ``shape`` over the ranks of ``group`` (the default
    process group when None), which must be initialised: the counterpart
    of the reference's ``compat.make_mesh``. ``dist_mesh(8)`` over 2
    ranks gives each rank 4 PEs on axis ``"pe"``."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("dist_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    sim = sim_mesh(shape, axis_names)
    return DistMesh(axis_names=sim.axis_names, axis_sizes=sim.axis_sizes,
                    world=dist.get_world_size(group),
                    rank=dist.get_rank(group), group=group)


def is_sim(mesh) -> bool:
    return isinstance(mesh, SimMesh)


def backend_name(mesh) -> str:
    """The backend label of a resolved mesh object (span annotations,
    trace metadata); keep in sync with :func:`resolve_backend`."""
    return "simshard" if is_sim(mesh) else "mesh"


def resolve_backend(backend: str, mesh, pe_axes: Sequence[str]):
    """Resolve a ``ListRankConfig.backend`` against the mesh object.

    Returns ``(backend, mesh)``: ``"auto"`` follows the mesh object
    (``"mesh"`` for a :class:`DistMesh`, ``"simshard"`` for a
    :class:`SimMesh`); ``"simshard"`` swaps any mesh-like object (``axis_
    names`` and ``shape``) for its SimMesh twin; ``"mesh"`` rejects a
    SimMesh, as the reference does, and needs a DistMesh.
    """
    pe_axes = tuple(pe_axes)
    if backend == "auto":
        backend = "simshard" if is_sim(mesh) else "mesh"
    if backend == "simshard" and not is_sim(mesh):
        mesh = SimMesh(axis_names=pe_axes,
                       axis_sizes=tuple(mesh.shape[a] for a in pe_axes))
    elif backend == "mesh" and is_sim(mesh):
        raise ValueError("backend='mesh' requires a real device mesh; "
                         "got a SimMesh (use backend='auto'/'simshard')")
    elif backend == "mesh" and not isinstance(mesh, DistMesh):
        raise TypeError(f"backend='mesh' runs over a DistMesh "
                        f"(dist_mesh); got {type(mesh).__name__}")
    elif backend not in ("mesh", "simshard"):
        raise ValueError(f"unknown transport backend {backend!r}")
    return backend, mesh


def _strides(sizes: Sequence[int]) -> list[int]:
    out, acc = [], 1
    for s in reversed(sizes):
        out.append(acc)
        acc *= s
    return out[::-1]


def axes_sum(x: torch.Tensor, pe_axes: Sequence[str],
             axis_sizes: Sequence[int], axes: Sequence[str]) -> torch.Tensor:
    """(p, ...) -> (p, ...): every PE's ``x`` summed over the PEs that
    differ from it only in ``axes`` (a reshape to the axis grid and one
    sum), broadcast back to each of them; dtype kept."""
    dims = tuple(tuple(pe_axes).index(a) for a in axes)
    if not dims:
        return x
    grid = x.reshape(tuple(axis_sizes) + tuple(x.shape[1:]))
    tot = grid.sum(dim=dims, keepdim=True, dtype=x.dtype)
    return tot.expand_as(grid).reshape(x.shape)


def hop_sources(pe_axes: Sequence[str], axis_sizes: Sequence[int],
                hop: Sequence[str]):
    """Static maps of one hop over all ``p`` PEs: ``src[j, b]`` is the
    PE whose mailbox row ``coord[j]`` lands in row ``b`` of PE ``j``'s
    receive buffer (the peer with hop coordinate ``b`` and ``j``'s other
    coords)."""
    pe_axes, axis_sizes = tuple(pe_axes), tuple(axis_sizes)
    strides = _strides(axis_sizes)
    p = int(np.prod(axis_sizes, dtype=np.int64))
    pe = np.arange(p, dtype=np.int64)
    coord = np.zeros_like(pe)
    rest = pe.copy()
    s = 1
    for a in hop:
        i = pe_axes.index(a)
        c = (pe // strides[i]) % axis_sizes[i]
        coord = coord * axis_sizes[i] + c
        rest -= c * strides[i]
        s *= axis_sizes[i]
    # hop coordinate b -> its contribution to the flat PE id
    b = np.arange(s, dtype=np.int64)
    contrib = np.zeros(s, np.int64)
    for a in reversed(hop):
        i = pe_axes.index(a)
        contrib += (b % axis_sizes[i]) * strides[i]
        b = b // axis_sizes[i]
    src = rest[:, None] + contrib[None, :]
    return src, coord


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

    #: every PE is local: the leading axis of every tensor has size p
    p_local = p
    first_pe = 0
    #: one process: rank 0 of a world of one
    world = 1
    rank = 0

    def axis_index(self) -> torch.Tensor:
        """(p,) int32: every PE's own flat id."""
        return torch.arange(self.p, dtype=torch.int32, device=self.device)

    def all_to_all(self, x: torch.Tensor, hop: Sequence[str],
                   axis: int) -> torch.Tensor:
        """Tiled all_to_all over the axis group ``hop``: ``x`` is
        (p, ...) and its per-PE axis ``axis`` (of size hop_size) is both
        split and concatenated, as ``lax.all_to_all(..., tiled=True)``."""
        hop = tuple(hop)
        if hop not in self._perm:
            src, coord = hop_sources(self.pe_axes, self.axis_sizes, hop)
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

    def psum_axes(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum over the mesh axes ``axes`` only (:func:`axes_sum`)."""
        return axes_sum(x, self.pe_axes, self.axis_sizes, axes)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather over every PE: (p, c, ...) -> (p, p*c, ...)."""
        flat = x.reshape((1, -1) + tuple(x.shape[2:]))
        return flat.expand((self.p,) + tuple(flat.shape[1:]))

    def gather_pes(self, x: torch.Tensor) -> torch.Tensor:
        """Every PE's rows, (p, ...): ``x`` itself (uncounted)."""
        return x

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, held whole by every rank, as an input of per-PE work:
        ``x`` itself (one process)."""
        return x

    def rank_sum(self, x: torch.Tensor) -> torch.Tensor:
        """A host-read total over the ranks: ``x`` itself (uncounted)."""
        return x

    def agree(self, flags) -> list[int]:
        """``flags`` (ints) summed over the ranks: ``flags`` itself (one
        process)."""
        return [int(f) for f in flags]

    def from_rank0(self, value: int) -> int:
        """Rank 0's ``value``: ``value`` itself (one process)."""
        return int(value)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of this process's PEs of a whole (p, ...) tensor:
        ``x`` itself."""
        return x


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives take it: contiguous, bool as uint8."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype == torch.bool else x


@dataclasses.dataclass(frozen=True, eq=False)
class DistTransport:
    """The PEs of one rank of a process group; collectives are
    ``torch.distributed`` calls over the group (see the module doc).
    Every tensor's leading axis holds the rank's ``p_local`` PEs."""

    pe_axes: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    device: torch.device
    world: int
    rank: int
    group: Any = None
    #: per-hop maps (split sizes, device index maps), built once per hop
    _maps: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def for_mesh(cls, mesh: DistMesh, pe_axes: Sequence[str], device):
        pe_axes = tuple(pe_axes)
        return cls(pe_axes, tuple(mesh.shape[a] for a in pe_axes),
                   torch.device(device), mesh.world, mesh.rank, mesh.group)

    @property
    def p(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    @property
    def p_local(self) -> int:
        return self.p // self.world

    @property
    def first_pe(self) -> int:
        return self.rank * self.p_local

    def axis_index(self) -> torch.Tensor:
        """(k,) int32: the rank's own global PE ids."""
        return torch.arange(self.first_pe, self.first_pe + self.p_local,
                            dtype=torch.int32, device=self.device)

    def _hop_maps(self, hop: tuple[str, ...]):
        """(s, send index, send splits, receive index, receive splits)
        of one hop on this rank. Receive row (j, b) comes from send row
        (src[j, b], coord[j]); rows between two ranks travel in the
        receiver's row order, so both sides derive the same layout."""
        if hop in self._maps:
            return self._maps[hop]
        src, coord = hop_sources(self.pe_axes, self.axis_sizes, hop)
        k, r = self.p_local, self.rank
        p, s = src.shape
        dst = np.repeat(np.arange(p), s)              # receiving PE j
        snd = src.reshape(-1)                         # sending PE
        snd_row = (snd % k) * s + coord[dst]          # row in its buffer
        dst_rank, snd_rank = dst // k, snd // k
        # send: rows this rank ships to other ranks, grouped by receiver
        out = (snd_rank == r) & (dst_rank != r)
        order = np.argsort(dst_rank[out], kind="stable")
        send_idx = snd_row[out][order]
        send_splits = np.bincount(dst_rank[out], minlength=self.world)
        # receive: this rank's rows in order, from the wire (grouped by
        # sender, receiver order within) or, for local senders, by index
        mine = dst_rank == r
        from_rank = snd_rank[mine]
        wire = from_rank != r
        recv_splits = np.bincount(from_rank[wire], minlength=self.world)
        n_recv = int(recv_splits.sum())
        pos = np.empty(from_rank.shape[0], np.int64)
        # the wire delivers sender by sender, each in this rank's row
        # order: a row's place is its rank in a stable sort by sender
        by_sender = np.argsort(from_rank[wire], kind="stable")
        wire_pos = np.empty_like(by_sender)
        wire_pos[by_sender] = np.arange(by_sender.shape[0])
        pos[wire] = wire_pos
        pos[~wire] = n_recv + snd_row[mine][~wire]
        dev = self.device
        maps = (s, torch.as_tensor(send_idx, device=dev),
                send_splits.tolist(), torch.as_tensor(pos, device=dev),
                recv_splits.tolist())
        self._maps[hop] = maps
        return maps

    def all_to_all(self, x: torch.Tensor, hop: Sequence[str],
                   axis: int) -> torch.Tensor:
        """Tiled all_to_all over the axis group ``hop`` (as
        :meth:`VirtualTransport.all_to_all`, on the rank's (k, ...)
        slice): one ``all_to_all_single``."""
        import torch.distributed as dist
        hop = tuple(hop)
        s, send_idx, send_splits, recv_idx, recv_splits = self._hop_maps(hop)
        ax = axis + 1
        if x.shape[ax] != s:
            raise ValueError(f"mailbox axis has size {x.shape[ax]}, hop "
                             f"{hop} has {s} peers")
        xm = x.movedim(ax, 1)                       # (k, s, ...)
        rows = _wire(xm.reshape((self.p_local * s,) + xm.shape[2:]))
        send = rows.index_select(0, send_idx)
        recv = rows.new_empty((sum(recv_splits),) + rows.shape[1:])
        dist.all_to_all_single(recv, send, recv_splits, send_splits,
                               group=self.group)
        out = torch.cat([recv, rows]).index_select(0, recv_idx)
        if x.dtype == torch.bool:
            out = out.view(torch.bool)
        return out.reshape(xm.shape).movedim(1, ax)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """(k, ...) on every rank -> (p, ...): one all_gather."""
        import torch.distributed as dist
        gather = getattr(dist, "all_gather_single",
                         dist.all_gather_into_tensor)
        wx = _wire(x)
        out = wx.new_empty((self.world * wx.shape[0],) + wx.shape[1:])
        gather(out, wx, group=self.group)
        return out.view(torch.bool) if x.dtype == torch.bool else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over every PE, broadcast back to the rank's PEs (dtype
        kept: int32 sums wrap like the reference's)."""
        import torch.distributed as dist
        if x.is_floating_point():
            tot = self._gather(x).sum(dim=0, keepdim=True, dtype=x.dtype)
        else:
            tot = x.sum(dim=0, keepdim=True, dtype=x.dtype)
            dist.all_reduce(tot, group=self.group)
        return tot.expand_as(x)

    def _axes_group(self, axes: tuple[str, ...]):
        """(ranks, group) of a reduction over ``axes``: the ranks whose PEs
        share a reduction group with this rank's, joined through shared
        groups, and the process group over them (unused when they are
        this rank alone). Every rank builds every such group once, in the same
        order, as ``new_group`` needs."""
        key = ("axes", axes)
        if key in self._maps:
            return self._maps[key]
        import torch.distributed as dist
        pe = np.arange(self.p)
        strides = _strides(self.axis_sizes)
        gid = np.zeros(self.p, np.int64)   # a PE's coordinates off `axes`
        for i, a in enumerate(self.pe_axes):
            if a not in axes:
                gid = gid * self.axis_sizes[i] + (pe // strides[i]) \
                    % self.axis_sizes[i]
        comp = list(range(self.world))     # union-find over the ranks

        def find(r):
            while comp[r] != r:
                r = comp[r]
            return r
        for g in np.unique(gid):
            ranks = np.unique(pe[gid == g] // self.p_local)
            for r in ranks[1:]:
                comp[find(int(r))] = find(int(ranks[0]))
        comps: dict = {}
        for r in range(self.world):
            comps.setdefault(find(r), []).append(r)
        mine = None
        for ranks in comps.values():
            if len(ranks) == 1:
                group = None
            elif len(ranks) == self.world:
                group = self.group
            else:
                group = dist.new_group([
                    r if self.group is None else
                    dist.get_global_rank(self.group, r) for r in ranks])
            if self.rank in ranks:
                mine = (tuple(ranks), group)
        self._maps[key] = mine
        return mine

    def _psum_axes(self, x: torch.Tensor, axes: tuple[str, ...]):
        """The rank's rows of :func:`axes_sum` over every PE: this
        rank's block and the blocks gathered from the ranks of its
        reduction groups (one all_gather), placed in a (p, ...) grid
        with zeros elsewhere, so every sum runs in the virtual
        transport's order."""
        import torch.distributed as dist
        ranks, group = self._axes_group(axes)
        k, first = self.p_local, self.first_pe
        full = x.new_zeros((self.p,) + tuple(x.shape[1:]))
        if len(ranks) == 1:
            full[first:first + k] = x
        else:
            wx = _wire(x)
            got = wx.new_empty((len(ranks) * k,) + tuple(wx.shape[1:]))
            dist.all_gather_into_tensor(got, wx, group=group)
            if x.dtype == torch.bool:
                got = got.view(torch.bool)
            for i, r in enumerate(ranks):
                full[r * k:(r + 1) * k] = got[i * k:(i + 1) * k]
        return axes_sum(full, self.pe_axes, self.axis_sizes,
                        axes)[first:first + k]

    def psum_axes(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum over the mesh axes ``axes`` only, broadcast back to the
        rank's PEs: bit for bit the virtual transport's
        :meth:`~VirtualTransport.psum_axes` on the same PEs' values. No
        collective when every group of the rank's PEs lies on the rank;
        differentiable (the sum is its own transpose)."""
        return _PsumAxes.apply(self, tuple(axes), x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather over every PE: (k, c, ...) -> (k, p*c, ...)."""
        flat = self._gather(x).reshape((1, -1) + tuple(x.shape[2:]))
        return flat.expand((self.p_local,) + tuple(flat.shape[1:]))

    def gather_pes(self, x: torch.Tensor) -> torch.Tensor:
        """Every PE's rows on every rank, (p, ...): one all_gather that
        no counter sees (a host read, not a collective of the
        algorithm). Differentiable: every rank holds the same whole
        result, so a rank's gradient is the cotangent's own rows."""
        return _GatherPEs.apply(self, x)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, held whole by every rank, as an input of the rank's
        per-PE work: ``x`` itself, whose backward sums the cotangent over
        the ranks (one uncounted all_reduce), since each rank's work
        reads its own part of ``x``. With :meth:`gather_pes` on the way
        out, every rank gets the whole gradient of its replicated
        inputs, as a one-process run does."""
        return x if self.world == 1 else _Replicated.apply(self, x)

    def rank_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (one uncounted all_reduce): a
        host-read total, equal on every rank."""
        import torch.distributed as dist
        tot = x.clone()
        dist.all_reduce(tot, group=self.group)
        return tot

    def agree(self, flags) -> list[int]:
        """``flags`` (ints) summed over the ranks, read on the host: one
        uncounted all_reduce, none on one rank. Every rank calls it at
        the same point and acts on the same sums."""
        if self.world == 1:
            return [int(f) for f in flags]
        return self.rank_sum(torch.tensor(
            [int(f) for f in flags], dtype=torch.int64,
            device=self.device)).tolist()

    def from_rank0(self, value: int) -> int:
        """Rank 0's ``value`` on every rank (:meth:`agree` of it and
        zeros). Over several ranks it is a barrier as well, since no
        rank's sum is complete before every rank has called it."""
        return self.agree([value if self.rank == 0 else 0])[0]

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's PEs' rows ``[first_pe, first_pe + p_local)`` of a
        whole (p, ...) tensor (no collective)."""
        return x[self.first_pe:self.first_pe + self.p_local]


class _PsumAxes(torch.autograd.Function):
    """:meth:`DistTransport.psum_axes` with its backward: the cotangent
    summed over the same groups."""

    @staticmethod
    def forward(ctx, transport, axes, x):
        ctx.transport, ctx.axes = transport, axes
        return transport._psum_axes(x, axes)

    @staticmethod
    def backward(ctx, ct):
        return None, None, ctx.transport._psum_axes(ct, ctx.axes)


class _GatherPEs(torch.autograd.Function):
    """:meth:`DistTransport.gather_pes` with its backward."""

    @staticmethod
    def forward(ctx, transport, x):
        ctx.rows = slice(transport.first_pe,
                         transport.first_pe + transport.p_local)
        return transport._gather(x)

    @staticmethod
    def backward(ctx, ct):
        return None, ct[ctx.rows]


class _Replicated(torch.autograd.Function):
    """:meth:`DistTransport.replicated` with its backward."""

    @staticmethod
    def forward(ctx, transport, x):
        ctx.transport = transport
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return None, ctx.transport.rank_sum(ct.contiguous())


class CountingTransport:
    """Wraps a transport; counts every collective call by name.

    ``counts`` is a ``collections.Counter`` over ``all_to_all``,
    ``psum`` (``psum_axes`` counts as one) and ``all_gather``
    (``axis_index`` is not a collective);
    ``nbytes`` the same over each call's payload bytes per PE, the
    input's ``numel() * element_size()`` over the PEs its leading axis
    holds (``p_local``: p on the virtual transport, the rank's PEs on the
    distributed one), so a stage's bytes per PE are the same on both.
    Both read tensor metadata only: no device work, no synchronisation.
    ``resume.run_staged`` clears them per stage. The uncounted host
    reads (``gather_pes``, ``rank_sum``, ``agree``, ``from_rank0``) and
    ``local_rows`` pass through."""

    def __init__(self, inner):
        self.inner = inner
        self.counts: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()

    p = property(lambda self: self.inner.p)
    p_local = property(lambda self: self.inner.p_local)
    first_pe = property(lambda self: self.inner.first_pe)
    device = property(lambda self: self.inner.device)
    world = property(lambda self: self.inner.world)
    rank = property(lambda self: self.inner.rank)

    def _count(self, prim: str, x) -> None:
        self.counts[prim] += 1
        self.nbytes[prim] += (x.numel() * x.element_size()
                              // self.inner.p_local)

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

    def psum_axes(self, x, axes):
        self._count("psum", x)
        return self.inner.psum_axes(x, axes)

    def all_gather(self, x):
        self._count("all_gather", x)
        return self.inner.all_gather(x)

    def gather_pes(self, x):
        return self.inner.gather_pes(x)

    def replicated(self, x):
        return self.inner.replicated(x)

    def rank_sum(self, x):
        return self.inner.rank_sum(x)

    def agree(self, flags):
        return self.inner.agree(flags)

    def from_rank0(self, value):
        return self.inner.from_rank0(value)

    def local_rows(self, x):
        return self.inner.local_rows(x)
