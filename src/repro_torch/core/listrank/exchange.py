"""Bucketed message routing over the PE mesh (paper §2.4).

Each communication round is one (or ``d``, with indirection) dense,
fixed-capacity ``all_to_all`` per hop. A *hop* fixes the destination
coordinate along one mesh-axis group. Direct delivery is a single hop
over all PE axes; grid indirection is one hop per axis (minor axis
first — the paper's column-then-row routing).

Static capacities force a per-peer mailbox capacity. Messages that do
not fit are *leftovers*: they stay on the holding PE and re-enter
routing in the caller's next round. Capacity overflow therefore costs
rounds, never correctness; the amount is tracked in ``stats``.

Packed wire format: with ``MeshPlan.wire_packing`` all payload leaves of
a message batch are bit-packed into one ``(W, Q)`` int32 word-plane
matrix (:class:`WireFormat`), so each hop costs exactly **one**
``all_to_all`` whatever the leaf count. The unpacked path (one
collective per leaf plus one for validity) is kept behind the same API;
both paths share every index computation, so they are bit-identical.

Every per-PE tensor here carries a leading PE axis of size ``p_local``
(``p`` on the virtual-PE transport, the rank's PEs on the distributed
one; see :mod:`.transport`): a payload leaf is ``(p, Q, *trail)``,
``dest`` and ``valid`` are ``(p, Q)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.listrank import transport as transport_lib
from repro_torch.core.listrank.batched import (INT_MAX, arange, set_drop,
                                               take, unpermute)
from repro_torch.core.listrank.config import IndirectionSpec
from repro_torch.kernels.mailbox_pack import ops as mp_ops
from repro_torch.kernels.mailbox_pack import ref as mp_ref
from repro_torch.obs import telemetry as tele_lib

#: payload keys reserved for the router itself.
RESERVED_KEYS = ("_dest", "_src")


@dataclasses.dataclass(frozen=True, eq=False)
class MeshPlan:
    """Static routing metadata for a PE grid embedded in a mesh.

    PE ids are flattened row-major over ``pe_axes``. ``wire_packing``
    selects the packed wire format (one collective per hop);
    ``pallas_pack`` routes the pack + bucket scatter through the
    ``mailbox_pack`` CUDA kernel. Every collective goes through the
    :meth:`my_id` / :meth:`all_to_all` / :meth:`psum` /
    :meth:`all_gather` delegates to ``transport``. ``telemetry``
    mirrors ``ListRankConfig.telemetry``: routing then emits a per-PE
    :mod:`repro_torch.obs.telemetry` record in ``stats["telemetry"]``
    — local arithmetic on the bucket sort, no added collective.
    """

    pe_axes: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    indirection: IndirectionSpec
    wire_packing: bool = True
    pallas_pack: bool = False
    transport: Any = None
    telemetry: bool = False
    #: per-hop device constants (sender-id contributions), built once
    _consts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def p(self) -> int:
        """The global PE count (the algorithm's, the tuner's and the
        cost model's ``p``)."""
        out = 1
        for s in self.axis_sizes:
            out *= s
        return out

    @property
    def p_local(self) -> int:
        """The leading-axis size of every per-PE tensor: the PEs this
        process holds (``p`` on the virtual-PE transport)."""
        return self.transport.p_local

    @property
    def local_pes(self) -> range:
        """The global ids of the PEs this process holds."""
        first = self.transport.first_pe
        return range(first, first + self.p_local)

    @property
    def device(self) -> torch.device:
        return self.transport.device

    def axis_size(self, name: str) -> int:
        return self.axis_sizes[self.pe_axes.index(name)]

    def hop_size(self, hop: tuple[str, ...]) -> int:
        out = 1
        for a in hop:
            out *= self.axis_size(a)
        return out

    def my_id(self) -> torch.Tensor:
        """(p_local,) int32 flat ids of the local PEs."""
        return self.transport.axis_index()

    def all_to_all(self, x: torch.Tensor, hop: tuple[str, ...],
                   axis: int) -> torch.Tensor:
        """One routing collective over the axis group ``hop``; ``axis``
        is the per-PE mailbox axis (split and concatenated)."""
        return self.transport.all_to_all(x, hop, axis)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum-reduce over every PE, result on every PE."""
        return self.transport.psum(x)

    def psum_axes(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum-reduce over the transport's mesh axes ``axes`` only (the
        reference's ``lax.psum(x, axes)`` inside ``shard_map``)."""
        return self.transport.psum_axes(x, axes)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled gather over every PE axis (allgather base case)."""
        return self.transport.all_gather(x)

    def hop_coord(self, pe_id: torch.Tensor,
                  hop: tuple[str, ...]) -> torch.Tensor:
        """Coordinate of ``pe_id`` along the axis group ``hop``,
        flattened row-major within the group."""
        coord = torch.zeros_like(pe_id)
        for a in hop:
            i = self.pe_axes.index(a)
            stride = 1
            for s in self.axis_sizes[i + 1:]:
                stride *= s
            c = (pe_id // stride) % self.axis_sizes[i]
            coord = coord * self.axis_sizes[i] + c
        return coord

    def hop_coord_to_pe(self, hop: tuple[str, ...]) -> np.ndarray:
        """Contribution of group coordinate ``b`` to the flat PE id (the
        remaining axes contribute the receiver's own coordinates)."""
        s = self.hop_size(hop)
        b = np.arange(s, dtype=np.int32)
        rem, acc = b, np.zeros(s, np.int32)
        for a in reversed(hop):
            i = self.pe_axes.index(a)
            stride = 1
            for sz in self.axis_sizes[i + 1:]:
                stride *= sz
            c = rem % self.axis_sizes[i]
            rem = rem // self.axis_sizes[i]
            acc = acc + c.astype(np.int32) * stride
        return acc

    def src_contrib(self, hop: tuple[str, ...], cap: int) -> torch.Tensor:
        """(s*cap,) int32: sender-id contribution of every receive row."""
        key = ("src", hop, cap)
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(
                np.repeat(self.hop_coord_to_pe(hop), cap), device=self.device)
        return self._consts[key]

    @staticmethod
    def from_mesh(mesh, pe_axes: Sequence[str],
                  indirection: IndirectionSpec | None = None,
                  wire_packing: bool = True,
                  pallas_pack: bool = False,
                  transport=None,
                  device: torch.device | str = "cpu",
                  telemetry: bool = False) -> "MeshPlan":
        """Plan for a :class:`transport.SimMesh` or
        :class:`transport.DistMesh`; the transport defaults to the
        virtual-PE transport on ``device``."""
        pe_axes = tuple(pe_axes)
        sizes = tuple(mesh.shape[a] for a in pe_axes)
        if indirection is None:
            indirection = IndirectionSpec.direct(pe_axes)
        for hop in indirection.hops:
            for a in hop:
                if a not in pe_axes:
                    raise ValueError(f"hop axis {a} not in pe_axes {pe_axes}")
        if transport is None:
            transport = transport_lib.VirtualTransport(
                pe_axes, sizes, torch.device(device))
        return MeshPlan(pe_axes=pe_axes, axis_sizes=sizes,
                        indirection=indirection, wire_packing=wire_packing,
                        pallas_pack=pallas_pack, transport=transport,
                        telemetry=telemetry)


# --------------------------------------------------------------------------
# wire format
# --------------------------------------------------------------------------

#: 16-bit floats cross the wire as their bit patterns, one word each
HALF_FLOATS = (torch.bfloat16, torch.float16)


def to_wire_word(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret a 32-bit-or-narrower leaf as int32 words, exactly.

    A bfloat16 or float16 leaf travels as its 16-bit pattern widened to
    one word, as an int16 leaf does. The reference raises ``TypeError``
    for them, so its expert-parallel MoE cannot run in bfloat16."""
    dt = x.dtype
    if dt == torch.int32:
        return x
    if dt == torch.float32:
        return x.view(torch.int32)
    if dt == torch.bool:
        return x.to(torch.int32)
    if dt in HALF_FLOATS:
        return x.view(torch.int16).to(torch.int32)
    if dt in (torch.int8, torch.uint8, torch.int16):
        return x.to(torch.int32)
    raise TypeError(f"wire format does not support dtype {dt}")


def from_wire_word(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`to_wire_word`."""
    if dtype == torch.int32:
        return w
    if dtype == torch.float32:
        return w.view(torch.float32)
    if dtype == torch.bool:
        return w != 0
    if dtype in HALF_FLOATS:
        return w.to(torch.int16).view(dtype)
    return w.to(dtype)


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """Static descriptor of the packed on-wire layout of a message batch.

    Each payload leaf of per-PE shape ``(Q, *trail)`` occupies
    ``prod(trail)`` int32 words per message; the final word is the
    validity flag. Leaves are laid out in sorted-key order so the format
    depends only on the payload *structure*.
    """

    keys: tuple[str, ...]
    dtypes: tuple[torch.dtype, ...]
    trails: tuple[tuple[int, ...], ...]

    @classmethod
    def from_payload(cls, payload: dict[str, torch.Tensor]) -> "WireFormat":
        keys = tuple(sorted(payload.keys()))
        return cls(keys=keys,
                   dtypes=tuple(payload[k].dtype for k in keys),
                   trails=tuple(tuple(int(d) for d in payload[k].shape[2:])
                                for k in keys))

    @classmethod
    def for_leaves(cls, leaves: dict[str, torch.dtype]) -> "WireFormat":
        """Host-side construction from {name: dtype} scalar leaves."""
        keys = tuple(sorted(leaves.keys()))
        return cls(keys=keys, dtypes=tuple(leaves[k] for k in keys),
                   trails=((),) * len(keys))

    def leaf_words(self, i: int) -> int:
        out = 1
        for d in self.trails[i]:
            out *= d
        return out

    @property
    def width(self) -> int:
        """Total int32 words per message, incl. the validity word."""
        return sum(self.leaf_words(i) for i in range(len(self.keys))) + 1

    def payload_columns(self, payload: dict[str, torch.Tensor]
                        ) -> list[torch.Tensor]:
        """The ``width - 1`` (p, Q) int32 payload word-planes."""
        cols: list[torch.Tensor] = []
        for k in self.keys:
            leaf = payload[k]
            w = to_wire_word(leaf).reshape(leaf.shape[0], leaf.shape[1], -1)
            cols.extend(w[:, :, j] for j in range(w.shape[2]))
        return cols

    def planes(self, payload: dict[str, torch.Tensor],
               valid: torch.Tensor) -> torch.Tensor:
        """The wire matrix's ``width`` int32 word-planes, validity last,
        stacked as (p, width, Q) in one copy per leaf (a message of
        ``d_model`` words is ``d_model`` planes)."""
        p, q = valid.shape
        parts = [to_wire_word(payload[k]).reshape(p, q, -1).movedim(2, 1)
                 for k in self.keys]
        return torch.cat(parts + [valid.to(torch.int32)[:, None]], 1)

    def unpack_cols(self, cols: torch.Tensor
                    ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
        """Unpack from word-planes: ``cols`` is (p, width, R)."""
        p, _, r = cols.shape
        payload = {}
        off = 0
        for i, k in enumerate(self.keys):
            w = self.leaf_words(i)
            leaf = cols[:, off:off + w].movedim(1, -1).reshape(
                (p, r) + self.trails[i])
            payload[k] = from_wire_word(leaf, self.dtypes[i])
            off += w
        return payload, cols[:, off] != 0


# --------------------------------------------------------------------------
# shared sort/scatter primitives
# --------------------------------------------------------------------------

def sort_and_group(key: torch.Tensor, valid: torch.Tensor, sentinel):
    """One stable sort per PE, shared by bucketing and request dedup.

    Invalid rows sort to the back (keyed ``sentinel``, which must compare
    greater than every valid key). Returns

      order:  (p, Q) int64 the sort permutation,
      skey:   (p, Q) keys in sorted order,
      pos:    (p, Q) int32 rank of each sorted row within its run,
      newrun: (p, Q) True at the first row of each run.
    """
    p, q = key.shape
    k = torch.where(valid, key, torch.full_like(key, sentinel))
    skey, order = torch.sort(k, dim=1, stable=True)
    i = arange(q, p, key.device)
    newrun = torch.ones_like(skey, dtype=torch.bool)
    newrun[:, 1:] = skey[:, 1:] != skey[:, :-1]
    run_start = torch.cummax(torch.where(newrun, i, 0), dim=1).values
    return order, skey, i - run_start, newrun


def _bucket_indices(coord: torch.Tensor, valid: torch.Tensor,
                    n_buckets: int, cap: int):
    """Mailbox scatter coordinates for one hop.

    Returns (order, row, col, fits, leftover_sorted, skey); ``row``/
    ``col`` address the ``(n_buckets, cap)`` mailbox grid in *sorted*
    order with out-of-range sentinels for rows that don't ship this hop.
    ``leftover_sorted`` marks valid messages beyond bucket capacity.
    Every shipping row gets its own cell: (row, col) = (bucket, rank in
    bucket) is unique. ``skey`` is the sorted bucket key (``n_buckets``
    for invalid rows), from which the ``mailbox_pack`` kernel finds each
    bucket's run of ``order``, and telemetry each bucket's demand.
    """
    order, skey, pos, _ = sort_and_group(coord, valid, n_buckets)
    infit = skey < n_buckets
    fits = infit & (pos < cap)
    row = torch.where(fits, skey, n_buckets).to(torch.int32)
    col = torch.where(fits, pos, cap).to(torch.int32)
    return order, row, col, fits, infit & ~fits, skey


def _scatter_leaf(leaf: torch.Tensor, flat: torch.Tensor, n_rows: int):
    """Scatter rows to flat mailbox slots (non-shipping slots dropped;
    shipping slots are unique, see :func:`_bucket_indices`)."""
    buf = leaf.new_zeros((leaf.shape[0], n_rows) + tuple(leaf.shape[2:]))
    return set_drop(buf, flat, leaf)


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def _check_payload(payload: dict[str, torch.Tensor], track_src: bool):
    for k in RESERVED_KEYS:
        if k in payload:
            raise ValueError(f"payload key {k!r} is reserved")
    if track_src and "src" in payload:
        raise ValueError("track_src=True would overwrite payload key 'src'")


def _sum32(x: torch.Tensor) -> torch.Tensor:
    """Per-PE int32 count/sum over the message axis."""
    return x.sum(dim=1, dtype=torch.int32)


def _route_impl(plan: MeshPlan, caps: Sequence[int],
                payload: dict[str, torch.Tensor], dest: torch.Tensor,
                valid: torch.Tensor, track_src: bool, queue_cap: int | None,
                keep_slots: bool = False):
    """Shared body of :func:`route`, :func:`route_compact` and
    :func:`route_differentiable`.

    With ``queue_cap`` set, per-hop leftovers are compacted into a single
    queue *by the bucket sort itself* (prefix-sum slots over the sorted
    order — no extra sort); otherwise they are returned as the per-hop
    fragment list. With ``plan.telemetry`` each hop's bucket sort also
    yields its occupancy sample, and ``stats["telemetry"]`` the wave's
    record (``telemetry.route_wave``). With ``keep_slots``,
    ``stats["slots"]`` holds each hop's input-aligned mailbox slots
    (:func:`_io_slots`): local indices, nothing more on the wire.
    """
    hops = plan.indirection.hops
    if len(caps) != len(hops):
        raise ValueError(f"{len(caps)} caps for {len(hops)} hops")
    _check_payload(payload, track_src)
    user_keys = tuple(payload.keys())
    p, dev = plan.p_local, plan.device

    cur = dict(payload)
    cur["_dest"] = dest.to(torch.int32)
    cur_valid = valid
    src_acc = None
    leftovers = []
    if queue_cap is not None:
        lq = {k: v.new_zeros((p, queue_cap) + tuple(v.shape[2:]))
              for k, v in payload.items()}
        lq_dest = torch.zeros((p, queue_cap), dtype=torch.int32, device=dev)
        nleft = torch.zeros(p, dtype=torch.int32, device=dev)
    stats = {"sent": [],
             "leftover": torch.zeros(p, dtype=torch.int32, device=dev)}
    tele_hops, tele_hist = [], None

    for h, (hop, cap) in enumerate(zip(hops, caps)):
        s = plan.hop_size(hop)
        coord = plan.hop_coord(cur["_dest"], hop)
        order, row, col, fits, leftover_sorted, skey = _bucket_indices(
            coord, cur_valid, s, cap)
        if plan.telemetry:
            # per-PE occupancy/skew sample of this hop, read off the
            # bucket sort — no collective
            sample, hist = _hop_sample(plan, skey, s, cap, h == 0)
            tele_hops.append(sample)
            if h == 0:
                tele_hist = hist

        nl = _sum32(leftover_sorted)
        if queue_cap is None:
            left_mask = unpermute(order, leftover_sorted)
            leftovers.append(({k: cur[k] for k in user_keys},
                              cur["_dest"], cur_valid & left_mask))
        else:
            lpos = nleft[:, None] + torch.cumsum(
                leftover_sorted.to(torch.int32), dim=1,
                dtype=torch.int32) - 1
            lslot = torch.where(leftover_sorted, lpos, queue_cap)
            # leftover slots are distinct prefix-sum positions
            io_lslot = unpermute(order, lslot)
            for k in lq:
                lq[k] = set_drop(lq[k], io_lslot, cur[k])
            lq_dest = set_drop(lq_dest, io_lslot, cur["_dest"])
            nleft = nleft + nl
        stats["sent"].append(_sum32(fits))
        stats["leftover"] = stats["leftover"] + nl
        if keep_slots:
            stats.setdefault("slots", []).append(
                _io_slots(order, row, col, cap))

        # exchange: mailbox row b goes to the peer with coordinate b
        # along `hop`. The packed buffer is plane-major (word-planes
        # first); the collective splits/concats the mailbox-row axis.
        if plan.wire_packing:
            wf = WireFormat.from_payload(cur)
            buf = _pack_scatter(plan, wf, cur, cur_valid, order, row, col,
                                skey, s, cap)
            recv = plan.all_to_all(buf, hop, 1)  # 1 collective
            cur, cur_valid = wf.unpack_cols(recv.reshape(p, wf.width, s * cap))
        else:
            io_flat = _io_slots(order, row, col, cap)
            recv = {}
            for k, v in cur.items():
                b = _scatter_leaf(v, io_flat, s * cap).reshape(
                    (p, s, cap) + tuple(v.shape[2:]))
                recv[k] = plan.all_to_all(b, hop, 0)
            bval = _scatter_leaf(cur_valid, io_flat, s * cap).reshape(p, s, cap)
            rval = plan.all_to_all(bval, hop, 0)
            cur = {k: v.reshape((p, s * cap) + tuple(v.shape[3:]))
                   for k, v in recv.items()}
            cur_valid = rval.reshape(p, s * cap)

        if track_src:
            # Sender reconstruction from the receive-buffer row index:
            # row b was filled by the peer whose coordinate along `hop`
            # is b (other axes match the receiver's own); summing the
            # per-hop contributions yields the origin PE id.
            contrib = plan.src_contrib(hop, cap)
            prev = cur.pop("_src", None)
            src_acc = (contrib.expand(p, -1) if prev is None
                       else prev + contrib)
            if h < len(hops) - 1:
                cur["_src"] = src_acc

    if plan.telemetry:
        stats["telemetry"] = tele_lib.route_wave(tele_hops, tele_hist)
    delivered = {k: cur[k] for k in user_keys}
    if track_src:
        delivered["src"] = src_acc
    if queue_cap is not None:
        qv = arange(queue_cap, p, dev) < torch.clamp(
            nleft, max=queue_cap)[:, None]
        dropped = torch.clamp(nleft - queue_cap, min=0)
        return delivered, cur_valid, (lq, lq_dest, qv, dropped), stats
    return delivered, cur_valid, leftovers, stats


def _hop_sample(plan: MeshPlan, skey: torch.Tensor, s: int, cap: int,
                with_hist: bool):
    """One hop's telemetry sample from its sorted bucket keys ``skey``
    (``s`` for invalid rows), per PE: ``demand_max`` (the longest bucket
    run: the reference's largest within-bucket rank + 1), ``delivered``
    (the rows that fit, ``sum(min(run, cap))``), ``total`` (the valid
    rows) and, ``with_hist``, the ``HIST_BINS``-bin histogram of the
    valid keys (bin ``key * HIST_BINS // s``). One ``searchsorted`` of
    the s + 1 bucket boundaries into the sorted keys gives them all,
    with no pass over the messages and no atomics: integer counts,
    equal to the reference's."""
    key = ("tele", s)
    if key not in plan._consts:
        nb, p, dev = tele_lib.HIST_BINS, plan.p_local, plan.device
        # bin b holds keys from ceil(b * s / nb): thresholds in key space
        edges = (torch.arange(nb + 1, dtype=torch.int64, device=dev) * s
                 + nb - 1) // nb
        bounds = torch.arange(s + 1, dtype=skey.dtype, device=dev)
        plan._consts[key] = (bounds.expand(p, -1).contiguous(),
                             edges.expand(p, -1))
    bounds, edges = plan._consts[key]
    # below[:, k]: the sorted keys < k
    below = torch.searchsorted(skey, bounds, out_int32=True)
    runs = below[:, 1:] - below[:, :-1]
    sample = {"demand_max": runs.max(1).values,
              "delivered": torch.clamp(runs, max=cap).sum(
                  1, dtype=torch.int32),
              "total": below[:, s], "cap": cap, "s": s}
    hist = None
    if with_hist:
        at = torch.gather(below, 1, edges)
        hist = at[:, 1:] - at[:, :-1]
    return sample, hist


def _io_slots(order, row, col, cap: int) -> torch.Tensor:
    """Input-aligned mailbox slots: message i ships to slot ``[i]``
    (``>= n_buckets * cap`` if it does not ship this hop)."""
    return unpermute(order, row * cap + col)


def _pack_scatter(plan: MeshPlan, wf: WireFormat, payload, valid, order,
                  row, col, skey, n_buckets: int, cap: int) -> torch.Tensor:
    """Pack + bucket-fill the (p, W, n_buckets, cap) send buffer.

    With ``pallas_pack`` the kernel gathers the payload planes through the
    bucket sort's ``order``; a shipping message is always valid, so the
    validity plane is "this cell is filled" and is never read. Otherwise
    every plane, validity included, is scattered to input-aligned slots.
    """
    if plan.pallas_pack:
        cols = [c.contiguous() for c in wf.payload_columns(payload)]
        buf = mp_ops.mailbox_pack(cols, order, skey, n_buckets, cap)
    else:
        buf = mp_ref.mailbox_pack_ref(wf.planes(payload, valid),
                                      _io_slots(order, row, col, cap),
                                      n_buckets * cap)
    return buf.reshape(plan.p_local, wf.width, n_buckets, cap)


def route(plan: MeshPlan, caps: Sequence[int],
          payload: dict[str, torch.Tensor], dest: torch.Tensor,
          valid: torch.Tensor, track_src: bool = False):
    """Route messages to their destination PE through the plan's hops.

    Args:
      caps: per-peer mailbox capacity per hop (len == #hops).
      payload: dict of (p, Q, ...) tensors.
      dest: (p, Q) destination PE ids (flattened over pe_axes).
      valid: (p, Q) mask.
      track_src: reconstruct each message's origin PE from receive-
        buffer row indices; returned as ``delivered["src"]``.

    Returns:
      delivered: dict of (p, R, ...) tensors (R = hop_size[-1]*caps[-1]),
      delivered_valid: (p, R),
      leftovers: list of (payload_dict, dest, valid) per hop,
      stats: dict with per-hop sent counts and total leftover count.
    """
    return _route_impl(plan, caps, payload, dest, valid, track_src,
                       queue_cap=None)


class _DifferentiableRoute(torch.autograd.Function):
    """One direct hop of :func:`route` whose float leaves carry
    gradients: the forward is the route itself (the same wire); the
    backward sends each float leaf's cotangent back along the delivery
    map. A tiled all_to_all over one hop is its own inverse (row ``b``
    of PE ``i`` lands in row ``coord(i)`` of the PE with coordinate
    ``b``), so the cotangent's mailbox, sent through the same
    ``all_to_all``, arrives at the senders laid out as their send
    buffers, and each message reads its gradient at its own mailbox
    slot (zero where it did not ship). Leaves of one dtype share one
    collective.

    A hop of one PE keeps every message on its PE: the mailbox is the
    delivery, so each leaf is scattered to its slot in its own dtype, with
    no pack, no collective and no unpack either way. The wire is exact and
    its empty cells are zero words, so the result is the wire's bit for
    bit."""

    @staticmethod
    def forward(ctx, plan, cap, keys, dest, valid, *leaves):
        hop = plan.indirection.hops[0]
        if plan.hop_size(hop) == 1:
            coord = plan.hop_coord(dest.to(torch.int32), hop)
            order, row, col, *_ = _bucket_indices(coord, valid, 1, cap)
            slot = _io_slots(order, row, col, cap)
            delivered = {k: _scatter_leaf(v, slot, cap)
                         for k, v in zip(keys, leaves)}
            dval = _scatter_leaf(valid, slot, cap)
        else:
            delivered, dval, _, stats = _route_impl(
                plan, [cap], dict(zip(keys, leaves)), dest, valid,
                track_src=False, queue_cap=None, keep_slots=True)
            slot = stats["slots"][0]
        ctx.plan, ctx.cap = plan, cap
        ctx.floats = [v.is_floating_point() for v in leaves]
        ctx.save_for_backward(slot)
        outs = tuple(delivered[k] for k in keys)
        ctx.mark_non_differentiable(
            dval, *(o for o, f in zip(outs, ctx.floats) if not f))
        return outs + (dval,)

    @staticmethod
    def backward(ctx, *cts):
        slot, = ctx.saved_tensors
        plan, cap = ctx.plan, ctx.cap
        hop = plan.indirection.hops[0]
        s = plan.hop_size(hop)
        p, q = slot.shape
        grads: list = [None] * len(ctx.floats)
        todo = [i for i, f in enumerate(ctx.floats)
                if f and cts[i] is not None]
        for dt in dict.fromkeys(cts[i].dtype for i in todo):
            group = [i for i in todo if cts[i].dtype == dt]
            trails = [tuple(cts[i].shape[2:]) for i in group]
            flat = torch.cat([cts[i].reshape(p, s * cap, -1) for i in group],
                             dim=2)
            back = flat.reshape(p, s, cap, -1)
            if s > 1:
                back = plan.all_to_all(back, hop, 0)
            back = torch.cat([back.reshape(p, s * cap, -1),
                              back.new_zeros((p, 1, back.shape[-1]))], 1)
            got = take(back, torch.clamp(slot, max=s * cap))
            off = 0
            for i, trail in zip(group, trails):
                w = int(np.prod(trail, dtype=np.int64))
                grads[i] = got[:, :, off:off + w].reshape((p, q) + trail)
                off += w
        return (None, None, None, None, None, *grads)


def route_differentiable(plan: MeshPlan, cap: int,
                         payload: dict[str, torch.Tensor],
                         dest: torch.Tensor, valid: torch.Tensor):
    """:func:`route` over a plan of one direct hop with mailbox capacity
    ``cap``, differentiable in its float leaves (see
    :class:`_DifferentiableRoute`); the wire is :func:`route`'s (a hop of
    one PE delivers its result with no wire). Returns
    ``(delivered, delivered_valid)``; the leftovers are not returned.

    The reference's route bit-casts every leaf to int32 words, so no
    gradient crosses it; this is the port's repair, for the
    expert-parallel MoE's training."""
    if plan.indirection.depth != 1:
        raise ValueError("route_differentiable routes one hop; the plan "
                         f"has {plan.indirection.depth}")
    keys = tuple(payload)
    out = _DifferentiableRoute.apply(plan, cap, keys, dest, valid,
                                     *(payload[k] for k in keys))
    return dict(zip(keys, out[:-1])), out[-1]


def route_compact(plan: MeshPlan, caps: Sequence[int], frags, queue_cap: int):
    """Route concatenated fragments; leftovers come back as one compact
    queue. The first-hop bucket sort *is* the queue compaction.

    Returns (delivered, delivered_valid, (queue_payload, queue_dest,
    queue_valid), dropped, stats).
    """
    payload, dest, valid = _concat_frags(frags)
    delivered, dval, (qpl, qd, qv, dropped), stats = _route_impl(
        plan, caps, payload, dest, valid, track_src=False,
        queue_cap=queue_cap)
    return delivered, dval, (qpl, qd, qv), dropped, stats


def _concat_frags(entries):
    keys = tuple(entries[0][0].keys())
    for pl, _, _ in entries:
        if set(pl.keys()) != set(keys):
            raise ValueError("fragments must share payload keys")
    payload = {k: torch.cat([pl[k] for pl, _, _ in entries], dim=1)
               for k in keys}
    dest = torch.cat([d for _, d, _ in entries], dim=1)
    valid = torch.cat([v for _, _, v in entries], dim=1)
    return payload, dest, valid


def compact_queue(entries, cap: int):
    """Merge (payload, dest, valid) fragments into one queue of size cap.

    Valid entries are packed to the front *in order* by a prefix-sum
    scatter (distinct slots) — no sort. Returns (payload, dest, valid,
    dropped_count); dropped_count > 0 means ``cap`` was too small.
    """
    cat_payload, cat_dest, cat_valid = _concat_frags(entries)
    p = cat_valid.shape[0]
    pos = torch.cumsum(cat_valid.to(torch.int32), dim=1,
                       dtype=torch.int32) - 1
    slot = torch.where(cat_valid, pos, cap)
    out_payload = {
        k: set_drop(v.new_zeros((p, cap) + tuple(v.shape[2:])), slot, v)
        for k, v in cat_payload.items()}
    out_dest = set_drop(cat_dest.new_zeros((p, cap)), slot, cat_dest)
    n_valid = _sum32(cat_valid)
    out_valid = arange(cap, p, cat_valid.device) < torch.clamp(
        n_valid, max=cap)[:, None]
    dropped = torch.clamp(n_valid - cap, min=0)
    return out_payload, out_dest, out_valid, dropped


# --------------------------------------------------------------------------
# request/response gather
# --------------------------------------------------------------------------

def _as_caps(plan: MeshPlan, c):
    return list(c) if isinstance(c, (tuple, list)) \
        else [c] * plan.indirection.depth


def request_reply(plan: MeshPlan, req_caps, resp_caps,
                  payload: dict[str, torch.Tensor], dest: torch.Tensor,
                  valid: torch.Tensor, reply_fn):
    """Two-leg owner-computes exchange (request round + reply round).

    Route ``payload`` to ``dest``; on the receiving PE, ``reply_fn``
    turns the delivered batch into a reply batch with its *own*
    addressing; route those replies and return them.

    ``reply_fn``: (delivered_payload, delivered_valid) ->
    (reply_payload, reply_dest, reply_valid[, aux]).

    Returns (reply_delivered, reply_valid, aux, stats) with
    ``stats = {"sent", "leftover"}`` summed over both legs (and, with
    ``plan.telemetry``, both legs' merged ``"telemetry"`` record).
    """
    delivered, dval, _, st1 = route(plan, _as_caps(plan, req_caps), payload,
                                    dest, valid)
    out = reply_fn(delivered, dval)
    rpl, rdest, rvalid = out[:3]
    aux = out[3] if len(out) > 3 else None
    rdel, rval, _, st2 = route(plan, _as_caps(plan, resp_caps), rpl,
                               rdest.to(torch.int32), rvalid)
    stats = {"sent": sum(st1["sent"] + st2["sent"]),
             "leftover": st1["leftover"] + st2["leftover"]}
    if plan.telemetry:
        stats["telemetry"] = tele_lib.merge(st1["telemetry"],
                                            st2["telemetry"])
    return rdel, rval, aux, stats


def remote_gather(plan: MeshPlan, targets: torch.Tensor, valid: torch.Tensor,
                  owner_of: Callable[[torch.Tensor], torch.Tensor],
                  lookup_fn: Callable, req_cap, resp_cap, dedup: bool = True):
    """Fetch per-element data about remote ``targets`` (request/response).

    ``dedup=True`` is the paper's per-PE request aggregation (identical
    targets are asked once, then fanned back out). Requests carry no
    source-PE leaf: the responder rebuilds the origin from receive-buffer
    row indices (``route(track_src=True)``).

    Args:
      targets: (p, Q) global element ids to query.
      valid: (p, Q) mask.
      owner_of: global id -> owning PE id.
      lookup_fn: (ids (p, R), valid (p, R)) -> dict of (p, R, ...)
        response leaves, evaluated on the owning PE.
      req_cap/resp_cap: per-peer mailbox capacity for the two legs.

    Returns (values, answered, stats): ``values`` aligned with
    ``targets``; ``answered`` False => capacity overflow somewhere.
    """
    p, q = targets.shape
    dev = targets.device
    if dedup:
        order, skey, _, newrun = sort_and_group(targets, valid, INT_MAX)
        is_uniq = newrun & (skey != INT_MAX)
        group = torch.cumsum(is_uniq.to(torch.int32), dim=1,
                             dtype=torch.int32) - 1
        # one distinct slot per unique target
        uniq_slot = torch.where(is_uniq, group, q)
        req_targets = set_drop(torch.zeros_like(targets), uniq_slot, skey)
        n_uniq = _sum32(is_uniq)
        req_valid = arange(q, p, dev) < n_uniq[:, None]
        # original slot i -> unique slot group[rank of i in sort]; rows
        # sorted before the first unique target (all invalid) hold -1,
        # which indexes from the end as in the reference
        inv = unpermute(order, group)
        inv = torch.where(inv < 0, inv + q, inv)
    else:
        req_targets, req_valid = targets, valid
        inv = arange(q, p, dev)

    payload = {"target": req_targets, "slot": arange(q, p, dev)}
    dest = owner_of(req_targets).to(torch.int32)
    delivered, dval, leftovers, st_req = route(
        plan, _as_caps(plan, req_cap), payload, dest, req_valid,
        track_src=True)
    req_left = sum(_sum32(lv) for _, _, lv in leftovers)

    # answer on the owner
    values = lookup_fn(delivered["target"], dval)
    resp_payload = dict(values)
    resp_payload["slot"] = delivered["slot"]
    rdel, rval, rleft, st_resp = route(plan, _as_caps(plan, resp_cap),
                                       resp_payload, delivered["src"], dval)
    resp_left = sum(_sum32(lv) for _, _, lv in rleft)

    # scatter responses into the unique-request table: each request
    # slot is answered at most once, so the kept indices are distinct
    slot = torch.where(rval, rdel["slot"], q).to(torch.int32)
    uniq_answered = set_drop(torch.zeros((p, q), dtype=torch.bool,
                                         device=dev), slot, rval)
    out = {}
    for k in values:
        leaf = rdel[k]
        buf = set_drop(leaf.new_zeros((p, q) + tuple(leaf.shape[2:])),
                       slot, leaf)
        out[k] = take(buf, inv)
    answered = take(uniq_answered, inv) & valid
    stats = {
        "req_sent": sum(st_req["sent"]),
        "resp_sent": sum(st_resp["sent"]),
        "undelivered": req_left + resp_left,
    }
    if plan.telemetry:
        stats["telemetry"] = tele_lib.merge(st_req["telemetry"],
                                            st_resp["telemetry"])
    return out, answered, stats
