"""The port's exchange layer against the reference's, byte for byte.

The reference's ``route`` / ``route_compact`` / ``remote_gather`` run
per PE under ``transport.device_run`` on a virtual mesh (8 flat PEs, and
a (2, 4) grid with two-hop indirection); the port runs the same inputs
with the PE axis written out. Delivered buffers, leftover queues,
``dropped`` and ``sent`` must be identical; the packed and unpacked wire
paths must agree; and a packed ``route`` issues one ``all_to_all`` per
hop.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.listrank import exchange as ref_ex
from repro.core.listrank import transport as ref_tr
from repro.core.listrank.config import IndirectionSpec as RefIndirection
from repro_torch.core.listrank import exchange as ex
from repro_torch.core.listrank import transport as tr
from repro_torch.core.listrank.config import IndirectionSpec

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

GRIDS = {
    "direct8": ((8,), ("pe",), False),
    "grid2x4": ((2, 4), ("row", "col"), True),
}


def _plans(grid, packed, counting=False):
    shape, axes, two_hop = GRIDS[grid]
    ref_ind = RefIndirection.grid(axes) if two_hop else None
    ind = IndirectionSpec.grid(axes) if two_hop else None
    ref_mesh = ref_tr.sim_mesh(shape, axes)
    ref_plan = ref_ex.MeshPlan.from_mesh(ref_mesh, axes, ref_ind,
                                         wire_packing=packed)
    mesh = tr.sim_mesh(shape, axes)
    transport = tr.VirtualTransport(axes, shape, torch.device("cpu"))
    if counting:
        transport = tr.CountingTransport(transport)
    plan = ex.MeshPlan.from_mesh(mesh, axes, ind, wire_packing=packed,
                                 transport=transport)
    return ref_mesh, ref_plan, plan


def _messages(p, q, seed):
    rng = np.random.default_rng(seed)
    payload = {
        "ia": rng.integers(-5, 100, (p, q)).astype(np.int32),
        "fb": rng.normal(size=(p, q)).astype(np.float32),
        "bc": rng.integers(0, 2, (p, q)).astype(bool),
    }
    # skewed destinations so some mailboxes overflow
    dest = np.minimum(rng.geometric(0.25, (p, q)) - 1, p - 1).astype(np.int32)
    valid = rng.random((p, q)) < 0.8
    return payload, dest, valid


def _flat(x):
    return jnp.asarray(x.reshape((-1,) + x.shape[2:]))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _same(ref, ours, p):
    """Reference (p*R, ...) flat array == port (p, R, ...) tensor, bytes."""
    ref = np.asarray(ref)
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ref.dtype == ours.dtype
    assert ref.reshape(ours.shape).tobytes() == ours.tobytes()


def _keys():
    return sorted(["ia", "fb", "bc"])


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("track_src", [False, True])
def test_route_matches_reference(grid, packed, track_src):
    ref_mesh, ref_plan, plan = _plans(grid, packed)
    p, q, cap = plan.p, 24, 3
    caps = [cap] * plan.indirection.depth
    payload, dest, valid = _messages(p, q, seed=p + cap + track_src)
    keys = _keys()

    def body(*leaves):
        pl = dict(zip(keys, leaves[:-2]))
        d, dv, lo, st = ref_ex.route(ref_plan, caps, pl, leaves[-2],
                                     leaves[-1], track_src=track_src)
        return d, dv, lo, {"sent": jnp.stack(st["sent"])[None],
                           "leftover": st["leftover"][None]}

    sh = P(ref_plan.pe_axes)
    run = ref_tr.device_run(ref_mesh, ref_plan.pe_axes, body,
                            in_specs=(sh,) * (len(keys) + 2), out_specs=sh)
    r_d, r_dv, r_lo, r_st = run(*[_flat(payload[k]) for k in keys],
                                _flat(dest), _flat(valid))

    d, dv, lo, st = ex.route(plan, caps, {k: _t(payload[k]) for k in keys},
                             _t(dest), _t(valid), track_src=track_src)
    assert set(d) == set(r_d)
    for k in d:
        _same(r_d[k], d[k], p)
    _same(r_dv, dv, p)
    assert len(lo) == len(r_lo)
    for (rpl, rdest, rv), (pl, dst, v) in zip(r_lo, lo):
        for k in keys:
            _same(rpl[k], pl[k], p)
        _same(rdest, dst, p)
        _same(rv, v, p)
    _same(r_st["sent"], torch.stack(st["sent"], 1), p)
    _same(r_st["leftover"], st["leftover"], p)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("packed", [True, False])
def test_route_compact_matches_reference(grid, packed):
    ref_mesh, ref_plan, plan = _plans(grid, packed)
    p, cap, qc = plan.p, 2, 4
    caps = [cap] * plan.indirection.depth
    fr1 = _messages(p, 14, seed=1)
    fr2 = _messages(p, 10, seed=2)
    keys = _keys()

    def body(*args):
        a = len(keys) + 2
        frags = []
        for part in (args[:a], args[a:]):
            frags.append((dict(zip(keys, part[:-2])), part[-2], part[-1]))
        d, dv, (qpl, qd, qv), dropped, st = ref_ex.route_compact(
            ref_plan, caps, frags, qc)
        return d, dv, qpl, qd, qv, dropped[None], jnp.stack(st["sent"])[None]

    sh = P(ref_plan.pe_axes)
    run = ref_tr.device_run(ref_mesh, ref_plan.pe_axes, body,
                            in_specs=(sh,) * (2 * len(keys) + 4),
                            out_specs=sh)
    args = []
    for pl, dest, valid in (fr1, fr2):
        args += [_flat(pl[k]) for k in keys] + [_flat(dest), _flat(valid)]
    r_d, r_dv, r_qpl, r_qd, r_qv, r_drop, r_sent = run(*args)

    frags = [({k: _t(pl[k]) for k in keys}, _t(dest), _t(valid))
             for pl, dest, valid in (fr1, fr2)]
    d, dv, (qpl, qd, qv), dropped, st = ex.route_compact(plan, caps, frags, qc)
    for k in keys:
        _same(r_d[k], d[k], p)
        _same(r_qpl[k], qpl[k], p)
    _same(r_dv, dv, p)
    _same(r_qd, qd, p)
    _same(r_qv, qv, p)
    _same(r_drop, dropped, p)
    _same(r_sent, torch.stack(st["sent"], 1), p)
    assert int(dropped.sum()) > 0  # the queue overflowed somewhere


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("dedup", [True, False])
def test_remote_gather_matches_reference(grid, dedup):
    ref_mesh, ref_plan, plan = _plans(grid, packed=True)
    p, q, m, cap = plan.p, 20, 16, 4
    rng = np.random.default_rng(7 + dedup)
    table = rng.integers(-1000, 1000, (p, m)).astype(np.int32)
    ftable = rng.normal(size=(p, m)).astype(np.float32)
    targets = rng.integers(0, p * m, (p, q)).astype(np.int32)
    targets[:, ::3] = targets[:, 1::3][:, :targets[:, ::3].shape[1]]  # dups
    valid = rng.random((p, q)) < 0.85

    def ref_body(tgt, val, tbl, ftbl):
        base = ref_plan.my_id() * m

        def lookup(g, v):
            slot = jnp.clip(g - base, 0, m - 1)
            ok = v & (g >= base) & (g < base + m)
            return {"x": jnp.where(ok, tbl[slot], 0),
                    "f": jnp.where(ok, ftbl[slot], 0.0), "found": ok}

        out, ans, st = ref_ex.remote_gather(
            ref_plan, tgt, val, lambda g: g // m, lookup, cap, cap,
            dedup=dedup)
        return out, ans, {k: v[None] for k, v in st.items()}

    sh = P(ref_plan.pe_axes)
    run = ref_tr.device_run(ref_mesh, ref_plan.pe_axes, ref_body,
                            in_specs=(sh,) * 4, out_specs=sh)
    r_out, r_ans, r_st = run(_flat(targets), _flat(valid), _flat(table),
                             _flat(ftable))

    base = plan.my_id()[:, None] * m
    tbl, ftbl = _t(table), _t(ftable)

    def lookup(g, v):
        slot = torch.clamp(g - base, 0, m - 1).long()
        ok = v & (g >= base) & (g < base + m)
        return {"x": torch.where(ok, torch.gather(tbl, 1, slot), 0),
                "f": torch.where(ok, torch.gather(ftbl, 1, slot), 0.0),
                "found": ok}

    out, ans, st = ex.remote_gather(plan, _t(targets), _t(valid),
                                    lambda g: g // m, lookup, cap, cap,
                                    dedup=dedup)
    for k in ("x", "f", "found"):
        _same(r_out[k], out[k], p)
    _same(r_ans, ans, p)
    for k in ("req_sent", "resp_sent", "undelivered"):
        _same(r_st[k], st[k], p)
    assert not bool(ans.all())  # some mailbox overflowed


@pytest.mark.parametrize("grid", list(GRIDS))
def test_packed_equals_unpacked_and_one_collective_per_hop(grid):
    keys = _keys()
    outs, counts = [], []
    for packed in (True, False):
        _, _, plan = _plans(grid, packed, counting=True)
        p = plan.p
        payload, dest, valid = _messages(p, 16, seed=3)
        res = ex.route(plan, [4] * plan.indirection.depth,
                       {k: _t(payload[k]) for k in keys}, _t(dest),
                       _t(valid), track_src=True)
        outs.append(res)
        counts.append(dict(plan.transport.counts))
    (d1, v1, _, s1), (d2, v2, _, s2) = outs
    assert torch.equal(v1, v2)
    for k in d1:
        assert d1[k].numpy().tobytes() == d2[k].numpy().tobytes()
    hops = len(GRIDS[grid][0]) if GRIDS[grid][2] else 1
    # packed: one all_to_all per hop; unpacked: one per leaf (3 payload
    # leaves + _dest, + _src after the first hop of two) and validity
    assert counts[0] == {"all_to_all": hops}
    unpacked = 5 * hops + (hops - 1)
    assert counts[1] == {"all_to_all": unpacked}


def test_wire_roundtrip_exact():
    payload, _, valid = _messages(2, 9, seed=4)
    payload["fb"][0, 0], payload["fb"][1, 1] = np.nan, -0.0
    pl = {k: _t(v) for k, v in payload.items()}
    wf = ex.WireFormat.from_payload(pl)
    assert wf.width == 4
    out, v2 = wf.unpack_cols(wf.planes(pl, _t(valid)))
    assert torch.equal(v2, _t(valid))
    for k in pl:
        assert out[k].numpy().tobytes() == pl[k].numpy().tobytes()
    # 16-bit floats travel as their bit patterns (the reference raises
    # for them); a 64-bit leaf still does not fit a word
    half = torch.tensor([[1.5, -0.0, float("nan")]], dtype=torch.float16)
    back = ex.from_wire_word(ex.to_wire_word(half), torch.float16)
    assert back.numpy().tobytes() == half.numpy().tobytes()
    with pytest.raises(TypeError):
        ex.to_wire_word(torch.zeros(2, 3, dtype=torch.float64))


def test_all_to_all_is_the_mesh_permutation():
    """Row b of PE i lands in row coord(i) of the PE with coordinate b
    along the hop (other coordinates kept)."""
    t = tr.VirtualTransport(("row", "col"), (2, 3), torch.device("cpu"))
    x = torch.arange(6 * 3).reshape(6, 3)   # x[i, b] = 3*i + b
    got = t.all_to_all(x, ("col",), 0)
    for j in range(6):
        r, c = divmod(j, 3)
        for b in range(3):
            i = r * 3 + b
            assert int(got[j, b]) == 3 * i + c
    got = t.all_to_all(torch.arange(6 * 2).reshape(6, 2), ("row",), 0)
    for j in range(6):
        r, c = divmod(j, 3)
        for b in range(2):
            assert int(got[j, b]) == 2 * (b * 3 + c) + r
    assert torch.equal(t.psum(torch.ones(6, dtype=torch.int32)),
                       torch.full((6,), 6, dtype=torch.int32))
    assert t.all_gather(torch.arange(12).reshape(6, 2)).shape == (6, 12)
