"""Plain models of the schedules the card's list-ranking kernels run,
against the plain versions they must equal bit for bit.

- ``local_chase``: one persistent launch that walks rows in groups and
  stops a group at the first doubling step that changes no bit
  (``ref.local_chase_fixed_point_ref``);
- ``mailbox_pack``: a gather over the send buffer's cells from the
  bucket sort's order (``ref.mailbox_pack_sorted_ref``, the wrapper's CPU
  path), fed by the port's own ``exchange._bucket_indices``.

Their twins on the card are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mailbox_pack import kernel as mp_kernel_jax
from _torch_kernel_inputs import (PACK_HOPS, bucket_hop, chains,
                                  chase_edge_case, float_dist)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core.listrank import exchange, instances, local
from repro_torch.kernels.local_chase import ops as lc_ops, ref as lc_ref
from repro_torch.kernels.mailbox_pack import ops as mp_ops, ref as mp_ref


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("group", [None, 1, 2])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("gamma", [0.0, 0.3, 1.0])
def test_fixed_point_model_equals_local_chase_ref(gamma, dtype, group):
    succ, dist, steps = chains(4, 256, seed=17, gamma=gamma)
    if dtype == "float32":
        dist = float_dist(dist, seed=5)
    s, d = torch.from_numpy(succ), torch.from_numpy(dist)
    s_m, d_m, run = lc_ref.local_chase_fixed_point_ref(s, d, steps, group)
    s_r, d_r = lc_ref.local_chase_ref(s, d, steps)
    assert _same_bits(s_m, s_r) and _same_bits(d_m, d_r)
    assert run.shape == (4,) and 1 <= int(run.min()) <= int(run.max()) <= steps


@pytest.mark.parametrize("kind", ["neg_zero", "self_loop", "wrap"])
@pytest.mark.parametrize("group", [None, 1])
def test_fixed_point_model_exact_at_the_edges(kind, group):
    """-0.0 weights, self-loops that carry a weight, wrapping int32 sums:
    the model stops only where the bits stop changing."""
    succ, dist, steps = chase_edge_case(kind, seed=3)
    s, d = torch.from_numpy(succ), torch.from_numpy(dist)
    s_m, d_m, run = lc_ref.local_chase_fixed_point_ref(s, d, steps, group)
    s_r, d_r = lc_ref.local_chase_ref(s, d, steps)
    assert _same_bits(s_m, s_r) and _same_bits(d_m, d_r)
    if kind == "self_loop":
        # a weighted self-loop doubles every step: no fixed point
        assert int(run.min()) == steps
    else:
        assert int(run.max()) < steps
    if kind == "neg_zero":
        assert bool((torch.signbit(d_m) & (d_m == 0)).any())


def test_fixed_point_model_needs_bits_not_equality():
    """A state whose only change is -0.0 -> +0.0 is equal under ``==`` but
    not in bits: stopping on ``==`` would keep the -0.0."""
    succ = torch.tensor([[1, 1]], dtype=torch.int32)
    dist = torch.tensor([[-0.0, 0.0]], dtype=torch.float32)
    s_m, d_m, run = lc_ref.local_chase_fixed_point_ref(succ, dist, 3)
    s_r, d_r = lc_ref.local_chase_ref(succ, dist, 3)
    assert _same_bits(d_m, d_r) and not torch.signbit(d_r[0, 0])
    assert int(run[0]) == 2


def test_fixed_point_model_stops_at_step_4_on_gamma_1():
    """List(2^16, gamma=1) over 4 PEs, as local contraction builds it:
    the 4th of its 14 doubling steps is the first that changes nothing,
    on every row (the main path's List(2^24) over 16 PEs stops there
    too, checked on the card)."""
    n, p = 1 << 16, 4
    m = n // p
    succ, rank = instances.gen_list(n, 1.0, seed=1)
    s, d, steps, _ = local.chase_input(
        torch.from_numpy(succ).reshape(p, m),
        torch.from_numpy(rank).reshape(p, m),
        torch.arange(p, dtype=torch.int32) * m, m)
    assert steps == 14
    for group in (None, 1, 2):
        s_m, d_m, run = lc_ref.local_chase_fixed_point_ref(s, d, steps, group)
        assert run.tolist() == [4] * p
        s_r, d_r = lc_ref.local_chase_ref(s, d, steps)
        assert _same_bits(s_m, s_r) and _same_bits(d_m, d_r)


def test_group_rows_fit_the_l2():
    """Two 2^20-element rows in both int32 buffer pairs (32 MB) fit 75 %
    of a 50 MB L2; three do not."""
    l2 = 50 * 2 ** 20
    assert lc_ops.l2_group_rows(16, 1 << 20, 4, l2) == 2
    assert lc_ops.l2_group_rows(16, 1 << 10, 4, l2) == 16
    assert lc_ops.l2_group_rows(3, 1 << 26, 4, l2) == 1


@pytest.mark.parametrize("hop", range(len(PACK_HOPS)))
def test_sorted_pack_equals_slot_scatter(hop):
    """The gather from the bucket sort writes the bytes of the scatter to
    input-aligned slots, validity plane included, on hops with over-full
    and empty buckets, an all-invalid PE and no messages at all."""
    p, q, n_buckets, cap = PACK_HOPS[hop]
    cols, valid, order, skey, slots = bucket_hop(p, q, n_buckets, cap,
                                                 seed=hop)
    got = mp_ops.mailbox_pack(cols, order, skey, n_buckets, cap)
    want = mp_ref.mailbox_pack_ref(
        torch.stack(cols + [valid.to(torch.int32)], 1), slots,
        n_buckets * cap)
    assert got.shape == (p, len(cols) + 1, n_buckets * cap)
    assert got.dtype == torch.int32 and _same_bits(got, want)
    if q:
        filled = got[:, -1].reshape(p, n_buckets, cap).sum(-1)
        run = torch.stack([(skey == b).sum(1) for b in range(n_buckets)], 1)
        assert torch.equal(filled, torch.clamp(run, max=cap))
        assert int(run[:, n_buckets - 2].max()) == 0  # an empty bucket
        if p > 1:
            assert int(got[-1].abs().sum()) == 0  # the all-invalid PE
        if hop == 0:
            assert int(run.max()) > cap  # an over-full bucket


@pytest.mark.parametrize("cap", [0, 3])
def test_sorted_pack_empty_shapes(cap):
    cols, _, order, skey, _ = bucket_hop(2, 40, 4, 5, seed=1)
    out = mp_ops.mailbox_pack(cols, order, skey, 4, cap)
    assert out.shape == (2, len(cols) + 1, 4 * cap)
    out0 = mp_ops.mailbox_pack(cols, order, skey, 0, cap)
    assert out0.shape == (2, len(cols) + 1, 0)


@pytest.mark.parametrize("hop", [0, 1])
def test_sorted_pack_matches_pallas(hop):
    """The wrapper's CPU path against the JAX package's Pallas kernel
    (interpret mode), given the same hop's slots."""
    p, q, n_buckets, cap = PACK_HOPS[hop]
    cols, valid, order, skey, slots = bucket_hop(p, q, n_buckets, cap,
                                                 seed=hop)
    got = mp_ops.mailbox_pack(cols, order, skey, n_buckets, cap)
    planes = [c.numpy() for c in cols] + [valid.numpy().astype(np.int32)]
    for pe in range(p):
        ref = mp_kernel_jax.mailbox_pack_pallas(
            tuple(jnp.asarray(c[pe]) for c in planes),
            jnp.asarray(slots[pe].numpy()), n_buckets * cap, interpret=True)
        assert got[pe].numpy().tobytes() == np.asarray(ref).tobytes()


def test_route_with_the_sorted_pack_equals_the_scatter():
    """One packed ``route`` over a 2x4 grid (two hops, different caps)
    gives the same bytes with ``pallas_pack`` (the sorted gather) and
    without it (the slot scatter)."""
    from repro_torch.core.listrank import transport as tr
    from repro_torch.core.listrank.config import IndirectionSpec
    rng = np.random.default_rng(8)
    p, q = 8, 120
    payload = {"a": torch.from_numpy(rng.integers(-9, 99, (p, q))
                                      .astype(np.int32)),
               "f": torch.from_numpy(rng.normal(size=(p, q))
                                      .astype(np.float32))}
    dest = torch.from_numpy(np.minimum(rng.geometric(0.3, (p, q)) - 1,
                                       p - 1).astype(np.int32))
    valid = torch.from_numpy(rng.random((p, q)) < 0.8)
    outs = []
    for pallas_pack in (True, False):
        plan = exchange.MeshPlan.from_mesh(
            tr.sim_mesh((2, 4), ("row", "col")), ("row", "col"),
            IndirectionSpec.grid(("row", "col")), pallas_pack=pallas_pack)
        outs.append(exchange.route(plan, [20, 9], payload, dest, valid,
                                   track_src=True))
    (d1, v1, l1, s1), (d2, v2, l2, s2) = outs
    assert _same_bits(v1, v2)
    for k in d1:
        assert _same_bits(d1[k], d2[k])
    for a, b in zip(s1["sent"], s2["sent"]):
        assert torch.equal(a, b)
