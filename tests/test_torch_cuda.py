"""The port's CUDA kernels against their plain torch versions, on the
card (marker ``torch_cuda``; they skip without CUDA or nvcc). The file
imports no jax, so it runs on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m torch_cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_kernel_inputs import (ATTN_CASES, ATTN_TOL, CROSS_ATTN_CASES,
                                  D128_ATTN_CASES, D128_HEADS,
                                  GEMMA2_ATTN_CASES, GEMMA2_HEADS, K2_HEADS,
                                  PACK_HOPS, SSD_CASES, SSD_RAGGED, SSD_TOL, attn_inputs,
                                  bucket_hop, chains, chase_edge_case,
                                  float_dist, ssd_inputs, ssd_training_inputs)
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro_torch.kernels.local_chase import ops as lc_ops, ref as lc_ref
from repro_torch.kernels.mailbox_pack import ops as mp_ops, ref as mp_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops, ref as ssd_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        build.nvcc_path()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    return torch.device("cuda")


@pytest.mark.torch_cuda
@pytest.mark.parametrize("b,m", [(3, 64), (16, 1 << 16)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_local_chase_cuda_matches_plain(cuda, b, m, dtype):
    succ, dist, steps = chains(b, m, seed=11)
    if dtype == "float32":
        dist = float_dist(dist, seed=3)
    s, d = torch.from_numpy(succ).to(cuda), torch.from_numpy(dist).to(cuda)
    before = lc_ops.LAUNCHES
    s_k, d_k = lc_ops.local_chase(s, d, steps)
    torch.cuda.synchronize()
    assert lc_ops.LAUNCHES == before + 1
    s_r, d_r = lc_ref.local_chase_ref(s, d, steps)
    assert torch.equal(s_k, s_r)
    assert torch.equal(d_k.view(torch.int32), d_r.view(torch.int32))


def _chase_on_card(succ, dist, steps, cuda):
    """The kernel against the plain version and the plain model of its
    schedule: equal bits, equal steps run."""
    s, d = torch.from_numpy(succ).to(cuda), torch.from_numpy(dist).to(cuda)
    s_k, d_k = lc_ops.local_chase(s, d, steps)
    run = lc_ops.STEPS_RUN.cpu()
    s_r, d_r = lc_ref.local_chase_ref(s, d, steps)
    assert torch.equal(s_k, s_r)
    assert torch.equal(d_k.view(torch.int32), d_r.view(torch.int32))
    g = lc_ops.rows_per_group(s.shape[0], s.shape[1], d.element_size(),
                              cuda)
    _, _, run_model = lc_ref.local_chase_fixed_point_ref(
        torch.from_numpy(succ), torch.from_numpy(dist), steps, g)
    assert torch.equal(run, run_model)
    return run


@pytest.mark.torch_cuda
@pytest.mark.parametrize("kind", ["neg_zero", "self_loop", "wrap"])
def test_local_chase_cuda_fixed_point_at_the_edges(cuda, kind):
    """-0.0 weights, weighted self-loops (no fixed point: every step
    runs), wrapping int32 sums; an odd number of steps, so a stop at
    step 0 or 1 ends in either buffer pair."""
    succ, dist, steps = chase_edge_case(kind, seed=3)
    run = _chase_on_card(succ, dist, steps, cuda)
    if kind == "self_loop":
        assert int(run.min()) == steps


@pytest.mark.torch_cuda
@pytest.mark.parametrize("steps", [1, 2, 3, 7])
def test_local_chase_cuda_stops_at_step_0_or_runs_out(cuda, steps):
    """All stops (step 0 changes nothing) and a chain longer than
    2^steps (every step changes something), at both parities."""
    m = 300
    stops = np.tile(np.arange(m, dtype=np.int32), (2, 1))
    run = _chase_on_card(stops, np.zeros((2, m), np.int32), steps, cuda)
    assert run.tolist() == [1, 1]
    chain = np.minimum(np.arange(m, dtype=np.int32) + 1, m - 1)[None]
    run = _chase_on_card(chain, np.ones((1, m), np.float32), steps, cuda)
    assert run.tolist() == [steps]


def _main_chase_input(gamma):
    """local contraction's doubling input of the main path: List(2^24,
    gamma) over 16 PEs, seed 1 (B 16, m 2^20, 20 steps)."""
    from repro_torch.core.listrank import instances, local
    n, p = 1 << 24, 16
    m = n // p
    succ, rank = instances.gen_list(n, gamma, seed=1)
    s, d, steps, _ = local.chase_input(
        torch.from_numpy(succ).reshape(p, m),
        torch.from_numpy(rank).reshape(p, m),
        torch.arange(p, dtype=torch.int32) * m, m)
    return s.numpy(), d.numpy(), steps


@pytest.mark.torch_cuda
def test_local_chase_cuda_main_path_stops_at_step_4(cuda):
    """The main path's gamma=1 input reaches its fixed point on the 4th of
    its 20 steps (in L2-sized groups of rows, two on an H100, each
    stopping at its own)."""
    succ, dist, steps = _main_chase_input(1.0)
    assert steps == 20
    run = _chase_on_card(succ, dist, steps, cuda)
    assert int(run.max()) == 4


@pytest.mark.torch_cuda
def test_local_chase_cuda_gamma_0_runs_every_step(cuda):
    """List(2^24, gamma=0): each PE holds one chain of 2^20, so all 20
    steps change something."""
    succ, dist, steps = _main_chase_input(0.0)
    run = _chase_on_card(succ, dist, steps, cuda)
    assert run.tolist() == [steps] * 16


@pytest.mark.torch_cuda
def test_local_chase_cuda_zero_steps_launches_nothing(cuda):
    s = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    lc_ops.local_chase(s.expand(3, 8).contiguous(), s.expand(3, 8)
                       .contiguous(), 2)
    before = lc_ops.LAUNCHES
    s_k, d_k = lc_ops.local_chase(s, s, 0)
    assert lc_ops.LAUNCHES == before
    assert torch.equal(s_k, s) and torch.equal(d_k, s)
    # STEPS_RUN describes this call, not the one before
    assert lc_ops.STEPS_RUN.tolist() == [0]


def _pack_on_card(cols, order, skey, valid, slots, n_buckets, cap, cuda):
    cols = [c.to(cuda) for c in cols]
    order, skey = order.to(cuda), skey.to(cuda)
    before = mp_ops.LAUNCHES
    out = mp_ops.mailbox_pack(cols, order, skey, n_buckets, cap)
    torch.cuda.synchronize()
    assert mp_ops.LAUNCHES == before + (out.numel() > 0)
    assert torch.equal(out, mp_ref.mailbox_pack_sorted_ref(
        cols, order, skey, n_buckets, cap))
    want = mp_ref.mailbox_pack_ref(
        torch.stack(cols + [valid.to(cuda, torch.int32)], 1), slots.to(cuda),
        n_buckets * cap)
    assert torch.equal(out, want)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("hop", range(len(PACK_HOPS)))
def test_mailbox_pack_cuda_matches_plain(cuda, hop):
    """Over-full and empty buckets, an all-invalid PE, cap 1, a bucket of
    two tiles, no messages; float32 bit patterns in a payload plane."""
    p, q, n_buckets, cap = PACK_HOPS[hop]
    cols, valid, order, skey, slots = bucket_hop(p, q, n_buckets, cap,
                                                 seed=hop)
    _pack_on_card(cols, order, skey, valid, slots, n_buckets, cap, cuda)


@pytest.mark.torch_cuda
def test_mailbox_pack_cuda_cap_0_launches_nothing(cuda):
    cols, valid, order, skey, slots = bucket_hop(2, 40, 4, 0, seed=1)
    _pack_on_card(cols, order, skey, valid, slots, 4, 0, cuda)


@pytest.mark.torch_cuda
def test_mailbox_pack_cuda_main_path_hop(cuda):
    """A level-0 hop of the main path: p 16, Q 196 800, 16 buckets of
    4096, 4 payload planes, uniform destinations, 32 768 valid messages a
    PE on average."""
    from repro_torch.core.listrank import exchange
    p, q, nb, cap = 16, 196800, 16, 4096
    g = torch.Generator().manual_seed(7)
    valid = torch.rand((p, q), generator=g) < 32768 / q
    dest = torch.randint(0, nb, (p, q), generator=g, dtype=torch.int32)
    cols = [torch.randint(-2 ** 31, 2 ** 31 - 1, (p, q), generator=g,
                          dtype=torch.int32) for _ in range(4)]
    order, row, col, fits, _, skey = exchange._bucket_indices(
        dest, valid, nb, cap)
    slots = exchange.unpermute(order, row * cap + col)
    _pack_on_card(cols, order, skey, valid, slots, nb, cap, cuda)


@pytest.mark.torch_cuda
def test_route_cuda_sorted_pack_on_the_4x4_grid(cuda):
    """Two-hop routing on a 4x4 grid (4 buckets per hop, different caps):
    the kernel's packed route equals the slot scatter's, byte for byte."""
    from repro_torch.core.listrank import exchange, transport
    from repro_torch.core.listrank.config import IndirectionSpec
    p, q = 16, 3000
    g = torch.Generator().manual_seed(3)
    payload = {"a": torch.randint(-9, 99, (p, q), generator=g,
                                  dtype=torch.int32).to(cuda),
               "f": torch.randn((p, q), generator=g).to(cuda)}
    dest = torch.randint(0, p, (p, q), generator=g,
                         dtype=torch.int32).to(cuda)
    valid = (torch.rand((p, q), generator=g) < 0.8).to(cuda)
    outs = []
    for pallas_pack in (True, False):
        plan = exchange.MeshPlan.from_mesh(
            transport.sim_mesh((4, 4), ("row", "col")), ("row", "col"),
            IndirectionSpec.grid(("row", "col")), pallas_pack=pallas_pack,
            device=cuda)
        before = mp_ops.LAUNCHES
        outs.append(exchange.route(plan, [700, 180], payload, dest, valid))
        assert mp_ops.LAUNCHES == before + 2 * pallas_pack
    (d1, v1, _, s1), (d2, v2, _, s2) = outs
    assert torch.equal(v1, v2)
    for k in d1:
        assert torch.equal(d1[k].view(torch.int32), d2[k].view(torch.int32))
    for a, b in zip(s1["sent"], s2["sent"]):
        assert torch.equal(a, b)


#: a three-axis mesh and its topology-aware spec: ("col",), then one hop
#: over ("node", "row")
MESH3 = ((2, 2, 4), ("node", "row", "col"))
TOPOLOGY = (("col",), ("node", "row"))


@pytest.mark.torch_cuda
def test_route_cuda_sorted_pack_under_the_topology_spec(cuda):
    """Two-hop topology-aware routing on the (2, 2, 4) mesh (4 buckets on
    the intra-node hop, 4 on the hop over two axes): the kernel's packed
    route equals the slot scatter's, byte for byte."""
    from repro_torch.core.listrank import exchange, transport
    from repro_torch.core.listrank.config import IndirectionSpec
    p, q = 16, 3000
    g = torch.Generator().manual_seed(5)
    payload = {"a": torch.randint(-9, 99, (p, q), generator=g,
                                  dtype=torch.int32).to(cuda),
               "f": torch.randn((p, q), generator=g).to(cuda)}
    dest = torch.randint(0, p, (p, q), generator=g,
                         dtype=torch.int32).to(cuda)
    valid = (torch.rand((p, q), generator=g) < 0.8).to(cuda)
    outs = []
    for pallas_pack in (True, False):
        plan = exchange.MeshPlan.from_mesh(
            transport.sim_mesh(*MESH3), MESH3[1],
            IndirectionSpec.topology(*TOPOLOGY), pallas_pack=pallas_pack,
            device=cuda)
        before = mp_ops.LAUNCHES
        outs.append(exchange.route(plan, [700, 180], payload, dest, valid))
        assert mp_ops.LAUNCHES == before + 2 * pallas_pack
    (d1, v1, _, s1), (d2, v2, _, s2) = outs
    assert torch.equal(v1, v2)
    for k in d1:
        assert torch.equal(d1[k].view(torch.int32), d2[k].view(torch.int32))
    for a, b in zip(s1["sent"], s2["sent"]):
        assert torch.equal(a, b)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("variant", [
    {"algorithm": "doubling"},
    {"avoid_reversal": False},
    {"base_case": "allgather"},
    {"wire_packing": False, "srs_rounds": 2}],
    ids=["doubling", "reversal", "allgather_base", "unpacked"])
def test_solver_configs_cuda_kernels_on_equal_off(cuda, variant):
    """At n = 2^14 under the topology spec on the (2, 2, 4) mesh: each
    configuration solved twice with both kernels on and twice with both
    off gives the oracle's outputs, and all four runs the same bits and
    integer counters (the scatters of these paths are deterministic on
    the card)."""
    from repro_torch.core.listrank import (IndirectionSpec, ListRankConfig,
                                           instances, rank_list_seq,
                                           rank_list_with_stats, sim_mesh)
    succ, rank = instances.gen_list(1 << 14, gamma=0.5, seed=6)
    s_ref, r_ref = rank_list_seq(succ, rank)
    runs = []
    for on in (True, True, False, False):
        cfg = ListRankConfig(**variant, use_pallas=on, use_pallas_pack=on)
        lc_ops.LAUNCHES = mp_ops.LAUNCHES = 0
        s, r, st = rank_list_with_stats(
            succ, rank, sim_mesh(*MESH3), cfg=cfg, device=cuda,
            indirection=IndirectionSpec.topology(*TOPOLOGY))
        launches = (lc_ops.LAUNCHES, mp_ops.LAUNCHES)
        packed = variant.get("wire_packing", True)
        assert launches == ((1, launches[1]) if on else (0, 0))
        assert (launches[1] > 0) == (on and packed)
        runs.append((s.cpu(), r.cpu(), _int_stats(st)))
    np.testing.assert_array_equal(runs[0][0].numpy(), s_ref)
    np.testing.assert_array_equal(runs[0][1].numpy(), r_ref)
    for s, r, ints in runs[1:]:
        assert torch.equal(s, runs[0][0]) and torch.equal(r, runs[0][1])
        assert ints == runs[0][2]


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_flash_attention_cuda_matches_plain(cuda, case, dtype):
    b, hq, hkv, lq, lk, d, kw = ATTN_CASES[case]
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                seed=case, dtype=dtype))
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               fa_ref.attention_ref(q, k, v, **kw).float(),
                               **ATTN_TOL[dtype])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CROSS_ATTN_CASES)))
def test_flash_attention_cuda_cross_shapes(cuda, case, dtype):
    """seamless's cross-attention shapes: non-causal with Lq != Lk, and one
    query over a key count that is not a multiple of the decode tile (bf16:
    the split-K pair, whose last part runs past the keys)."""
    b, hq, hkv, lq, lk, d, kw = CROSS_ATTN_CASES[case]
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                seed=40 + case, dtype=dtype))
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(),
                               fa_ref.attention_ref(q, k, v, **kw).float(),
                               **ATTN_TOL[dtype])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
def test_flash_attention_cuda_decode_per_slot(cuda, d):
    """One query per slot at its own position over a 300-key cache, GQA
    group 8, every head dim the kernel is built for."""
    q, k, v = (t.to(cuda) for t in attn_inputs(5, 16, 2, 1, 300, d, seed=d))
    offsets = torch.tensor([0, 63, 64, 200, 299], dtype=torch.int32,
                           device=cuda)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, q_offset=offsets, window=100)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    torch.testing.assert_close(
        out, fa_ref.attention_ref(q, k, v, q_offset=offsets, window=100),
        **ATTN_TOL[torch.float32])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
@pytest.mark.parametrize("kw", [{}, {"window": 70, "softcap": 30.0},
                                {"causal": False}], ids=["causal",
                                                         "window", "full"])
def test_flash_attention_cuda_bf16_tensor_cores(cuda, d, kw):
    """The bf16 prefill kernel (mma.sync) for every head dim it is built
    for: GQA group 4, 150 queries over 230 keys (ragged 64-key tiles and a
    ragged 128-row tile), against the plain version at the bf16 tolerance."""
    q, k, v = (t.to(cuda) for t in attn_inputs(2, 8, 2, 150, 230, d,
                                                seed=d, dtype=torch.bfloat16))
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, q_offset=80, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, q_offset=80, **kw).float(),
        **ATTN_TOL[torch.bfloat16])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("d", [24, 64, 128, 256])
@pytest.mark.parametrize("kw", [{}, {"window": 300, "softcap": 30.0},
                                {"causal": False}], ids=["causal",
                                                         "window", "full"])
def test_flash_attention_cuda_bf16_long_keys(cuda, d, kw):
    """The bf16 prefill over 1600 keys (25 K/V tiles through the ring) at
    per-slot offsets 1400 and -50 (under the causal mask the first 50 rows
    of the second slot keep no key: exactly 0)."""
    q, k, v = (t.to(cuda) for t in attn_inputs(2, 16, 2, 200, 1600, d,
                                                seed=d, dtype=torch.bfloat16))
    off = torch.tensor([1400, -50], dtype=torch.int32, device=cuda)
    out = fa_ops.flash_attention(q, k, v, q_offset=off, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, q_offset=off, **kw).float(),
        **ATTN_TOL[torch.bfloat16])
    if kw.get("causal", True):
        assert torch.count_nonzero(out[1, :, :50]) == 0


@pytest.mark.torch_cuda
@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
def test_flash_attention_cuda_split_decode(cuda, d):
    """bf16 decode through split-K: per-slot offsets 0, 1, a part
    boundary and Lk - 1, and -1 (a row with no kept key, exactly 0), with
    the merge held to the plain version and to its plain split-and-merge."""
    b, hq, hkv, lk = 5, 16, 2, 1000
    splits = fa_ops.decode_splits(b, hkv, hq // hkv, lk, torch.cuda
                                  .get_device_properties(cuda)
                                  .multi_processor_count)
    part = fa_ops.decode_part_len(lk, splits)
    assert splits > 1 and part < lk
    offsets = torch.tensor([0, 1, part, lk - 1, -1], dtype=torch.int32,
                           device=cuda)
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, 1, lk, d, seed=d,
                                                dtype=torch.bfloat16))
    for kw in ({}, {"window": 300, "softcap": 30.0}):
        before = fa_ops.LAUNCHES
        out = fa_ops.flash_attention(q, k, v, q_offset=offsets, **kw)
        torch.cuda.synchronize()
        assert fa_ops.LAUNCHES == before + 1
        want = fa_ref.attention_ref(q, k, v, q_offset=offsets, **kw).float()
        torch.testing.assert_close(out.float(), want,
                                   **ATTN_TOL[torch.bfloat16])
        torch.testing.assert_close(
            out.float(), fa_ref.attention_split_ref(
                q, k, v, part_len=part, q_offset=offsets, **kw).float(),
            **ATTN_TOL[torch.bfloat16])
        assert torch.count_nonzero(out[4]) == 0


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GEMMA2_ATTN_CASES,
                         ids=[c[0] for c in GEMMA2_ATTN_CASES])
def test_flash_attention_cuda_gemma2_heads(cuda, case, dtype):
    """gemma2-2b's heads (D 256, scale 256^-0.5, soft-cap 50) over its
    8192-key slot: the bf16 prefill kernel's 3-stage ring of 32-key tiles
    with Q read from shared memory, the float32 kernel and the split-K
    decode at D = 256, with and without the 4096-key window; a decode also
    against its plain split-and-merge."""
    name, b, lq, lk, offs, window = case
    hq, hkv, d, scale, cap = GEMMA2_HEADS
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                seed=lq, dtype=dtype))
    off = offs[0] if b == 1 else torch.tensor(offs, dtype=torch.int32,
                                                device=cuda)
    kw = dict(q_offset=off, window=window, softcap=cap, scale=scale)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, **kw).float(),
        **ATTN_TOL[dtype])
    if name.startswith("decode") and dtype == torch.bfloat16:
        part = fa_ops.decode_part_len(lk, fa_ops.decode_splits(
            b, hkv, hq // hkv, lk,
            torch.cuda.get_device_properties(cuda).multi_processor_count))
        torch.testing.assert_close(
            out.float(), fa_ref.attention_split_ref(
                q, k, v, part_len=part, **kw).float(), **ATTN_TOL[dtype])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(D128_HEADS))
def test_flash_attention_cuda_d128_heads(cuda, arch, kind):
    """The head-dim-128 decoders' heads (GQA groups 5, 3 and 4, scale
    128^-0.5) in bf16: the tensor-core prefill at 300 queries over 300
    keys (ragged tiles of the group's rows), and the split-K decode of 5
    slots over 700 keys at offsets 0, 1, 350, 600 and 699, also against
    its plain split-and-merge; one launch a call."""
    hq, hkv, d, scale, cap = D128_HEADS[arch]
    if kind == "prefill":
        b, lq, lk, off = 1, 300, 300, 0
    else:
        b, lq, lk = 5, 1, 700
        off = torch.tensor([0, 1, 350, 600, 699], dtype=torch.int32,
                           device=cuda)
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                seed=hq,
                                                dtype=torch.bfloat16))
    kw = dict(q_offset=off, scale=scale, softcap=cap)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, **kw).float(),
        **ATTN_TOL[torch.bfloat16])
    if kind == "decode":
        splits = fa_ops.decode_splits(b, hkv, hq // hkv, lk, torch.cuda
                                      .get_device_properties(cuda)
                                      .multi_processor_count)
        assert splits > 1
        torch.testing.assert_close(
            out.float(), fa_ref.attention_split_ref(
                q, k, v, part_len=fa_ops.decode_part_len(lk, splits),
                **kw).float(), **ATTN_TOL[torch.bfloat16])


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", D128_ATTN_CASES,
                         ids=[c[0] for c in D128_ATTN_CASES])
def test_flash_attention_cuda_k2_heads(cuda, case, dtype):
    """kimi-k2's heads (Hq 64 over Hkv 8: GQA group 8, D 112, scale
    112^-0.5) at its serving shapes over an 8192-key slot: the causal
    prefill at 4096 x 4096, a 1024-token bucket and the decode of 5 slots
    at offsets 0, 1, 4095, 6000 and 8191, against the plain version (a
    bf16 decode also against its plain split-and-merge); one launch a
    call."""
    name, b, lq, lk, offs, window = case
    hq, hkv, d, scale, cap = K2_HEADS
    q, k, v = (t.to(cuda) for t in attn_inputs(b, hq, hkv, lq, lk, d,
                                                seed=lq, dtype=dtype))
    off = offs[0] if b == 1 else torch.tensor(offs, dtype=torch.int32,
                                                device=cuda)
    kw = dict(q_offset=off, window=window, softcap=cap, scale=scale)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, **kw).float(),
        **ATTN_TOL[dtype])
    if name == "decode" and dtype == torch.bfloat16:
        part = fa_ops.decode_part_len(lk, fa_ops.decode_splits(
            b, hkv, hq // hkv, lk,
            torch.cuda.get_device_properties(cuda).multi_processor_count))
        torch.testing.assert_close(
            out.float(), fa_ref.attention_split_ref(
                q, k, v, part_len=part, **kw).float(), **ATTN_TOL[dtype])


#: hymba-1.5b's attention: Hq, Hkv (a GQA group of 5), D, window
HYMBA_ATTN = (25, 5, 64, 1024)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [2048, 4096])
def test_flash_attention_cuda_hymba_windowed_prefill(cuda, l, dtype):
    """hymba's heads and 1024-key window over a bucket longer than the
    window (the prefill kernel skips the K/V tiles before it)."""
    hq, hkv, d, win = HYMBA_ATTN
    q, k, v = (t.to(cuda) for t in attn_inputs(1, hq, hkv, l, l, d, seed=l,
                                                dtype=dtype))
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, window=win)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, window=win).float(),
        **ATTN_TOL[dtype])


@pytest.mark.torch_cuda
def test_flash_attention_cuda_hymba_split_decode_at_the_window_edge(cuda):
    """bf16 split-K decode with hymba's heads over 4096 keys at per-slot
    offsets on both sides of the window's edge: whole parts before the
    window keep no key (l = 0) and the group of 5 fills 5 of 16 rows."""
    hq, hkv, d, win = HYMBA_ATTN
    lk = 4096
    offsets = torch.tensor([100, 1023, 1024, 1025, 3000, 4095],
                           dtype=torch.int32, device=cuda)
    q, k, v = (t.to(cuda) for t in attn_inputs(6, hq, hkv, 1, lk, d, seed=7,
                                                dtype=torch.bfloat16))
    splits = fa_ops.decode_splits(6, hkv, hq // hkv, lk, torch.cuda
                                  .get_device_properties(cuda)
                                  .multi_processor_count)
    assert splits > 1
    kw = dict(q_offset=offsets, window=win)
    before = fa_ops.LAUNCHES
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 1
    torch.testing.assert_close(
        out.float(), fa_ref.attention_ref(q, k, v, **kw).float(),
        **ATTN_TOL[torch.bfloat16])
    torch.testing.assert_close(
        out.float(), fa_ref.attention_split_ref(
            q, k, v, part_len=fa_ops.decode_part_len(lk, splits),
            **kw).float(), **ATTN_TOL[torch.bfloat16])


@pytest.mark.torch_cuda
def test_flash_attention_cuda_rejects_what_it_does_not_take(cuda):
    q, k, v = (t.to(cuda) for t in attn_inputs(1, 4, 2, 8, 8, 48, seed=0))
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_attention(q, k, v)
    q, k, v = (t.to(cuda) for t in attn_inputs(1, 4, 2, 8, 8, 32, seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, v)


#: mamba2-130m's training shape: (Bt, L, H, G, N, P, chunk)
MAMBA_SHAPE = (8, 1024, 24, 1, 128, 64, 256)


def _ssd_check(cuda, shape, dtype, tol, skip=True, seed=0):
    bt, l, h, g, n, p, chunk = shape
    x, dt, A, B, C, D = (t.to(cuda) for t in ssd_inputs(
        bt, l, h, g, n, p, seed=seed, dtype=dtype))
    D = D if skip else None
    before = ssd_ops.LAUNCHES
    y = ssd_ops.ssd_scan(x, dt, A, B, C, D, chunk)
    torch.cuda.synchronize()
    assert ssd_ops.LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(y.float(),
                               ssd_ref.ssd_ref(x, dt, A, B, C, D).float(),
                               **tol)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("skip", [True, False], ids=["D", "noD"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_cuda_matches_plain(cuda, case, skip):
    _ssd_check(cuda, case, torch.float32, SSD_TOL, skip, seed=sum(case))


@pytest.mark.torch_cuda
@pytest.mark.parametrize("shape", [
    (1, 300, 4, 2, 16, 32, 128),      # ragged: 2 full chunks + 44 steps
    (2, 100, 8, 1, 32, 16, 64),       # ragged, G = 1 < H
    (1, 1000, 24, 1, 128, 64, 256),   # mamba2-130m widths, ragged
    (1, 130, 6, 3, 64, 48, 130),      # one chunk of 130: ragged row block
])
def test_ssd_scan_cuda_ragged_and_grouped(cuda, shape):
    _ssd_check(cuda, shape, torch.float32, SSD_TOL, seed=sum(shape))


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_cuda_mamba_shape(cuda, dtype):
    tol = SSD_TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    _ssd_check(cuda, MAMBA_SHAPE, dtype, tol, seed=1)


#: hymba-1.5b's SSD shape: 50 heads, N = 16
HYMBA_SSD = (1, 4096, 50, 1, 16, 64, 128)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_scan_cuda_hymba_shape(cuda, dtype):
    tol = SSD_TOL if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)
    _ssd_check(cuda, HYMBA_SSD, dtype, tol, seed=2)


@pytest.mark.torch_cuda
def test_ssd_scan_cuda_underflowing_decays(cuda):
    """The training regime: dt = softplus(.) and A = -1, as at mamba2-130m's
    init, drive a chunk's summed log-decay below -88, where exp underflows
    in float32."""
    bt, l, h, g, n, p, chunk = 2, 1024, 24, 1, 128, 64, 256
    x, _, _, B, C, D = (t.to(cuda) for t in ssd_inputs(bt, l, h, g, n, p,
                                                       seed=5))
    gen = torch.Generator(cuda).manual_seed(5)
    dt = torch.nn.functional.softplus(
        torch.randn(bt, l, h, device=cuda, generator=gen))
    A = -torch.ones(h, device=cuda)
    assert float((dt * A)[:, :chunk].sum(1).max()) < -88
    y = ssd_ops.ssd_scan(x, dt, A, B, C, D, chunk)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, ssd_ref.ssd_ref(x, dt, A, B, C, D),
                               **SSD_TOL)


BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("shape", SSD_CASES + SSD_RAGGED)
def test_ssd_scan_cuda_bf16_tensor_cores(cuda, shape):
    """The chunk-parallel bf16 kernels on the kernel sweep and the ragged
    and grouped shapes, against ssd_ref on the same bf16 inputs."""
    _ssd_check(cuda, shape, torch.bfloat16, BF16_TOL, seed=sum(shape))


@pytest.mark.torch_cuda
def test_ssd_scan_cuda_bf16_training_regime(cuda):
    """bf16 at mamba2-130m's shape with dt = softplus(N(0, 1)) and A = -1:
    log-decays of about -200 a chunk, where W rounded once to bf16 would
    take most of the gate (the kernel splits it in two parts)."""
    args = [t.to(cuda) for t in ssd_training_inputs(2, 1024, 24, 1, 128, 64,
                                                    seed=5,
                                                    dtype=torch.bfloat16)]
    y = ssd_ops.ssd_scan(*args, 256)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y.float(), ssd_ref.ssd_ref(*args).float(),
                               **BF16_TOL)


@pytest.mark.torch_cuda
def test_ssd_scan_cuda_empty_launches_nothing(cuda):
    x, dt, A, B, C, D = (t.to(cuda)[:, :0] if t.dim() > 1 else t.to(cuda)
                         for t in ssd_inputs(2, 8, 4, 1, 16, 32, seed=0))
    before = ssd_ops.LAUNCHES
    y = ssd_ops.ssd_scan(x, dt, A, B, C, D, 64)
    assert y.shape == x.shape and ssd_ops.LAUNCHES == before


@pytest.mark.torch_cuda
@pytest.mark.parametrize("skip", [True, False], ids=["D", "noD"])
def test_ssd_scan_cuda_gradients(cuda, skip):
    """Gradients through the autograd.Function (kernel forward, backward
    through the recomputed ssd_ref) against autograd through ssd_ref."""
    bt, l, h, g, n, p, chunk = 2, 200, 4, 2, 16, 32, 64
    ins = [t.to(cuda) for t in ssd_inputs(bt, l, h, g, n, p, seed=7)]
    if not skip:
        ins = ins[:5]
    w = torch.randn(bt, l, h, p, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(0))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        y = fn(*leaves[:5], leaves[5] if skip else None)
        return torch.autograd.grad((y * w).sum(), leaves)

    before = ssd_ops.LAUNCHES
    got = grads(lambda *a: ssd_ops.ssd_scan(*a, chunk))
    assert ssd_ops.LAUNCHES == before + 1
    want = grads(ssd_ref.ssd_ref)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, **SSD_TOL)


@pytest.mark.torch_cuda
def test_ssd_scan_cuda_rejects_what_it_does_not_take(cuda):
    x, dt, A, B, C, D = (t.to(cuda) for t in ssd_inputs(1, 8, 2, 1, 4, 8,
                                                         seed=0))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                         A, B, C, D)
    x, dt, A, B, C, D = (t.to(cuda) for t in ssd_inputs(1, 8, 2, 1, 4, 160,
                                                         seed=0))
    with pytest.raises(ValueError, match="head dim"):
        ssd_ops.ssd_scan(x, dt, A, B, C, D)


# --------------------------------------------------------------------------
# the tree and graph paths on the card: kernels on equal kernels off
# --------------------------------------------------------------------------

def _counting_pack(monkeypatch):
    """Count ``mailbox_pack`` calls on the path by wrapping the wrapper
    (not by reading the profiler)."""
    calls, real = [], mp_ops.mailbox_pack

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(mp_ops, "mailbox_pack", counting)
    return calls


def _int_stats(stats):
    return {k: v for k, v in stats.items() if isinstance(v, int)}


@pytest.mark.torch_cuda
@pytest.mark.parametrize("n,num_trees", [(257, 1), (1000, 5)])
def test_tree_stats_cuda_kernels_on_equal_off(cuda, monkeypatch, n,
                                              num_trees):
    from repro_torch.core import treealg
    from repro_torch.core.listrank import ListRankConfig, instances, sim_mesh
    parent = instances.gen_tree_parents(n, seed=n, locality=True,
                                        num_trees=num_trees)
    mesh = sim_mesh(8)
    off = treealg.tree_stats(parent, mesh, cfg=ListRankConfig(), device=cuda)
    calls = _counting_pack(monkeypatch)
    chase = lc_ops.LAUNCHES
    on = treealg.tree_stats(parent, mesh, device=cuda, cfg=ListRankConfig(
        use_pallas=True, use_pallas_pack=True))
    assert len(calls) > 0 and lc_ops.LAUNCHES > chase
    for k in ("depth", "subtree_size", "preorder", "postorder", "root_of"):
        np.testing.assert_array_equal(getattr(on, k), getattr(off, k))
    assert _int_stats(on.stats) == _int_stats(off.stats)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("n,e,comps", [(200, 600, 1), (512, 1024, 4)])
def test_graph_stats_cuda_kernels_on_equal_off(cuda, monkeypatch, n, e,
                                               comps):
    from repro_torch.core import graphalg
    from repro_torch.core.listrank import ListRankConfig, instances, sim_mesh
    edges = instances.gen_graph_edges(n, e, seed=1, num_components=comps)
    mesh = sim_mesh(8)
    off = graphalg.graph_stats(edges, n, mesh, cfg=ListRankConfig(),
                               device=cuda)
    calls = _counting_pack(monkeypatch)
    chase = lc_ops.LAUNCHES
    on = graphalg.graph_stats(edges, n, mesh, device=cuda, cfg=ListRankConfig(
        use_pallas=True, use_pallas_pack=True))
    assert len(calls) > 0 and lc_ops.LAUNCHES > chase
    for k in ("components", "parent", "depth", "subtree_size", "preorder",
              "postorder"):
        np.testing.assert_array_equal(getattr(on, k), getattr(off, k))
    assert _int_stats(on.stats) == _int_stats(off.stats)
    cpu = graphalg.graph_stats(edges, n, mesh, cfg=ListRankConfig(),
                               device="cpu")
    np.testing.assert_array_equal(on.parent, cpu.parent)
    assert _int_stats(cpu.stats) == _int_stats(on.stats)


# ------------------------------------------------------------ flight recorder
@pytest.mark.torch_cuda
def test_telemetry_and_tracing_cuda_change_nothing(cuda, monkeypatch):
    """At 2^20, p = 16: tracing and telemetry on against off with the
    kernels on (outputs, counters, per-stage collectives equal, both
    kernels launched), and the telemetry records equal with the kernels
    on and off."""
    from repro_torch import obs
    from repro_torch.core.listrank import (ListRankConfig, instances,
                                           rank_list_seq,
                                           rank_list_with_stats, sim_mesh)
    succ, rank = instances.gen_list(1 << 20, gamma=1.0, seed=2)
    s_ref, r_ref = rank_list_seq(succ, rank)
    on = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    off = ListRankConfig()

    def run(cfg, **kw):
        s, r, st = rank_list_with_stats(succ, rank, sim_mesh(16), cfg=cfg,
                                        device=cuda, stage_counters=True,
                                        **kw)
        return s, r, st

    s0, r0, st0 = run(on)
    np.testing.assert_array_equal(s0.cpu().numpy(), s_ref)
    np.testing.assert_array_equal(r0.cpu().numpy(), r_ref)
    calls = _counting_pack(monkeypatch)
    chase = lc_ops.LAUNCHES
    tracer = obs.Tracer()
    s1, r1, st1 = run(on.with_(telemetry=True), tracer=tracer)
    assert len(calls) > 0 and lc_ops.LAUNCHES == chase + 1
    assert torch.equal(s0, s1) and torch.equal(r0, r1)
    assert _int_stats(st0) == _int_stats(st1)
    assert st0["stage_collectives"] == st1["stage_collectives"]
    attempts = list(tracer.find(cat="stage-attempt"))
    assert [a.name.split("#")[0] for a in attempts] == list(st1["stage_log"])
    for att, (_, coll) in zip(attempts, st1["stage_collectives"]):
        assert np.isfinite(att.args["predicted_s"])
        assert att.args["collective_count"] == sum(c for _, c in coll)
    s2, r2, st2 = run(off.with_(telemetry=True))
    assert torch.equal(s1, s2) and torch.equal(r1, r2)
    assert _int_stats(st1) == _int_stats(st2)
    assert st1["telemetry"] == st2["telemetry"]


# ------------------------------------------------ the distributed transport
@pytest.mark.torch_cuda
@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_dist_solve_cuda_equals_the_virtual_transport(cuda, backend, world):
    """At 2^20, p = 8, kernels on: a solve over ``world`` spawned ranks on
    the card (gloo with CUDA tensors, 4 PEs a rank; NCCL at world size 1,
    every PE on one rank) gives the virtual transport's outputs, counters
    and per-stage collectives, with each kernel launched as often on
    every rank as in the virtual solve."""
    from _torch_dist_rank import RankPool
    from repro_torch.core.listrank import (ListRankConfig, instances,
                                           rank_list_with_stats, sim_mesh)
    succ, rank = instances.gen_list(1 << 20, gamma=1.0, seed=3)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)
    lc_ops.LAUNCHES = mp_ops.LAUNCHES = 0
    s0, r0, st0 = rank_list_with_stats(succ, rank, sim_mesh(8), cfg=cfg,
                                       device=cuda, stage_counters=True)
    launches = {"local_chase": lc_ops.LAUNCHES,
                "mailbox_pack": mp_ops.LAUNCHES}
    assert launches["local_chase"] == 1 and launches["mailbox_pack"] > 0
    pool = RankPool(world, backend=backend, device="cuda:0")
    try:
        outs = pool.run("solve", succ, rank, (8,), ("pe",), cfg, None,
                        {"stage_counters": True}, timeout=300)
    finally:
        pool.close()
    for out in outs:
        np.testing.assert_array_equal(out["succ"], s0.cpu().numpy())
        np.testing.assert_array_equal(out["rank"], r0.cpu().numpy())
        assert {k: v for k, v in out["stats"].items() if isinstance(v, int)
                } == _int_stats(st0)
        assert out["stats"]["stage_collectives"] == st0["stage_collectives"]
        assert out["launches"] == launches


# ------------------------------------------------------------ fault tolerance
@pytest.mark.torch_cuda
def test_checkpoint_cuda_tree_round_trips_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint.checkpointer import flatten
    g = torch.Generator(cuda).manual_seed(5)
    tree = {"w": torch.randn(64, 33, generator=g, device=cuda),
            "h": torch.randn(17, generator=g, device=cuda).to(torch.bfloat16),
            "i": (torch.randint(-9, 9, (40,), generator=g, device=cuda,
                                dtype=torch.int32),
                  torch.rand(40, generator=g, device=cuda) < 0.5),
            "step": torch.zeros((), dtype=torch.int32, device=cuda)}
    ck = Checkpointer(tmp_path, async_save=True)
    ck.save(1, tree)
    ck.wait()
    _, leaves, rebuild = flatten(tree)
    got, step = ck.restore(None, rebuild([torch.empty_like(x, device="meta")
                                          for x in leaves]), cuda)
    assert step == 1
    for a, b in zip(leaves, flatten(got)[1]):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        assert b.shape == a.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))


@pytest.mark.torch_cuda
def test_supervised_solve_cuda_preempts_and_resumes_on_the_card(cuda,
                                                                 monkeypatch,
                                                                 tmp_path):
    """A kernels-on solve preempted after descend@1 resumes onto the card
    (every restored leaf on CUDA), equal to the oracle, without running
    prep again."""
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.core.listrank import (FaultSpec, ListRankConfig,
                                           instances, rank_list_seq,
                                           rank_list_with_stats, resume,
                                           sim_mesh)
    from repro_torch.runtime.fault_tolerance import (Preempted,
                                                     SolveSupervisor,
                                                     SolveSupervisorConfig)
    succ, rank = instances.gen_list(1 << 14, gamma=1.0, seed=4)
    s_ref, r_ref = rank_list_seq(succ, rank)
    cfg = ListRankConfig(use_pallas=True, use_pallas_pack=True)

    def run(**kw):
        return rank_list_with_stats(
            succ, rank, sim_mesh(16), cfg=cfg, device=cuda,
            supervisor=SolveSupervisor(SolveSupervisorConfig(
                ckpt_dir=str(tmp_path))), **kw)

    with pytest.raises(Preempted):
        run(inject=FaultSpec("preempt", stage="descend", level=1))
    devices, layout = [], resume.per_pe_layout

    def recording(flat, like):
        out = layout(flat, like)
        devices.extend(x.device.type for x in flatten(out)[1])
        return out

    monkeypatch.setattr(resume, "per_pe_layout", recording)
    chase = lc_ops.LAUNCHES
    s, r, stats = run()
    assert lc_ops.LAUNCHES == chase
    assert devices and set(devices) == {"cuda"}
    assert stats["recovery"]["resumed_from"] == 3
    np.testing.assert_array_equal(s.cpu().numpy(), s_ref)
    np.testing.assert_array_equal(r.cpu().numpy(), r_ref)


@pytest.mark.torch_cuda
def test_supervised_training_cuda_restores_bit_for_bit(cuda, tmp_path):
    """mamba2-130m at full width, 2 layers, float32, kernels on, 6 steps
    checkpointed every 2 with a failure at step index 3: the restored
    state equals the state saved at step 2 bit for bit, and the final
    loss is within phase 13's 1e-4 (relative) of an uninterrupted run."""
    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.data import pipeline
    from repro_torch.launch import train as train_launch
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault_tolerance import (Supervisor,
                                                     SupervisorConfig)
    from repro_torch.train import steps as train_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("mamba2-130m").with_(
        num_layers=2, dtype=torch.float32, use_kernels=True)
    assert cfg.d_model == 768
    tcfg = train_steps.TrainConfig(optimizer=adamw.AdamWConfig(lr=3e-3),
                                   warmup_steps=1, total_steps=6)
    dcfg = pipeline.DataConfig(vocab_size=cfg.vocab_size, seq_len=256,
                               global_batch=2)

    def supervised(directory, fail_at=None):
        sup = Supervisor(
            SupervisorConfig(ckpt_dir=str(tmp_path / directory),
                             ckpt_every=2),
            lambda: train_launch.initial_state(cfg, tcfg, cuda),
            lambda: train_launch.state_like(cfg, tcfg), device=cuda)
        sup.inject_failure_at = fail_at
        saved, restored = {}, []
        save, restore = sup.ckpt.save, sup.ckpt.restore

        def keeping_save(step, state, **kw):
            saved[step] = [x.detach().cpu().clone()
                           for x in flatten(state)[1]]
            return save(step, state, **kw)

        def keeping_restore(*a, **kw):
            out = restore(*a, **kw)
            restored.append((out[1], flatten(out[0])[1]))
            return out

        sup.ckpt.save, sup.ckpt.restore = keeping_save, keeping_restore
        losses = {}
        sup.run(train_launch.step_fn(cfg, dcfg, tcfg, cuda), 6,
                lambda done, m: losses.__setitem__(done, float(m["loss"])))
        return sup, saved, restored, losses

    _, _, _, straight = supervised("a")
    sup, saved, restored, losses = supervised("b", fail_at=3)
    assert sup.stats["restarts"] == 1
    assert [step for step, _ in restored] == [2]
    for a, b in zip(saved[2], restored[0][1]):
        assert b.device.type == "cuda"
        assert torch.equal(a, b.cpu())
    rel = abs(losses[6] - straight[6]) / abs(straight[6])
    assert np.isfinite(losses[6]) and rel <= 1e-4, (losses, straight)


@pytest.mark.torch_cuda
def test_hymba_engine_cuda_matches_the_cpu(cuda):
    """hymba-1.5b SMOKE (float32) served on the card with the kernels on
    gives the same engine's tokens on the CPU: slots reused, both prefill
    buckets, the 16-token window crossed."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.params import map_tree
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    cfg = configs.get_config("hymba-1.5b", smoke=True).with_(
        use_kernels=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (72, 3, 150, 129, 21)]
    out = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(
            map_tree(lambda t: t.to(dev), params), cfg,
            ServeConfig(slots=2, max_seq=256, max_new_tokens=6, eos_id=-1),
            device=dev)
        for uid, prompt in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=prompt))
        before = fa_ops.LAUNCHES
        out[str(dev)] = eng.run_to_completion()
        if dev == cuda:
            assert fa_ops.LAUNCHES > before
    assert out["cpu"] == out[str(cuda)]



@pytest.mark.torch_cuda
def test_moe_forward_cuda_is_deterministic(cuda):
    """granite-moe SMOKE (float32, kernels on, capacity factor 1 so
    assignments drop) run twice on the card gives the same logits and aux
    loss bit for bit: the dispatch's only repeated scatter index is the
    sentinel, and the combine sums each token's k results in a fixed
    order; and it agrees with the CPU's forward."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.params import map_tree

    cfg = configs.get_config("granite-moe-1b-a400m", smoke=True).with_(
        use_kernels=True, capacity_factor=1.0)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        2, cfg.vocab_size, (4, 96)).astype(np.int32))
    want, aux_want = M.forward(params, {"tokens": toks}, cfg)
    params = map_tree(lambda t: t.to(cuda), params)
    before = fa_ops.LAUNCHES
    runs = [M.forward(params, {"tokens": toks.to(cuda)}, cfg)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES == before + 2 * cfg.num_layers
    (a, aux_a), (b, aux_b) = runs
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    torch.testing.assert_close(a.cpu(), want, atol=2e-3, rtol=1e-3)
    torch.testing.assert_close(aux_a.cpu(), aux_want, atol=1e-5, rtol=1e-5)


def _ep_run(ffn, x, cfg, shape, grad=False):
    """moe_ffn under a ("data", "model") mesh context of ``shape``:
    (y, aux[, the gradients of sum(y * y) in x and the weights])."""
    from repro_torch.core.listrank import sim_mesh
    from repro_torch.models import layers as L
    from repro_torch.runtime import context
    leaves = [x] + [v for v in ffn.values() if not isinstance(v, dict)]
    if grad:
        leaves = [t.detach().requires_grad_() for t in leaves]
        x, ffn = leaves[0], dict(zip([k for k, v in ffn.items()
                                      if not isinstance(v, dict)],
                                     leaves[1:]))
    with context.use_mesh(sim_mesh(shape, ("data", "model"))):
        y, aux = L.moe_ffn(ffn, x, cfg)
    if not grad:
        return y, aux
    return y, aux, torch.autograd.grad((y.float() ** 2).sum(), leaves)


@pytest.mark.torch_cuda
@pytest.mark.parametrize("shape", [(1, 1), (4, 1), (2, 2)])
def test_moe_ep_cuda_is_deterministic(cuda, shape):
    """granite-moe SMOKE's expert-parallel layer (float32, capacity factor
    1 so assignments drop) run twice on the card: the same output, aux
    and gradients bit for bit (every scatter writes each slot once, the
    sentinel aside, and the routes are permutations), and the CPU's
    within float32 tolerance."""
    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get_config("granite-moe-1b-a400m", smoke=True).with_(
        capacity_factor=1.0)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ffn = {k: v[0] for k, v in params["layers"]["ffn"].items()}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 32, cfg.d_model)).astype(np.float32))
    y_cpu, aux_cpu, g_cpu = _ep_run(ffn, x, cfg, shape, grad=True)
    ffn_c = {k: v.to(cuda) for k, v in ffn.items()}
    runs = [_ep_run(ffn_c, x.to(cuda), cfg, shape, grad=True)
            for _ in range(2)]
    torch.cuda.synchronize()
    (a, aux_a, g_a), (b, aux_b, g_b) = runs
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert all(torch.equal(u, v) for u, v in zip(g_a, g_b))
    torch.testing.assert_close(a.cpu(), y_cpu, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux_a.cpu(), aux_cpu, atol=1e-6, rtol=1e-6)
    for u, v in zip(g_a, g_cpu):
        torch.testing.assert_close(u.cpu(), v, atol=2e-5, rtol=1e-4)


@pytest.mark.torch_cuda
def test_moe_ep_full_width_bf16_layer_cuda(cuda):
    """One granite-moe-1b MoE layer at full width in bfloat16 (8 x 1024
    tokens, a capacity factor at which no expert drops) under a (2, 2)
    mesh, which splits d_ff over the tensor axis: within bfloat16's
    tolerance of the dense dispatch, and no mailbox_pack launch (the
    reference's pallas_pack is off on this path)."""
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models.params import init_params

    cfg = configs.get_config("granite-moe-1b-a400m")
    gen = torch.Generator(cuda).manual_seed(0)
    ffn = init_params(gen, L.moe_specs(cfg))
    x = torch.randn((8, 1024, cfg.d_model), generator=gen,
                    device=cuda).to(cfg.dtype)
    probs = torch.softmax(x.reshape(-1, cfg.d_model).float()
                          @ ffn["router"], dim=-1)
    top = int(torch.bincount(L._top_k(probs, cfg.top_k)[1].reshape(-1),
                             minlength=cfg.num_experts).max())
    cfg = cfg.with_(capacity_factor=(top + 1.5) * cfg.num_experts
                    / (x.shape[0] * x.shape[1] * cfg.top_k))
    want, _ = L._moe_ffn_dense(ffn, x, cfg)
    before = mp_ops.LAUNCHES
    y, aux = _ep_run(ffn, x, cfg, (2, 2))
    torch.cuda.synchronize()
    assert mp_ops.LAUNCHES == before
    assert y.dtype == torch.bfloat16 and torch.isfinite(aux)
    torch.testing.assert_close(y.float(), want.float(), atol=2e-2, rtol=2e-2)
