"""Kernel inputs shared by the port's CPU and card tests (numpy and the
port only — no jax, so the card's tests can import it)."""
import numpy as np
import torch

from repro_torch.core.listrank import exchange, instances, local


def chains(b, m, seed, gamma=0.3):
    """(b, m) local-chase input as local contraction builds it: local
    chains of a List(n, gamma) instance, stops as weight-0 self-loops."""
    succ, rank = instances.gen_list(b * m, gamma=gamma, seed=seed,
                                    num_lists=3)
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 7, b * m).astype(np.int32)
    w[succ == np.arange(b * m)] = 0
    base = torch.arange(b, dtype=torch.int32) * m
    succ_l, dist0, steps, _ = local.chase_input(
        torch.from_numpy(succ).reshape(b, m), torch.from_numpy(w).reshape(b, m),
        base, m)
    return succ_l.numpy(), dist0.numpy(), steps


def float_dist(dist, seed):
    """Random float32 weights on the same links (0 at stops)."""
    rng = np.random.default_rng(seed)
    out = rng.normal(scale=3.0, size=dist.shape).astype(np.float32)
    out[dist == 0] = 0.0
    return out


def pack_inputs(p, q, n_rows, seed, dtype):
    """W=5 word-planes (one holding float32 bit patterns) and per-PE
    slots: distinct cells for shipping messages, some out of range."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-2 ** 31, 2 ** 31 - 1, (p, q), dtype=np.int64)
            .astype(np.int32) for _ in range(4)]
    if dtype == "float32":
        cols[2] = rng.normal(size=(p, q)).astype(np.float32).view(np.int32)
    cols.append(rng.integers(0, 2, (p, q)).astype(np.int32))  # valid word
    slots = np.stack([rng.permutation(n_rows + q)[:q] for _ in range(p)])
    slots[:, ::7] = n_rows + 3  # non-shipping rows (several per PE)
    return cols, slots.astype(np.int32)


def chase_edge_case(kind, b=3, m=96, seed=0):
    """(succ, dist, steps) local-chase inputs at the edges of exactness:

    - ``"neg_zero"``: float32 weights, -0.0 on a third of the links and
      of the stops (adding +0.0 would turn -0.0 into +0.0);
    - ``"self_loop"``: stops carry nonzero int32 weights, so they double
      every step and the state never stops changing;
    - ``"wrap"``: int32 weights from 2^29 to 2^31, so the sums wrap.
    """
    succ, dist, steps = chains(b, m, seed=seed)
    rng = np.random.default_rng(seed)
    stop = succ == np.arange(m, dtype=np.int32)
    if kind == "neg_zero":
        out = float_dist(dist, seed)
        out[rng.random(out.shape) < 1 / 3] = -0.0
        return succ, out, steps
    if kind == "self_loop":
        out = dist.copy()
        out[stop] = rng.integers(1, 9, int(stop.sum())).astype(np.int32)
        return succ, out, steps
    if kind == "wrap":
        out = rng.integers(2 ** 29, 2 ** 31 - 1, dist.shape).astype(np.int32)
        out[stop] = 0
        return succ, out, steps
    raise ValueError(kind)


def bucket_hop(p, q, n_buckets, cap, seed, n_payload=4):
    """One routing hop's ``mailbox_pack`` input from the port's own bucket
    sort (``exchange._bucket_indices``): ``n_payload`` (p, q) int32
    payload planes (one holding float32 bit patterns), skewed bucket keys
    (low buckets over-full, bucket ``n_buckets - 2`` empty), 30 % invalid
    messages and, with p > 1, one PE with none valid. Returns
    (cols, valid, order, skey, slots): ``slots`` the input-aligned cells
    the exchange scatters to without the kernel."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(-2 ** 31, 2 ** 31 - 1, (p, q), dtype=np.int64)
            .astype(np.int32) for _ in range(n_payload)]
    if n_payload > 1:
        cols[1] = rng.normal(size=(p, q)).astype(np.float32).view(np.int32)
    dest = np.minimum(rng.geometric(0.3, (p, q)) - 1, n_buckets - 1)
    if n_buckets > 2:
        dest[dest == n_buckets - 2] = 0
    valid = rng.random((p, q)) < 0.7
    if p > 1:
        valid[-1] = False
    dest_t, valid_t = torch.from_numpy(dest.astype(np.int32)), \
        torch.from_numpy(valid)
    order, row, col, _, _, skey = exchange._bucket_indices(
        dest_t, valid_t, n_buckets, cap)
    slots = exchange.unpermute(order, row * cap + col)
    return ([torch.from_numpy(c) for c in cols], valid_t, order, skey,
            slots)


#: ``mailbox_pack`` hops (p, q, n_buckets, cap): over-full and empty
#: buckets, an all-invalid PE, cap 1, a cap of several tiles, no messages
PACK_HOPS = [
    (4, 200, 8, 16),
    (3, 500, 4, 37),
    (2, 64, 16, 1),
    (2, 5000, 3, 1500),
    (1, 50, 5, 64),
    (2, 0, 4, 8),
]


#: the flash-attention sweep of tests/test_kernels.py (b, hq, hkv, lq, lk,
#: d, kwargs), copied here so the card's tests need no jax
ATTN_CASES = [
    (2, 4, 4, 128, 128, 64, {}),
    (1, 8, 2, 256, 256, 32, {}),
    (1, 4, 4, 200, 200, 32, {"window": 64}),
    (1, 4, 2, 128, 128, 32, {"softcap": 50.0}),
    (1, 4, 4, 96, 160, 32, {"causal": False}),
    (2, 8, 2, 1, 384, 64, {"q_offset": 383}),
    (2, 8, 4, 160, 224, 32, {"window": 96, "softcap": 30.0, "scale": 0.1}),
]

#: cross-attention shapes (seamless-m4t's decoder over its encoder), which
#: the sweep above (pinned equal to tests/test_kernels.py's) lacks:
#: non-causal with Lq < Lk and Lq > Lk (a target prefill over source
#: frames), and one query over a key count that is not a multiple of the
#: split-K decode's 64-key tile
CROSS_ATTN_CASES = [
    (2, 4, 4, 48, 200, 64, {"causal": False}),
    (1, 8, 8, 200, 72, 64, {"causal": False}),
    (3, 4, 4, 1, 1000, 64, {"causal": False}),
    (2, 16, 16, 1, 130, 64, {"causal": False}),
]

#: gemma2-2b's attention heads: Hq, Hkv, D, scale, soft-cap (causal; the
#: local layers keep the last 4096 keys)
GEMMA2_HEADS = (8, 4, 256, 256 ** -0.5, 50.0)
GEMMA2_WINDOW = 4096
#: flash-attention at gemma2-2b's heads, as its full-width serving path
#: calls it over an 8192-key slot (name, b, lq, lk, per-slot offsets,
#: window): global and local prefills at Lq = Lk, a 1024-token prefill
#: bucket, and split-K decodes at offsets about the window's edge
GEMMA2_ATTN_CASES = [
    ("prefill_global", 1, 8192, 8192, (0,), None),
    ("prefill_local", 1, 8192, 8192, (0,), GEMMA2_WINDOW),
    ("prefill_bucket", 1, 1024, 8192, (0,), None),
    ("decode_global", 5, 1, 8192, (100, 4095, 4096, 4097, 8191), None),
    ("decode_local", 5, 1, 8192, (100, 4095, 4096, 4097, 8191),
     GEMMA2_WINDOW),
]

#: the head-dim-128 decoders' attention heads, by config: Hq, Hkv (GQA
#: groups 5, 3 and 4), D, scale, soft-cap (causal, no window)
D128_HEADS = {"qwen2.5-14b": (40, 8, 128, 128 ** -0.5, None),
              "phi4-mini-3.8b": (24, 8, 128, 128 ** -0.5, None),
              "pixtral-12b": (32, 8, 128, 128 ** -0.5, None)}
#: flash-attention at those heads, as their full-width serving path calls
#: it over an 8192-key slot (the cases' fields as ``GEMMA2_ATTN_CASES``'):
#: a causal prefill at Lq = Lk = 4096, a 1024-token prefill bucket, and a
#: split-K decode of 5 slots at offsets from the first key to the last
D128_ATTN_CASES = [
    ("prefill", 1, 4096, 4096, (0,), None),
    ("prefill_bucket", 1, 1024, 8192, (0,), None),
    ("decode", 5, 1, 8192, (0, 1, 4095, 6000, 8191), None),
]
#: kimi-k2's attention heads, in ``D128_HEADS``' form: Hq 64, Hkv 8 (GQA
#: group 8), D 112 (causal, no window); its cases are ``D128_ATTN_CASES``
K2_HEADS = (64, 8, 112, 112 ** -0.5, None)

#: the repo's flash-attention tolerances (tests/test_kernels.py)
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def attn_inputs(b, hq, hkv, lq, lk, d, seed, dtype=torch.float32):
    """Normal q (b, hq, lq, d) and k, v (b, hkv, lk, d) in ``dtype``."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((b, hq, lq, d), (b, hkv, lk, d),
                                      (b, hkv, lk, d)))


#: the SSD-scan sweep of tests/test_kernels.py (bt, l, h, g, n, p, chunk),
#: copied here so the card's tests need no jax
SSD_CASES = [
    (2, 256, 4, 4, 16, 32, 64),
    (1, 128, 8, 2, 32, 16, 32),
    (1, 64, 2, 1, 8, 8, 64),
    (1, 96, 4, 2, 16, 16, 32),
]

#: the repo's SSD-scan tolerance (tests/test_kernels.py)
SSD_TOL = dict(atol=1e-5, rtol=1e-4)


def ssd_inputs(bt, l, h, g, n, p, seed, dtype=torch.float32):
    """x, dt, A, B, C, D drawn as tests/test_kernels.py draws them: x, B, C
    in ``dtype``; dt, A, D float32 (dt in [0.001, 0.1], A in [-2, -0.5])."""
    rng = np.random.default_rng(seed)
    f = lambda a, dt=dtype: torch.from_numpy(  # noqa: E731
        np.asarray(a, np.float32)).to(dt)
    x = f(rng.normal(size=(bt, l, h, p)) * 0.5)
    dt = f(rng.uniform(0.001, 0.1, size=(bt, l, h)), torch.float32)
    A = f(-rng.uniform(0.5, 2.0, size=(h,)), torch.float32)
    B = f(rng.normal(size=(bt, l, g, n)) * 0.5)
    C = f(rng.normal(size=(bt, l, g, n)) * 0.5)
    D = f(rng.normal(size=(h,)), torch.float32)
    return x, dt, A, B, C, D


#: ragged (L % chunk != 0) and grouped (G < H) SSD shapes (bt, l, h, g, n,
#: p, chunk): two full chunks and a tail, G = 1 < H, mamba2-130m's widths,
#: and one chunk of 130 steps (a ragged 16-row slab)
SSD_RAGGED = [
    (1, 300, 4, 2, 16, 32, 128),
    (2, 100, 8, 1, 32, 16, 64),
    (1, 1000, 24, 1, 128, 64, 256),
    (1, 130, 6, 3, 64, 48, 130),
]


def ssd_training_inputs(bt, l, h, g, n, p, seed, dtype=torch.float32):
    """The training regime: x, B, C, D as :func:`ssd_inputs`, but dt =
    softplus(N(0, 1)) and A = -1, as at mamba2-130m's init, so a chunk of
    256 steps sums its log-decay to about -200, far past float32's exp
    underflow at -88."""
    x, _, _, B, C, D = ssd_inputs(bt, l, h, g, n, p, seed, dtype)
    rng = np.random.default_rng(seed + 1)
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.normal(size=(bt, l, h)).astype(np.float32)))
    return x, dt, -torch.ones(h), B, C, D
