"""The port's ``flash_attention`` (its plain version: the CPU path of the
wrapper) against the JAX package's: the Pallas kernel in interpret mode
on the kernel sweep of ``tests/test_kernels.py``, the jnp reference with
per-slot query offsets, and the gradients in q, k and v through the
autograd.Function against ``jax.grad`` through the reference's custom
vjp. The CUDA kernel's twins of these checks are in
``test_torch_cuda.py``."""
import functools
import importlib.util
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_kernels
from _torch_kernel_inputs import (ATTN_CASES, ATTN_TOL, CROSS_ATTN_CASES,
                                  GEMMA2_ATTN_CASES, GEMMA2_HEADS,
                                  attn_inputs)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro import configs as jax_configs
from repro.kernels.flash_attention import ops as fa_ops_jax
from repro.kernels.flash_attention import ref as fa_ref_jax
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops as fa_ops, ref as fa_ref

def _jax(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), {torch.float32: jnp.float32,
                                           torch.bfloat16: jnp.bfloat16}[t.dtype])


def test_attn_cases_match_the_kernel_sweep():
    assert ATTN_CASES == test_kernels.ATTN_CASES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_plain_matches_pallas(case, dtype):
    b, hq, hkv, lq, lk, d, kw = ATTN_CASES[case]
    q, k, v = attn_inputs(b, hq, hkv, lq, lk, d, seed=case, dtype=dtype)
    out = fa_ops.flash_attention(q, k, v, **kw)
    assert out.dtype == dtype and out.shape == q.shape
    want = fa_ops_jax.flash_attention(
        _jax(q), _jax(k), _jax(v), kw.get("causal", True), kw.get("window"),
        kw.get("softcap"), kw.get("scale"), kw.get("q_offset", 0), True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(CROSS_ATTN_CASES)))
def test_plain_matches_pallas_at_cross_shapes(case, dtype):
    """The cross-attention shapes against the Pallas kernel in interpret
    mode; for one query also the split-K decomposition at the part length
    the decode kernel takes on 132 SMs (its last part runs past Lk)."""
    b, hq, hkv, lq, lk, d, kw = CROSS_ATTN_CASES[case]
    q, k, v = attn_inputs(b, hq, hkv, lq, lk, d, seed=40 + case, dtype=dtype)
    out = fa_ops.flash_attention(q, k, v, **kw)
    want = fa_ops_jax.flash_attention(
        _jax(q), _jax(k), _jax(v), False, None, None, None, 0, True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32), **ATTN_TOL[dtype])
    if lq == 1:
        part = fa_ops.decode_part_len(lk, fa_ops.decode_splits(
            b, hkv, hq // hkv, lk, 132))
        assert lk % part
        split = fa_ref.attention_split_ref(q, k, v, part_len=part, **kw)
        torch.testing.assert_close(split.float(), out.float(),
                                   **ATTN_TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(None, None), (24, 30.0)])
def test_per_slot_offsets_match_reference(window, softcap):
    """Decode with one query per slot at its own position (B,) — the
    serving engine's decode — and a short multi-query block."""
    offsets = np.array([0, 5, 63, 40], np.int32)
    for lq in (1, 3):
        q, k, v = attn_inputs(4, 8, 2, lq, 64 + lq, 16, seed=lq)
        kw = dict(window=window, softcap=softcap)
        out = fa_ops.flash_attention(q, k, v, q_offset=torch.from_numpy(
            offsets), **kw)
        want = fa_ref_jax.attention_ref(_jax(q), _jax(k), _jax(v),
                                        q_offset=jnp.asarray(offsets), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   **ATTN_TOL[torch.float32])
        # a scalar offset is the same as that offset in every slot
        same = fa_ops.flash_attention(q, k, v, q_offset=7, **kw)
        per_slot = fa_ref.attention_ref(q, k, v, q_offset=torch.full(
            (4,), 7, dtype=torch.int32), **kw)
        torch.testing.assert_close(same, per_slot, rtol=0, atol=0)


def test_fully_masked_rows_are_zero():
    q, k, v = attn_inputs(1, 2, 1, 4, 8, 16, seed=0)
    out = fa_ref.attention_ref(q, k, v, q_offset=-4)  # every key ahead
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("arch", [a for a in configs.list_archs()
                                  if configs.get_config(a).family != "mamba"])
def test_every_head_dim_has_a_kernel(arch):
    """Every config with attention has a head dim the kernel takes."""
    for smoke in (False, True):
        cfg = configs.get_config(arch, smoke=smoke)
        assert cfg.resolved_head_dim == \
            jax_configs.get_config(arch, smoke=smoke).resolved_head_dim
        assert cfg.resolved_head_dim in fa_ops.HEAD_DIMS
        assert cfg.n_heads // cfg.n_kv_heads <= fa_ops.MAX_GROUP


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def _grads_j(q, k, v, w, causal, window, softcap, q_offset):
    def f(q, k, v):
        return jnp.sum(fa_ops_jax.flash_attention(
            q, k, v, causal, window, softcap, None, q_offset, True) * w)
    return jax.grad(f, argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("hq,hkv,lq,lk,kw", [
    (4, 4, 48, 48, {}),
    (8, 2, 40, 40, {"window": 16, "softcap": 30.0}),
    (4, 2, 24, 56, {"causal": False, "softcap": 20.0}),
    (8, 4, 5, 37, {"q_offset": 32, "window": 24}),
])
def test_gradients_match_jax_custom_vjp(hq, hkv, lq, lk, kw):
    """d(sum(out * w))/d(q, k, v): the port's backward (autograd through
    the recomputed ``attention_ref``) against the reference's (``jax.vjp``
    of its ``attention_ref``), GQA, windows and softcap; float32 at the
    kernel tolerance (atol 2e-5, rtol 1e-4)."""
    q, k, v = attn_inputs(2, hq, hkv, lq, lk, 16, seed=lq + lk)
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=q.shape).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.flash_attention(*leaves, **kw)
    got = torch.autograd.grad((out * w).sum(), leaves)
    want = _grads_j(_jax(q), _jax(k), _jax(v), _jax(w), kw.get("causal", True),
                    kw.get("window"), kw.get("softcap"), kw.get("q_offset", 0))
    for name, g_t, g_j in zip("qkv", got, want):
        assert g_t.shape == g_j.shape, name
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                                   **ATTN_TOL[torch.float32], err_msg=name)


def test_offset_tensor_is_not_differentiated():
    """A (B,) q_offset tensor rides along; q, k, v get gradients."""
    q, k, v = attn_inputs(2, 4, 2, 1, 20, 16, seed=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    off = torch.tensor([3, 19], dtype=torch.int32)
    fa_ops.flash_attention(*leaves, q_offset=off).sum().backward()
    assert all(t.grad is not None for t in leaves) and off.grad is None


def test_decode_split_count():
    """The split count of a bf16 decode: at the serving shape (8 slots, 4
    kv heads, group 8, a 2048-key cache, 132 SMs) 8 splits of 4 parts of
    64 keys, 256 CTAs; everywhere parts of whole tiles that cover the keys,
    no split wholly past them, and two CTAs per SM unless that would leave
    a part less than one tile."""
    assert fa_ops.decode_splits(8, 4, 8, 2048, 132) == 8
    assert fa_ops.decode_part_len(2048, 8) == 64
    per_split = fa_ops.PARTS_PER_SPLIT * fa_ops.DECODE_TILE
    for b, hkv, group, lk, n_sm in itertools.product(
            (1, 8), (1, 4), (1, 8, 40), (1, 63, 64, 300, 2048, 5000),
            (8, 132)):
        splits = fa_ops.decode_splits(b, hkv, group, lk, n_sm)
        part = fa_ops.decode_part_len(lk, splits)
        assert splits >= 1 and part % fa_ops.DECODE_TILE == 0
        assert splits * fa_ops.PARTS_PER_SPLIT * part >= lk
        assert (splits - 1) * per_split < lk or splits == 1
        ctas = b * hkv * -(-group // 16) * splits
        assert ctas >= 2 * n_sm or splits == -(-lk // per_split)


@pytest.mark.parametrize("part_len", [64, 128])
@pytest.mark.parametrize("case", range(len(ATTN_CASES)))
def test_split_merge_matches_reference(case, part_len):
    """The split-K decomposition (attention per key part, merged by
    log-sum-exp) against ``attention_ref`` and the JAX reference on the
    kernel sweep, float32 at the kernel tolerance."""
    b, hq, hkv, lq, lk, d, kw = ATTN_CASES[case]
    q, k, v = attn_inputs(b, hq, hkv, lq, lk, d, seed=case)
    out = fa_ref.attention_split_ref(q, k, v, part_len=part_len, **kw)
    torch.testing.assert_close(out, fa_ref.attention_ref(q, k, v, **kw),
                               **ATTN_TOL[torch.float32])
    want = fa_ref_jax.attention_ref(_jax(q), _jax(k), _jax(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               **ATTN_TOL[torch.float32])


@pytest.mark.parametrize("window,softcap", [(None, None), (100, 30.0)])
def test_split_merge_per_slot_offsets(window, softcap):
    """Decode slots at offsets 0 (three of four 64-key parts empty), 1, a
    part boundary, the last key, and -1 (no kept key: exactly 0)."""
    offsets = np.array([0, 1, 64, 255, -1], np.int32)
    q, k, v = attn_inputs(5, 8, 2, 1, 256, 16, seed=3)
    kw = dict(window=window, softcap=softcap)
    out = fa_ref.attention_split_ref(q, k, v, part_len=64, q_offset=torch
                                     .from_numpy(offsets), **kw)
    want = fa_ref_jax.attention_ref(_jax(q), _jax(k), _jax(v),
                                    q_offset=jnp.asarray(offsets), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(want),
                               **ATTN_TOL[torch.float32])
    assert torch.count_nonzero(out[4]) == 0 and torch.isfinite(out).all()


def _profile_lm_kernels():
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "profile_lm_kernels.py")
    spec = importlib.util.spec_from_file_location("profile_lm_kernels", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(GEMMA2_ATTN_CASES)))
def test_flex_yardstick_computes_the_kernels_function(case, dtype):
    """``tools/profile_lm_kernels.py`` times one call of torch's
    ``flex_attention`` beside the kernel at gemma2-2b's heads
    (``chip_smoke.py`` phase 22 (a)'s shapes). Its masks
    and soft-cap, run eager here, give the plain version's output on each
    case at 1/32 of its lengths (the window 128, decode offsets about its
    edge)."""
    name, b, lq, lk, offs, window = GEMMA2_ATTN_CASES[case]
    hq, hkv, d, scale, cap = GEMMA2_HEADS
    lq, lk = max(1, lq // 32), lk // 32
    window = window and window // 32
    if b > 1:
        offs = (3, 127, 128, 129, 255)
    q, k, v = attn_inputs(b, hq, hkv, lq, lk, d, seed=case, dtype=dtype)
    kw = dict(q_offset=offs[0] if b == 1 else torch.tensor(offs),
              window=window, softcap=cap, scale=scale)
    got = _profile_lm_kernels().flex_yardstick(q, k, v, **kw)()
    want = fa_ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
