"""The port's models against the JAX package's: each dense layer with the
same parameters carried across through numpy, then forward, prefill and
decode logits of the tinyllama, gemma2, qwen2.5, granite-moe, kimi-k2 and
seamless-m4t SMOKE configs (float32, atol 1e-4), the parameter schema of
every architecture at full size (no allocation), the configs as data, the
Mamba-2 schema and forward, and an unknown family. The Mamba-2 layers'
parity is in test_torch_train.py, the SSM serving path's (mamba2-130m,
hymba-1.5b) in test_torch_ssm_serve.py, the MoE FFN's and the encoder's
in test_torch_moe_encdec.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as LJ
from repro.models import model as MJ
from repro.models import params as PJ
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

DENSE = ["tinyllama-1.1b", "gemma2-2b", "qwen2.5-14b", "phi4-mini-3.8b",
         "pixtral-12b"]
#: the models that carry SSM state (mamba, hybrid)
SSM = ["mamba2-130m", "hymba-1.5b"]
ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got: torch.Tensor, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _pair(arch, seed=0):
    """(jax cfg, port cfg, jax params, port params) of a SMOKE config. The
    JAX side runs its jnp attention (its Pallas kernel is held to the
    port's in test_torch_flash_attention.py and test_torch_serve.py); the
    port's attention goes through the kernel's wrapper (``use_kernels``),
    whose CPU path is the plain version."""
    cfg_j = jax_configs.get_config(arch, smoke=True)
    cfg_t = configs.get_config(arch, smoke=True).with_(use_kernels=True)
    params_j = MJ.init(jax.random.PRNGKey(seed), cfg_j)
    params_t = P.from_reference(_np_tree(params_j), cfg_t, "cpu")
    return cfg_j, cfg_t, params_j, params_t


def _layer_params(specs_j, specs_t, seed):
    p_j = PJ.init_params(jax.random.PRNGKey(seed), specs_j)
    return p_j, P.load_tree(_np_tree(p_j), specs_t, "cpu")


RNG = np.random.default_rng(0)


def _x(*shape):
    return RNG.normal(size=shape).astype(np.float32)


# ------------------------------------------------------------------ layers
def test_rms_norm():
    x = _x(2, 5, 32)
    scale = 1.0 + _x(32)
    got = L.rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
                     1e-6)
    _close(got, LJ.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                            1e-6), atol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_rope(theta):
    x = _x(2, 7, 3, 16)
    pos = RNG.integers(0, 2048, (2, 7)).astype(np.int32)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, LJ.rope(jnp.asarray(x), jnp.asarray(pos), theta), atol=1e-4)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_embed_unembed(arch):
    """gemma2 scales the embeddings and soft-caps the final logits."""
    cfg_j, cfg_t, params_j, params_t = _pair(arch)
    toks = RNG.integers(0, cfg_t.vocab_size, (2, 9)).astype(np.int32)
    x_t = L.embed(params_t["embed"], torch.from_numpy(toks), cfg_t)
    x_j = LJ.embed(params_j["embed"], jnp.asarray(toks), cfg_j)
    _close(x_t, x_j, atol=1e-6)
    h = _x(2, 9, cfg_t.d_model)
    _close(L.unembed(params_t["embed"], torch.from_numpy(h), cfg_t),
           LJ.unembed(params_j["embed"], jnp.asarray(h), cfg_j))


def test_swiglu():
    cfg_j = jax_configs.get_config("tinyllama-1.1b", smoke=True)
    cfg_t = configs.get_config("tinyllama-1.1b", smoke=True)
    p_j, p_t = _layer_params(LJ.swiglu_specs(cfg_j), L.swiglu_specs(cfg_t), 3)
    x = _x(2, 6, cfg_t.d_model)
    _close(L.swiglu(p_t, torch.from_numpy(x)), LJ.swiglu(p_j, jnp.asarray(x)))


@pytest.mark.parametrize("arch,is_local", [("qwen2.5-14b", False),
                                           ("gemma2-2b", True),
                                           ("gemma2-2b", False)])
def test_attention(arch, is_local):
    """Without a cache, with a contiguous append (prefill), and one decode
    token per slot at per-slot positions."""
    cfg_j = jax_configs.get_config(arch, smoke=True)
    cfg_t = configs.get_config(arch, smoke=True).with_(use_kernels=True)
    specs_j, specs_t = LJ.attention_specs(cfg_j), L.attention_specs(cfg_t)
    p_j, p_t = _layer_params(specs_j, specs_t, 5)
    if cfg_t.qkv_bias:  # zeros at init: make the biases count
        for name in ("bq", "bk", "bv"):
            p_j[name] = jnp.asarray(_x(*p_j[name].shape))
            p_t[name] = torch.from_numpy(np.array(p_j[name]))
    b, l, s = 2, 24, 40
    x = _x(b, l, cfg_t.d_model)
    pos = np.broadcast_to(np.arange(l, dtype=np.int32), (b, l))
    # one compiled program per call: much quicker here than eager jax
    attend_j = jax.jit(lambda p, x, pos, cache, cache_pos: LJ.attention(
        p, x, cfg_j, positions=pos, is_local=jnp.asarray(is_local),
        cache=cache, cache_pos=cache_pos))

    def attend_t(x, pos, cache=None, cache_pos=None):
        return L.attention(p_t, torch.from_numpy(x), cfg_t,
                           positions=torch.from_numpy(np.array(pos)),
                           is_local=is_local, cache=cache,
                           cache_pos=cache_pos)

    out_t, none = attend_t(x, pos)
    out_j, _ = attend_j(p_j, x, pos, None, None)
    assert none is None
    _close(out_t, out_j)

    shape = (b, cfg_t.n_kv_heads, s, cfg_t.resolved_head_dim)
    c0 = [_x(*shape), _x(*shape)]
    cache_t = L.KVCache(*(torch.from_numpy(c.copy()) for c in c0))
    out_t, cache_t = attend_t(x, pos, cache_t, 0)
    out_j, cache_j = attend_j(p_j, x, pos, LJ.KVCache(*c0), 0)
    _close(out_t, out_j)
    for a, c in zip(cache_t, cache_j):
        _close(a, c, atol=1e-5)

    slot_pos = np.array([l, 7], np.int32)
    x1 = _x(b, 1, cfg_t.d_model)
    out_t, cache_t = attend_t(x1, slot_pos[:, None], cache_t,
                              torch.from_numpy(slot_pos))
    out_j, cache_j = attend_j(p_j, x1, slot_pos[:, None], cache_j, slot_pos)
    _close(out_t, out_j)
    for a, c in zip(cache_t, cache_j):
        _close(a, c, atol=1e-5)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b",
                                  "qwen2.5-14b", "granite-moe-1b-a400m",
                                  "kimi-k2-1t-a32b", "seamless-m4t-medium"])
def test_forward_prefill_decode_match_jax(arch):
    """The MoE models at their own capacity factor, so the prefill and
    forward drop assignments as the reference does; seamless with encoder
    frames, each decode step cross-attending to the encoder's output."""
    cfg_j, cfg_t, params_j, params_t = _pair(arch, seed=1)
    if cfg_t.qkv_bias:  # zeros at init: make the biases count
        for name in ("bq", "bk", "bv"):
            a = _x(*params_j["layers"]["mixer"][name].shape)
            params_j["layers"]["mixer"][name] = jnp.asarray(a)
            params_t["layers"]["mixer"][name] = torch.from_numpy(a)
    b, seq, s = 2, 24, 32
    toks = RNG.integers(0, cfg_t.vocab_size, (b, seq)).astype(np.int32)
    extra = {}
    if cfg_t.family == "encdec":
        extra["enc_embeds"] = _x(b, 20, cfg_t.prefix_embed_dim)

    def batch_t(t):
        return {"tokens": torch.from_numpy(t),
                **{k: torch.from_numpy(v) for k, v in extra.items()}}

    logits_t, aux = M.forward(params_t, batch_t(toks), cfg_t)
    logits_j, aux_j = jax.jit(lambda p, t: MJ.forward(
        p, {"tokens": t, **extra}, cfg_j))(params_j, toks)
    assert logits_t.shape == (b, seq, cfg_t.padded_vocab)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
    assert (float(aux) > 0) == cfg_t.moe
    _close(logits_t, logits_j)

    half = seq // 2
    cache_t = M.init_cache(cfg_t, b, s, device="cpu")
    lg_t, cache_t = M.prefill(params_t, batch_t(toks[:, :half]), cfg_t,
                              cache_t)
    lg_j, cache_j = jax.jit(lambda p, t, c: MJ.prefill(
        p, {"tokens": t, **extra}, cfg_j, c))(params_j, toks[:, :half],
                                              MJ.init_cache(cfg_j, b, s))
    _close(lg_t, lg_j)
    enc_t = enc_j = None
    if extra:
        enc_t = M.encode(params_t, batch_t(toks), cfg_t)
        enc_j = MJ.encode(params_j, extra, cfg_j)
    decode_j = jax.jit(lambda p, t, pos, c, e: MJ.decode_step(
        p, t, pos, cfg_j, c, enc_out=e))
    for t in range(half, half + 3):
        lg_t, cache_t = M.decode_step(params_t, torch.from_numpy(
            toks[:, t:t + 1]), t, cfg_t, cache_t, enc_out=enc_t)
        lg_j, cache_j = decode_j(params_j, toks[:, t:t + 1], t, cache_j,
                                 enc_j)
        _close(lg_t, lg_j)
    for a, c in zip(cache_t, cache_j):
        _close(a, c, atol=1e-5)


def test_use_kernels_is_the_plain_version_on_the_cpu():
    """On CPU tensors the kernel's wrapper takes the plain version, so the
    switch changes nothing there (on the card it is held to atol 2e-3 by
    chip_smoke.py)."""
    cfg = configs.get_config("gemma2-2b", smoke=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = {"tokens": torch.from_numpy(
        RNG.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32))}
    on, _ = M.forward(params, toks, cfg.with_(use_kernels=True))
    off, _ = M.forward(params, toks, cfg)
    assert torch.equal(on, off)


def test_prefix_embeds_match_jax():
    """pixtral's stubbed patch embeddings go in front of the tokens."""
    cfg_j, cfg_t, params_j, params_t = _pair("pixtral-12b", seed=2)
    toks = RNG.integers(0, cfg_t.vocab_size, (2, 10)).astype(np.int32)
    pre = _x(2, 4, cfg_t.prefix_embed_dim)
    got, _ = M.forward(params_t, {"tokens": torch.from_numpy(toks),
                                  "prefix_embeds": torch.from_numpy(pre)},
                       cfg_t)
    want, _ = MJ.forward(params_j, {"tokens": jnp.asarray(toks),
                                    "prefix_embeds": jnp.asarray(pre)}, cfg_j)
    assert got.shape == (2, 14, cfg_t.padded_vocab)
    _close(got, want)


# --------------------------------------------------- schema, configs, init
@pytest.mark.parametrize("arch", configs.list_archs())
def test_full_size_param_shapes_match_jax(arch):
    """Shapes, dtypes and structure at full size, allocating nothing."""
    cfg_t = configs.get_config(arch)
    want = MJ.abstract(jax_configs.get_config(arch))
    got = P.map_tree(lambda s: (s.shape, str(s.dtype).removeprefix("torch.")),
                     M.param_specs(cfg_t))
    assert got == jax.tree.map(lambda a: (a.shape, a.dtype.name), want)
    assert P.count_params(M.param_specs(cfg_t)) == PJ.count_params(
        MJ.param_specs(jax_configs.get_config(arch)))


@pytest.mark.parametrize("arch", configs.list_archs())
def test_configs_match_jax(arch):
    for smoke in (False, True):
        got = dataclasses.asdict(configs.get_config(arch, smoke=smoke))
        want = dataclasses.asdict(jax_configs.get_config(arch, smoke=smoke))
        assert str(got.pop("dtype")).removeprefix("torch.") == \
            jnp.dtype(want.pop("dtype")).name
        assert got == want


def test_unknown_family_raises():
    cfg = configs.get_config("tinyllama-1.1b", smoke=True).with_(
        family="retnet")
    with pytest.raises(ValueError, match="unknown family"):
        M.param_specs(cfg)
    with pytest.raises(ValueError, match="unknown family"):
        M.init_cache(cfg, 1, 8, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-130m"])
def test_mamba_param_specs_and_forward_work(arch):
    """The schema (no FFN, no norm_ffn; float32 a_log, dt_bias, d_skip in a
    bfloat16 model) and a forward of the SMOKE config in bfloat16."""
    specs = M.param_specs(configs.get_config(arch))
    block = specs["layers"]
    assert sorted(block) == ["mixer", "norm_mixer"]
    assert {k: block["mixer"][k].dtype for k in ("a_log", "dt_bias", "d_skip",
                                                 "in_proj")} == {
        "a_log": torch.float32, "dt_bias": torch.float32,
        "d_skip": torch.float32, "in_proj": torch.bfloat16}
    cfg = configs.get_config(arch, smoke=True).with_(dtype=torch.bfloat16,
                                                     use_kernels=True)
    params = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 32))
                            .astype(np.int32))
    logits, aux = M.forward(params, {"tokens": toks}, cfg)
    assert logits.shape == (2, 32, cfg.padded_vocab)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert float(aux) == 0.0


def test_from_reference_carries_the_mamba_tree():
    """A bfloat16 mamba model's float32 leaves stay float32, bit for bit."""
    cfg_j = jax_configs.get_config("mamba2-130m", smoke=True).with_(
        dtype=jnp.bfloat16)
    cfg_t = configs.get_config("mamba2-130m", smoke=True).with_(
        dtype=torch.bfloat16)
    tree = _np_tree(MJ.init(jax.random.PRNGKey(1), cfg_j))
    tree["layers"]["mixer"]["a_log"] = RNG.normal(
        size=tree["layers"]["mixer"]["a_log"].shape).astype(np.float32)
    params = P.from_reference(tree, cfg_t, "cpu")
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0], P.leaves(params)):
        assert str(got.dtype).removeprefix("torch.") == want.dtype.name, path
        bits = np.int16 if want.dtype.name == "bfloat16" else np.int32
        view = torch.int16 if bits is np.int16 else torch.int32
        assert np.array_equal(got.view(view).numpy(), want.view(bits)), path


def test_init_is_seeded_and_follows_the_schema():
    cfg = configs.get_config("gemma2-2b", smoke=True)
    a = M.init(cfg, torch.Generator().manual_seed(3), "cpu")
    b = M.init(cfg, torch.Generator().manual_seed(3), "cpu")
    c = M.init(cfg, torch.Generator().manual_seed(4), "cpu")
    specs = M.param_specs(cfg)
    for s, x, y, z in zip(P.leaves(specs), P.leaves(a), P.leaves(b),
                          P.leaves(c)):
        assert x.shape == s.shape and x.dtype == s.dtype
        assert torch.equal(x, y)
        if s.init == "ones":
            assert torch.all(x == 1)
        else:
            assert not torch.equal(x, z)
    emb = a["embed"]["embedding"]  # small_normal: std 0.02
    assert 0.015 < float(emb.std()) < 0.025


def test_from_reference_keeps_bfloat16_bits():
    cfg_j = jax_configs.get_config("tinyllama-1.1b", smoke=True).with_(
        dtype=jnp.bfloat16)
    cfg_t = configs.get_config("tinyllama-1.1b", smoke=True).with_(
        dtype=torch.bfloat16)
    tree = _np_tree(MJ.init(jax.random.PRNGKey(0), cfg_j))
    params = P.from_reference(tree, cfg_t, "cpu")
    w_j = tree["layers"]["mixer"]["wq"]
    w_t = params["layers"]["mixer"]["wq"]
    assert w_t.dtype == torch.bfloat16
    assert np.array_equal(w_t.view(torch.int16).numpy(), w_j.view(np.int16))
    bad = dict(tree, embed={})
    with pytest.raises(ValueError, match="keys"):
        P.from_reference(bad, cfg_t, "cpu")
