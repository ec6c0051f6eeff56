"""kimi-k2's attention and routing geometry against the JAX package, on
the CPU in float32 (atol 1e-4): its SMOKE model with the full config's
heads and experts (``KIMI_GEOMETRY``: 16 query heads over 2 kv heads, GQA
group 8 as in the full model's 64 over 8, head dim 112, 384 experts, top-8,
the shared expert kept) through forward, prefill and decode logits and the
serving engine's greedy tokens against
``repro.serve.engine.ServingEngine``'s. At a tick's two tokens the
dispatch gives each of the 384 experts its minimum capacity of 8 rows,
as the full model's does at 8 slots.

The reference runs in child processes (``_torch_reference_child.py``,
jobs ``d128_logits`` and ``d128_engine``); the port takes its parameters
over with ``models.params.from_reference``. Also: the card's inputs at
kimi's heads (``K2_HEADS``) are the full config's, and
``params.init_params``, which scales each draw in place, gives every
SMOKE model the bits of the out-of-place ``(randn * scale).to(dtype)`` it
replaced, in bf16 and f32; and the library call that
``tools/profile_lm_kernels.py`` times beside the kernel at kimi's heads
computes the kernel's function.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from _torch_kernel_inputs import (ATTN_TOL, D128_ATTN_CASES, K2_HEADS,
                                  attn_inputs)
from _torch_reference_child import run_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import configs
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.models import model as M
from repro_torch.models.params import (ParamSpec, from_reference,
                                       init_params, leaves, map_tree, spec)
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

KIMI = "kimi-k2-1t-a32b"
#: the full config's attention and routing geometry on the SMOKE model
KIMI_GEOMETRY = dict(n_heads=16, n_kv_heads=2, head_dim=112, num_experts=384,
                     top_k=8)
ATOL = 1e-4
#: (B, L) tokens of the logits checks: forward over L, prefill of L / 2
TOKS = (2, 24)
#: the cache of the logits checks, the decode steps after the prefill
CACHE, STEPS = 32, 4
#: the engine's settings and prompt lengths (tests/test_torch_serve.py's)
ENGINE = dict(slots=2, max_seq=256, max_new_tokens=6)
LENGTHS = (72, 3, 150, 129, 21)
RNG = np.random.default_rng(28)


def _cfg(**kw):
    return configs.get_config(KIMI, smoke=True).with_(
        use_kernels=True, **KIMI_GEOMETRY, **kw)


@pytest.fixture(scope="module")
def inputs():
    vocab = _cfg().vocab_size
    return {"toks": RNG.integers(0, vocab, TOKS).astype(np.int32),
            "prompts": [RNG.integers(2, vocab, n).astype(np.int32)
                        for n in LENGTHS]}


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    jobs = {
        "engine": ("d128_engine", (KIMI, inputs["prompts"], ENGINE, None,
                                   None, None, KIMI_GEOMETRY)),
        "logits": ("d128_logits", (KIMI, 3, inputs["toks"], CACHE, STEPS,
                                   None, KIMI_GEOMETRY)),
    }
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), procs=2)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-5)


def test_forward_prefill_decode_match_jax(ref, inputs):
    """Forward logits over 24 tokens, a prefill of 12 into a 32-position
    cache and 4 decode steps: logits and cache, the MoE on every layer."""
    cfg = _cfg()
    assert cfg.moe and cfg.num_shared_experts == 1
    assert cfg.n_heads // cfg.n_kv_heads == 8
    params = from_reference(ref["logits"]["params"], cfg, "cpu")
    assert params["layers"]["ffn"]["w_up"].shape[1] == 384
    toks = inputs["toks"]
    logits, aux = M.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert logits.shape == toks.shape + (cfg.padded_vocab,)
    assert float(aux) > 0
    _close(logits, ref["logits"]["forward"])
    half = toks.shape[1] // 2
    cache = M.init_cache(cfg, toks.shape[0], CACHE, device="cpu")
    lg, cache = M.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :half])}, cfg, cache)
    got = [lg]
    for i in range(STEPS):
        lg, cache = M.decode_step(params, torch.from_numpy(
            toks[:, half + i:half + i + 1]), half + i, cfg, cache)
        got.append(lg)
    _close(torch.cat(got, dim=1), ref["logits"]["plain"]["logits"])
    for a, c in zip(cache, ref["logits"]["plain"]["cache"]):
        _close(a, c, atol=1e-5)


def test_engine_matches_jax_engine(ref, inputs):
    """Two slots, five requests of 3..150 tokens (prefill buckets 128 and
    256): the same greedy tokens."""
    cfg = _cfg()
    params = from_reference(ref["engine"]["params"], cfg, "cpu")
    eng = ServingEngine(params, cfg, ServeConfig(**ENGINE), device="cpu")
    for uid, prompt in enumerate(inputs["prompts"]):
        eng.submit(Request(uid=uid, prompt=prompt))
    got = eng.run_to_completion()
    assert got == ref["engine"]["out"]
    assert all(1 <= len(v) <= ENGINE["max_new_tokens"] for v in got.values())


def test_k2_heads_are_the_configs():
    """The card's inputs at kimi's heads (``_torch_kernel_inputs``) and the
    SMOKE geometry above are the full config's: Hq 64 over Hkv 8, D 112,
    the default scale, no soft-cap, no window; 384 experts, top-8."""
    cfg = configs.get_config(KIMI)
    hq, hkv, d, scale, cap = K2_HEADS
    assert (hq, hkv, d) == (cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim) == (64, 8, 112)
    assert cfg.attn_scale is None and scale == d ** -0.5
    assert cap is None and cfg.attn_softcap is None
    assert cfg.local_window is None
    smoke = _cfg()
    assert smoke.n_heads // smoke.n_kv_heads == hq // hkv
    assert smoke.resolved_head_dim == d
    assert (smoke.num_experts, smoke.top_k, smoke.num_shared_experts) == (
        cfg.num_experts, cfg.top_k, cfg.num_shared_experts)


def _old_init(generator, spec_tree):
    """``init_params`` as it was: the scale applied out of place, a second
    float32 tensor, before the cast."""
    device = generator.device

    def draw(s):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.scale if s.scale is not None else fan_in ** -0.5
        if s.init == "small_normal":
            scale = s.scale if s.scale is not None else 0.02
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(s.dtype)

    return map_tree(draw, spec_tree)


def _bits(t):
    """A tensor's bytes, for a bit-for-bit comparison."""
    return t.contiguous().view(torch.uint8)


def _same_bits(spec_tree, seed):
    new = init_params(torch.Generator().manual_seed(seed), spec_tree)
    old = _old_init(torch.Generator().manual_seed(seed), spec_tree)
    pairs = list(zip(leaves(spec_tree), leaves(new), leaves(old)))
    for s, a, b in pairs:
        assert a.dtype == b.dtype == s.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    return {s.init for s, _, _ in pairs}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("arch", configs.list_archs())
def test_init_params_bits_are_the_old_formulas(arch, dtype):
    """Every SMOKE model's parameters in ``dtype`` (a mamba model keeps its
    float32 leaves) are bit for bit what ``(randn * scale).to(dtype)``
    drew, leaf by leaf in the same order from the same generator."""
    cfg = configs.get_config(arch, smoke=True).with_(dtype=dtype)
    kinds = _same_bits(M.param_specs(cfg), seed=5)
    assert "normal" in kinds and "ones" in kinds


def test_init_params_every_init_kind_keeps_its_bits():
    """Every init kind, an explicit scale, and the SMOKE models between
    them cover each kind but the explicit scale."""
    tree = {"a": spec((6, 5), ("embed", "mlp"), torch.bfloat16),
            "b": spec((7,), ("embed",), torch.bfloat16, "zeros"),
            "c": spec((3, 4), ("embed", "mlp"), torch.float32, "ones"),
            "d": spec((9, 2), ("vocab", "embed"), torch.bfloat16,
                      "small_normal"),
            "e": spec((4, 8), ("embed", "mlp"), torch.float32, "normal",
                      scale=0.37),
            "f": spec((2, 3, 4), ("experts", "embed", "mlp"), torch.bfloat16,
                      "small_normal", scale=1.5)}
    assert _same_bits(tree, seed=11) == {"normal", "zeros", "ones",
                                         "small_normal"}
    kinds = set()
    for arch in configs.list_archs():
        specs = M.param_specs(configs.get_config(arch, smoke=True))
        kinds |= {s.init for s in leaves(specs) if isinstance(s, ParamSpec)}
    assert kinds == {"normal", "zeros", "ones", "small_normal"}


@pytest.fixture(scope="module")
def tool():
    """``tools/profile_lm_kernels.py``, loaded as a module."""
    path = (pathlib.Path(__file__).resolve().parents[1] / "tools"
            / "profile_lm_kernels.py")
    spec_ = importlib.util.spec_from_file_location("profile_lm_kernels", path)
    module = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", D128_ATTN_CASES,
                         ids=[c[0] for c in D128_ATTN_CASES])
def test_sdpa_yardstick_computes_the_kernels_function(tool, case, dtype):
    """``tools/profile_lm_kernels.py`` times one SDPA call (``enable_gqa``)
    beside the kernel at ``K2_HEADS`` on ``D128_ATTN_CASES`` (phase 25
    (a)'s shapes). Run here at 1/32 of their lengths (decode offsets from
    the first key to the last), it gives the plain version's output."""
    name, b, lq, lk, offs, window = case
    hq, hkv, d, scale, cap = K2_HEADS
    lq, lk = max(1, lq // 32), lk // 32
    if b > 1:
        offs = (0, 1, 127, 187, 255)
    q, k, v = attn_inputs(b, hq, hkv, lq, lk, d, seed=lq, dtype=dtype)
    kw = dict(q_offset=offs[0] if b == 1 else torch.tensor(offs),
              window=window, softcap=cap, scale=scale)
    got = tool.sdpa_yardstick(q, k, v, **kw)()
    want = fa_ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
