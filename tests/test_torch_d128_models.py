"""The head-dim-128 decoders against the JAX package, on the CPU at SMOKE
width in float32 (atol 1e-4): phi4-mini-3.8b's and pixtral-12b's forward,
prefill and decode logits, pixtral's prefill behind patch embeddings
(``prefix_embeds`` through ``prefix_proj``) with decode steps at positions
P + T + i, and the serving engine's greedy tokens for qwen2.5-14b with
non-zero q/k/v biases and for phi4-mini against
``repro.serve.engine.ServingEngine``'s, once with a vocabulary that leaves
padded rows in phi4-mini's tied head, rows that would win the argmax if
the engine did not mask them.

The reference runs in child processes (``_torch_reference_child.py``,
jobs ``d128_logits`` and ``d128_engine``): each jits several programs.
The port takes its parameters over with ``models.params.from_reference``.
Also: the card's inputs at these heads (``D128_HEADS``) are the configs'.
"""
import numpy as np
import pytest
import torch

from _torch_kernel_inputs import D128_HEADS
from _torch_reference_child import run_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

ATOL = 1e-4
#: (B, L) tokens of the logits checks: forward over L, prefill of L / 2
TOKS = (2, 24)
#: the cache of the logits checks, the decode steps after each prefill,
#: the patch embeddings a row in front of pixtral's tokens
CACHE, STEPS, PATCHES = 32, 4, 6
#: the engine's settings and prompt lengths (tests/test_torch_serve.py's)
ENGINE = dict(slots=2, max_seq=256, max_new_tokens=6)
LENGTHS = (72, 3, 150, 129, 21)
#: phi4-mini's vocabulary cut so that its tied head keeps 12 padded rows
PADDED_VOCAB = 500
RNG = np.random.default_rng(27)


def _x(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _prompts(vocab):
    return [RNG.integers(2, vocab, n).astype(np.int32) for n in LENGTHS]


def _pad_rows(cfg, vocab):
    """Rows past ``vocab`` of the tied head: +-100 along the first
    coordinates, so that some padded row outscores every real one."""
    rows = np.zeros((cfg.padded_vocab - vocab, cfg.d_model), np.float32)
    for i in range(rows.shape[0]):
        rows[i, i // 2] = 100.0 if i % 2 == 0 else -100.0
    return rows


@pytest.fixture(scope="module")
def inputs():
    qwen = configs.get_config("qwen2.5-14b", smoke=True)
    phi4 = configs.get_config("phi4-mini-3.8b", smoke=True)
    pix = configs.get_config("pixtral-12b", smoke=True)
    shapes = {k: v.shape for k, v in
              M.param_specs(qwen)["layers"]["mixer"].items()
              if k in ("bq", "bk", "bv")}
    return {
        "toks": RNG.integers(0, 512, TOKS).astype(np.int32),
        "prefix": _x(TOKS[0], PATCHES, pix.prefix_embed_dim),
        "qwen_prompts": _prompts(qwen.vocab_size),
        "qwen_biases": {k: _x(*s, scale=0.5) for k, s in shapes.items()},
        "phi4_prompts": _prompts(phi4.vocab_size),
        "padded_prompts": _prompts(PADDED_VOCAB),
        "pad_rows": _pad_rows(phi4, PADDED_VOCAB),
    }


@pytest.fixture(scope="module")
def ref(tmp_path_factory, inputs):
    toks = inputs["toks"]
    jobs = {
        "pixtral": ("d128_logits", ("pixtral-12b", 3, toks, CACHE, STEPS,
                                    inputs["prefix"])),
        "phi4": ("d128_logits", ("phi4-mini-3.8b", 3, toks, CACHE, STEPS)),
        "qwen_engine": ("d128_engine", ("qwen2.5-14b", inputs["qwen_prompts"],
                                        ENGINE, inputs["qwen_biases"])),
        "phi4_engine": ("d128_engine", ("phi4-mini-3.8b",
                                        inputs["phi4_prompts"], ENGINE)),
        "padded_engine": ("d128_engine", (
            "phi4-mini-3.8b", inputs["padded_prompts"], ENGINE, None,
            PADDED_VOCAB, inputs["pad_rows"])),
    }
    return run_reference(jobs, tmp_path_factory.mktemp("ref"), procs=2)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=1e-5)


def _cfg(arch, **kw):
    return configs.get_config(arch, smoke=True).with_(use_kernels=True, **kw)


def _run(params, cfg, batch, start, toks):
    """The port's prefill of ``batch`` into a zero cache of ``CACHE`` and
    the decode steps fed ``toks``' next tokens from ``start``:
    (logits (B, 1 + steps, V), cache)."""
    half = toks.shape[1] // 2
    cache = M.init_cache(cfg, toks.shape[0], CACHE, device="cpu")
    lg, cache = M.prefill(params, batch, cfg, cache)
    logits = [lg]
    for i in range(STEPS):
        lg, cache = M.decode_step(params, torch.from_numpy(
            toks[:, half + i:half + i + 1]), start + i, cfg, cache)
        logits.append(lg)
    return torch.cat(logits, dim=1), cache


@pytest.mark.parametrize("arch,key", [("phi4-mini-3.8b", "phi4"),
                                      ("pixtral-12b", "pixtral")])
def test_forward_prefill_decode_match_jax(ref, inputs, arch, key):
    """phi4-mini's tied head and pixtral's untied one, GQA groups 3 and 4
    at SMOKE width: forward logits over 24 tokens, a prefill of 12 into a
    32-position cache and 4 decode steps, logits and cache."""
    cfg = _cfg(arch)
    params = from_reference(ref[key]["params"], cfg, "cpu")
    toks = inputs["toks"]
    logits, _ = M.forward(params, {"tokens": torch.from_numpy(toks)}, cfg)
    assert logits.shape == toks.shape + (cfg.padded_vocab,)
    _close(logits, ref[key]["forward"])
    half = toks.shape[1] // 2
    got, cache = _run(params, cfg, {"tokens": torch.from_numpy(
        toks[:, :half])}, half, toks)
    _close(got, ref[key]["plain"]["logits"])
    for a, c in zip(cache, ref[key]["plain"]["cache"]):
        _close(a, c, atol=1e-5)


def test_prefix_prefill_and_decode_match_jax(ref, inputs):
    """pixtral's patch embeddings (6 a row) in front of 12 tokens: the
    prefill fills positions 0..17 of the cache, and 4 decode steps go on
    at positions 18 + i, as the reference's do."""
    cfg = _cfg("pixtral-12b")
    params = from_reference(ref["pixtral"]["params"], cfg, "cpu")
    toks = inputs["toks"]
    half = toks.shape[1] // 2
    batch = {"tokens": torch.from_numpy(toks[:, :half]),
             "prefix_embeds": torch.from_numpy(inputs["prefix"])}
    got, cache = _run(params, cfg, batch, PATCHES + half, toks)
    want = ref["pixtral"]["prefix"]
    assert got.shape == (toks.shape[0], 1 + STEPS, cfg.padded_vocab)
    _close(got, want["logits"])
    for a, c in zip(cache, want["cache"]):
        _close(a, c, atol=1e-5)
    filled = cache.k.ne(0).any(dim=-1).any(dim=2).any(dim=0)
    assert filled.sum(dim=1).tolist() == [PATCHES + half + STEPS] * 2
    assert bool(filled[:, :PATCHES + half + STEPS].all())
    # the patches change what follows them
    assert not np.allclose(want["logits"][:, 0],
                           ref["pixtral"]["plain"]["logits"][:, 0], atol=1e-2)


def _engine_tokens(ref_out, cfg, prompts):
    params = from_reference(ref_out["params"], cfg, "cpu")
    eng = ServingEngine(params, cfg, ServeConfig(**ENGINE), device="cpu")
    for uid, prompt in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=prompt))
    return params, eng.run_to_completion()


@pytest.mark.parametrize("arch,key", [("qwen2.5-14b", "qwen"),
                                      ("phi4-mini-3.8b", "phi4")])
def test_engine_matches_jax_engine(ref, inputs, arch, key):
    """Two slots, five requests of 3..150 tokens: the same greedy tokens
    (qwen2.5 with its q/k/v biases non-zero)."""
    cfg = _cfg(arch)
    params, got = _engine_tokens(ref[f"{key}_engine"], cfg,
                                 inputs[f"{key}_prompts"])
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            b = params["layers"]["mixer"][name]
            assert float(b.abs().max()) > 0.1
    assert got == ref[f"{key}_engine"]["out"]
    assert all(1 <= len(v) <= ENGINE["max_new_tokens"] for v in got.values())


def test_engine_masks_the_tied_heads_padded_rows(ref, inputs):
    """phi4-mini's tied head with a 500-token vocabulary in its 512 rows,
    the 12 padded rows made to outscore every real one: unmasked, the
    head picks a padded row; both engines mask them (to -1e9) and give the
    same tokens, all in the vocabulary."""
    cfg = _cfg("phi4-mini-3.8b", vocab_size=PADDED_VOCAB)
    assert cfg.padded_vocab == 512 and cfg.tie_embeddings
    params, got = _engine_tokens(ref["padded_engine"], cfg,
                                 inputs["padded_prompts"])
    logits, _ = M.forward(params, {"tokens": torch.from_numpy(
        inputs["padded_prompts"][0][None])}, cfg)
    assert int(torch.argmax(logits[0, -1])) >= PADDED_VOCAB
    assert got == ref["padded_engine"]["out"]
    assert all(0 <= t < PADDED_VOCAB for v in got.values() for t in v)


@pytest.mark.parametrize("arch", sorted(D128_HEADS))
def test_d128_heads_are_the_configs(arch):
    """The card's inputs at these heads (``_torch_kernel_inputs``) are the
    full configs': Hq, Hkv, D, the default scale, no soft-cap, no
    window."""
    cfg = configs.get_config(arch)
    hq, hkv, d, scale, cap = D128_HEADS[arch]
    assert (hq, hkv, d) == (cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim) and d == 128
    assert cfg.attn_scale is None and scale == d ** -0.5
    assert cap is None and cfg.attn_softcap is None
    assert cfg.local_window is None
