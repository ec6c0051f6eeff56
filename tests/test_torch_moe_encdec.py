"""The port's MoE FFN (granite-moe-1b, kimi-k2) and encoder-decoder
(seamless-m4t-medium) against the JAX package's, at the SMOKE configs in
float32 with the reference's weights carried across by ``from_reference``:
the single-program dispatch alone with assignments dropped at capacity
factor 1, the loss, aux loss and every gradient of a train step, the
encoder, prefill and decode against the port's own forward, and the
serving engine's tokens against the JAX engine's. The forward, prefill
and decode logits of all three models against the reference's are in
test_torch_models.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as LJ
from repro.models import model as MJ
from repro.models import params as PJ
from repro.serve import engine as engine_j
from repro.train import steps as steps_j
from repro_torch import configs
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
from repro_torch.train import steps

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

MOE = ["granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
RNG = np.random.default_rng(0)
#: float32 forward parity, as tests/test_torch_models.py
ATOL = 1e-4
#: gradient parity of a train step, as tests/test_torch_train.py
GRAD_TOL = dict(atol=2e-5, rtol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _x(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@functools.lru_cache(maxsize=None)
def _params_j(arch, seed):
    """The JAX package's SMOKE parameters, drawn once a file."""
    cfg = jax_configs.get_config(arch, smoke=True)
    return jax.jit(MJ.init, static_argnums=1)(jax.random.PRNGKey(seed), cfg)


def _pair(arch, seed=0, **kw):
    """(jax cfg, port cfg, jax params, port params); the port's attention
    through the kernel's wrapper, whose CPU path is the plain version."""
    cfg_j = jax_configs.get_config(arch, smoke=True).with_(**kw)
    cfg_t = configs.get_config(arch, smoke=True).with_(use_kernels=True, **kw)
    params_j = _params_j(arch, seed)
    return cfg_j, cfg_t, params_j, P.from_reference(_np_tree(params_j),
                                                    cfg_t, "cpu")


def _batch(cfg, b=2, l=24):
    """Tokens and labels (as tests/test_models.py builds them), with an
    encdec model's encoder frames; numpy."""
    out = {"tokens": RNG.integers(0, cfg.vocab_size, (b, l)).astype(np.int32),
           "labels": RNG.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = _x(b, l, cfg.prefix_embed_dim)
    return out


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- dispatch
def _drops(probs, k, cap):
    """The reference's dropped assignments, recounted in numpy: its top-k
    (the lower index first among equals) and each expert's assignments past
    ``cap``."""
    eidx = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
    counts = np.bincount(eidx.reshape(-1), minlength=probs.shape[-1])
    return int(np.clip(counts - cap, 0, None).sum())


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_dense_drops_like_the_reference(arch):
    """At capacity factor 1 some experts overflow: the output (kept
    assignments, their gates, the shared expert) and the aux loss equal the
    reference's, so the same assignments were dropped."""
    cfg_j = jax_configs.get_config(arch, smoke=True).with_(
        capacity_factor=1.0)
    cfg_t = configs.get_config(arch, smoke=True).with_(capacity_factor=1.0)
    p_j = PJ.init_params(jax.random.PRNGKey(7), LJ.moe_specs(cfg_j))
    p_t = P.load_tree(_np_tree(p_j), L.moe_specs(cfg_t), "cpu")
    b, l, e, k = 2, 40, cfg_t.num_experts, cfg_t.top_k
    x = _x(b, l, cfg_t.d_model)
    probs = jax.nn.softmax(x.reshape(-1, cfg_t.d_model)
                           @ np.asarray(p_j["router"]), axis=-1)
    cap = max(8, int(cfg_t.capacity_factor * b * l * k / e))
    assert _drops(np.asarray(probs), k, cap) > 0
    y_t, aux_t = L.moe_ffn(p_t, torch.from_numpy(x), cfg_t)
    y_j, aux_j = jax.jit(lambda p, x: LJ._moe_ffn_dense(p, x, cfg_j))(p_j, x)
    _close(y_t, y_j, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    assert aux_t.dtype == torch.float32


# ------------------------------------------------------------ train step
@pytest.mark.parametrize("arch", MOE + ["seamless-m4t-medium"])
def test_loss_aux_and_every_gradient_match_jax(arch):
    """``value_and_grad`` of the port's loss (next-token loss plus the MoE
    aux term) against ``jax.value_and_grad(loss_fn)``: the router, every
    expert, the shared expert, the cross-attention and the encoder."""
    cfg_j, cfg_t, params_j, params_t = _pair(arch, seed=2)
    host = _batch(cfg_t)
    (loss_t, ex_t), g_t = steps.value_and_grad(params_t, _torch(host), cfg_t,
                                               steps.TrainConfig())
    (loss_j, ex_j), g_j = jax.jit(jax.value_and_grad(
        lambda p, b: steps_j.loss_fn(p, b, cfg_j, steps_j.TrainConfig()),
        has_aux=True))(params_j, host)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(float(ex_t["aux_loss"]),
                               float(ex_j["aux_loss"]), rtol=1e-5)
    assert (float(ex_t["aux_loss"]) > 0) == cfg_t.moe
    flat_t, flat_j = P.leaves(g_t), jax.tree.leaves(g_j)
    assert len(flat_t) == len(flat_j) == len(P.leaves(params_t))
    for (path, _), a, b in zip(jax.tree_util.tree_flatten_with_path(g_j)[0],
                               flat_t, flat_j):
        assert tuple(a.shape) == b.shape, path
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------- encode / decode
def test_encode_matches_jax():
    cfg_j, cfg_t, params_j, params_t = _pair("seamless-m4t-medium", seed=1)
    frames = {"enc_embeds": _x(2, 33, cfg_t.prefix_embed_dim)}
    got = M.encode(params_t, _torch(frames), cfg_t)
    want = jax.jit(lambda p, b: MJ.encode(p, b, cfg_j))(params_j, frames)
    assert got.shape == (2, 33, cfg_t.d_model)
    _close(got, want)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "seamless-m4t-medium"])
def test_prefill_decode_reproduce_forward(arch):
    """tests/test_models.py's decode consistency on the port: a prefill of
    half the tokens and a decode step for each of the rest give the
    logits of the full forward (granite-moe at capacity factor 8, which
    drops nothing; seamless cross-attending to ``encode``'s output)."""
    kw = {"capacity_factor": 8.0} if arch in MOE else {}
    _, cfg, _, params = _pair(arch, seed=1, **kw)
    b, seq = 2, 16
    batch = _torch(_batch(cfg, b, seq))
    full, _ = M.forward(params, batch, cfg)
    half = seq // 2
    cache = M.init_cache(cfg, b, seq, device="cpu")
    first = {k: v[:, :half] if k == "tokens" else v for k, v in batch.items()}
    lg, cache = M.prefill(params, first, cfg, cache)
    _close(lg[:, -1], full[:, half - 1])
    enc_out = M.encode(params, batch, cfg) if "enc_embeds" in batch else None
    for t in range(half, seq):
        lg, cache = M.decode_step(params, batch["tokens"][:, t:t + 1], t, cfg,
                                  cache, enc_out=enc_out)
        _close(lg[:, 0], full[:, t])


# ----------------------------------------------------------------- engine
def test_engine_tokens_equal_the_jax_engines():
    """One prompt and 6 greedy tokens at the default capacity factor: the
    bucketed, right-padded prefill routes its pad tokens, which take
    expert capacity, in both engines."""
    arch = "granite-moe-1b-a400m"
    cfg_j, cfg_t, params_j, params_t = _pair(arch)
    prompt = np.random.default_rng(1).integers(2, cfg_t.vocab_size,
                                               21).astype(np.int32)
    kw = dict(slots=2, max_seq=256, max_new_tokens=6, eos_id=-1)
    eng_j = engine_j.ServingEngine(params_j, cfg_j,
                                   engine_j.ServeConfig(**kw))
    eng_j.submit(engine_j.Request(uid=0, prompt=prompt))
    want = eng_j.run_to_completion()
    eng = ServingEngine(params_t, cfg_t, ServeConfig(**kw), device="cpu")
    eng.submit(Request(uid=0, prompt=prompt))
    got = eng.run_to_completion()
    assert len(got[0]) == 6
    assert got == want


def test_engine_refuses_encdec():
    cfg = configs.get_config("seamless-m4t-medium", smoke=True)
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine({}, cfg, ServeConfig(), device="cpu")


def test_serve_cli_exits_for_encdec():
    """The serving entry point reports the engine's refusal and exits, as
    the JAX package's does for the encdec family."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", "seamless-m4t-medium", "--smoke",
                    "--device", "cpu"])
