"""The model zoo in PyTorch: the dense/GQA decoder family, the
attention-free Mamba-2 stack (mamba) and the parallel attention + SSM
heads of Hymba (hybrid), each with forward, prefill and decode.

The configuration and the parameter tree are the JAX package's
(``repro.models.model``): the same ``ModelConfig`` fields and defaults,
the same nested dict of parameters with layers stacked on axis 0. Layers
run as a Python loop in place of ``lax.scan``. ``forward`` is
differentiable (the training path, ``repro_torch.train.steps``).

``remat`` and ``remat_policy`` have no effect: the port has no activation
checkpointing, and autograd keeps every layer's activations. mamba2-130m
trains at batch 8 x 1024 tokens in bf16 on one 80 GB card without it.

The serving cache is the JAX package's pytree with layers stacked in
front: a ``KVCache`` (decoder), an ``SSMCache`` (mamba), or the tuple
``(KVCache, SSMCache)`` (hybrid). Prefill and decode update it in place.
``prefill`` takes a ``valid_len`` that stops the SSM state at the end of a
right-padded prompt (the serving engine's admission); without it the
prefill is the JAX package's. The MoE FFN and the encdec family raise
``NotImplementedError``: they are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import init_params, map_tree, spec

VOCAB_PAD = 512


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "decoder"          # decoder | hybrid | mamba | encdec
    num_layers: int = 2
    num_encoder_layers: int = 0
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int | None = None
    d_ff: int = 1024
    vocab_size: int = 1024
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    attn_scale: float | None = None
    local_window: int | None = None
    layer_pattern: str = "global"    # global | local_global | sparse_global
    post_norms: bool = False         # gemma2-style post-block norms
    scale_embeddings: bool = False   # gemma2 multiplies embeds by sqrt(d)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # SSM
    ssm_state: int = 128
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # modality stub (vlm patches / audio frames)
    prefix_embed_dim: int | None = None
    # numerics / runtime
    dtype: Any = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"
    use_kernels: bool = False
    scan_layers: bool = True

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // VOCAB_PAD) * VOCAB_PAD

    @property
    def is_local_flags(self) -> tuple[bool, ...]:
        """Per-(decoder-)layer sliding-window flag."""
        n = self.num_layers
        if self.layer_pattern == "local_global":
            return tuple(i % 2 == 0 for i in range(n))
        if self.layer_pattern == "sparse_global":
            glob = {0, n // 2, n - 1}
            return tuple(i not in glob for i in range(n))
        if self.layer_pattern == "local_only":
            return tuple(True for _ in range(n))
        return tuple(False for _ in range(n))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def _require_ported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet: the encdec and MoE
    models."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encdec family (encoder, cross-attention) is a "
            "later slice of the port")
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is a later slice of the port")
    if cfg.family not in ("decoder", "hybrid", "mamba"):
        raise ValueError(f"unknown family {cfg.family!r}")


# ---------------------------------------------------------------------------
# parameter schema
# ---------------------------------------------------------------------------


def _block_specs(cfg: ModelConfig):
    if cfg.family == "mamba":  # no FFN, no norm_ffn
        return {"norm_mixer": L.rms_norm_spec(cfg.d_model),
                "mixer": L.mamba_specs(cfg)}
    mixer = L.hymba_specs(cfg) if cfg.family == "hybrid" else \
        L.attention_specs(cfg)
    s: dict[str, Any] = {"norm_mixer": L.rms_norm_spec(cfg.d_model),
                         "norm_ffn": L.rms_norm_spec(cfg.d_model),
                         "mixer": mixer, "ffn": L.swiglu_specs(cfg)}
    if cfg.post_norms:
        s["post_norm_mixer"] = L.rms_norm_spec(cfg.d_model)
        s["post_norm_ffn"] = L.rms_norm_spec(cfg.d_model)
    return s


def _stack_specs(block, n):
    return map_tree(lambda sp: spec((n,) + sp.shape, ("layers",) + sp.axes,
                                    sp.dtype, sp.init, sp.scale), block)


def param_specs(cfg: ModelConfig):
    _require_ported(cfg)
    specs: dict[str, Any] = {
        "embed": L.embed_specs(cfg),
        "final_norm": L.rms_norm_spec(cfg.d_model),
        "layers": _stack_specs(_block_specs(cfg), cfg.num_layers),
    }
    if cfg.prefix_embed_dim:
        specs["prefix_proj"] = spec((cfg.prefix_embed_dim, cfg.d_model),
                                    ("embed", "embed"), cfg.dtype)
    if not cfg.tie_embeddings:
        specs["lm_head"] = spec((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), cfg.dtype, "small_normal")
    return specs


def init(cfg: ModelConfig, generator: torch.Generator | None = None,
         device=None):
    """Random parameters from ``generator`` (default: seed 0) on
    ``device`` (CUDA unless given; raises without it)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{device}")
    return init_params(generator, param_specs(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(bp, x, cfg, *, positions, is_local, cache, cache_pos,
                 valid_len=None):
    """One transformer block. Returns (x, cache)."""
    h = L.rms_norm(bp["norm_mixer"], x, cfg.norm_eps)
    if cfg.family == "mamba":
        out, cache = L.mamba_mixer(bp["mixer"], h, cfg, cache=cache,
                                   valid_len=valid_len)
        return x + out, cache
    if cfg.family == "hybrid":
        out, cache = L.hymba_mixer(bp["mixer"], h, cfg, positions=positions,
                                   is_local=is_local, cache=cache,
                                   cache_pos=cache_pos, valid_len=valid_len)
    else:
        out, cache = L.attention(bp["mixer"], h, cfg, positions=positions,
                                 is_local=is_local, cache=cache,
                                 cache_pos=cache_pos)
    if cfg.post_norms:
        out = L.rms_norm(bp["post_norm_mixer"], out, cfg.norm_eps)
    x = x + out
    h = L.rms_norm(bp["norm_ffn"], x, cfg.norm_eps)
    out = L.swiglu(bp["ffn"], h)
    if cfg.post_norms:
        out = L.rms_norm(bp["post_norm_ffn"], out, cfg.norm_eps)
    return x + out, cache


def map_cache(fn, cache):
    """``fn`` over every tensor of a cache: a ``KVCache``, an ``SSMCache``
    or the hybrid's ``(KVCache, SSMCache)``."""
    if type(cache) is tuple:
        return tuple(map_cache(fn, c) for c in cache)
    return type(cache)(*map(fn, cache))


def _run_stack(stacked, x, cfg, *, positions, local_flags, caches,
               cache_pos, valid_len=None):
    """The layers in order over stacked params (a loop in place of the
    JAX ``lax.scan``). ``caches``: the stacked cache of :func:`init_cache`,
    updated in place layer by layer, or None."""
    for i, is_local in enumerate(local_flags):
        bp = map_tree(lambda a: a[i], stacked)
        cache = None if caches is None else map_cache(lambda a: a[i], caches)
        x, _ = _block_apply(bp, x, cfg, positions=positions,
                            is_local=is_local, cache=cache,
                            cache_pos=cache_pos, valid_len=valid_len)
    return x, caches


def _inputs_to_embeds(params, batch, cfg):
    """tokens (+ optional modality prefix embeddings) -> (x, positions)."""
    x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.prefix_embed_dim and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(cfg.dtype) @ params["prefix_proj"]
        x = torch.cat([pre, x], dim=1)
    b, l, _ = x.shape
    positions = torch.arange(l, dtype=torch.int32,
                             device=x.device)[None, :].expand(b, l)
    return x, positions


def _logits(params, x, cfg):
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"]["embedding"])
    return L.unembed({"embedding": head}, x, cfg)


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> (logits, aux_loss); aux is 0 (no MoE)."""
    _require_ported(cfg)
    x, positions = _inputs_to_embeds(params, batch, cfg)
    x, _ = _run_stack(params["layers"], x, cfg, positions=positions,
                      local_flags=cfg.is_local_flags, caches=None,
                      cache_pos=None)
    return _logits(params, x, cfg), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Stacked per-layer zero cache on ``device`` (CUDA unless given): a
    ``KVCache`` of (n_layers, B, Hkv, S, Dh) tensors, an ``SSMCache`` of
    (n_layers, B, K-1, conv_dim) in the model dtype and (n_layers, B, H, N,
    P) float32 (mamba), or both (hybrid)."""
    _require_ported(cfg)
    device = resolve_device(device)
    n = cfg.num_layers

    def kv():
        shape = (n, batch, cfg.n_kv_heads, max_seq, cfg.resolved_head_dim)
        return L.KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device))

    def ssm():
        return L.init_ssm_cache(cfg, (n, batch), cfg.dtype, device)

    if cfg.family == "mamba":
        return ssm()
    if cfg.family == "hybrid":
        return kv(), ssm()
    return kv()


def prefill(params, batch, cfg: ModelConfig, cache,
            valid_len: int | None = None):
    """Process the prompt, filling the cache in place from position 0.
    Returns (last-position logits (B, 1, V), cache). ``valid_len``: the
    prompt's positions from there on are padding, which the SSM state and
    conv cache do not take in (see ``layers.mamba_mixer``)."""
    _require_ported(cfg)
    x, positions = _inputs_to_embeds(params, batch, cfg)
    x, cache = _run_stack(params["layers"], x, cfg, positions=positions,
                          local_flags=cfg.is_local_flags, caches=cache,
                          cache_pos=0, valid_len=valid_len)
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, tokens, pos: int, cfg: ModelConfig, cache):
    """One decode step. tokens: (B, 1); pos: the position of every row.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    _require_ported(cfg)
    x = L.embed(params["embed"], tokens, cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    x, cache = _run_stack(params["layers"], x, cfg, positions=positions,
                          local_flags=cfg.is_local_flags, caches=cache,
                          cache_pos=pos)
    return _logits(params, x, cfg), cache
