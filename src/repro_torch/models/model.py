"""The model zoo in PyTorch: every family of the JAX package
(``repro.models.model``), each with forward, prefill and decode:

- decoder: the dense/GQA decoder (tinyllama, gemma2, qwen2.5, phi4-mini,
  pixtral's backbone), with the MoE FFN for granite-moe and kimi-k2;
- mamba: the attention-free Mamba-2 stack (mamba2-130m);
- hybrid: Hymba's parallel attention + SSM heads (hymba-1.5b);
- encdec: the encoder-decoder with cross-attention (seamless-m4t's
  backbone; the audio frontend is stubbed as frame embeddings,
  ``batch["enc_embeds"]``).

The configuration and the parameter tree are the JAX package's: the same
``ModelConfig`` fields and defaults, the same nested dict of parameters
with layers stacked on axis 0. Layers run as a Python loop in place of
``lax.scan``. ``forward`` is differentiable (the training path,
``repro_torch.train.steps``) and returns the MoE aux loss, summed over
the layers in float32.

``remat`` is the reference's activation checkpointing: when it is set and
autograd records the forward (training; never with a cache, nor when no
input requires grad), each layer runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, so the
backward recomputes the layer's activations from its input instead of
keeping them. ``remat_policy`` says what a layer keeps besides its
input: ``"nothing"`` (the default; any other name too, as in the
reference), ``"save_moe"`` (the expert-parallel MoE's call, whose route
then runs once a step: ``layers.MoeKeep``) or ``"offload_moe"`` (the
same, kept in pinned host memory). A policy changes what is kept, never a
value: the recompute gives the forward's bits.

The serving cache is the JAX package's pytree with layers stacked in
front: a ``KVCache`` (decoder, and the encdec decoder's self-attention),
an ``SSMCache`` (mamba), or the tuple ``(KVCache, SSMCache)`` (hybrid).
Prefill and decode update it in place. An encdec model's cross-attention
keys and values are not cached: ``decode_step(..., enc_out=)`` recomputes
them from the encoder's output every step, as the JAX package does.
``prefill`` takes a ``valid_len`` that stops the SSM state at the end of a
right-padded prompt (the serving engine's admission); without it the
prefill is the JAX package's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import (abstract_params, init_params, leaves,
                                      map_tree, spec)
from repro_torch.runtime import context as runtime_context

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


FAMILIES = ("decoder", "hybrid", "mamba", "encdec")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; the families are "
                         f"{FAMILIES}")


# ---------------------------------------------------------------------------
# parameter schema
# ---------------------------------------------------------------------------


def _block_specs(cfg: ModelConfig, cross: bool = False):
    """One layer's parameters; ``cross``: an encdec decoder layer's
    cross-attention and its norm."""
    if cfg.family == "mamba":  # no FFN, no norm_ffn
        return {"norm_mixer": L.rms_norm_spec(cfg.d_model),
                "mixer": L.mamba_specs(cfg)}
    mixer = L.hymba_specs(cfg) if cfg.family == "hybrid" else \
        L.attention_specs(cfg)
    s: dict[str, Any] = {"norm_mixer": L.rms_norm_spec(cfg.d_model),
                         "norm_ffn": L.rms_norm_spec(cfg.d_model),
                         "mixer": mixer,
                         "ffn": L.moe_specs(cfg) if cfg.moe else
                         L.swiglu_specs(cfg)}
    if cross:
        s["cross"] = L.attention_specs(cfg, cross=True)
        s["norm_cross"] = L.rms_norm_spec(cfg.d_model)
    if cfg.post_norms:
        s["post_norm_mixer"] = L.rms_norm_spec(cfg.d_model)
        s["post_norm_ffn"] = L.rms_norm_spec(cfg.d_model)
    return s


def _stack_specs(block, n):
    return map_tree(lambda sp: spec((n,) + sp.shape, ("layers",) + sp.axes,
                                    sp.dtype, sp.init, sp.scale), block)


def param_specs(cfg: ModelConfig):
    _check_family(cfg)
    specs: dict[str, Any] = {
        "embed": L.embed_specs(cfg),
        "final_norm": L.rms_norm_spec(cfg.d_model),
        "layers": _stack_specs(_block_specs(cfg, cross=cfg.family == "encdec"),
                               cfg.num_layers),
    }
    if cfg.family == "encdec":
        specs["enc_layers"] = _stack_specs(_block_specs(cfg),
                                           cfg.num_encoder_layers)
        specs["enc_final_norm"] = L.rms_norm_spec(cfg.d_model)
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


def abstract(cfg: ModelConfig, mode=None, device="cpu"):
    """The parameter tree as fake tensors under ``mode`` (see
    ``params.abstract_params``): the dry run's parameters."""
    return abstract_params(param_specs(cfg), mode, device)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_apply(bp, x, cfg, *, positions, causal, is_local, cache,
                 cache_pos, enc_out=None, valid_len=None):
    """One transformer block. Returns (x, aux): aux is the MoE FFN's aux
    loss, None without one. ``enc_out``: the encoder's output, which an
    encdec decoder layer cross-attends to."""
    aux = None
    h = L.rms_norm(bp["norm_mixer"], x, cfg.norm_eps)
    if cfg.family == "mamba":
        out, cache = L.mamba_mixer(bp["mixer"], h, cfg, cache=cache,
                                   valid_len=valid_len)
        return x + out, aux
    if cfg.family == "hybrid":
        out, cache = L.hymba_mixer(bp["mixer"], h, cfg, positions=positions,
                                   is_local=is_local, cache=cache,
                                   cache_pos=cache_pos, valid_len=valid_len)
    else:
        out, cache = L.attention(bp["mixer"], h, cfg, positions=positions,
                                 causal=causal, is_local=is_local,
                                 cache=cache, cache_pos=cache_pos)
    if cfg.post_norms:
        out = L.rms_norm(bp["post_norm_mixer"], out, cfg.norm_eps)
    x = x + out
    if enc_out is not None and "cross" in bp:
        h = L.rms_norm(bp["norm_cross"], x, cfg.norm_eps)
        out, _ = L.attention(bp["cross"], h, cfg, positions=positions,
                             causal=False, kv_x=enc_out)
        x = x + out
    h = L.rms_norm(bp["norm_ffn"], x, cfg.norm_eps)
    if cfg.moe:
        out, aux = L.moe_ffn(bp["ffn"], h, cfg)
    else:
        out = L.swiglu(bp["ffn"], h)
    if cfg.post_norms:
        out = L.rms_norm(bp["post_norm_ffn"], out, cfg.norm_eps)
    return x + out, aux


def map_cache(fn, cache):
    """``fn`` over every tensor of a cache: a ``KVCache``, an ``SSMCache``
    or the hybrid's ``(KVCache, SSMCache)``."""
    if type(cache) is tuple:
        return tuple(map_cache(fn, c) for c in cache)
    return type(cache)(*map(fn, cache))


def _remat(block, x, policy: str):
    """``block(x)`` checkpointed: its activations recomputed in the
    backward, under the mesh context of the forward, with ``policy``'s
    :class:`~repro_torch.models.layers.MoeKeep` for the expert-parallel
    MoE."""
    keep = L.MoeKeep.for_policy(policy)
    ctx = runtime_context.current()

    def run(x):
        with L.moe_policy(keep), runtime_context.entered(ctx):
            return block(x)

    # the forward draws no random numbers: no RNG state to replay
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False)


def _run_stack(stacked, x, cfg, *, positions, local_flags, caches,
               cache_pos, causal=True, enc_out=None, valid_len=None):
    """The layers in order over stacked params (a loop in place of the
    JAX ``lax.scan``), each remat'd (:func:`_remat`) when ``cfg.remat`` is
    set and autograd records the forward (grad mode on, and the input or
    a layer parameter requires grad), and there is no cache.
    ``caches``: the stacked cache of :func:`init_cache`, updated in place
    layer by layer, or None. Returns (x, aux, caches): aux the layers' MoE
    aux losses summed in float32 in layer order."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = (cfg.remat and caches is None and torch.is_grad_enabled()
             and (x.requires_grad or any(a.requires_grad
                                         for a in leaves(stacked))))
    for i, is_local in enumerate(local_flags):
        bp = map_tree(lambda a: a[i], stacked)
        cache = None if caches is None else map_cache(lambda a: a[i], caches)

        def block(x, bp=bp, is_local=is_local, cache=cache):
            return _block_apply(bp, x, cfg, positions=positions,
                                causal=causal, is_local=is_local, cache=cache,
                                cache_pos=cache_pos, enc_out=enc_out,
                                valid_len=valid_len)
        x, aux_l = _remat(block, x, cfg.remat_policy) if remat else block(x)
        if aux_l is not None:
            aux = aux + aux_l
    return x, aux, caches


def _inputs_to_embeds(params, batch, cfg):
    """tokens (+ optional modality prefix embeddings) -> (x, positions)."""
    x = L.embed(params["embed"], batch["tokens"], cfg)
    if cfg.prefix_embed_dim and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(cfg.dtype) @ params["prefix_proj"]
        x = torch.cat([pre, x], dim=1)
    b, l, _ = x.shape
    return x, _positions(b, l, x.device)


def _logits(params, x, cfg):
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    head = params.get("lm_head", params["embed"]["embedding"])
    return L.unembed({"embedding": head}, x, cfg)


def _positions(b, l, device):
    return torch.arange(l, dtype=torch.int32,
                        device=device)[None, :].expand(b, l)


def encode(params, batch, cfg: ModelConfig):
    """The encoder stack (encdec family): ``batch["enc_embeds"]`` (B, Ls,
    D_in), the stubbed modality frontend's frames, through ``prefix_proj``
    and the non-causal encoder layers, then ``enc_final_norm``."""
    enc_in = batch["enc_embeds"].to(cfg.dtype)
    if cfg.prefix_embed_dim:
        enc_in = enc_in @ params["prefix_proj"]
    b, ls, _ = enc_in.shape
    x, _, _ = _run_stack(params["enc_layers"], enc_in, cfg,
                         positions=_positions(b, ls, enc_in.device),
                         local_flags=(False,) * cfg.num_encoder_layers,
                         caches=None, cache_pos=None, causal=False)
    return L.rms_norm(params["enc_final_norm"], x, cfg.norm_eps)


def forward(params, batch, cfg: ModelConfig):
    """Full-sequence forward -> (logits, aux_loss); aux is the MoE layers'
    aux loss (0 without MoE). An encdec batch carries ``enc_embeds``."""
    enc_out = encode(params, batch, cfg) if cfg.family == "encdec" else None
    x, positions = _inputs_to_embeds(params, batch, cfg)
    x, aux, _ = _run_stack(params["layers"], x, cfg, positions=positions,
                           local_flags=cfg.is_local_flags, caches=None,
                           cache_pos=None, enc_out=enc_out)
    return _logits(params, x, cfg), aux


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None):
    """Stacked per-layer zero cache on ``device`` (CUDA unless given): a
    ``KVCache`` of (n_layers, B, Hkv, S, Dh) tensors, an ``SSMCache`` of
    (n_layers, B, K-1, conv_dim) in the model dtype and (n_layers, B, H, N,
    P) float32 (mamba), or both (hybrid). An encdec model's cache is its
    decoder's KV cache."""
    _check_family(cfg)
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


def cache_axes(cfg: ModelConfig):
    """Logical axes of the cache (mirrors :func:`init_cache`), as the JAX
    package's ``cache_axes``."""
    kv_ax = L.KVCache(k=("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
                      v=("layers", "batch", "kv_heads", "kv_seq", "head_dim"))
    ssm_ax = L.SSMCache(conv=("layers", "batch", "conv", "mlp"),
                        state=("layers", "batch", "ssm_heads", "ssm_state",
                               None))
    if cfg.family == "mamba":
        return ssm_ax
    if cfg.family == "hybrid":
        return (kv_ax, ssm_ax)
    return kv_ax


def prefill(params, batch, cfg: ModelConfig, cache,
            valid_len: int | None = None):
    """Process the prompt, filling the cache in place from position 0.
    Returns (last-position logits (B, 1, V), cache). An encdec batch
    carries ``enc_embeds``, which are encoded first (the caller encodes
    them again for ``decode_step``, as with the JAX package).
    ``valid_len``: the prompt's positions from there on are padding, which
    the SSM state and conv cache do not take in (see
    ``layers.mamba_mixer``)."""
    enc_out = encode(params, batch, cfg) if cfg.family == "encdec" else None
    x, positions = _inputs_to_embeds(params, batch, cfg)
    x, _, cache = _run_stack(params["layers"], x, cfg, positions=positions,
                             local_flags=cfg.is_local_flags, caches=cache,
                             cache_pos=0, enc_out=enc_out,
                             valid_len=valid_len)
    return _logits(params, x[:, -1:], cfg), cache


def decode_step(params, tokens, pos: int, cfg: ModelConfig, cache,
                enc_out=None):
    """One decode step. tokens: (B, 1); pos: the position of every row;
    ``enc_out``: the encoder's output (encdec). Returns (logits (B, 1, V),
    cache), the cache updated in place."""
    x = L.embed(params["embed"], tokens, cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    x, _, cache = _run_stack(params["layers"], x, cfg, positions=positions,
                             local_flags=cfg.is_local_flags, caches=cache,
                             cache_pos=pos, enc_out=enc_out)
    return _logits(params, x, cfg), cache
