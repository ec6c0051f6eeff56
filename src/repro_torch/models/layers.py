"""Model building blocks of the dense decoder, the Mamba-2 stack and the
Hymba hybrid, in PyTorch.

Every block has a ``*_specs(cfg)`` (ParamSpec tree) and an apply function
on plain tensors, as in the JAX package. Attention goes to the
``flash_attention`` kernel when ``cfg.use_kernels`` and to its plain
version otherwise; the Mamba-2 mixer without a cache goes to the
``ssd_scan`` kernel when ``cfg.use_kernels`` and to ``ssd_chunked_ref``
otherwise. Both kernels are differentiable (backward through their plain
versions). With a cache the mixer serves as the JAX package's does: the
prefill through ``ssd_chunked_ref(return_state=True)``, the decode through
the plain ``ssd_decode_step``. The MoE and cross-attention blocks are
later slices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.params import spec

# ---------------------------------------------------------------------------
# norms / rope / embedding
# ---------------------------------------------------------------------------


def rms_norm_spec(d):
    return {"scale": spec((d,), ("embed",), init="ones")}


def rms_norm(p, x, eps):
    """Normalise in float32, cast back, then scale in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"].to(x.dtype)


def rope(x, positions, theta):
    """x: (..., L, H, D) rotary over last dim; positions: (..., L)."""
    d = x.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=x.device), exps)
    ang = positions[..., None].float() * freq  # (..., L, half)
    ang = ang[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_specs(cfg):
    return {"embedding": spec((cfg.padded_vocab, cfg.d_model),
                              ("vocab", "embed"), cfg.dtype, "small_normal")}


def embed(p, tokens, cfg):
    x = p["embedding"][tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def unembed(p, x, cfg):
    """Logits in float32 (the product in x's dtype, as the JAX einsum),
    soft-capped by ``cfg.final_softcap``."""
    logits = (x @ p["embedding"].T).float()
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Hkv, S, Dh); the model stacks layers in front
    v: torch.Tensor


def attention_specs(cfg):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": spec((d, hq * dh), ("embed", "qkv_features"), cfg.dtype),
        "wk": spec((d, hkv * dh), ("embed", "kv_features"), cfg.dtype),
        "wv": spec((d, hkv * dh), ("embed", "kv_features"), cfg.dtype),
        "wo": spec((hq * dh, d), ("qkv_features", "embed"), cfg.dtype),
    }
    if cfg.qkv_bias:
        s["bq"] = spec((hq * dh,), ("qkv_features",), cfg.dtype, "zeros")
        s["bk"] = spec((hkv * dh,), ("kv_features",), cfg.dtype, "zeros")
        s["bv"] = spec((hkv * dh,), ("kv_features",), cfg.dtype, "zeros")
    return s


def _project_qkv(p, x, cfg):
    b, l, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, l, hq, dh), k.reshape(b, l, hkv, dh),
            v.reshape(b, l, hkv, dh))


def _sdpa(q, k, v, cfg, *, causal, window, q_offset):
    """q: (B, Lq, Hq, D); k/v: (B, Hkv, Lk, D) -> (B, Lq, Hq, D)."""
    qh = q.transpose(1, 2).contiguous()
    scale = cfg.attn_scale if cfg.attn_scale else cfg.resolved_head_dim ** -0.5
    attend = fa_ops.flash_attention if cfg.use_kernels else fa_ref.attention_ref
    out = attend(qh, k, v, causal=causal, window=window,
                 softcap=cfg.attn_softcap, scale=scale, q_offset=q_offset)
    return out.transpose(1, 2)


def attention(p, x, cfg, *, positions, causal=True, is_local=None,
              cache: KVCache | None = None, cache_pos=None):
    """Self-attention with an optional KV cache.

    ``is_local``: this layer's sliding-window flag (a Python bool).
    ``cache``: this layer's (B, Hkv, S, Dh) cache, updated IN PLACE (the
    JAX package returns a new one; writing in place saves a copy of the
    cache per step) and returned. ``cache_pos``: an int, where the new
    keys are appended for every row, or a (B,) tensor of per-slot
    positions (continuous-batching decode, one new token per row).
    Attention then runs over the whole cache length, with the query
    offset ``cache_pos``: per-slot offsets go to the kernel as they are.
    """
    b, lq, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    q_offset = 0
    if cache is not None:
        kh, vh = k.transpose(1, 2), v.transpose(1, 2)
        if isinstance(cache_pos, torch.Tensor):
            rows = torch.arange(b, device=x.device)
            cache.k[rows, :, cache_pos] = kh[:, :, 0]
            cache.v[rows, :, cache_pos] = vh[:, :, 0]
        else:
            # lax.dynamic_update_slice clamps the start so the block fits
            start = min(max(int(cache_pos), 0), cache.k.shape[2] - lq)
            cache.k[:, :, start:start + lq] = kh
            cache.v[:, :, start:start + lq] = vh
        k, v = cache.k, cache.v
        q_offset = cache_pos
    else:
        k = k.transpose(1, 2).contiguous()
        v = v.transpose(1, 2).contiguous()

    if is_local is None or cfg.local_window is None:
        window = cfg.local_window if cfg.layer_pattern == "local_only" else None
    else:
        window = cfg.local_window if is_local else None
    out = _sdpa(q, k, v, cfg, causal=causal, window=window, q_offset=q_offset)
    return out.reshape(b, lq, -1) @ p["wo"], cache


# ---------------------------------------------------------------------------
# feed-forward: dense SwiGLU
# ---------------------------------------------------------------------------


def swiglu_specs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": spec((d, f), ("embed", "mlp"), cfg.dtype),
        "w_up": spec((d, f), ("embed", "mlp"), cfg.dtype),
        "w_down": spec((f, d), ("mlp", "embed"), cfg.dtype),
    }


def swiglu(p, x):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mamba-2 mixer
# ---------------------------------------------------------------------------


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, conv_dim), the model dtype
    state: torch.Tensor  # (B, H, N, P) float32; the model stacks layers


def _mamba_dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def mamba_specs(cfg):
    d = cfg.d_model
    d_inner, h, conv_dim = _mamba_dims(cfg)
    g, n = cfg.ssm_groups, cfg.ssm_state
    proj_out = 2 * d_inner + 2 * g * n + h
    return {
        "in_proj": spec((d, proj_out), ("embed", "mlp"), cfg.dtype),
        "conv_w": spec((cfg.ssm_conv, conv_dim), ("conv", "mlp"), cfg.dtype),
        "conv_b": spec((conv_dim,), ("mlp",), cfg.dtype, "zeros"),
        "a_log": spec((h,), ("ssm_heads",), torch.float32, "zeros"),
        "dt_bias": spec((h,), ("ssm_heads",), torch.float32, "zeros"),
        "d_skip": spec((h,), ("ssm_heads",), torch.float32, "ones"),
        "norm": rms_norm_spec(d_inner),
        "out_proj": spec((d_inner, d), ("mlp", "embed"), cfg.dtype),
    }


def _causal_conv(x, w, b, cache=None):
    """x: (B, L, C) depthwise causal conv, kernel (K, C), after the K - 1
    inputs in ``cache`` (zeros without one). Returns (out, x_pad): the
    inputs with their K - 1 predecessors in front."""
    k = w.shape[0]
    x_pad = F.pad(x, (0, 0, k - 1, 0)) if cache is None else \
        torch.cat([cache, x], dim=1)
    out = sum(x_pad[:, i:i + x.shape[1]] * w[i] for i in range(k)) + b
    return out, x_pad


def mamba_mixer(p, x, cfg, *, cache: SSMCache | None = None,
                valid_len: int | None = None):
    """Mamba-2 block body. x: (B, L, D) -> ((B, L, D), cache).

    Without a cache, the full-sequence forward: the ``ssd_scan`` kernel when
    ``cfg.use_kernels``, ``ssd_chunked_ref`` otherwise. With this layer's
    cache, as the JAX package: one token (L = 1) advances the state through
    ``ssd_decode_step``; a prefill (L > 1) convolves after ``cache.conv``
    and scans from a zero state through ``ssd_chunked_ref`` with
    ``return_state``, whatever ``cache.state`` holds. Both update the cache
    IN PLACE and return it (the JAX package returns a new one), as
    :func:`attention` does with its KV cache.

    ``valid_len`` (prefill only): the inputs from that position on are
    padding. Their dt is 0, so exp(dt A) = 1 and the update is 0: the
    state stops at ``valid_len``; the conv cache takes the K - 1 inputs
    that end there. Without it every position is valid, as in the JAX
    package.
    """
    b, l, d = x.shape
    d_inner, h, conv_dim = _mamba_dims(cfg)
    g, n, pdim = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, h], dim=-1)
    xbc, x_pad = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                              None if cache is None else cache.conv)
    xbc = F.silu(xbc)
    xin, bmat, cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    # the kernel takes contiguous (Bt, L, H, P) / (Bt, L, G, N) arrays
    xh = xin.reshape(b, l, h, pdim).contiguous()
    bh = bmat.reshape(b, l, g, n).contiguous()
    ch = cmat.reshape(b, l, g, n).contiguous()
    if cache is not None and l == 1:
        y, state = ssd_ops.ssd_decode_step(xh[:, 0], dt[:, 0], a, bh[:, 0],
                                           ch[:, 0], p["d_skip"], cache.state)
        y = y[:, None]
        cache.conv.copy_(x_pad[:, 1:])
        cache.state.copy_(state)
    elif cache is not None:
        end = l if valid_len is None else valid_len
        if end < l:
            dt = torch.where(torch.arange(l, device=x.device)[:, None] < end,
                             dt, 0.0)
        y, state = ssd_ref.ssd_chunked_ref(xh, dt, a, bh, ch, p["d_skip"],
                                           chunk=cfg.ssm_chunk,
                                           return_state=True)
        # the conv cache holds the last K-1 *pre-conv* inputs
        cache.conv.copy_(x_pad[:, end:end + cfg.ssm_conv - 1])
        cache.state.copy_(state)
    elif cfg.use_kernels:
        y = ssd_ops.ssd_scan(xh, dt, a, bh, ch, p["d_skip"], cfg.ssm_chunk)
    else:
        y = ssd_ref.ssd_chunked_ref(xh, dt, a, bh, ch, p["d_skip"],
                                    chunk=cfg.ssm_chunk)
    y = y.reshape(b, l, d_inner)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"], cache


def init_ssm_cache(cfg, batch, dtype, device):
    """A zero SSM cache: the conv tail in ``dtype``, the state in float32.
    ``batch``: the leading dims, an int or a tuple (the model stacks its
    layers in front: ``(n_layers, B)``)."""
    _, h, conv_dim = _mamba_dims(cfg)
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    return SSMCache(
        conv=torch.zeros(lead + (cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device),
        state=torch.zeros(lead + (h, cfg.ssm_state, cfg.ssm_head_dim),
                          dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Hymba mixer: parallel attention + SSM heads (arXiv:2411.13676)
# ---------------------------------------------------------------------------


def hymba_specs(cfg):
    return {
        "attn": attention_specs(cfg),
        "mamba": mamba_specs(cfg),
        "norm_attn": rms_norm_spec(cfg.d_model),
        "norm_ssm": rms_norm_spec(cfg.d_model),
    }


def hymba_mixer(p, x, cfg, *, positions, is_local=None, cache=None,
                cache_pos=None, valid_len: int | None = None):
    """Parallel attention and SSM heads, each output normalised, then
    averaged (the paper's beta-weighted mean with beta = 1). ``cache``: this
    layer's (KVCache, SSMCache), both updated in place, or None."""
    kv, ssm = cache if cache is not None else (None, None)
    attn_out, kv = attention(p["attn"], x, cfg, positions=positions,
                             is_local=is_local, cache=kv, cache_pos=cache_pos)
    ssm_out, ssm = mamba_mixer(p["mamba"], x, cfg, cache=ssm,
                               valid_len=valid_len)
    out = 0.5 * (rms_norm(p["norm_attn"], attn_out, cfg.norm_eps)
                 + rms_norm(p["norm_ssm"], ssm_out, cfg.norm_eps))
    return out, None if cache is None else (kv, ssm)
