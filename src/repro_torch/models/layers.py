"""Model building blocks of the dense decoder, the MoE FFN, the Mamba-2
stack, the Hymba hybrid and the encoder-decoder's cross-attention, in
PyTorch.

Every block has a ``*_specs(cfg)`` (ParamSpec tree) and an apply function
on plain tensors, as in the JAX package. Attention (self and cross) goes
to the ``flash_attention`` kernel when ``cfg.use_kernels`` and to its
plain version otherwise; the Mamba-2 mixer without a cache goes to the
``ssd_scan`` kernel when ``cfg.use_kernels`` and to ``ssd_chunked_ref``
otherwise. Both kernels are differentiable (backward through their plain
versions). With a cache the mixer serves as the JAX package's does: the
prefill through ``ssd_chunked_ref(return_state=True)``, the decode through
the plain ``ssd_decode_step``. The MoE FFN is the JAX package's
single-program sort-based dispatch, or under a mesh context
(``runtime.context``) its expert-parallel dispatch over the port's
transports (no kernel in either: their sort, scatter and combine are
plain tensor code and their expert products batched matrix products).
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import NamedTuple

import math

import torch
import torch.nn.functional as F

from repro_torch.core.listrank.batched import arange, set_drop, take, unpermute
from repro_torch.core.listrank.config import IndirectionSpec
from repro_torch.core.listrank.exchange import MeshPlan, route_differentiable
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.params import spec
from repro_torch.runtime import context as runtime_context

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
    soft-capped by ``cfg.final_softcap``. Under a mesh context the
    reference also pins the logits' sharding (batch over the data axes,
    vocabulary over the tensor axis) for GSPMD; the port's mesh context
    carries no sharding, so there is nothing to pin."""
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


def attention_specs(cfg, cross: bool = False):
    """q/k/v/o projections; q/k/v biases when ``cfg.qkv_bias``, except in a
    cross-attention block (``cross``), as in the JAX package."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    s = {
        "wq": spec((d, hq * dh), ("embed", "qkv_features"), cfg.dtype),
        "wk": spec((d, hkv * dh), ("embed", "kv_features"), cfg.dtype),
        "wv": spec((d, hkv * dh), ("embed", "kv_features"), cfg.dtype),
        "wo": spec((hq * dh, d), ("qkv_features", "embed"), cfg.dtype),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = spec((hq * dh,), ("qkv_features",), cfg.dtype, "zeros")
        s["bk"] = spec((hkv * dh,), ("kv_features",), cfg.dtype, "zeros")
        s["bv"] = spec((hkv * dh,), ("kv_features",), cfg.dtype, "zeros")
    return s


def _project_qkv(p, xq, xkv, cfg):
    """Queries from ``xq`` (B, Lq, D), keys and values from ``xkv`` (B, Lk,
    D): (B, Lq, Hq, Dh), (B, Lk, Hkv, Dh), (B, Lk, Hkv, Dh)."""
    b, lq, _ = xq.shape
    lk = xkv.shape[1]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = xq @ p["wq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, lq, hq, dh), k.reshape(b, lk, hkv, dh),
            v.reshape(b, lk, hkv, dh))


def _sdpa(q, k, v, cfg, *, causal, window, q_offset):
    """q: (B, Lq, Hq, D); k/v: (B, Hkv, Lk, D) -> (B, Lq, Hq, D)."""
    qh = q.transpose(1, 2).contiguous()
    scale = cfg.attn_scale if cfg.attn_scale else cfg.resolved_head_dim ** -0.5
    attend = fa_ops.flash_attention if cfg.use_kernels else fa_ref.attention_ref
    out = attend(qh, k, v, causal=causal, window=window,
                 softcap=cfg.attn_softcap, scale=scale, q_offset=q_offset)
    return out.transpose(1, 2)


def attention(p, x, cfg, *, positions, causal=True, is_local=None,
              cache: KVCache | None = None, cache_pos=None, kv_x=None):
    """Self- or cross-attention with an optional KV cache.

    ``is_local``: this layer's sliding-window flag (a Python bool).
    ``cache``: this layer's (B, Hkv, S, Dh) cache, updated IN PLACE (the
    JAX package returns a new one; writing in place saves a copy of the
    cache per step) and returned. ``cache_pos``: an int, where the new
    keys are appended for every row, or a (B,) tensor of per-slot
    positions (continuous-batching decode, one new token per row).
    Attention then runs over the whole cache length, with the query
    offset ``cache_pos``: per-slot offsets go to the kernel as they are.
    ``kv_x``: the encoder's output (B, Ls, D) for cross-attention: keys and
    values come from it, without rope, and no cache is read or written
    (the JAX package's cross-attention recomputes them every call).
    """
    b, lq, _ = x.shape
    q, k, v = _project_qkv(p, x, x if kv_x is None else kv_x, cfg)
    if kv_x is None:  # rope only for self-attention
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
# feed-forward: dense SwiGLU and MoE
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


def moe_specs(cfg):
    """A float32 router, ``num_experts`` stacked SwiGLU experts and, with
    ``num_shared_experts``, one shared SwiGLU of their summed width."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = {
        "router": spec((d, e), ("embed", "experts"), torch.float32,
                       "small_normal"),
        "w_gate": spec((e, d, f), ("experts", "embed", "expert_mlp"),
                       cfg.dtype),
        "w_up": spec((e, d, f), ("experts", "embed", "expert_mlp"), cfg.dtype),
        "w_down": spec((e, f, d), ("experts", "expert_mlp", "embed"),
                       cfg.dtype),
    }
    if cfg.num_shared_experts:
        s["shared"] = swiglu_specs(cfg, d_ff=cfg.d_ff * cfg.num_shared_experts)
    return s


def _top_k(probs, k):
    """``jax.lax.top_k`` over the last axis: the k largest, largest first,
    the lower index first among equals (``torch.topk`` promises no order
    among equals on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x, cfg):
    """The MoE FFN dispatcher, (B, L, D) -> ((B, L, D), float32 aux loss),
    as the JAX package's: the expert-parallel :func:`moe_ffn_ep` under a
    mesh context (``runtime.context.use_mesh``) whose expert axis divides
    ``num_experts``, the single-program :func:`_moe_ffn_dense`
    otherwise (serving, single-device tests, smoke configs)."""
    ctx = runtime_context.current()
    if ctx is not None and cfg.num_experts % ctx.mesh.shape[ctx.ep_axis] == 0:
        return moe_out(lambda: moe_ffn_ep(p, x, cfg, ctx))
    return _moe_ffn_dense(p, x, cfg)


#: the remat policy's hold on the expert-parallel MoE (:class:`MoeKeep`),
#: set by :func:`moe_policy`
_MOE_KEEP: ContextVar["MoeKeep | None"] = ContextVar("repro_torch_moe_keep",
                                                     default=None)


@contextlib.contextmanager
def moe_policy(keep: "MoeKeep | None"):
    """Run the expert-parallel MoE calls inside under ``keep`` (a remat'd
    layer's :class:`MoeKeep`, the same one in its forward and its
    recompute), or under none."""
    tok = _MOE_KEEP.set(keep)
    try:
        yield
    finally:
        _MOE_KEEP.reset(tok)


def moe_out(call):
    """``call()``, the expert-parallel MoE's ``(y, aux)``, under the remat
    policy of the layer that runs it: the port's counterpart of the
    reference's ``checkpoint_name(y, "moe_out")``, which its ``save_moe``
    and ``offload_moe`` policies keep so that the backward does not re-run
    the dispatch's all_to_alls. Outside a layer with such a policy,
    ``call()``."""
    keep = _MOE_KEEP.get()
    return call() if keep is None else keep(call)


class MoeKeep:
    """What a layer remat'd under ``save_moe`` (``offload``: under
    ``offload_moe``) keeps of its expert-parallel MoE call.

    In the layer's forward the call runs with its own saved tensors kept
    (in pinned host memory when ``offload``), outside the layer's
    recompute, and its output is kept too; in the recompute the kept
    output stands in for the call, so the route runs once a step and its
    backward is the forward's own graph. The reference keeps the output
    alone, since its route passes no gradient (``ROADMAP.md``, queue 3);
    the port's route passes one, and the backward through the MoE needs
    the MoE's residuals."""

    def __init__(self, offload: bool):
        self.offload = offload
        self.kept = None

    @classmethod
    def for_policy(cls, policy: str) -> "MoeKeep | None":
        """A fresh hold for one remat'd layer under ``policy``
        (``cfg.remat_policy``); None under ``"nothing"``."""
        if policy in ("save_moe", "offload_moe"):
            return cls(offload=policy == "offload_moe")
        return None

    def __call__(self, call):
        if self.kept is not None:  # the recompute
            y, aux, grad = self.kept
            dev = aux.device
            return y.to(dev, non_blocking=True).requires_grad_(grad), aux
        hooks = (torch.autograd.graph.save_on_cpu(pin_memory=True)
                 if self.offload else
                 torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                          lambda t: t))
        with hooks:
            y, aux = call()
        out = y.detach()
        if self.offload and out.device.type == "cuda":
            out = torch.empty(out.shape, dtype=out.dtype,
                              pin_memory=True).copy_(out, non_blocking=True)
        self.kept = (out, aux.detach(), y.requires_grad)
        return y, aux


def _moe_ffn_dense(p, x, cfg):
    """The single-program MoE FFN: sort-based top-k dispatch with
    per-expert capacity, as the JAX package's ``_moe_ffn_dense``.

    The router's float32 softmax picks ``top_k`` experts a token, their
    gates renormalised. The n * k assignments are sorted by expert (a
    stable sort, so by token within an expert); an assignment at position
    ``pos >= cap`` of its expert's run is dropped, with ``cap = max(8,
    int(capacity_factor * n * k / E))``. The kept tokens are packed into an
    (E, cap, D) buffer, the experts run as batched matrix products, and
    each token sums its k gate-weighted results. The aux loss is the
    Switch load-balancing loss, ``E * sum(mean prob * assignment share)``.
    """
    b, l, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    n = b * l
    xf = x.reshape(n, d)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eidx = _top_k(probs, k)                 # (n, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    flat_e = eidx.reshape(-1)                          # (n*k,)
    order = torch.argsort(flat_e, stable=True)
    se, sgate = flat_e[order], gate_vals.reshape(-1)[order]
    stok = order // k                                  # the token of each
    # where each expert's run starts in the sorted assignments
    starts = torch.searchsorted(
        se, torch.arange(e + 1, dtype=se.dtype, device=x.device),
        right=False, out_int32=True)

    # aux loss (Switch-style load balancing). The runs' lengths are each
    # expert's exact assignment count (torch.bincount would read its input's
    # max back to the host on CUDA: a sync a layer)
    me = probs.mean(dim=0)
    ce = (starts[1:] - starts[:-1]).float() / (n * k)
    aux_loss = e * torch.sum(me * ce)

    pos = torch.arange(n * k, dtype=torch.int32, device=x.device) - starts[se]
    cap = max(8, int(cfg.capacity_factor * n * k / e)) if e > 1 else n * k
    keep = pos < cap
    row = torch.where(keep, se, e)
    col = torch.where(keep, pos, cap).long()

    # the sentinel row e / column cap takes every dropped assignment (jax's
    # mode="drop"), so it is the only index written twice (on CUDA in an
    # unspecified order), and it is sliced off
    buf = torch.zeros((e + 1, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((row, col), xf[stok])[:e, :cap]
    h = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    yb = torch.bmm(F.silu(h) * u, p["w_down"])
    # combine: each kept result weighted by its gate (a product in x's
    # dtype, as the reference's), put back in its (token, k) slot through
    # the inverse of ``order`` (a permutation: no index repeats), then
    # summed over k. The reference's scatter-add over tokens would repeat
    # every token k times, which on CUDA sums in no fixed order.
    gathered = yb[torch.clamp(row, max=e - 1), torch.clamp(col, max=cap - 1)]
    contrib = torch.where(keep[:, None],
                          gathered * sgate[:, None].to(x.dtype), 0)
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(n * k, device=x.device))
    y = contrib[inv].reshape(n, k, d).sum(dim=1)
    if cfg.num_shared_experts:
        y = y + swiglu(p["shared"], xf)
    return y.reshape(b, l, d), aux_loss


# ---------------------------------------------------------------------------
# expert-parallel MoE
# ---------------------------------------------------------------------------
#
# The reference runs this dispatch inside shard_map: tokens route to the
# expert shards over the mesh's expert axis through the list-ranking
# core's exchange.route (the paper's coalesced exchange, one collective a
# hop), the (E_loc, C, D) batched products run with d_ff sharded over the
# tensor axis, the results route back and the partial sums meet in one
# psum. Here every per-PE tensor carries the transport's PEs on a leading
# axis: all PEs of a SimMesh on one device, or a rank's PEs of a
# DistMesh.


def _pe_rows(t, mesh, axes, tr):
    """``t``, whose leading dims are the mesh axes ``axes`` in that order,
    laid out over the PEs (flattened row-major over the mesh's axes,
    replicated over the others): the rows of the transport's PEs."""
    names = tuple(mesh.axis_names)
    n, rest = len(axes), tuple(t.shape[len(axes):])
    order = sorted(range(n), key=lambda i: names.index(axes[i]))
    t = t.permute(*order, *range(n, t.dim()))
    t = t.reshape(tuple(mesh.shape[a] if a in axes else 1 for a in names)
                  + rest).expand(tuple(mesh.axis_sizes) + rest)
    t = t.reshape((-1,) + rest)
    return t[tr.first_pe:tr.first_pe + tr.p_local]


def _split(t, dim, n):
    """``t`` with dim ``dim`` cut into ``n`` blocks, the block index
    first."""
    sh = tuple(t.shape)
    return t.reshape(sh[:dim] + (n, sh[dim] // n) + sh[dim + 1:]).movedim(
        dim, 0)


def _blocks(w, ctx, tr, f_dim, experts=True):
    """A weight as its per-PE blocks, (k, ...): dim ``f_dim`` (``d_ff``)
    split over the tensor axis, if the mesh has one, and with
    ``experts`` dim 0 split over the expert axis."""
    mesh, t, axes = ctx.mesh, w, ()
    if ctx.tp_axis is not None:
        t, axes = _split(t, f_dim, mesh.shape[ctx.tp_axis]), (ctx.tp_axis,)
    if experts:
        t = _split(t, len(axes), mesh.shape[ctx.ep_axis])
        axes = (ctx.ep_axis,) + axes
    return _pe_rows(t, mesh, axes, tr)


def moe_ffn_ep(p, x, cfg, ctx):
    """The expert-parallel MoE FFN, as the JAX package's ``moe_ffn_ep``:
    its ``shard_map`` body on every PE of ``ctx.mesh`` at once. x: (B, L,
    D), the batch split over ``ctx.dp_axes`` -> ((B, L, D), float32 aux).

    Each PE takes its tokens' router softmax, top-k and renormalised
    gates; its Switch aux loss is averaged over ``dp_axes``. Its q = s * k
    assignments (the token repeated k times, gates in x's dtype) route to
    the PE of the expert's shard over the expert axis through
    ``exchange.route`` with a mailbox of ``cap_send = min(q, int(q/p_ep +
    5 sqrt(q/p_ep)) + 8)`` a peer (overflow dropped). There they are
    grouped by local expert (a stable sort, ``searchsorted`` starts),
    packed into an (E_loc, cap_e, D) buffer with ``cap_e = max(8,
    int(capacity_factor * q / E_loc))`` (overflow dropped), and run
    through the shard's experts, ``d_ff`` split over ``ctx.tp_axis``. The
    results route back to their sources, are gate-weighted into their
    (token, k) slots (each written once) and summed over k; the shared
    experts add their part, and one sum over the tensor axis joins the
    partial sums.

    The route carries bfloat16 leaves (``exchange.to_wire_word``) and
    passes gradients (``exchange.route_differentiable``), where the
    reference raises and passes none. Under a DistMesh every rank passes
    the whole x and weights and gets the whole output and the aux of
    global PE 0 (``gather_pes``); the gradients of x and the weights are
    summed over the ranks (``replicated``), so every rank holds the whole
    gradient.
    """
    mesh, ep, tp = ctx.mesh, ctx.ep_axis, ctx.tp_axis
    if ep == tp:
        raise ValueError(f"the expert and tensor axes are both {ep!r}")
    e_total, k = cfg.num_experts, cfg.top_k
    p_ep = mesh.shape[ep]
    if e_total % p_ep:
        raise ValueError(f"{e_total} experts do not split over {p_ep} PEs")
    e_loc = e_total // p_ep
    dp = tuple(ctx.dp_axes)
    dp_sizes = tuple(mesh.shape[a] for a in dp)
    p_dp = math.prod(dp_sizes)
    b, l, d = x.shape
    if b % p_dp:
        raise ValueError(f"batch {b} does not split over {p_dp} PEs")
    tr = ctx.transport(x.device)
    kp, dev = tr.p_local, x.device
    plan = MeshPlan.from_mesh(mesh, (ep,), IndirectionSpec.direct((ep,)),
                              transport=tr)
    # every rank holds x and the weights whole and works on its PEs' part
    x = tr.replicated(x)
    p = {name: ({kk: tr.replicated(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else tr.replicated(v))
         for name, v in p.items()}

    xb = _pe_rows(x.reshape(dp_sizes + (b // p_dp, l, d)), mesh, dp, tr)
    wg = _blocks(p["w_gate"], ctx, tr, 2)              # (k, E_loc, D, F_loc)
    wu = _blocks(p["w_up"], ctx, tr, 2)
    wd = _blocks(p["w_down"], ctx, tr, 1)              # (k, E_loc, F_loc, D)
    s = xb.shape[1] * l
    xf = xb.reshape(kp, s, d)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)              # (k, s, E)
    gate_vals, eidx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    q = s * k
    flat_e = eidx.reshape(kp, q).to(torch.int32)
    # aux loss over the local shard, averaged over the batch axes. The
    # counts are integer sums (exact in any order)
    counts = torch.zeros((kp, e_total), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, flat_e.long(), torch.ones_like(flat_e))
    aux = e_total * torch.sum(probs.mean(dim=1) * (counts.float() / q), -1)
    aux = plan.psum_axes(aux, dp) / p_dp

    # route each assignment to its expert's shard over the expert axis
    stride = math.prod(mesh.axis_sizes[mesh.axis_names.index(ep) + 1:])
    me_id = (tr.axis_index() // stride) % p_ep          # (k,) int32
    m_dest = q / p_ep
    cap_send = min(q, int(m_dest + 5.0 * m_dest ** 0.5) + 8)
    payload = {"x": xf.repeat_interleave(k, dim=1),
               "g": gate_vals.reshape(kp, q).to(x.dtype),
               "slot": arange(q, kp, dev),
               "src": me_id[:, None].expand(kp, q),
               "e": flat_e}
    delivered, dval = route_differentiable(
        plan, cap_send, payload, flat_e // e_loc,
        torch.ones((kp, q), dtype=torch.bool, device=dev))

    # group by local expert with per-expert capacity
    r = dval.shape[1]
    le = torch.where(dval, delivered["e"] - me_id[:, None] * e_loc, e_loc)
    sle, order = torch.sort(le, dim=1, stable=True)
    starts = torch.searchsorted(
        sle, torch.arange(e_loc + 1, dtype=sle.dtype,
                          device=dev).expand(kp, -1).contiguous(),
        out_int32=True)
    pos = arange(r, kp, dev) - take(starts, torch.clamp(sle, max=e_loc))
    cap_e = max(8, int(cfg.capacity_factor * q / e_loc))
    fits = (sle < e_loc) & (pos < cap_e)
    row = torch.where(fits, sle, e_loc).long()
    col = torch.where(fits, pos, cap_e).long()
    pe = torch.arange(kp, device=dev)[:, None].expand(kp, r)
    # the sentinel row / column takes every dropped assignment (the only
    # index written twice) and is sliced off
    xbuf = x.new_zeros((kp, e_loc + 1, cap_e + 1, d)).index_put(
        (pe, row, col), take(delivered["x"], order))[:, :e_loc, :cap_e]
    xbuf = xbuf.reshape(kp * e_loc, cap_e, d)
    h = torch.bmm(xbuf, wg.reshape((kp * e_loc,) + tuple(wg.shape[2:])))
    u = torch.bmm(xbuf, wu.reshape((kp * e_loc,) + tuple(wu.shape[2:])))
    yb = torch.bmm(F.silu(h) * u,
                   wd.reshape((kp * e_loc,) + tuple(wd.shape[2:])))
    # d_ff is split over the tensor axis, so yb holds partial sums; they
    # meet after the combine, in one sum over (tokens, D)
    yb = yb.reshape(kp, e_loc, cap_e, d)
    gathered = yb[pe, torch.clamp(row, max=e_loc - 1),
                  torch.clamp(col, max=cap_e - 1)]
    gathered = torch.where(fits[..., None], gathered, 0)
    # back in delivered order: ``order`` is a permutation
    ydel = take(gathered, unpermute(order, arange(r, kp, dev)))

    # route the results back to their source shards
    back, bval = route_differentiable(
        plan, cap_send, {"y": ydel, "slot": delivered["slot"],
                         "g": delivered["g"]}, delivered["src"], dval)
    contrib = torch.where(bval[..., None], back["y"] * back["g"][..., None],
                          0)
    # every (token, k) slot comes back at most once
    y = set_drop(x.new_zeros((kp, q, d)), torch.where(bval, back["slot"], q),
                 contrib)
    y = y.reshape(kp, s, k, d).sum(dim=2)
    if cfg.num_shared_experts:
        sh = p["shared"]
        hs = F.silu(xf @ _blocks(sh["w_gate"], ctx, tr, 1, False)) \
            * (xf @ _blocks(sh["w_up"], ctx, tr, 1, False))
        y = y + hs @ _blocks(sh["w_down"], ctx, tr, 0, False)  # partial
    if tp is not None:
        y = plan.psum_axes(y, (tp,))

    # the batch back in (B, L, D): the PEs at coordinate 0 off dp_axes
    y = tr.gather_pes(y.reshape(kp, b // p_dp, l, d))
    names = tuple(mesh.axis_names)
    grid = y.reshape(tuple(mesh.axis_sizes) + (b // p_dp, l, d))
    grid = grid[tuple(slice(None) if a in dp else 0 for a in names)]
    kept = [a for a in names if a in dp]
    grid = grid.permute(*(kept.index(a) for a in dp),
                        *range(len(dp), grid.dim()))
    # the aux of global PE 0, as y is read from the PEs that hold it: one
    # cotangent a mesh, not one a rank
    return grid.reshape(b, l, d), tr.gather_pes(aux)[0]


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
