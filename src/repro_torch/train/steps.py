"""Training step functions, as the JAX package's ``repro.train.steps``.

``train_step`` is one optimizer step: forward, next-token cross-entropy
with z-loss (plus the MoE aux loss, for the models that have one),
backward, global-norm clipping and AdamW; with ``microbatches > 1`` the
gradients of equal slices of the batch are averaged first. Gradients
come from ``torch.autograd.grad`` over the parameter leaves, which are
made leaf tensors that require grad for the call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as M
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import adamw, schedule as sched


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 10_000
    z_loss: float = 1e-4
    microbatches: int = 1  # gradient accumulation factor


def next_token_loss(logits, labels, cfg: M.ModelConfig, z_weight=1e-4):
    """Shifted cross-entropy. labels: (B, L_total) aligned with logits;
    positions with label < 0 are masked (prefix/padding)."""
    logits = logits[:, :-1]
    targets = labels[:, 1:]
    mask = targets >= 0
    tclip = torch.clamp(targets, min=0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, tclip[..., None])[..., 0]
    nll = (lse - ll) * mask
    z = torch.square(lse) * mask
    denom = torch.clamp(mask.sum(), min=1)
    return nll.sum() / denom + z_weight * z.sum() / denom


def loss_fn(params, batch, cfg: M.ModelConfig, tcfg: TrainConfig):
    logits, aux = M.forward(params, batch, cfg)
    loss = next_token_loss(logits, batch["labels"], cfg, tcfg.z_loss)
    if cfg.moe:
        loss = loss + cfg.aux_loss_weight * aux
    return loss, {"aux_loss": aux}


def value_and_grad(params, batch, cfg: M.ModelConfig, tcfg: TrainConfig):
    """((loss, extras), grads): ``loss_fn`` and its gradient in every
    parameter (zeros for a parameter the batch does not reach)."""
    with torch.enable_grad():
        p_req = map_tree(lambda p: p.detach().requires_grad_(), params)
        loss, extras = loss_fn(p_req, batch, cfg, tcfg)
        flat = torch.autograd.grad(loss, leaves(p_req), allow_unused=True,
                                   materialize_grads=True)
    it = iter(flat)
    grads = map_tree(lambda _: next(it), params)
    extras = {k: v.detach() for k, v in extras.items()}
    return (loss.detach(), extras), grads


def _split_microbatches(batch, n):
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
             for k, v in batch.items()} for i in range(n)]


def train_step(params, opt_state, batch, cfg: M.ModelConfig,
               tcfg: TrainConfig):
    """One optimizer step (with grad accumulation when microbatches>1).
    Returns (params, opt_state, metrics); the inputs are not modified."""
    if tcfg.microbatches > 1:
        grads = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=torch.float32,
                           device=leaves(params)[0].device)
        for mb in _split_microbatches(batch, tcfg.microbatches):
            (l_mb, _), g_mb = value_and_grad(params, mb, cfg, tcfg)
            grads = map_tree(torch.add, grads, g_mb)
            loss = loss + l_mb
        grads = map_tree(lambda g: g / tcfg.microbatches, grads)
        loss = loss / tcfg.microbatches
        extras = {}
    else:
        (loss, extras), grads = value_and_grad(params, batch, cfg, tcfg)

    lr_scale = {
        "cosine": sched.cosine_warmup,
        "rsqrt": sched.rsqrt,
        "constant": sched.constant,
    }[tcfg.schedule](opt_state["step"] + 1,  # step counter is 0-based
                     warmup_steps=tcfg.warmup_steps,
                     total_steps=tcfg.total_steps)
    params, opt_state, om = adamw.update(grads, opt_state, params,
                                         tcfg.optimizer, lr_scale)
    metrics = {"loss": loss, **om, **extras}
    return params, opt_state, metrics


def eval_step(params, batch, cfg: M.ModelConfig, tcfg: TrainConfig):
    with torch.no_grad():
        loss, extras = loss_fn(params, batch, cfg, tcfg)
    return {"loss": loss, **extras}
