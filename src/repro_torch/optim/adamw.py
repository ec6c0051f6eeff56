"""AdamW over the port's parameter trees, computing the JAX package's
update (``repro.optim.adamw``) in its state tree: ``step``, the moments
``m`` and ``v`` (float32, bfloat16, or int8 blockwise quantized:
``runtime.compression.QInt8``, requantized after every update), and an
fp32 ``master`` copy when ``master_weights`` is set. Global-norm
clipping, bias correction and decoupled weight decay on every leaf.

Plain functions, not ``torch.optim.AdamW``: the update and the state
layout are the reference's. :func:`state_shardings` gives the state's
ZeRO-1 layout on a mesh (specs as data, ``runtime.sharding``), which the
shape-only dry run prices per device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.params import is_spec, leaves, map_tree
from repro_torch.runtime import sharding as shlib
from repro_torch.runtime.compression import QInt8

_STATE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    #: moments dtype: float32 | bfloat16 | int8 (blockwise quantized)
    state_dtype: str = "float32"
    #: keep an fp32 master copy when params are low-precision
    master_weights: bool = True


def _zeros_moment(p, cfg: AdamWConfig):
    if cfg.state_dtype == "int8":
        return QInt8.zeros(p.shape, device=p.device)
    if cfg.state_dtype not in _STATE_DTYPES:
        raise ValueError(f"unknown state_dtype {cfg.state_dtype!r}")
    return torch.zeros(p.shape, dtype=_STATE_DTYPES[cfg.state_dtype],
                       device=p.device)


def _load(x):
    return x.dequantize() if isinstance(x, QInt8) else x.float()


def _store(x, like):
    if isinstance(like, QInt8):
        return QInt8.quantize(x)
    return x.to(like.dtype)


def init(params, cfg: AdamWConfig):
    device = leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": map_tree(lambda p: _zeros_moment(p, cfg), params),
        "v": map_tree(lambda p: _zeros_moment(p, cfg), params),
    }
    if cfg.master_weights:
        state["master"] = map_tree(
            lambda p: p.detach().float() if p.dtype != torch.float32
            else p.detach(), params)
    return state


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    stepf = step.float()
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    lr = cfg.lr * lr_scale
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)

    def upd(g, m, v, p, master):
        g = g.float() * clip
        mf = _load(m) * cfg.b1 + (1 - cfg.b1) * g
        vf = _load(v) * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = mf / bc1
        vhat = vf / bc2
        base = master if master is not None else p.float()
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + cfg.weight_decay * base)
        return (new.to(p.dtype), _store(mf, m), _store(vf, v),
                new if master is not None else None)

    masters = state.get("master")
    if masters is None:
        masters = map_tree(lambda _: None, params)
    with torch.no_grad():
        outs = map_tree(upd, grads, state["m"], state["v"], params, masters)
    new_state = {"step": step, "m": _pick(outs, 1), "v": _pick(outs, 2)}
    if "master" in state:
        new_state["master"] = _pick(outs, 3)
    metrics = {"grad_norm": gnorm, "lr": torch.as_tensor(
        lr, dtype=torch.float32, device=gnorm.device)}
    return _pick(outs, 0), new_state, metrics


def _pick(tree, i):
    """Element ``i`` of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# state layout (ZeRO-1)
# ---------------------------------------------------------------------------


def state_shardings(param_specs_tree, mesh, cfg: AdamWConfig, rules=None,
                    zero1: bool = True):
    """Specs for the optimizer state tree (``step``, ``m``, ``v``, and
    ``master`` with ``master_weights``), as the reference's.

    Moments and master copies take the parameter's resolved spec; with
    ``zero1`` the first replicated dimension that divides (and is at
    least as large) is also sharded over ``("pod", "data")``, else over
    ``("data",)``, whichever the mesh has and the spec does not use yet.
    """
    def one(s):
        parts = list(shlib.resolve_spec(s.shape, s.axes, mesh, rules))
        if zero1:
            used = shlib.spec_axes(parts)
            for axes_try in (("pod", "data"), ("data",)):
                cand = tuple(a for a in axes_try
                             if a in mesh.axis_names and a not in used)
                if not cand:
                    continue
                size = 1
                for a in cand:
                    size *= mesh.shape[a]
                free = [i for i, pt in enumerate(parts) if pt is None
                        and s.shape[i] % size == 0 and s.shape[i] >= size]
                if free:
                    parts[free[0]] = cand if len(cand) > 1 else cand[0]
                    break
        return tuple(parts)

    moment = map_tree(lambda s: one(s) if is_spec(s) else s,
                      param_specs_tree)
    out = {"step": (), "m": moment, "v": moment}
    if cfg.master_weights:
        out["master"] = moment
    return out
