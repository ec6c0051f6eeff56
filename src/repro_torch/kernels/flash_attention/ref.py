"""Plain PyTorch version of the ``flash_attention`` kernel: multi-head
attention with GQA, causal masking, sliding windows and logit
soft-capping, in float32. The CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and its
oracle on the card."""
from __future__ import annotations

import torch

#: masked logits; not -inf, since exp(-inf - -inf) is NaN
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  q_offset=0) -> torch.Tensor:
    """Reference attention.

    q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D) with Hq % Hkv == 0.
    ``window``: attend to the last ``window`` keys; ``softcap``:
    ``cap*tanh(s/cap)`` on the logits; ``scale`` defaults to 1/sqrt(D).
    ``q_offset``: absolute position of q[:, :, 0] — an int or a (B,)
    integer tensor (heterogeneous decode slots). Rows that attend to
    nothing give 0. Returns (B, Hq, Lq, D) in q's dtype.
    """
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qo = torch.as_tensor(q_offset, device=q.device)
    q_pos = torch.arange(lq, device=q.device)[:, None]
    if qo.dim() == 1:  # per-batch offsets -> a (B, 1, Lq, 1) position grid
        q_pos = qo.long()[:, None, None, None] + q_pos
    else:
        q_pos = int(qo) + q_pos
    k_pos = torch.arange(lk, device=q.device)
    mask = torch.ones(q_pos.shape[:-1] + (lk,), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    # rows that attend to nothing (fully masked) produce zeros
    out = torch.where(mask.any(dim=-1, keepdim=True), out, 0.0)
    return out.to(q.dtype)


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        part_len: int, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None,
                        q_offset=0) -> torch.Tensor:
    """The split-K decode's decomposition in plain torch (float32): the keys
    cut into parts of ``part_len``, each part's unnormalised (m, l, acc),
    merged by log-sum-exp over the parts with l > 0; a row with no kept key
    in any part is 0. Same arguments and result as :func:`attention_ref`.
    Not on the main path: the oracle of the decode kernel's arithmetic."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    qo = torch.as_tensor(q_offset, device=q.device)
    q_pos = torch.arange(lq, device=q.device)[:, None]
    q_pos = (qo.long()[:, None, None, None] + q_pos if qo.dim() == 1
             else int(qo) + q_pos)
    ms, ls, accs = [], [], []
    for k0 in range(0, lk, part_len):
        ks, vs = kf[:, :, k0:k0 + part_len], vf[:, :, k0:k0 + part_len]
        k_pos = torch.arange(k0, k0 + ks.shape[2], device=q.device)
        mask = torch.ones(q_pos.shape[:-1] + (ks.shape[2],), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & (q_pos - k_pos < window)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, ks) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("bhqk,bhkd->bhqd", p, vs))
    m, l, acc = (torch.stack(t) for t in (ms, ls, accs))  # parts first
    live = l > 0
    m_all = torch.where(live, m, NEG_INF).amax(dim=0)
    w = torch.where(live, torch.exp(torch.where(live, m - m_all, 0.0)), 0.0)
    den = (w * l).sum(dim=0)
    num = (w * acc).sum(dim=0)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.to(q.dtype)
