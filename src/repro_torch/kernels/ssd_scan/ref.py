"""Plain PyTorch versions of the Mamba-2 SSD scan (arXiv:2405.21060).

Sequential state-space recurrence, per head h in group g = h // (H/G):

  S_t = exp(dt[t,h] * A[h]) * S_{t-1} + dt[t,h] * B[t,g]^T x[t,h]
  y[t,h] = C[t,g] S_t + D[h] * x[t,h]

with S in R^{N x P} (state dim x head dim), A[h] < 0, dt > 0 (already
softplus-ed), in float32.

- :func:`ssd_ref` is the sequential scan: the CPU path and backward of
  :func:`repro_torch.kernels.ssd_scan.ops.ssd_scan`, and the kernel's
  oracle on the card. Its decays are at most 1, so its gradient is finite
  at any length.
- :func:`ssd_chunked_ref` is the two-level chunked form, the model's path
  without kernels. Written op for op like the JAX package's, masked
  exponentials included: its forward is finite, but its gradient is NaN
  once a masked exponent overflows (a summed log-decay past about 88).
"""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor | None = None,
            initial_state: torch.Tensor | None = None,
            return_state: bool = False):
    """x: (Bt,L,H,P); dt: (Bt,L,H); A: (H,); B/C: (Bt,L,G,N); D: (H,).

    Returns y (Bt,L,H,P) in x's dtype, and the final (Bt,H,N,P) float32
    state with ``return_state``."""
    bt, l, h, p = x.shape
    _, _, g, n = B.shape
    assert h % g == 0
    rep = h // g
    xf = x.float()
    dtf = dt.float()
    Af = A.float()
    Bf = B.float().repeat_interleave(rep, dim=2)  # (Bt,L,H,N)
    Cf = C.float().repeat_interleave(rep, dim=2)

    if initial_state is None:
        s = torch.zeros((bt, h, n, p), dtype=torch.float32, device=x.device)
    else:
        s = initial_state.float()

    ys = []
    # unbind (not indexing) per step: its backward is one stack
    for xt, dtt, bt_, ct in zip(torch.unbind(xf, 1), torch.unbind(dtf, 1),
                                torch.unbind(Bf, 1), torch.unbind(Cf, 1)):
        decay = torch.exp(dtt * Af)[..., None, None]                 # (Bt,H,1,1)
        upd = (dtt[..., None] * bt_)[..., None] * xt[..., None, :]  # (Bt,H,N,P)
        s = decay * s + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", ct, s))
    if ys:
        y = torch.stack(ys, dim=1)  # (Bt,L,H,P)
    else:
        y = xf.new_zeros((bt, 0, h, p))
    if D is not None:
        y = y + D.float()[None, None, :, None] * xf
    y = y.to(x.dtype)
    if return_state:
        return y, s
    return y


def ssd_chunked_ref(x, dt, A, B, C, D=None, chunk=256, initial_state=None,
                    return_state=False):
    """The two-level SSD: intra-chunk masked-decay products, chunk states,
    and a closed-form lower-triangular decay over chunks (dense einsums,
    no time loop). Same arguments and results as :func:`ssd_ref`, with
    ``chunk`` dividing L (after ``min(chunk, L)``)."""
    bt, l, h, p = x.shape
    _, _, g, n = B.shape
    rep = h // g
    chunk = min(chunk, l)
    assert l % chunk == 0
    nc = l // chunk
    xf = x.float().reshape(bt, nc, chunk, h, p)
    dtf = dt.float().reshape(bt, nc, chunk, h)
    Af = A.float()
    Bf = B.float().repeat_interleave(rep, dim=2).reshape(bt, nc, chunk, h, n)
    Cf = C.float().repeat_interleave(rep, dim=2).reshape(bt, nc, chunk, h, n)

    lc = torch.cumsum(dtf * Af, dim=2)                   # (bt,nc,Q,h)
    # ---- intra-chunk (masked decay kernel)
    seg = lc[:, :, :, None, :] - lc[:, :, None, :, :]    # (bt,nc,Q,Q,h)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    mask = tri[None, None, :, :, None]
    mdecay = torch.where(mask, torch.exp(seg), 0.0)
    cb = torch.einsum("bcthn,bcshn->bctsh", Cf, Bf)
    w = cb * mdecay
    dtx = dtf[..., None] * xf
    y = torch.einsum("bctsh,bcshp->bcthp", w, dtx)
    # ---- chunk states
    to_end = torch.exp(lc[:, :, -1:, :] - lc)            # (bt,nc,Q,h)
    s_chunk = torch.einsum("bcshn,bcshp->bchnp",
                           Bf * (to_end * dtf)[..., None], xf)
    # ---- inter-chunk: lower-triangular decay matrix over chunks
    dtot = lc[:, :, -1, :]                               # (bt,nc,h)
    cum = torch.cumsum(dtot, dim=1)                      # inclusive
    # decay(i -> j) = exp(sum_{m=i+1}^{j-1} dtot[m]) = exp(cj[j] - cj[i+1])
    cj = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    trij = torch.tril(torch.ones((nc, nc), dtype=torch.bool,
                                 device=x.device), diagonal=-1)
    expo = cj[:, :-1, None, :] - cj[:, None, 1:, :]
    tmat = torch.where(trij[None, :, :, None], torch.exp(expo), 0.0)
    s_before = torch.einsum("bjih,bihnp->bjhnp", tmat, s_chunk)
    if initial_state is not None:
        s0 = initial_state.float()                       # (bt,h,n,p)
        dec0 = torch.exp(cj[:, :-1])                     # decay to chunk start
        s_before = s_before + dec0[..., None, None] * s0[:, None]
    y = y + torch.exp(lc)[..., None] * torch.einsum(
        "bcthn,bchnp->bcthp", Cf, s_before)
    y = y.reshape(bt, l, h, p)
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    y = y.to(x.dtype)
    if return_state:
        s_fin = torch.exp(cum[:, -1])[..., None, None] * (
            initial_state.float() if initial_state is not None else 0.0)
        s_fin = s_fin + torch.einsum(
            "bih,bihnp->bhnp", torch.exp(cum[:, -1:, :] - cum), s_chunk)
        return y, s_fin
    return y


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back (differentiable)."""
    return t.to(torch.bfloat16).to(t.dtype)


def ssd_three_stage_ref(x, dt, A, B, C, D=None, chunk=256,
                        bf16_points=False):
    """The bf16 kernel's decomposition in plain torch: (1) each chunk's
    state contribution sum_s B_s^T (w_s x_s), w_s = dt_s exp(lc_end -
    lc_s); (2) the sequential pass S_c = exp(lc_end,c) S_{c-1} +
    contribution_c; (3) each chunk's y = exp(lc_t) C_t S_{c-1} + ((C B^T)
    . M . dt_s) x + D x, M[t,s] = exp(lc_t - lc_s) for s <= t.

    The log-decay prefix lc is summed in float64 and only differences are
    rounded to float32; exponents are taken only where s <= t (the masked
    entries exponentiate 0), so the gradient is finite at any log-decay. A
    ragged last chunk (L % chunk != 0) is zero-padded. With
    ``bf16_points`` the operands the kernel rounds to bfloat16 before their
    products are rounded here too: w . x and the state S_{c-1} to bfloat16,
    and W = (C B^T) . M . dt_s as a high and a low bfloat16 part (two
    products: rounded once, W alone takes most of the bf16 gate's 2e-2 in
    the training regime, and with dt . x rounded too the gate is missed). Same
    arguments and result as :func:`ssd_ref`; not on the main path."""
    bt, l, h, p = x.shape
    _, _, g, n = B.shape
    rep = h // g
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    rnd = _bf16 if bf16_points else (lambda t: t)

    def chunks(t):
        t = t.float()
        if pad:
            t = torch.cat([t, t.new_zeros((bt, pad) + t.shape[2:])], dim=1)
        return t.reshape((bt, nc, q) + t.shape[2:])

    xf, dtf, Bf, Cf = chunks(x), chunks(dt), chunks(B), chunks(C)
    lc = torch.cumsum((dtf * A.float()).double(), dim=2)   # (bt,nc,q,h)
    lc_end = lc[:, :, -1:]                                 # pad: dt = 0
    Bh = Bf.repeat_interleave(rep, dim=3)                  # (bt,nc,q,h,n)
    Ch = Cf.repeat_interleave(rep, dim=3)
    # (1) chunk states
    w = dtf * torch.exp((lc_end - lc).float())
    contrib = torch.einsum("bcshn,bcshp->bchnp", Bh,
                           rnd(w[..., None] * xf))
    # (2) the state entering each chunk
    decay = torch.exp(lc_end[:, :, 0]).float()             # (bt,nc,h)
    s = xf.new_zeros((bt, h, n, p))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = decay[:, c, :, None, None] * s + contrib[:, c]
    s_in = torch.stack(s_in, dim=1)                        # (bt,nc,h,n,p)
    if bf16_points:
        s_in = _bf16(s_in)
    # (3) chunk scan
    cb = torch.einsum("bctgn,bcsgn->bctsg", Cf, Bf).repeat_interleave(
        rep, dim=4)                                        # (bt,nc,t,s,h)
    seg = lc[:, :, :, None, :] - lc[:, :, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    mask = tri[None, None, :, :, None]
    m = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0).float()), 0.0)
    w = cb * m * dtf[:, :, None, :, :]                     # dt_s folded in
    if bf16_points:
        hi = _bf16(w)
        w = hi + _bf16(w - hi)
    y = torch.einsum("bctsh,bcshp->bcthp", w, xf)
    y = y + torch.exp(lc.float())[..., None] * torch.einsum(
        "bcthn,bchnp->bcthp", Ch, s_in)
    y = y.reshape(bt, nc * q, h, p)[:, :l]
    if D is not None:
        y = y + D.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)
