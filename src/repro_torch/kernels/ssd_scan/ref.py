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
