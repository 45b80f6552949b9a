"""Plain PyTorch versions of the SSD kernels: the scan's naive sequential
recurrence, one step per position, and the one-token decode update."""
from __future__ import annotations

import torch


def ssd_ref_sequential(x, dt, a, bmat, cmat, init_state=None):
    """x (B, L, H, P); dt (B, L, H); a (H,); bmat/cmat (B, L, N), or
    (B, L, G, N) in G groups (head h reads group h // (H / G)); the scan
    starts from ``init_state`` (B, H, P, N), or from 0 where it is None.
    Returns (y (B, L, H, P) in x's dtype, state (B, H, P, N) fp32)."""
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf, af = bmat.float(), cmat.float(), a.float()
    if bmat.dim() == 4:              # each head's group's B and C
        idx = torch.arange(h, device=x.device) // (h // bmat.shape[2])
        bf, cf = bf[:, :, idx], cf[:, :, idx]
    else:
        bf, cf = bf[:, :, None].expand(b, l, h, n), \
            cf[:, :, None].expand(b, l, h, n)
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    for t in range(l):
        dt_t = dtf[:, t]                                       # (B, H)
        upd = (dt_t[:, :, None] * xf[:, t])[..., None] \
            * bf[:, t, :, None, :]                             # (B, H, P, N)
        state = state * torch.exp(dt_t * af)[..., None, None] + upd
        ys[:, t] = torch.einsum("bhn,bhpn->bhp", cf[:, t], state)
    return ys.to(x.dtype), state


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token state update. x_t (B, H, P); dt_t (B, H); B/C_t (B, N),
    or (B, G, N) by group. Returns (y (B, H, P), new_state (B, H, P, N)),
    both fp32."""
    dt_t = dt_t.float()
    dA = torch.exp(dt_t * A.float())                         # (B, H)
    if B_t.dim() == 2:
        upd = (dt_t[:, :, None] * x_t.float())[..., None] \
            * B_t.float()[:, None, None, :]
        new_state = state.float() * dA[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", C_t.float(), new_state)
        return y, new_state
    # grouped: the heads as (G, H / G), each group's heads on its B and C
    b, h, p = x_t.shape
    g, n = B_t.shape[1:]
    upd = (dt_t[:, :, None] * x_t.float()).view(b, g, h // g, p)[..., None] \
        * B_t.float()[:, :, None, None, :]
    new_state = state.float().view(b, g, h // g, p, n) \
        * dA.view(b, g, h // g)[..., None, None] + upd
    y = torch.einsum("bgn,bgrpn->bgrp", C_t.float(), new_state)
    return y.reshape(b, h, p), new_state.view(b, h, p, n)
