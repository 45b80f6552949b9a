"""Plain PyTorch version of the SSD kernel: the naive sequential
recurrence, one step per position."""
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
