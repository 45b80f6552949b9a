"""Mamba2 (SSD, state-space duality) blocks, counterpart of
``repro.models.ssm``: the blocked chunked scan, the O(1) decode state
update, the depthwise causal conv and the full block.

Shapes: x (B, L, H, P); dt (B, L, H); A (H,); B/C (B, L, N) [one state
group]; state (B, H, P, N).

``mamba_block(use_kernel=True)`` runs the scan in the hand-written CUDA
kernel (``repro_torch.kernels.ssd_scan.kernel.ssd_cuda``, its plain
version for CPU tensors); ``use_kernel=False`` runs ``ssd_ref``, the
blocked plain-torch decomposition. Both continue a given ``ssd_state``.
One deliberate difference from the reference: its kernel path silently
drops a given ``ssd_state`` for L > 1 (``repro/models/ssm.py:126-129``),
while the port's kernel continues the scan from it, as the reference's
plain path does.

Under a device mesh the block's heads follow the 'q_heads' axis (the
reference's ``shard`` of ``xh``), and the scan, kernel or plain, runs on
each rank's heads inside ``shard_map`` (``_scan_heads``): a CUDA
extension cannot take a DTensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.kernel import ssd_cuda
from repro_torch.models.config import SSMConfig
from repro_torch.models.layers import rms_norm
from repro_torch.sharding import rules


def ssd_ref(x, dt, A, B, C, chunk: int = 128, init_state=None):
    """Chunked SSD in plain torch (the reference's block decomposition).
    Returns (y (B, L, H, P) fp32, final_state (B, H, P, N) fp32)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    lp = l + pad
    nc = lp // chunk
    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()
    seg = torch.cumsum(dtc * A.float(), dim=2)   # (b, nc, Q, h) inclusive

    # intra-chunk: y[i] += sum_{j<=i} (C_i.B_j) e^{seg_i - seg_j} dt_j x_j;
    # the exponent above the diagonal is -inf before the exp, so the decay
    # there is 0 and never inf: the reference selects an overflowed inf
    # away after the product, which its gradient turns into 0 * inf = NaN
    # for every input once a chunk's decay spans more than e^88
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.exp(torch.where(
        causal, seg[:, :, :, None, :] - seg[:, :, None, :, :], -torch.inf))
    M = G[..., None] * decay                                # (b,nc,i,j,h)
    y = torch.einsum("bcijh,bcjhp->bcihp", M * dtc[:, :, None], xc)
    del G, decay, M

    # chunk summary states: S_c = sum_j e^{seg_Q - seg_j} dt_j x_j B_j^T
    last = seg[:, :, -1:, :]
    w_end = torch.exp(last - seg) * dtc                     # (b, nc, Q, h)
    chunk_state = torch.einsum("bcjhp,bcjn->bchpn", xc * w_end[..., None],
                               Bc)

    # inter-chunk scan: S_c = e^{sum dA_c} S_{c-1} + chunk_state_c
    tot = torch.exp(last[:, :, 0, :])                       # (b, nc, h)
    s = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = torch.empty_like(chunk_state)
    for ci in range(nc):
        prev[:, ci] = s
        s = s * tot[:, ci, :, None, None] + chunk_state[:, ci]

    # inter-chunk contribution: y[i] += C_i . (e^{seg_i} S_prev)
    y += torch.einsum("bcin,bchpn->bcihp", Cc, prev) * torch.exp(seg)[..., None]
    return y.reshape(b, lp, h, p)[:, :l], s


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token state update. x_t (B, H, P); dt_t (B, H); B/C_t (B, N).
    Returns (y (B, H, P), new_state (B, H, P, N)), both fp32."""
    dt_t = dt_t.float()
    dA = torch.exp(dt_t * A.float())                         # (B, H)
    upd = (dt_t[:, :, None] * x_t.float())[..., None] \
        * B_t.float()[:, None, None, :]
    new_state = state.float() * dA[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", C_t.float(), new_state)
    return y, new_state


def causal_conv(x, w, cache=None):
    """Depthwise causal conv. x (B, L, C), w (W, C). Returns (y, new_cache)
    where new_cache holds the last W-1 inputs for decode."""
    width = w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([cache.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :]
            for i in range(width))
    new_cache = xp[:, -(width - 1):] if width > 1 else None
    return y.to(x.dtype), new_cache


def _conv(x, w, cache):
    """:func:`causal_conv`; under a device mesh on each rank's batch shard
    with the sequence and channels whole (DTensor has no rule for the
    conv's padding and shifted slices)."""
    ctx = rules.current_ctx()
    if not rules.is_device_mesh(ctx.mesh) or w.shape[0] == 1:
        return causal_conv(x, w, cache)
    bs = ctx.spec(("batch",), (x.shape[0],))[0]
    spec = (bs, None, None)
    return rules.shard_map(causal_conv, mesh=ctx.mesh,
                           in_specs=(spec, (None, None), spec),
                           out_specs=[spec, spec])(x, w, cache)


def _scan_heads(scan, xh, dt, A, Bv, Cv, chunk: int, init_state):
    """``scan(xh, dt, A, Bv, Cv, chunk=, init_state=)``; under a device
    mesh on each rank's local shards: x, dt, A and the states split over
    the heads as ``xh``'s spec says (and the batch over its axes), B and C
    whole over the heads."""
    ctx = rules.current_ctx()
    if not rules.is_device_mesh(ctx.mesh):
        return scan(xh, dt, A, Bv, Cv, chunk=chunk, init_state=init_state)
    bs, _, hs, _ = ctx.spec(("batch", None, "q_heads", None), xh.shape)
    state = (bs, hs, None, None)
    specs = ((bs, None, hs, None), (bs, None, hs), (hs,), (bs, None, None),
             (bs, None, None), state)
    return rules.shard_map(
        lambda x, d, a, bm, cm, s0: scan(x, d, a, bm, cm, chunk=chunk,
                                         init_state=s0),
        mesh=ctx.mesh, in_specs=specs,
        out_specs=[(bs, None, hs, None), state])(xh, dt, A, Bv, Cv,
                                                 init_state)


def mamba_block(params, x, cfg: SSMConfig, *, conv_cache=None,
                ssd_state=None, chunk=None, use_kernel=False):
    """Full Mamba2 block. x (B, L, D). Returns (out, (conv_cache,
    ssd_state fp32))."""
    b, l, d = x.shape
    di = cfg.d_inner(d)
    n = cfg.d_state
    h = cfg.n_heads(d)
    proj = rules.matmul(x, params["in_proj"])     # (B, L, 2*di + 2n + h)
    z, xbc, dt = torch.split(proj, [di, di + 2 * n, h], dim=-1)
    xbc, new_conv = _conv(xbc, params["conv_w"], conv_cache)
    xbc = F.silu(xbc)
    # column views of one (B, L, di + 2n) tensor: the kernel reads them
    # through their strides
    xs, Bv, Cv = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    xh = rules.shard(xs.reshape(b, l, h, cfg.head_dim), "batch", None,
                     "q_heads", None)
    if l == 1 and ssd_state is not None:
        y, new_state = ssd_decode_step(ssd_state, xh[:, 0], dt[:, 0], A,
                                       Bv[:, 0], Cv[:, 0])
        y = y[:, None]
    else:
        y, new_state = _scan_heads(ssd_cuda if use_kernel else ssd_ref, xh,
                                   dt, A, Bv, Cv, chunk or cfg.chunk,
                                   ssd_state)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(b, l, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["ssm_norm"])
    out = rules.matmul(y, params["out_proj"])
    return out, (new_conv, new_state.float())
