"""A plain fp32 forward of Zyphra's Zamba2 (hf:Zyphra/Zamba2-7B-Instruct,
the equations of transformers' ``modeling_zamba2.py``), independent of the
port's code: plain ``torch`` operations only, no kernel, cache or batching,
and the SSD as its step recurrence (one position at a time), not the port's
chunked scan.

``params`` is a parameter dict in the port's layout for Zyphra's hybrid
(``layers`` stacked per Mamba2 layer, ``blocks`` per shared block, ``hybrid``
per application); ``cfg`` a ``ModelConfig`` with ``hybrid_layer_ids``. The
norm scales are stored as w and applied as 1 + w, as in every family of the
port (transformers' modules hold 1 + w).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x, theta):
    """x (B, S, H, D) at positions 0..S-1, the two halves rotated."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32) * 2 / d)
    ang = torch.arange(s, dtype=torch.float32)[:, None] * inv
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def ssd_steps(x, dt, a, bm, cm):
    """The SSD recurrence one position at a time: x (B, L, H, P), dt (B, L,
    H), a (H,), bm/cm (B, L, G, N), head h on group h // (H / G). Returns y
    (B, L, H, P) and the final state (B, H, P, N)."""
    b, l, h, p = x.shape
    g, n = bm.shape[2:]
    grp = torch.arange(h) // (h // g)
    s = torch.zeros(b, h, p, n)
    ys = []
    for t in range(l):
        bt, ct = bm[:, t, grp], cm[:, t, grp]                # (B, H, N)
        s = s * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bt[:, :, None]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, ct))
    return torch.stack(ys, 1), s


def mamba2(p, x, cfg):
    """One Mamba2 mixer over x (B, L, D) (already normed)."""
    s = cfg.ssm
    b, l, d = x.shape
    di, n, g = s.expand * d, s.d_state, s.n_groups
    h = di // s.head_dim
    proj = x @ p["in_proj"].float()
    z, xbc, dt = proj.split([di, di + 2 * g * n, h], -1)
    w = p["conv_w"].float()                                  # (W, C)
    conv = F.conv1d(xbc.transpose(1, 2), w.T[:, None, :],
                    p["conv_b"].float(), padding=w.shape[0] - 1,
                    groups=w.shape[1])[..., :l].transpose(1, 2)
    xbc = F.silu(conv)
    xs, bm, cm = xbc.split([di, g * n, g * n], -1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    xh = xs.reshape(b, l, h, s.head_dim)
    y, _ = ssd_steps(xh, dt, a, bm.reshape(b, l, g, n), cm.reshape(b, l, g, n))
    y = (y + p["D"].float()[:, None] * xh).reshape(b, l, di) * F.silu(z)
    y = rms(y.reshape(b, l, g, di // g), p["ssm_norm"].float().view(g, -1),
            cfg.norm_eps).reshape(b, l, di)
    return y @ p["out_proj"].float()


def shared_block(blk, app, x, e, cfg):
    """A shared block's output (to the next Mamba2 layer's input): attention
    over concat(x, e), then GeGLU with the application's adapter, then the
    application's linear; no residual."""
    b, l, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    t = rms(torch.cat([x, e], -1), blk["ln_attn"], cfg.norm_eps)
    q = rope((t @ blk["wq"].float()).view(b, l, hq, hd), cfg.rope_theta)
    k = rope((t @ blk["wk"].float()).view(b, l, hkv, hd), cfg.rope_theta)
    v = (t @ blk["wv"].float()).view(b, l, hkv, hd)
    k = k.repeat_interleave(hq // hkv, 2)
    v = v.repeat_interleave(hq // hkv, 2)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd / 2)
    causal = torch.ones(l, l, dtype=torch.bool).tril()
    pr = torch.softmax(sc.masked_fill(~causal, -torch.inf), -1)
    o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, l, hq * hd)
    a = o @ blk["wo"].float()
    hh = rms(a, blk["ln_mlp"], cfg.norm_eps)
    low = hh @ app["adapter"].float()
    gate = hh @ blk["w_gate"].float() + low @ app["adapter_gate"].float()
    up = hh @ blk["w_up"].float() + low @ app["adapter_up"].float()
    m = (F.gelu(gate) * up) @ blk["w_down"].float()
    return m @ app["w_link"].float()


@torch.no_grad()
def hidden(params, tokens, cfg):
    """tokens (B, L) -> the final normed hidden states (B, L, D), fp32."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        e = params["embed"].float()[tokens.long()]
        x = e
        app = {lid: j for j, lid in enumerate(cfg.hybrid_layer_ids)}
        for i in range(cfg.n_layers):
            p = {k: v[i] for k, v in params["layers"].items()}
            xin = x
            if i in app:
                j = app[i]
                blk = {k: v[j % cfg.n_mem_blocks]
                       for k, v in params["blocks"].items()}
                ap = {k: v[j] for k, v in params["hybrid"].items()}
                xin = x + shared_block(blk, ap, x, e, cfg)
            x = x + mamba2(p, rms(xin, p["ln_ssm"], cfg.norm_eps), cfg)
        return rms(x, params["ln_final"], cfg.norm_eps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def logits(params, h, cfg):
    """Tied head: h (..., D) -> fp32 logits over the vocab."""
    return h @ params["embed"].float()[:cfg.vocab].T
