"""Plain fp32 forward of Zyphra's Zamba2 (hf:Zyphra/Zamba2-7B-Instruct),
as transformers' ``modeling_zamba2.py`` defines it, for the check of the
``zamba2-7b-instruct`` cells.

``dims`` is the configuration file's ``as_run`` group; ``params`` the
weights the benchmark made (bf16, in the program's leaf layout: ``layers``
stacked per Mamba2 layer, ``blocks`` per shared block, ``hybrid`` per
application, ``embed`` tied to the head). Each layer's weights are upcast
to fp32 when the layer runs and dropped after. Nothing is cached between
positions: every forward runs over whole sequences. TF32 is off while it
runs.

With e the token embedding, layer i of ``n_layers`` is a hybrid layer when
i is in ``hybrid_layer_ids``; the j-th such layer takes shared block
j mod ``n_mem_blocks`` and its own adapter and linear:

    t = concat(x, e); n = RMSNorm(t)
    a = o(attn(RoPE(q(n)), RoPE(k(n)), v(n)))      causal, scale (hd/2)^-1/2
    h = RMSNorm(a); [g | u] = h W_gu + (h A_j) B_j
    x_in = x + L_j(down(gelu(g) * u))              (no residual in the block)

and every other layer has x_in = x. Every layer then adds
Mamba2(RMSNorm(x_in)) to x: in_proj split [z | xBC | dt], xBC through the
depthwise causal conv with its bias and silu, dt = softplus(dt + dt_bias),
A = -exp(A_log), the SSD over the heads with B and C in ``n_groups``
groups (head h reads group h // (H / G)), plus D x, then y silu(z) normed
over each group's channels, and out_proj. A final RMSNorm and the tied
head end the model. The SSD is its masked-decay (quadratic) form over the
whole sequence: y_i = sum_{j <= i} (C_i . B_j) e^{sum_{j<k<=i} dt_k a}
dt_j x_j, the decay's exponent summed directly for each (i, j), not from
a difference of cumulative sums.

Departures from the published model, shared with the program: the norm
scales are stored as w and applied as 1 + w; dt is not floored at
``time_step_min`` (the published model's fused kernels take no floor).

``fp8=True`` is the control: every weight product takes its operands
rounded to float8 e4m3, as ``reference/model.py``'s (its ``q8``, copied:
the reference imports nothing but torch).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim`` so that each
    slice's largest magnitude maps to the format's largest, in fp32."""
    scale = E4M3_MAX / x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class NoTF32:
    """fp32 products in fp32 while it is entered: TF32 off for cuBLAS and
    cuDNN, as they were after."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old


def segsum(da: torch.Tensor) -> torch.Tensor:
    """da (..., L) -> (..., L, L): entry (i, j) the sum of da over
    j < k <= i for j <= i, -inf above the diagonal."""
    n = da.shape[-1]
    x = da[..., :, None].expand(*da.shape, n)           # x[..., i, j] = da_i
    below = torch.ones(n, n, dtype=torch.bool, device=da.device).tril(-1)
    s = torch.cumsum(x.masked_fill(~below, 0.0), dim=-2)
    keep = torch.ones(n, n, dtype=torch.bool, device=da.device).tril()
    return s.masked_fill(~keep, -torch.inf)


def ssd(x, dt, a, bm, cm):
    """x (B, L, H, P), dt (B, L, H), a (H,), bm/cm (B, L, G, N) -> y (B, L,
    H, P), all fp32, in the masked-decay form."""
    b, l, h, p = x.shape
    g = bm.shape[2]
    cb = torch.einsum("bign,bjgn->bgij", cm, bm)           # (B, G, L, L)
    cb = cb.repeat_interleave(h // g, dim=1)               # (B, H, L, L)
    decay = torch.exp(segsum((dt * a).transpose(1, 2)))    # (B, H, L, L)
    m = cb * decay * dt.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhij,bjhp->bihp", m, x)


class Reference:
    """One Zamba2 configuration's reference over one set of weights."""

    def __init__(self, dims: dict, params: dict, fp8: bool = False):
        if dims["kind"] != "hybrid" or not dims.get("hybrid_layer_ids"):
            raise NotImplementedError("the reference of Zyphra's hybrid")
        self.dims, self.params, self.fp8 = dims, params, fp8
        self.eps = dims["norm_eps"]
        table = params["embed"][:dims["vocab"]].float()
        self.table = q8(table, -1) if fp8 else table

    # ------------------------------------------------------------ pieces
    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return q8(x, -1) @ q8(w, 0)
        return x @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) \
            * (1.0 + scale.float())

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, H, D) at positions 0..S-1."""
        s, d = x.shape[1], x.shape[-1]
        half = d // 2
        freqs = 1.0 / (self.dims["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
            * freqs
        sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def shared_block(self, blk: dict, app: dict, x, e) -> torch.Tensor:
        """What a shared block adds to the next Mamba2 layer's input."""
        dims = self.dims
        b, s, _ = x.shape
        hq, hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
        n = self.norm(torch.cat([x, e], dim=-1), blk["ln_attn"])
        q = self.rope(self.mm(n, blk["wq"]).view(b, s, hq, hd))
        k = self.rope(self.mm(n, blk["wk"]).view(b, s, hkv, hd))
        v = self.mm(n, blk["wv"]).view(b, s, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd / 2)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), -1)
        del scores
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * hd)
        h = self.norm(self.mm(o, blk["wo"]), blk["ln_mlp"])
        low = self.mm(h, app["adapter"])
        g = self.mm(h, blk["w_gate"]) + self.mm(low, app["adapter_gate"])
        u = self.mm(h, blk["w_up"]) + self.mm(low, app["adapter_up"])
        return self.mm(self.mm(F.gelu(g) * u, blk["w_down"]), app["w_link"])

    def mamba(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """One Mamba2 mixer over x (B, L, D), already normed."""
        s = self.dims["ssm"]
        b, l, d = x.shape
        di, n, g = s["expand"] * d, s["d_state"], s["n_groups"]
        h = di // s["head_dim"]
        z, xbc, dt = self.mm(x, p["in_proj"]).split([di, di + 2 * g * n, h],
                                                     -1)
        w = p["conv_w"].float()                            # (W, C)
        xbc = F.conv1d(xbc.transpose(1, 2), w.T[:, None, :], p["conv_b"],
                       padding=w.shape[0] - 1, groups=w.shape[1])
        xbc = F.silu(xbc[..., :l].transpose(1, 2))
        xs, bm, cm = xbc.split([di, g * n, g * n], -1)
        dt = F.softplus(dt + p["dt_bias"])
        xh = xs.reshape(b, l, h, s["head_dim"])
        y = ssd(xh, dt, -torch.exp(p["A_log"]), bm.reshape(b, l, g, n),
                cm.reshape(b, l, g, n))
        y = (y + p["D"][:, None] * xh).reshape(b, l, di) * F.silu(z)
        y = self.norm(y.reshape(b, l, g, di // g),
                      p["ssm_norm"].view(g, di // g)).reshape(b, l, di)
        return self.mm(y, p["out_proj"])

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final normed hidden states (B, S, D), fp32."""
        dims, params = self.dims, self.params
        app = {lid: j for j, lid in enumerate(dims["hybrid_layer_ids"])}
        with NoTF32():
            e = F.embedding(tokens.long(), self.table)
            x = e
            for i in range(dims["n_layers"]):
                p = {k: v[i].float() for k, v in params["layers"].items()}
                xin = x
                if i in app:
                    j = app[i]
                    blk = {k: v[j % dims["n_mem_blocks"]].float()
                           for k, v in params["blocks"].items()}
                    ap = {k: v[j].float()
                          for k, v in params["hybrid"].items()}
                    xin = x + self.shared_block(blk, ap, x, e)
                    del blk, ap
                x = x + self.mamba(p, self.norm(xin, p["ln_ssm"]))
                del p
            return self.norm(x, params["ln_final"])

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """h (..., D) -> fp32 logits over the vocab."""
        with NoTF32():
            if self.fp8:
                return q8(h, -1) @ self.table.T
            return h @ self.table.T
