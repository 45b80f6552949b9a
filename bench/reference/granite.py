"""Plain fp32 forward of IBM's Granite 4.0-H (hf:ibm-granite/granite-4.0-h-
small), as transformers' ``modeling_granitemoehybrid.py`` defines it, for
the check of the ``granite-4.0-h-small`` cells.

``dims`` is the configuration file's ``as_run`` group; ``params`` the
weights the benchmark made (bf16, in the program's leaf layout: ``ssm``
stacked per Mamba2 layer, ``attn`` per attention layer, ``ffn`` per layer,
``embed`` tied to the head). Each weight is upcast to fp32 when its
product runs and dropped after (an expert's three matrices one expert at
a time). Nothing is cached between positions: every forward runs over
whole sequences. TF32 is off while it runs.

With ``layer_types`` giving each layer's mixer and r the residual
multiplier, the embedding is multiplied by ``embedding_multiplier``, and
layer i runs

    x = x + r * mixer_i(RMSNorm(x))
    h = RMSNorm(x); x = x + r * (MoE(h) + shared(h))

where an attention mixer is causal GQA (query head j reads key head
j // (Hq / Hkv)) with no positional encoding and softmax scale
``softmax_scale`` (``attention_multiplier``), and a Mamba2 mixer splits
in_proj into [z | xBC | dt], runs xBC through the depthwise causal conv
with its bias and silu, dt = softplus(dt + dt_bias), A = -exp(A_log), the
SSD over the heads with B and C in ``n_groups`` groups, plus D x, then
normalises y silu(z) and applies out_proj. The MoE takes the softmax over
the top-k of the fp32 router logits and adds each chosen expert's SwiGLU,
weighted; every assignment is computed (the published model drops none).
The shared expert is a SwiGLU of width ``d_ff``. A final RMSNorm and the
tied head end the model; the logits are divided by ``logits_scaling``.
The SSD is its masked-decay (quadratic) form over the whole sequence,
y_i = sum_{j <= i} (C_i . B_j) e^{sum_{j<k<=i} dt_k a} dt_j x_j, in blocks
of ``HEAD_BLOCK`` heads, the decay's exponent summed directly for each
(i, j).

Departures from the published model, shared with the program: the norm
scales are stored as w and applied as 1 + w (transformers holds 1 + w as
its weight); the router's product runs in fp32 (the published model's in
its dtype, then cast to fp32).

``fp8=True`` is the control: every weight product, the router's
included, takes its operands rounded to float8 e4m3, as
``reference/model.py``'s (its ``q8``, copied: the reference imports
nothing but torch).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
# heads of one block of the masked-decay SSD: (B, 16, L, L) fp32 at a time
HEAD_BLOCK = 16


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
    H, P), all fp32, in the masked-decay form, ``HEAD_BLOCK`` heads at a
    time (head h reads group h // (H / G))."""
    h, g = x.shape[2], bm.shape[2]
    cb = torch.einsum("bign,bjgn->bgij", cm, bm)           # (B, G, L, L)
    out = []
    for lo in range(0, h, HEAD_BLOCK):
        heads = torch.arange(lo, min(lo + HEAD_BLOCK, h), device=x.device)
        dth = dt[:, :, heads]
        decay = torch.exp(segsum((dth * a[heads]).transpose(1, 2)))
        m = cb[:, heads // (h // g)] * decay * dth.transpose(1, 2)[:, :, None]
        out.append(torch.einsum("bhij,bjhp->bihp", m, x[:, :, heads]))
        del decay, m
    return torch.cat(out, dim=2)


class Reference:
    """One Granite 4.0-H configuration's reference over one set of
    weights."""

    def __init__(self, dims: dict, params: dict, fp8: bool = False):
        if dims["kind"] != "hybrid" or not dims.get("layer_types"):
            raise NotImplementedError("the reference of a hybrid whose "
                                      "layer pattern is given as data")
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

    def swiglu(self, h, w_gate, w_up, w_down) -> torch.Tensor:
        return self.mm(F.silu(self.mm(h, w_gate)) * self.mm(h, w_up), w_down)

    def attention(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """Causal GQA over x (B, S, D), already normed; no positional
        encoding."""
        dims = self.dims
        b, s, _ = x.shape
        hq, hkv, hd = dims["n_heads"], dims["n_kv_heads"], dims["head_dim"]
        q = self.mm(x, p["wq"]).view(b, s, hq, hd)
        k = self.mm(x, p["wk"]).view(b, s, hkv, hd)
        v = self.mm(x, p["wv"]).view(b, s, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * dims["softmax_scale"]
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), -1)
        del scores
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * hd)
        return self.mm(o, p["wo"])

    def mamba(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        """One Mamba2 mixer over x (B, L, D), already normed."""
        s = self.dims["ssm"]
        b, l, d = x.shape
        di, n, g = s["expand"] * d, s["d_state"], s["n_groups"]
        h = di // s["head_dim"]
        z, xbc, dt = self.mm(x, p["in_proj"]).split([di, di + 2 * g * n, h],
                                                     -1)
        w = p["conv_w"].float()                            # (W, C)
        xbc = F.conv1d(xbc.transpose(1, 2), w.T[:, None, :],
                       p["conv_b"].float(), padding=w.shape[0] - 1,
                       groups=w.shape[1])
        xbc = F.silu(xbc[..., :l].transpose(1, 2))
        xs, bm, cm = xbc.split([di, g * n, g * n], -1)
        dt = F.softplus(dt + p["dt_bias"].float())
        xh = xs.reshape(b, l, h, s["head_dim"])
        y = ssd(xh, dt, -torch.exp(p["A_log"].float()),
                bm.reshape(b, l, g, n), cm.reshape(b, l, g, n))
        y = (y + p["D"].float()[:, None] * xh).reshape(b, l, di) * F.silu(z)
        y = self.norm(y.reshape(b, l, g, di // g),
                      p["ssm_norm"].view(g, di // g)).reshape(b, l, di)
        return self.mm(y, p["out_proj"])

    def moe(self, f: dict, i: int, h: torch.Tensor) -> torch.Tensor:
        """Layer i's experts over h (T, D), normed: every token through its
        top-k experts, weighted by the softmax over their logits; the
        experts' weights (``f`` the layer's bf16 FFN leaves, stacked over
        the experts) upcast one expert at a time."""
        m = self.dims["moe"]
        logits = self.mm(h, f["router"][i])
        gates, experts = torch.topk(logits, m["top_k"], dim=-1)
        weights = torch.softmax(gates, dim=-1)
        out = torch.zeros_like(h)
        for e in range(m["n_experts"]):
            rows, slot = torch.nonzero(experts == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self.swiglu(h[rows], f["moe_gate"][i, e], f["moe_up"][i, e],
                            f["moe_down"][i, e])
            out.index_add_(0, rows, weights[rows, slot][:, None] * y)
        return out

    def ffn(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """What layer i's FFN adds, before the residual multiplier."""
        f = self.params["ffn"]
        b, s, d = x.shape
        h = self.norm(x, f["ln_mlp"][i]).reshape(b * s, d)
        y = self.moe(f, i, h)
        y = y + self.swiglu(h, f["w_gate"][i], f["w_up"][i], f["w_down"][i])
        return y.reshape(b, s, d)

    # ----------------------------------------------------------- forward
    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final normed hidden states (B, S, D), fp32."""
        dims, params = self.dims, self.params
        r = dims["residual_multiplier"]
        seen = {"attention": 0, "mamba": 0}
        with NoTF32():
            x = F.embedding(tokens.long(), self.table) \
                * dims["embedding_multiplier"]
            for i, kind in enumerate(dims["layer_types"]):
                j = seen[kind]
                seen[kind] += 1
                if kind == "attention":
                    p = {k: v[j] for k, v in params["attn"].items()}
                    y = self.attention(p, self.norm(x, p["ln_attn"]))
                else:
                    p = {k: v[j] for k, v in params["ssm"].items()}
                    y = self.mamba(p, self.norm(x, p["ln_ssm"]))
                x = x + r * y
                x = x + r * self.ffn(i, x)
                del p, y
            return self.norm(x, params["ln_final"])

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """h (..., D) -> fp32 logits over the vocab, divided by
        ``logits_scaling``."""
        with NoTF32():
            if self.fp8:
                out = q8(h, -1) @ self.table.T
            else:
                out = h @ self.table.T
        return out / self.dims["logits_scaling"]
