"""Plain fp32 forward passes of the benchmark's configurations.

``dims`` is a configuration file's ``as_run`` group; ``params`` the
weights the benchmark made (bf16, in the program's leaf layout: stacked
per layer, ``embed`` tied to the head). Each layer's weights are upcast
to fp32 when the layer runs and dropped after, so that the reference fits
beside the bf16 weights on the card. Nothing is cached between positions:
every forward runs over whole sequences, causal attention in full.

The dense family, as its published configurations define it: pre-norm
blocks, RMSNorm with a zero-centred scale (``x / rms(x) * (1 + w)``), RoPE
on the two halves of each head, GQA (query head j reads key head
``j // (Hq / Hkv)``), softmax scale ``1 / sqrt(hd)``, SwiGLU, a tied head.

``fp8=True`` is the control: every weight product takes its operands
rounded to float8 e4m3 (per row of the activations, per output column of
the weights, each scaled to the format's range), the precision below the
configurations' bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def padded_vocab(dims: dict) -> int:
    return (dims["vocab"] + 127) // 128 * 128


def head_dim(dims: dict) -> int:
    return dims.get("head_dim") or dims["d_model"] // dims["n_heads"]


def q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3, scaled along ``dim`` so that each
    slice's largest magnitude maps to the format's largest, in fp32."""
    scale = E4M3_MAX / x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Reference:
    """One configuration's reference over one set of weights."""

    def __init__(self, dims: dict, params: dict, fp8: bool = False):
        if dims["kind"] != "dense":
            raise NotImplementedError(f"no reference for {dims['kind']!r}")
        self.dims, self.params, self.fp8 = dims, params, fp8
        self.hd = head_dim(dims)
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

    def attention_block(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        dims = self.dims
        b, s, _ = x.shape
        hq, hkv, hd = dims["n_heads"], dims["n_kv_heads"], self.hd
        h = self.norm(x, p["ln_attn"])
        q = self.rope(self.mm(h, p["wq"]).view(b, s, hq, hd))
        k = self.rope(self.mm(h, p["wk"]).view(b, s, hkv, hd))
        v = self.mm(h, p["wv"]).view(b, s, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~causal, -torch.inf), -1)
        del scores
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, hq * hd)
        x = x + self.mm(o, p["wo"])
        h = self.norm(x, p["ln_mlp"])
        return x + self.mm(F.silu(self.mm(h, p["w_gate"]))
                           * self.mm(h, p["w_up"]), p["w_down"])

    # ----------------------------------------------------------- forward
    def layers(self):
        """The leaves of every layer in order, each a bf16 view."""
        stack = self.params["layers"]
        for i in range(self.dims["n_layers"]):
            yield {k: v[i] for k, v in stack.items()}

    @torch.no_grad()
    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final normed hidden states (B, S, D), fp32."""
        x = F.embedding(tokens.long(), self.table)
        for p in self.layers():
            x = self.attention_block({k: v.float() for k, v in p.items()}, x)
        return self.norm(x, self.params["ln_final"])

    @torch.no_grad()
    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """h (..., D) -> fp32 logits over the vocab (the padding columns
        left out)."""
        if self.fp8:
            return q8(h, -1) @ self.table.T
        return h @ self.table.T
