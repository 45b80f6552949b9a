"""Common layers: RMSNorm, RoPE, SwiGLU, embeddings, logits and
cross-entropy, dense init."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import matmul, shard


def fused_f32(*ts: torch.Tensor) -> bool:
    """Whether products of these operands take :func:`matmul_f32`'s fused
    path: all bf16 and on CUDA."""
    return all(t.is_cuda and t.dtype == torch.bfloat16 for t in ts)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.float() @ b.float()`` for 2-D operands, or 3-D ones batched
    along dim 0. For two bf16 operands on CUDA, cuBLAS's product with fp32
    accumulation and fp32 output (``out_dtype``), as XLA fuses the
    reference's ``astype(f32)`` casts into its dots: each product of two
    bf16 values is exact in fp32, so only the order of the fp32 sums
    differs, and no widened copy of either operand is written. Otherwise
    (the CPU, fp32) the widened product; ``.float()`` of an fp32 tensor is
    the tensor itself."""
    if fused_f32(a, b):
        mm = torch.bmm if a.dim() == 3 else torch.mm
        return mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32 with a zero-centred scale: ``x / rms(x) * (1 + scale)``."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """(sin, cos) tables for the given absolute positions, shape (..., hd/2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    if sin.dim() == 2:  # (S, half) -> broadcast over batch and heads
        sin_, cos_ = sin[None, :, None, :], cos[None, :, None, :]
    else:  # (B, S, half)
        sin_, cos_ = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * cos_ - x2 * sin_, x2 * cos_ + x1 * sin_], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP, its hidden dim sharded over 'ff' under a mesh."""
    h = shard(F.silu(matmul(x, w_gate)) * matmul(x, w_up), "batch", None,
              "ff")
    return matmul(h, w_down)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    return shard(table[tokens].to(compute_dtype), "batch", None, None)


def lm_logits(x: torch.Tensor, table_or_head: torch.Tensor, tied: bool
              ) -> torch.Tensor:
    """Final projection to the vocab, fp32 logits for loss stability: x
    (..., D) against a tied table (V, D) or a head (D, V)."""
    w = table_or_head.float()
    return shard(x.float() @ (w.T if tied else w), "batch", None, "vocab")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy; logits (B, S, V), labels (B, S) ints; with
    ``mask`` (B, S) the mean over the masked-in tokens."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp(min=1)
    return nll.mean()


def init_dense(gen: torch.Generator, shape, scale: float | None = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) weights on ``gen``'s device, drawn in fp32 and cast;
    ``scale`` defaults to 1 / sqrt(fan-in), fan-in ``shape[0]``. The
    numbers differ from the reference's ``jax.random`` draws."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)
