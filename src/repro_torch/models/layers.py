"""Common layers: RMSNorm, RoPE, SwiGLU, embeddings."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
    """SwiGLU MLP."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    return table[tokens].to(compute_dtype)
