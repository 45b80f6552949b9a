"""Token embedding and greedy sampling over the (tied) embedding table,
local (single-device) paths of ``repro.models.embedloss``."""
from __future__ import annotations

import torch

from repro_torch.models.layers import matmul_f32


def embed_in(table: torch.Tensor, tokens: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """table (V, D); tokens (B, S) -> x (B, S, D)."""
    return table[tokens].to(compute_dtype)


def greedy(x: torch.Tensor, table: torch.Tensor,
           valid_vocab: int | None = None) -> torch.Tensor:
    """Greedy next-token ids (int32). x (B, D); table (Vp, D). Columns at
    or past ``valid_vocab`` (the vocab padding) are never chosen. The fp32
    logits of a bf16 ``x`` and table on CUDA come from one product with
    fp32 output, without the widened (Vp, D) copy of the table."""
    v = table.shape[0]
    valid = valid_vocab or v
    logits = matmul_f32(x, table.T)
    logits[:, valid:].fill_(-torch.inf)
    return logits.argmax(dim=-1).to(torch.int32)
