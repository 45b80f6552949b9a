"""Token embedding, the language-model loss and greedy sampling over the
(tied) embedding table, local (single-device) paths of
``repro.models.embedloss``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import matmul_f32


def embed_in(table: torch.Tensor, tokens: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """table (V, D); tokens (B, S) -> x (B, S, D). ``F.embedding`` gathers
    the same rows as ``table[tokens]``; its CUDA backward sums the rows'
    gradients by sorting the tokens, deterministically, where indexing's
    accumulates with fp32 atomics in an order that varies from run to
    run."""
    return F.embedding(tokens, table).to(compute_dtype)


def lm_loss(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
            valid_vocab: int | None = None, seq_chunk: int = 1024
            ) -> torch.Tensor:
    """Mean cross-entropy over the tokens whose label is >= 0: x (B, S, D),
    table (Vp, D), labels (B, S). Columns at or past ``valid_vocab`` (the
    vocab padding) are masked out of the softmax. The reference's local
    path (its vocab-sharded ``custom_vjp`` is item 12's)."""
    valid = valid_vocab or table.shape[0]
    return _ce_chunked(x, table, labels, valid, seq_chunk)


def _ce_chunked(x, table, labels, valid: int, seq_chunk: int):
    """Chunked CE, as the reference's: ``n = S // min(seq_chunk, S)``
    chunks of ``S // n`` positions plus the ragged remainder, each chunk's
    logits in fp32, so the (B, S, Vp) logits are never whole."""
    b, s, _ = x.shape
    v = table.shape[0]
    tbl32 = table.float()
    col_ok = torch.arange(v, device=x.device) < valid
    n_chunk = max(s // min(seq_chunk, s), 1)
    cs = s // n_chunk

    def chunk_nll(xc, lc):
        logits = (xc.float() @ tbl32.T).masked_fill(~col_ok, -torch.inf)
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc.clamp(0, v - 1).long()[..., None])[..., 0]
        mask = (lc >= 0).float()
        return ((lse - gold) * mask).sum(), mask.sum()

    sums = [chunk_nll(x[:, i * cs:(i + 1) * cs],
                      labels[:, i * cs:(i + 1) * cs]) for i in range(n_chunk)]
    tot = torch.stack([t for t, _ in sums]).sum()
    n = torch.stack([c for _, c in sums]).sum()
    if s > n_chunk * cs:
        t, c = chunk_nll(x[:, n_chunk * cs:], labels[:, n_chunk * cs:])
        tot, n = tot + t, n + c
    return tot / n.clamp(min=1.0)


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
