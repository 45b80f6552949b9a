"""Plain PyTorch versions of the attention kernels (standalone)."""
from __future__ import annotations

import math

import torch


def _visible(sq, skv, causal, window, device):
    """(Sq, Skv) bool: which keys each query sees under the mask."""
    q_pos = torch.arange(sq, device=device)[:, None]
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window=0):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D). A row that
    sees no key gets the mean of V, as the reference's ``attention_ref``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = _visible(sq, skv, causal, window, q.device)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def attention_kernel_ref(q, k, v, *, causal=True, window=0):
    """The kernels' function: ``attention_ref`` with every row that sees no
    key under ``causal`` and ``window`` set to 0, as the Pallas kernels
    (``flash_attention_tpu``, ``chunked_attention_tpu``) and the CUDA
    bodies give it."""
    out = attention_ref(q, k, v, causal=causal, window=window)
    empty = ~_visible(q.shape[2], k.shape[2], causal, window, q.device).any(-1)
    return out.masked_fill(empty[:, None], 0)
