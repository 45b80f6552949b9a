"""Attention, local (single-device) paths of ``repro.models.attention``.

Layouts: q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D); GQA handled in a grouped
(B, Hkv, G, Sq, D) layout so the kv tensors are never repeated.

Prefill paths, chosen by ``ModelConfig.attn_impl``:
  - ``kernel``    : the hand-written CUDA flash-attention kernel
                    (``repro_torch.kernels.flash_attention``) for CUDA
                    tensors, its plain version for CPU tensors;
  - ``chunked``   : the hand-written CUDA two-pass (lazy softmax) kernel,
                    the same function by another implementation point,
                    likewise its plain version for CPU tensors;
  - ``xla_flash`` : chunked running-softmax attention in plain torch, the
                    math of the kernel (the name is the reference's); a
                    causal sliding window goes to ``window_attention_xla``,
                    which reads only the keys each query chunk can see;
  - ``naive``     : O(S^2) oracle (tests, tiny shapes).
Decode attends one token per lane over the cache
(``decode_attention_local``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

_NEG = -1e30
IMPLS = ("kernel", "chunked", "xla_flash", "naive")


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Sq, Hq, D) -> (B, n_kv, G, Sq, D)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d).permute(0, 2, 3, 1, 4)


def _ungroup(o: torch.Tensor) -> torch.Tensor:
    """(B, n_kv, G, Sq, D) -> (B, Sq, Hq, D)."""
    b, n_kv, g, s, d = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, n_kv * g, d)


def _mask(q_pos, kv_pos, causal: bool, window: int):
    """Boolean mask (Sq, Skv): True = attend."""
    m = torch.ones(q_pos.shape + kv_pos.shape, dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= kv_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= kv_pos[None, :] > q_pos[:, None] - window
    return m


# ------------------------------------------------------------------- naive
def naive_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    kv_offset=0):
    b, sq, hq, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    qg = _group(q, n_kv)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgqd,bkhd->bhgqk", qg.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    kv_pos = kv_offset + torch.arange(skv, device=q.device)
    m = _mask(q_pos, kv_pos, causal, window)
    s = torch.where(m, s, _NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return _ungroup(o).to(q.dtype)


# --------------------------------------------------------------- xla flash
def flash_attention_xla(q, k, v, *, causal=True, window=0, q_offset=0,
                        kv_offset=0, kv_chunk=512, kv_len=None):
    """Memory-efficient attention: a loop over KV chunks with an fp32
    running softmax. ``kv_len``: optional count of valid kv positions."""
    b, sq, hq, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, skv)
    qg = _group(q, n_kv).float()  # (B, Hkv, G, Sq, D)
    scale = 1.0 / math.sqrt(d)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full(qg.shape[:-1], _NEG, device=q.device)
    l = torch.zeros(qg.shape[:-1], device=q.device)
    acc = torch.zeros_like(qg)
    for c0 in range(0, skv, kv_chunk):
        k_c = k[:, c0:c0 + kv_chunk].float()
        v_c = v[:, c0:c0 + kv_chunk].float()
        kv_pos = kv_offset + c0 + torch.arange(k_c.shape[1], device=q.device)
        s = torch.einsum("bhgqd,bkhd->bhgqk", qg, k_c) * scale
        msk = _mask(q_pos, kv_pos, causal, window)
        if kv_len is not None:
            msk &= (kv_pos < kv_len)[None, :]
        s = torch.where(msk, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v_c)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return _ungroup(o).to(q.dtype)


def window_attention_xla(q, k, v, *, window, q_offset=0, q_chunk=0):
    """Causal sliding-window attention with per-query-chunk KV slicing:
    each chunk of ``q_chunk`` queries reads only a (window + chunk)-sized
    KV slice, so the work is O(S * window), not O(S^2). When the slice
    would cover every key, it is ``flash_attention_xla``."""
    sq, skv = q.shape[1], k.shape[1]
    q_chunk = q_chunk or min(512, sq)
    span = window + q_chunk
    if span >= skv:
        return flash_attention_xla(q, k, v, causal=True, window=window,
                                   q_offset=q_offset)
    outs = []
    for a in range(0, sq, q_chunk):
        start = min(max(q_offset + a - window + 1, 0), skv - span)
        outs.append(flash_attention_xla(
            q[:, a:a + q_chunk], k[:, start:start + span],
            v[:, start:start + span], causal=True, window=window,
            q_offset=q_offset + a, kv_offset=start, kv_chunk=span))
    return torch.cat(outs, dim=1)


def context_attention(q, k, v, *, causal=True, window=0, impl="kernel"):
    """Prefill attention on one device (the reference's no-mesh branch),
    dispatched on ``impl`` (``ModelConfig.attn_impl``). The CUDA kernels
    take the window as a mask; the plain path slices the keys as the
    reference's ``local`` does."""
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "chunked":
        return fa_ops.chunked_attention(q, k, v, causal=causal, window=window)
    if impl == "xla_flash":
        if window > 0 and causal:
            return window_attention_xla(q, k, v, window=window)
        return flash_attention_xla(q, k, v, causal=causal, window=window)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"unknown attn_impl {impl!r}; expected one of {IMPLS}")


def attend(q, k, v, *, causal=True, window=0, impl="xla_flash",
           q_offset=0):
    """The reference's ``attend``: ``naive`` the oracle, ``kernel`` the
    CUDA flash kernel (the reference's ``pallas``; it takes no query
    offset), any other ``impl`` the plain path, windowed when causal."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "kernel":
        if q_offset:
            raise ValueError("the flash kernel takes no query offset")
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    if window > 0 and causal:
        return window_attention_xla(q, k, v, window=window,
                                    q_offset=q_offset)
    return flash_attention_xla(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


# ------------------------------------------------------------------ decode
def decode_attention_local(q, k_cache, v_cache, *, pos, window=0,
                           kv_offset=0):
    """Single-token attention over a cache: q (B, Hq, D), cache
    (B, S, Hkv, D), ``pos`` = current absolute position — an int, or a
    (B,) tensor of per-slot positions (continuous batching: each lane
    masks against its own progress). Returns (o, m, l)."""
    b, hq, d = q.shape
    skv, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, n_kv, hq // n_kv, d).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    kv_pos = kv_offset + torch.arange(skv, device=q.device)
    pos_b = torch.as_tensor(pos, device=q.device).expand(b)
    msk = kv_pos[None, :] <= pos_b[:, None]                 # (B, Skv)
    if window > 0:
        msk &= kv_pos[None, :] > pos_b[:, None] - window
    msk = msk[:, None, None, :]
    s = torch.where(msk, s, _NEG)
    m = s.amax(dim=-1)
    p = torch.where(msk, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def decode_attention(q, k_cache, v_cache, *, pos, window=0):
    """Decode attention on one device (the reference's no-mesh branch).
    q: (B, Hq, D) -> (B, Hq, D)."""
    o, _, _ = decode_attention_local(q, k_cache, v_cache, pos=pos,
                                     window=window)
    return o.reshape(q.shape).to(q.dtype)
