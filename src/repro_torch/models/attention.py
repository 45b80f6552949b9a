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

Under a mesh (``repro_torch.sharding``), the reference's two
``shard_map`` branches:
  - ``context_attention``: all-gather-KV context parallelism. Queries
    stay sequence-sharded over the 'seq' axis; each shard gathers the
    layer's K/V and attends with its queries at their absolute positions
    (``q_offset`` = the shard's start), through the kernel that ``impl``
    names (the reference runs ``flash_attention_xla`` there);
  - ``decode_attention``: flash-decoding. The cache is sharded along its
    sequence over the 'kv_seq' axes; each shard attends over its slice
    and the partial softmaxes merge by the log-sum-exp trick (``pmax`` /
    ``psum``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import fused_f32, matmul_f32
from repro_torch.obs.ranges import profiler_range
from repro_torch.sharding import rules

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
                    kv_offset=0, scale=None):
    b, sq, hq, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    qg = _group(q, n_kv)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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
                        kv_offset=0, kv_chunk=512, kv_len=None, scale=None):
    """Memory-efficient attention: a loop over KV chunks with an fp32
    running softmax. ``kv_len``: optional count of valid kv positions;
    ``scale``: the scores' (default 1 / sqrt(D))."""
    b, sq, hq, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    kv_chunk = min(kv_chunk, skv)
    qg = _group(q, n_kv).float()  # (B, Hkv, G, Sq, D)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
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


def _local_attention(q, k, v, causal, window, impl, q_offset, scale=None):
    """Prefill attention on local tensors, dispatched on ``impl``
    (``ModelConfig.attn_impl``), the queries at ``q_offset`` onwards, the
    scores scaled by ``scale`` (default 1 / sqrt(D)). The CUDA kernels take
    the window as a mask; the plain path slices the keys as the
    reference's ``local`` does (a window with its default scale only)."""
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, scale=scale)
    if impl == "chunked":
        return fa_ops.chunked_attention(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        scale=scale)
    if impl == "xla_flash":
        if window > 0 and causal and scale is None:
            return window_attention_xla(q, k, v, window=window,
                                        q_offset=q_offset)
        return flash_attention_xla(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, scale=scale)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    raise ValueError(f"unknown attn_impl {impl!r}; expected one of {IMPLS}")


def context_attention(q, k, v, *, causal=True, window=0, impl="kernel",
                      scale=None):
    """Prefill attention. Without a mesh, one local call. Under a mesh:
    all-gather-KV context parallelism, each sequence shard at its absolute
    offset; or, when the query sequence does not divide the 'seq' axes,
    the local call on each rank's batch shard, the sequences whole (the
    kernels take no DTensor). ``scale``: the scores' (default 1 / sqrt(D)).
    While a profiler records, the call is one ``attention`` range, whatever
    ``impl`` runs it."""
    with profiler_range("attention"):
        return _context_attention(q, k, v, causal, window, impl, scale)


def _context_attention(q, k, v, causal, window, impl, scale=None):
    ctx = rules.current_ctx()
    mesh = ctx.mesh
    sq = q.shape[1]
    axes = ctx.mesh_axes("seq")
    if not rules.is_device_mesh(mesh):
        return _local_attention(q, k, v, causal, window, impl, 0, scale)
    bspec = ctx.spec(("batch",), (q.shape[0],))[0]
    if not axes or sq % ctx.axes_size("seq") != 0:
        spec = (bspec, None, None, None)
        return rules.shard_map(
            lambda qq, kk, vv: _local_attention(qq, kk, vv, causal, window,
                                                impl, 0, scale),
            mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)(q, k, v)
    axis = axes[0]
    kv_sharded = k.shape[1] % rules.mesh_shape(mesh)[axis] == 0
    qspec = (bspec, axis, None, None)
    kvspec = (bspec, axis if kv_sharded else None, None, None)

    def f(qq, kk, vv):
        if kv_sharded:
            kk = rules.all_gather(kk, mesh, axis, 1)
            vv = rules.all_gather(vv, mesh, axis, 1)
        q_off = rules.axis_index(mesh, axis) * qq.shape[1]
        return _local_attention(qq, kk, vv, causal, window, impl, q_off,
                                scale)

    return rules.shard_map(f, mesh=mesh, in_specs=(qspec, kvspec, kvspec),
                           out_specs=qspec)(q, k, v)


def attend(q, k, v, *, causal=True, window=0, impl="xla_flash",
           q_offset=0):
    """The reference's ``attend``: ``naive`` the oracle, ``kernel`` the
    CUDA flash kernel (the reference's ``pallas``, which takes no query
    offset; this one does), any other ``impl`` the plain path, windowed
    when causal."""
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    if window > 0 and causal:
        return window_attention_xla(q, k, v, window=window,
                                    q_offset=q_offset)
    return flash_attention_xla(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)


# ------------------------------------------------------------------ decode
def split3_bf16(p: torch.Tensor) -> torch.Tensor:
    """fp32 ``p`` as three bf16 terms stacked on a new dim 1, hi + mid +
    lo == p exactly: each term takes the next 8 significant bits of the
    remainder (fp32's 24 in all; a term of |p| < 2^-110 may underflow)."""
    hi = p.to(torch.bfloat16)
    rest = p - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo], dim=1)


def scores_blockdiag(q, k_cache):
    """q·Kᵀ of every lane and head as one product batched over the lanes:
    q (B, Hq, D), k_cache (B, S, Hkv, D) -> (B, Hkv, G, S) fp32. Query
    row (h, g) sits in columns h·D..(h+1)·D of an otherwise zero
    (Hq, Hkv·D) matrix, so each lane's product with its cache rows
    (S, Hkv·D), read once as they lie, sums q[h, g]·k[s, h] and exact
    zeros; no copy of the cache is made. The head pairs h ≠ h' cost only
    tensor-core work: with at most 3·Hq = 192 rows (kimi-k2's p·V) a
    product does under 2·192 operations per 2-byte cache element, below
    the H100's 295 bf16 operations per byte of HBM, so it stays bound by
    the cache's bytes."""
    b, hq, d = q.shape
    skv, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = hq // n_kv
    qbd = q.new_zeros((b, n_kv, g, n_kv, d))
    qbd.diagonal(dim1=1, dim2=3).copy_(
        q.reshape(b, n_kv, g, d).permute(0, 2, 3, 1))
    s = matmul_f32(qbd.view(b, hq, n_kv * d),
                   k_cache.reshape(b, skv, n_kv * d).transpose(1, 2))
    return s.view(b, n_kv, g, skv)


def pv_blockdiag(p, v_cache):
    """p·V batched over the lanes: p (B, Hkv, G, S) fp32, v_cache
    (B, S, Hkv, D) -> (B, Hkv, G, D) fp32. ``p`` is split into
    three bf16 terms (:func:`split3_bf16`) stacked as rows, so every
    product is of two bf16 values, exact in fp32; each lane's rows meet
    its cache rows (S, Hkv·D) read once, and the diagonal blocks (h = h')
    of the three terms are summed."""
    b, n_kv, g, skv = p.shape
    d = v_cache.shape[-1]
    parts = split3_bf16(p).view(b, 3 * n_kv * g, skv)
    o = matmul_f32(parts, v_cache.reshape(b, skv, n_kv * d))
    o = o.view(b, 3, n_kv, g, n_kv, d).diagonal(dim1=2, dim2=4).sum(dim=1)
    return o.permute(0, 3, 1, 2)


def decode_attention_local(q, k_cache, v_cache, *, pos, window=0,
                           kv_offset=0, scale=None):
    """Single-token attention over a cache: q (B, Hq, D), cache
    (B, S, Hkv, D), ``pos`` = current absolute position — an int, or a
    (B,) tensor of per-slot positions (continuous batching: each lane
    masks against its own progress). Returns (o, m, l).

    The scores and the output are fp32 sums of the products of q (or p)
    and the cache, as the reference's ``astype(f32)`` einsums. On CUDA in
    bf16 both products are :func:`scores_blockdiag` and
    :func:`pv_blockdiag`, which read the bf16 cache as it lies, where the
    widened einsums would write an fp32 copy of it each step; elsewhere
    the einsums. An int ``pos`` (a cross layer's S - 1) enters the mask as
    a kernel argument, and the masked entries are filled with scalars
    (``masked_fill``), so no tensor is made from host data and the step
    can be captured as a CUDA graph. ``scale``: the scores' (default
    1 / sqrt(D))."""
    b, hq, d = q.shape
    skv, n_kv = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    fused = fused_f32(q, k_cache, v_cache)
    if fused:
        s = scores_blockdiag(q, k_cache) * scale
    else:
        qg = q.reshape(b, n_kv, hq // n_kv, d).float()
        s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    kv_pos = kv_offset + torch.arange(skv, device=q.device)
    pos_b = pos.expand(b)[:, None] if isinstance(pos, torch.Tensor) else pos
    hide = kv_pos[None, :] > pos_b                  # (B or 1, Skv)
    if window > 0:
        hide |= kv_pos[None, :] <= pos_b - window
    hide = hide[:, None, None, :]
    s = s.masked_fill(hide, _NEG)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]).masked_fill_(hide, 0.0)
    l = p.sum(dim=-1)
    if fused:
        o = pv_blockdiag(p, v_cache)
    else:
        o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def decode_attention(q, k_cache, v_cache, *, pos, window=0, scale=None):
    """Decode attention, q: (B, Hq, D) -> (B, Hq, D). Without a mesh, or
    when the cache's length does not divide the 'kv_seq' axes, one local
    call. Under a mesh, flash-decoding: the cache sequence-sharded over
    every 'kv_seq' axis the batch does not use, each shard's normalised
    partial output re-weighted by exp(m - max m)·l and the shards summed
    (``psum``), then divided by the summed weights."""
    ctx = rules.current_ctx()
    mesh = ctx.mesh
    b, hq, d = q.shape
    skv = k_cache.shape[1]
    axes = ctx.mesh_axes("kv_seq")
    if mesh is None or not axes or skv % ctx.axes_size("kv_seq") != 0:
        o, _, _ = decode_attention_local(q, k_cache, v_cache, pos=pos,
                                         window=window, scale=scale)
        return o.reshape(q.shape).to(q.dtype)
    bspec = ctx.spec(("batch",), (b,))[0]
    used = set(rules.spec_axes(bspec))
    axes = tuple(a for a in axes if a not in used) or axes
    qspec = (bspec, None, None)
    cspec = (bspec, axes if len(axes) > 1 else axes[0], None, None)
    # per-slot positions shard with the batch; an int passes as it is
    specs = (qspec, cspec, cspec, (bspec,))

    def f(qq, kk, vv, pp):
        base = rules.axis_index(mesh, axes) * kk.shape[1]
        o, m, l = decode_attention_local(qq, kk, vv, pos=pp, window=window,
                                         kv_offset=base, scale=scale)
        gm = rules.pmax(m, mesh, axes)
        wl = torch.exp(m - gm) * l
        num = rules.psum(o * wl[..., None], mesh, axes)
        den = rules.psum(wl, mesh, axes)
        return num / torch.clamp(den, min=1e-30)[..., None]

    o = rules.shard_map(f, mesh=mesh, in_specs=specs, out_specs=qspec)(
        q, k_cache, v_cache, pos)
    return o.reshape(q.shape).to(q.dtype)
