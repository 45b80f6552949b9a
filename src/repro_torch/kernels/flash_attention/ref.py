"""Plain PyTorch versions of the attention kernels (standalone)."""
from __future__ import annotations

import math

import torch


def _visible(sq, skv, causal, window, device, q_offset=0):
    """(Sq, Skv) bool: which keys each query sees under the mask, query
    row r at position r + ``q_offset``."""
    q_pos = torch.arange(sq, device=device)[:, None]
    if q_offset:
        q_pos = q_pos + q_offset
    kv_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kv_pos <= q_pos
    if window > 0:
        mask &= kv_pos > q_pos - window
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                  scale=None):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D), query row
    r at position r + ``q_offset`` (a sequence shard's start), the scores
    scaled by ``scale`` (default 1 / sqrt(D)). A row that sees no key gets
    the mean of V, as the reference's ``attention_ref``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    mask = _visible(sq, skv, causal, window, q.device, q_offset)
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype)


def attention_kernel_ref(q, k, v, *, causal=True, window=0, q_offset=0,
                         scale=None):
    """The kernels' function: ``attention_ref`` with every row that sees no
    key under ``causal`` and ``window`` set to 0, as the Pallas kernels
    (``flash_attention_tpu``, ``chunked_attention_tpu``) and the CUDA
    bodies give it."""
    out = attention_ref(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, scale=scale)
    empty = ~_visible(q.shape[2], k.shape[2], causal, window, q.device,
                      q_offset).any(-1)
    return out.masked_fill(empty[:, None], 0)


def _bmm_f32(a, b):
    """``a.float() @ b.float()`` for 3-D operands batched along dim 0; two
    bf16 operands on CUDA take cuBLAS's product with fp32 output, which
    writes no widened copy (each product of two bf16 values is exact in
    fp32)."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def attention_kernel_bwd_ref(q, k, v, o, do, *, causal=True, window=0,
                             q_offset=0, q_tile=512, scale=None):
    """The gradient of :func:`attention_kernel_ref` with respect to q, k
    and v: (dq, dk, dv) in the inputs' dtypes, computed from the saved q,
    k, v, the forward's output ``o`` and the output's gradient ``do``, all
    in the kernels' (B, H, S, D) layout, any strides.

    Query row r sits at position r + ``q_offset``, as in the forward.
    Blocked over tiles of ``q_tile`` queries, so that no (Sq x Skv) matrix
    is ever whole: each tile reads only the keys its rows can reach (the
    causal top, the window's bottom), recomputes its scores and softmax in
    fp32, then with D = rowsum(dO * O) and dS = P * (dO V^T - D) adds
    dV += P^T dO, dK += dS^T Q s and writes dQ = dS K s, the scores'
    scale s = ``scale`` (default 1 / sqrt(d)).
    The q heads of a GQA group are laid out as extra rows of their kv
    head's products, so dK and dV sum over the group. A row that sees no
    key has P = 0 (the kernels' zero output) and a zero gradient."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    dev = q.device
    delta = (do.float() * o.float()).sum(-1).reshape(b, hkv, g, sq)
    dq = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b * hkv, skv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b * hkv, skv, d), dtype=torch.float32, device=dev)
    kb = k.reshape(b * hkv, skv, d)
    vb = v.reshape(b * hkv, skv, d)
    qg = q.reshape(b, hkv, g, sq, d)
    dog = do.reshape(b, hkv, g, sq, d)
    for a0 in range(0, sq, q_tile):
        a1 = min(a0 + q_tile, sq)
        t = a1 - a0
        hi = min(skv, q_offset + a1) if causal else skv
        lo = max(0, q_offset + a0 - window + 1) if window > 0 else 0
        if hi <= lo:
            continue
        qt = qg[:, :, :, a0:a1].reshape(b * hkv, g * t, d)
        dot = dog[:, :, :, a0:a1].reshape(b * hkv, g * t, d)
        kt, vt = kb[:, lo:hi], vb[:, lo:hi]
        mask = _visible(a1, hi, causal, window, dev, q_offset)[a0:, lo:]
        s = _bmm_f32(qt, kt.transpose(1, 2)).view(b * hkv, g, t, hi - lo)
        s = s.mul_(scale).masked_fill_(~mask, -torch.inf)
        m = s.amax(-1, keepdim=True).nan_to_num_(neginf=0.0)
        p = s.sub_(m).exp_()
        p = p.div_(p.sum(-1, keepdim=True).clamp_(min=1e-30))
        p = p.view(b * hkv, g * t, hi - lo)
        dv[:, lo:hi] += p.transpose(1, 2) @ dot.float()
        dp = _bmm_f32(dot, vt.transpose(1, 2))
        dlt = delta[:, :, :, a0:a1].reshape(b * hkv, g * t, 1)
        ds = p.mul_(dp.sub_(dlt))
        dq[:, :, :, a0:a1] = (ds @ kt.float()).mul_(scale).view(
            b, hkv, g, t, d)
        dk[:, lo:hi] += (ds.transpose(1, 2) @ qt.float()).mul_(scale)
    return (dq.view(b, hq, sq, d).to(q.dtype),
            dk.view(b, hkv, skv, d).to(k.dtype),
            dv.view(b, hkv, skv, d).to(v.dtype))
