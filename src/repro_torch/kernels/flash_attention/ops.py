"""Public wrappers of the two attention kernels in the framework layout.

Take (B, S, H, D) and hand the kernels ``transpose(1, 2)`` views: the
kernels read through strides, so no transposed copy is made (the
reference's ``ops.py`` materialises three)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.chunked import chunked_attention_cuda
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    scale=None):
    """q (B, Sq, Hq, D); k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D), query row
    r at position r + ``q_offset``, the scores scaled by ``scale``
    (default 1 / sqrt(D))."""
    o = flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             q_offset=q_offset, scale=scale)
    return o.transpose(1, 2)


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      scale=None):
    """The two-pass kernel, same layout and function as
    :func:`flash_attention`."""
    o = chunked_attention_cuda(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window, q_offset=q_offset, scale=scale)
    return o.transpose(1, 2)
