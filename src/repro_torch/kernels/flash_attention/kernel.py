"""Wrapper of the hand-written CUDA flash-attention kernel
(``csrc/flash_attention.cu``), the port's counterpart of
``flash_attention_tpu``.

CPU tensors go to the plain version (``ref.attention_kernel_ref``: a row
that sees no key gives 0, as in the kernel); CUDA tensors launch the
kernel or raise. The kernel runs bf16 on the tensor cores (``wgmma``) and
fp32 on the CUDA cores, one entry point for both; ``build.launches``
counts its launches under ``"flash_attention"``. Under autograd the call
goes through ``autograd.AttentionFunction`` (plain backward, no launch).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.autograd import AttentionFunction, needs_grad
from repro_torch.kernels.flash_attention.ref import attention_kernel_ref

# the head dims both kernels instantiate (stablelm-3b 80, the zamba2
# variant's shared attention 112, Zyphra's zamba2 224, gemma3 256); the
# smoke configs' 16 runs only on the CPU, through the plain version, and
# raises here on CUDA
HEAD_DIMS = (32, 64, 80, 112, 128, 224, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_YZ = 65535


def check_args(q, k, v, window, q_offset=0):
    """What both attention kernels take, checked on any device: dtypes,
    shapes, head dim, grid limits, a contiguous head dim. Raises
    ``ValueError``."""
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the "
                         f"kernel takes one of {DTYPES} for all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}: want q (B, Hq, Sq, D) and "
                         "k, v (B, Hkv, Skv, D)")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[2] < 1 or sq < 1:
        raise ValueError("q and k/v disagree in batch or head dim, or a "
                         "sequence is empty")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if hq % k.shape[1]:
        raise ValueError(f"{hq} q heads are no multiple of {k.shape[1]} "
                         "kv heads")
    if b > MAX_GRID_YZ or hq > MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {hq} exceed the grid limit")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the head dim must be contiguous (stride 1)")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if not 0 <= q_offset < 2 ** 31 - sq:
        raise ValueError(f"query offset {q_offset} out of range")


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                         scale=None):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    Any strides with the head dim contiguous: a (B, S, H, D) tensor's
    ``transpose(1, 2)`` view is read in place. On CUDA the output is
    allocated as (B, Sq, Hq, D) and returned as its transposed view, so
    ``.transpose(1, 2)`` gives the model's layout with no copy.

    ``q_offset``: query row r sits at position r + ``q_offset`` under the
    causal and window masks, against keys at 0..Skv-1 (a sequence shard's
    queries against the gathered K/V)."""
    if needs_grad(q, k, v):
        return AttentionFunction.apply(_flash_fwd, q, k, v, bool(causal),
                                       int(window), int(q_offset), scale)
    return _flash_fwd(q, k, v, causal, window, q_offset, scale)


def attention_fwd(key, q, k, v, causal, window, q_offset=0, scale=None):
    """The forward of both attention kernels, ``key`` naming which:
    ``"flash_attention"`` or ``"chunked_attention"``, its wrapper
    ``<key>_cuda``, its extension entry ``<key>_fwd`` and its count in
    ``build.launches``. The plain version for CPU tensors, else the
    kernel; the scores scaled by ``scale`` (default 1 / sqrt(D))."""
    if build.all_cpu(q, k, v):
        return attention_kernel_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    build.check_cuda(f"{key}_cuda", q, k, v)
    check_args(q, k, v, window, q_offset)
    b, hq, sq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    ot = out.transpose(1, 2)
    getattr(build.extension(), f"{key}_fwd")(
        q, k, v, ot, bool(causal), int(window),
        1.0 / math.sqrt(d) if scale is None else float(scale), int(q_offset))
    build.launches[key] += 1
    return ot


_flash_fwd = functools.partial(attention_fwd, "flash_attention")
