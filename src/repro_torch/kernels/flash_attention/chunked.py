"""Wrapper of the hand-written CUDA two-pass attention kernel
(``csrc/chunked_attention.cu``), the port's counterpart of
``chunked_attention_tpu``: the same function as the flash kernel by a lazy
two-pass softmax (K read twice, no accumulator rescale), a separate
implementation point on the scheduler's variant axis.

CPU tensors go to the plain version (``ref.attention_kernel_ref``); CUDA
tensors launch the kernel or raise. Like the flash kernel it runs bf16 on
the tensor cores and fp32 on the CUDA cores; ``launches`` counts the
kernel's launches. Under autograd the call goes through
``autograd.AttentionFunction``, as the flash kernel's does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.autograd import AttentionFunction, needs_grad
from repro_torch.kernels.flash_attention.kernel import check_args
from repro_torch.kernels.flash_attention.ref import attention_kernel_ref

launches = 0


def chunked_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                           scale=None):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D), with the
    flash wrapper's contract: any strides with the head dim contiguous; on
    CUDA the output is a (B, Sq, Hq, D) tensor's transposed view."""
    if needs_grad(q, k, v):
        return AttentionFunction.apply(_chunked_fwd, q, k, v, bool(causal),
                                       int(window), int(q_offset), scale)
    return _chunked_fwd(q, k, v, causal, window, q_offset, scale)


def _chunked_fwd(q, k, v, causal, window, q_offset=0, scale=None):
    """The forward: the plain version for CPU tensors, else the kernel;
    the scores scaled by ``scale`` (default 1 / sqrt(D))."""
    if build.all_cpu(q, k, v):
        return attention_kernel_ref(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, scale=scale)
    build.check_cuda("chunked_attention_cuda", q, k, v)
    check_args(q, k, v, window, q_offset)
    global launches
    b, hq, sq, d = q.shape
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    ot = out.transpose(1, 2)
    build.extension().chunked_attention_fwd(q, k, v, ot, bool(causal),
                                            int(window),
                                            1.0 / math.sqrt(d) if scale is None
                                            else float(scale),
                                            int(q_offset))
    launches += 1
    return ot
