"""Wrapper of the hand-written CUDA two-pass attention kernel
(``csrc/chunked_attention.cu``), the port's counterpart of
``chunked_attention_tpu``: the same function as the flash kernel by a lazy
two-pass softmax (K read twice, no accumulator rescale), a separate
implementation point on the scheduler's variant axis.

CPU tensors go to the plain version (``ref.attention_kernel_ref``); CUDA
tensors launch the kernel or raise. Like the flash kernel it runs bf16 on
the tensor cores and fp32 on the CUDA cores, through the flash wrapper's
forward body (``kernel.attention_fwd``); ``build.launches`` counts its
launches under ``"chunked_attention"``. Under autograd the call goes
through ``autograd.AttentionFunction``, as the flash kernel's does.
"""
from __future__ import annotations

import functools

from repro_torch.kernels.autograd import AttentionFunction, needs_grad
from repro_torch.kernels.flash_attention.kernel import attention_fwd

_chunked_fwd = functools.partial(attention_fwd, "chunked_attention")


def chunked_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                           scale=None):
    """q (B, Hq, Sq, D); k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D), with the
    flash wrapper's contract: any strides with the head dim contiguous; on
    CUDA the output is a (B, Sq, Hq, D) tensor's transposed view."""
    if needs_grad(q, k, v):
        return AttentionFunction.apply(_chunked_fwd, q, k, v, bool(causal),
                                       int(window), int(q_offset), scale)
    return _chunked_fwd(q, k, v, causal, window, q_offset, scale)
