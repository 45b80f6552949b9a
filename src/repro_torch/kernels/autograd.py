"""Gradients through the hand-written kernels.

Each kernel wrapper (flash, two-pass, SSD scan) goes through one of these
``torch.autograd.Function``s whenever grad mode is on and an input requires
a gradient; otherwise it calls its forward directly. The Function takes
the forward as an argument: on CUDA tensors the wrapper hands it the
kernel's launch, on CPU tensors the kernel's plain version, so both
devices run the same backward.

The backward is plain PyTorch, as in the reference: the JAX package has
no backward kernel, and its training differentiates ``flash_attention_xla``
and ``ssd_ref`` with XLA's autodiff, outside any Pallas kernel.
  - attention: ``ref.attention_kernel_bwd_ref``, blocked over query tiles
    from the saved q, k, v and output;
  - SSD scan: the chunked plain ``models.ssm.ssd_ref`` recomputed under
    ``torch.enable_grad()`` and differentiated by ``torch.autograd.grad``;
    the initial state and the returned state keep their gradients.
Neither backward launches a kernel, so ``build.launches`` counts forward
launches only (with per-layer remat, the forward and its recompute).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import attention_kernel_bwd_ref


def needs_grad(*tensors) -> bool:
    """Whether a wrapper's call is part of a graph that autograd will
    differentiate: grad mode on and some input requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class AttentionFunction(torch.autograd.Function):
    """``apply(fwd, q, k, v, causal, window, q_offset, scale)`` -> ``fwd(q,
    k, v, causal, window, q_offset, scale)``, the kernels' layout (B, H, S,
    D); the backward is :func:`attention_kernel_bwd_ref`."""

    @staticmethod
    def forward(ctx, fwd, q, k, v, causal, window, q_offset, scale=None):
        o = fwd(q, k, v, causal, window, q_offset, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = attention_kernel_bwd_ref(
            q, k, v, o, do, causal=ctx.causal, window=ctx.window,
            q_offset=ctx.q_offset, scale=ctx.scale)
        return None, dq, dk, dv, None, None, None, None


class SSDFunction(torch.autograd.Function):
    """``apply(fwd, chunk, x, dt, a, bmat, cmat, init_state)`` -> ``fwd(x,
    dt, a, bmat, cmat, chunk, init_state)`` = (y, state); the backward
    recomputes ``ssd_ref`` at the same chunk and differentiates it."""

    @staticmethod
    def forward(ctx, fwd, chunk, x, dt, a, bmat, cmat, init_state):
        y, state = fwd(x, dt, a, bmat, cmat, chunk, init_state)
        ctx.save_for_backward(x, dt, a, bmat, cmat, init_state)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        # models.ssm imports the SSD wrapper, which imports this module
        from repro_torch.models.ssm import ssd_ref

        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(w)
                      for t, w in zip(saved, wants)]
            y, state = ssd_ref(*leaves[:5], chunk=ctx.chunk,
                               init_state=leaves[5])
            inputs = [t for t, w in zip(leaves, wants) if w]
            grads = iter(torch.autograd.grad(
                (y, state), inputs, (dy.to(y.dtype), dstate),
                allow_unused=True, materialize_grads=True))
        return (None, None) + tuple(next(grads) if w else None
                                    for w in wants)
