"""Wrapper of the hand-written CUDA kernel of Mamba2's one-token decode
update (``csrc/ssd_decode.cu``): the fp32 state updated in place, y
contracted in the same pass.

It replaces no TPU kernel: the reference's decode update is plain JAX
(``repro/models/ssm.py`` ``ssd_decode_step``). It is bound by the state's
bytes, read once and written once; the source says how its design meets
that bound. CPU tensors go to the plain version (``ref.ssd_decode_step``,
its new state written back into the given one); CUDA tensors launch the
kernel or raise. ``build.launches`` counts its launches under
``"ssd_decode"``. The model takes it where ``models.ssm.decode_route``
holds (``build.route``: no DTensor, then arguments the kernel takes,
:func:`takes`, one definition with the checks, then nothing autograd
records).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step

DTYPES = (torch.float32, torch.bfloat16)
NS = (16, 64, 128)      # the state dims the kernel is built for: the
                        # smoke configs', zamba2's, mamba2-1.3b's
MAX_GRID_X = 2 ** 31 - 1


def refusal(state, x, dt, a, bmat, cmat) -> str | None:
    """Why the kernel does not take these arguments, or None where it
    does, on any device: it takes state (B, H, P, N) fp32, contiguous and
    16-byte aligned, N in ``NS``; x (B, H, P) in one of ``DTYPES``, B and
    C (B, N) or (B, G, N) of x's dtype, G dividing H; dt (B, H) and a (H,)
    fp32; the last dim of each input contiguous; all on one device."""
    given = (state, x, dt, a, bmat, cmat)
    if len({t.device for t in given}) != 1:
        return "the state, x, dt, a, B and C must lie on one device"
    if state.dtype != torch.float32 or dt.dtype != torch.float32 \
            or a.dtype != torch.float32:
        return f"state {state.dtype}, dt {dt.dtype}, a {a.dtype}: want " \
            "float32"
    if x.dtype not in DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        return f"dtypes {x.dtype}, {bmat.dtype}, {cmat.dtype}: x, B and C " \
            f"take one of {DTYPES}"
    if state.dim() != 4 or x.dim() != 3 or dt.dim() != 2 or a.dim() != 1 \
            or bmat.dim() not in (2, 3) or bmat.shape != cmat.shape:
        return "want state (B, H, P, N), x (B, H, P), dt (B, H), a (H,), " \
            "B and C (B, N) or (B, G, N)"
    b, h, p, n = state.shape
    g = bmat.shape[1] if bmat.dim() == 3 else 1
    if tuple(x.shape) != (b, h, p) or tuple(dt.shape) != (b, h) \
            or tuple(a.shape) != (h,) or bmat.shape[0] != b \
            or bmat.shape[-1] != n or h % g or not b * h * p:
        return f"shapes state {tuple(state.shape)}, x {tuple(x.shape)}, " \
            f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, B " \
            f"{tuple(bmat.shape)} disagree, one is empty, or the groups " \
            "do not divide the heads"
    if n not in NS:
        return f"state dim {n}: the kernel is built for {NS}"
    if b * h > MAX_GRID_X:
        return f"{b} x {h} tiles exceed the grid limit"
    if not state.is_contiguous() or state.data_ptr() % 16:
        return "the state must be contiguous and 16-byte aligned"
    if any(t.stride(-1) != 1 for t in given[1:]):
        return "the last dim of every input must be contiguous"
    return None


def takes(state, x, dt, a, bmat, cmat) -> bool:
    """Whether the kernel takes this update: a CUDA state, and arguments
    :func:`refusal` finds nothing against."""
    return state.is_cuda and refusal(state, x, dt, a, bmat, cmat) is None


def check_args(state, x, dt, a, bmat, cmat) -> None:
    """Raises ``ValueError`` with :func:`refusal`'s reason where the kernel
    does not take these arguments."""
    why = refusal(state, x, dt, a, bmat, cmat)
    if why is not None:
        raise ValueError(why)


def ssd_decode_update(state, x, dt, a, bmat, cmat):
    """One token's update of ``state`` (B, H, P, N) fp32, in place: x (B, H,
    P); dt (B, H) fp32 [post-softplus]; a (H,) fp32 [negative]; B and C (B,
    N), or (B, G, N) in G groups (head h reads group h // (H / G)). Returns
    y (B, H, P) fp32; the state then holds ``ssd_decode_step``'s new state,
    bit for bit."""
    if build.all_cpu(state, x, dt, a, bmat, cmat):
        y, new_state = ssd_decode_step(state, x, dt, a, bmat, cmat)
        state.copy_(new_state)
        return y
    build.check_cuda("ssd_decode_update", state, x, dt, a, bmat, cmat)
    check_args(state, x, dt, a, bmat, cmat)
    if bmat.dim() == 2:              # one group
        bmat, cmat = bmat.unsqueeze(1), cmat.unsqueeze(1)
    y = torch.empty(state.shape[:3], dtype=torch.float32,
                    device=state.device)
    build.extension().ssd_decode_update(state, y, x, dt, a, bmat, cmat)
    build.launches["ssd_decode"] += 1
    return y
