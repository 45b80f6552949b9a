"""Wrapper of the hand-written CUDA SSD scan kernel (``csrc/ssd_scan.cu``),
the port's counterpart of ``ssd_tpu``.

CPU tensors go to the plain version (``ref.ssd_ref_sequential``); CUDA
tensors launch the kernel or raise. bf16 runs four chunk-parallel CUDA
kernels on the tensor cores (chunk cumsums, chunk states, the scan over
chunks, outputs), for which the wrapper allocates the scratch; fp32 runs
one kernel on the CUDA cores. ``build.launches`` counts calls that
launched under ``"ssd_scan"``, one per call however many CUDA kernels it
runs. Unlike ``ssd_tpu`` the
wrapper neither pads L nor transposes: the kernels mask the ragged last
chunk and read every input through its strides (only the last dim of
each must be contiguous). Under autograd the call goes through
``autograd.SSDFunction`` (the chunked plain scan recomputed and
differentiated, no launch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.autograd import SSDFunction, needs_grad
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential

DTYPES = (torch.float32, torch.bfloat16)
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 4096
MAX_GRID_Y = 65535


def check_args(x, dt, a, bmat, cmat, chunk, init_state=None):
    """What the kernel takes, checked on any device. Raises
    ``ValueError``."""
    given = (x, dt, a, bmat, cmat) + (() if init_state is None
                                      else (init_state,))
    if len({t.device for t in given}) != 1:
        raise ValueError("x, dt, a, B, C and the initial state must lie on "
                         "one device")
    if x.dtype not in DTYPES or bmat.dtype != x.dtype \
            or cmat.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}, {bmat.dtype}, {cmat.dtype}: "
                         f"x, B and C take one of {DTYPES}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt {dt.dtype} and a {a.dtype} must be float32")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 \
            or bmat.dim() not in (3, 4) or bmat.shape != cmat.shape:
        raise ValueError("want x (B, L, H, P), dt (B, L, H), a (H,), "
                         "B and C (B, L, N) or (B, L, G, N)")
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    g = bmat.shape[2] if bmat.dim() == 4 else 1
    if tuple(dt.shape) != (b, l, h) or tuple(a.shape) != (h,) \
            or tuple(bmat.shape[:2]) != (b, l) or l < 1 or h % g:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, B {tuple(bmat.shape)} "
                         "disagree, L is 0, or the groups do not divide "
                         "the heads")
    if p % 4 or p > MAX_P or n % 4 or n > MAX_N:
        raise ValueError(f"head dim {p} and state dim {n}: the kernel takes "
                         f"multiples of 4 up to {MAX_P} and {MAX_N}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    if b > MAX_GRID_Y:
        raise ValueError(f"batch {b} exceeds the grid limit")
    if any(t.stride(-1) != 1 for t in (x, dt, bmat, cmat)) \
            or a.stride(0) != 1:
        raise ValueError("the last dim of every input must be contiguous")
    if init_state is not None and (
            tuple(init_state.shape) != (b, h, p, n)
            or init_state.dtype != torch.float32):
        raise ValueError(f"initial state {tuple(init_state.shape)} "
                         f"{init_state.dtype}: want ({b}, {h}, {p}, {n}) "
                         "float32")


def ssd_cuda(x, dt, a, bmat, cmat, *, chunk=128, init_state=None):
    """x (B, L, H, P); dt (B, L, H) fp32 [post-softplus]; a (H,) fp32
    [negative]; bmat/cmat (B, L, N), or (B, L, G, N) in G groups (head h
    reads group h // (H / G)); the scan continues from
    ``init_state`` (B, H, P, N) fp32, or starts from 0 where it is None
    (``ssd_tpu`` always starts from 0). Returns (y (B, L, H, P) in x's
    dtype, state (B, H, P, N) fp32), as ``ssd_tpu``."""
    if needs_grad(x, dt, a, bmat, cmat, init_state):
        return SSDFunction.apply(_ssd_fwd, chunk, x, dt, a, bmat, cmat,
                                 init_state)
    return _ssd_fwd(x, dt, a, bmat, cmat, chunk, init_state)


def _ssd_fwd(x, dt, a, bmat, cmat, chunk, init_state):
    """The forward: the plain version for CPU tensors, else the kernel."""
    inputs = (x, dt, a, bmat, cmat) + (() if init_state is None
                                       else (init_state,))
    if build.all_cpu(*inputs):
        return ssd_ref_sequential(x, dt, a, bmat, cmat, init_state)
    build.check_cuda("ssd_cuda", *inputs)
    check_args(x, dt, a, bmat, cmat, chunk, init_state)
    b, l, h, p = x.shape
    n = bmat.shape[-1]
    if bmat.dim() == 3:              # one group
        bmat, cmat = bmat.unsqueeze(2), cmat.unsqueeze(2)
    q = min(int(chunk), l)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    none = state.new_empty(0)
    init = none if init_state is None else init_state.contiguous()
    if x.dtype == torch.bfloat16:
        # per position seg, dt and the tile-relative decay (head-major),
        # each chunk's own state, and the state before each chunk as two
        # bf16 parts (hi, lo)
        nc = -(-l // q)
        keys = torch.empty((3, b, h, l), dtype=torch.float32,
                           device=x.device)
        cstate = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                             device=x.device)
        prev = torch.empty((2, b, nc, h, p, n), dtype=torch.bfloat16,
                           device=x.device)
    else:
        keys = cstate = prev = none
    build.extension().ssd_scan_fwd(x, dt, a, bmat, cmat, y, state, init,
                                   keys, cstate, prev, q)
    build.launches["ssd_scan"] += 1
    return y, state
