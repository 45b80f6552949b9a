"""Wrappers of the hand-written CUDA kernels of the sequence forward's
pointwise ops (``csrc/pointwise.cu``): RMSNorm, the residual add fused with
RMSNorm, RoPE on q and k, and SwiGLU's gate.

They replace no TPU kernel: the reference's plain ops
(``models/layers.py``), which XLA fuses, run here in one pass each over
bf16, with no fp32 copy in device memory. CPU tensors go to the plain ops;
CUDA bf16 tensors launch the kernel or raise. ``build.launches`` counts
each kernel's launches under its wrapper's name less ``_cuda``. The model
takes them only where ``models.transformer.fused_route`` holds
(``build.route`` with :func:`takes`, and more than one position):
training keeps the plain ops and their gradients, the decode step its
present ops.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.models.layers import apply_rope, rms_norm

VEC = 8                 # bf16 values in one of the kernels' 16-byte accesses
MAX_D = 16384           # the widest row the norm holds in registers
SCALE_DTYPES = (torch.bfloat16, torch.float32)
MAX_GRID_X = 2 ** 31 - 1


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take a tensor's device and dtype: CUDA, bf16."""
    return x.is_cuda and x.dtype == torch.bfloat16


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def check_norm_args(x, scale, y=None):
    """What both norm kernels take, checked on any device: x (and y) bf16
    (..., D), contiguous, D a multiple of 8 up to ``MAX_D``; scale (D,)
    bf16 or fp32, contiguous. Raises ``ValueError``."""
    given = (x, scale) if y is None else (x, y, scale)
    if len({t.device for t in given}) != 1:
        raise ValueError("x, y and scale must lie on one device")
    if x.dtype != torch.bfloat16 or (y is not None and y.dtype != x.dtype):
        raise ValueError(f"dtype {x.dtype}: the norm kernels take bf16")
    if scale.dtype not in SCALE_DTYPES:
        raise ValueError(f"scale dtype {scale.dtype}: want one of "
                         f"{SCALE_DTYPES}")
    d = x.shape[-1] if x.dim() else 0
    if y is not None and y.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    if tuple(scale.shape) != (d,) or d % VEC or not 0 < d <= MAX_D:
        raise ValueError(f"row width {d}, scale {tuple(scale.shape)}: the "
                         f"kernel takes a multiple of {VEC} up to {MAX_D}")
    if not 0 < x.numel() // d <= MAX_GRID_X:
        raise ValueError(f"{x.numel() // d} rows: want 1 to {MAX_GRID_X}")
    if not all(t.is_contiguous() for t in given) or not _aligned(*given):
        raise ValueError("x, y and scale must be contiguous and 16-byte "
                         "aligned")


def check_rope_args(q, k, sin, cos):
    """What the RoPE kernel takes, checked on any device: q (B, S, Hq, D)
    and k (B, S, Hkv, D) bf16 with D / 2 a multiple of 8, each head's row
    contiguous and 16-byte aligned; sin and cos fp32, (S, D/2) or (B, S,
    D/2), last dim contiguous. Raises ``ValueError``."""
    if len({t.device for t in (q, k, sin, cos)}) != 1:
        raise ValueError("q, k, sin and cos must lie on one device")
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}: the kernel takes "
                         "bf16 q and k")
    if sin.dtype != torch.float32 or cos.dtype != torch.float32:
        raise ValueError(f"tables {sin.dtype}, {cos.dtype}: want float32")
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}: want "
                         "(B, S, Hq, D) and (B, S, Hkv, D)")
    b, s, _, d = q.shape
    want = ((s, d // 2), (b, s, d // 2))
    if sin.shape != cos.shape or tuple(sin.shape) not in want:
        raise ValueError(f"tables {tuple(sin.shape)}, {tuple(cos.shape)}: "
                         f"want {want[0]} or {want[1]}")
    if d % (2 * VEC) or b * s > MAX_GRID_X:
        raise ValueError(f"head dim {d} or {b} x {s} positions: the kernel "
                         f"takes head dims that are multiples of {2 * VEC}")
    if any(t.stride(-1) != 1 for t in (q, k, sin, cos)):
        raise ValueError("the last dim of q, k and the tables must be "
                         "contiguous")
    if any(st % VEC for t in (q, k) for st in t.stride()[:3]) \
            or any(st % 4 for t in (sin, cos) for st in t.stride()[:-1]) \
            or not _aligned(q, k, sin, cos):
        raise ValueError("every head's row of q and k, and every row of "
                         "the tables, must be 16-byte aligned")


def check_swiglu_args(g, u):
    """What the SwiGLU gate kernel takes, checked on any device: g and u
    bf16 of one shape, contiguous, their size a multiple of 8. Raises
    ``ValueError``."""
    if g.device != u.device:
        raise ValueError("g and u must lie on one device")
    if g.dtype != torch.bfloat16 or u.dtype != g.dtype:
        raise ValueError(f"dtypes {g.dtype}, {u.dtype}: the kernel takes "
                         "bf16")
    if g.shape != u.shape or g.numel() % VEC or not g.numel():
        raise ValueError(f"shapes {tuple(g.shape)}, {tuple(u.shape)}: want "
                         f"one shape of a size that is a multiple of {VEC}")
    if not (g.is_contiguous() and u.is_contiguous()) or not _aligned(g, u):
        raise ValueError("g and u must be contiguous and 16-byte aligned")


def rms_norm_cuda(x, scale, eps=1e-6):
    """``models.layers.rms_norm`` in one pass: x (..., D) bf16, scale (D,)
    -> (..., D) bf16."""
    if build.all_cpu(x, scale):
        return rms_norm(x, scale, eps)
    build.check_cuda("rms_norm_cuda", x, scale)
    check_norm_args(x, scale)
    h = torch.empty_like(x)
    empty = x.new_empty(0)
    build.extension().rms_norm_fwd(x, empty, empty, h, scale, float(eps))
    build.launches["rms_norm"] += 1
    return h


def add_rms_norm_cuda(x, y, scale, eps=1e-6):
    """The residual add and the next RMSNorm in one pass: (x + y in x's
    dtype, ``rms_norm(x + y, scale, eps)``), the norm taken of the rounded
    sum, as the plain add followed by the norm takes it."""
    if build.all_cpu(x, y, scale):
        s = x + y
        return s, rms_norm(s, scale, eps)
    build.check_cuda("add_rms_norm_cuda", x, y, scale)
    check_norm_args(x, scale, y)
    s, h = torch.empty_like(x), torch.empty_like(x)
    build.extension().rms_norm_fwd(x, y, s, h, scale, float(eps))
    build.launches["add_rms_norm"] += 1
    return s, h


def rope_qk_cuda(q, k, sin, cos):
    """``models.layers.apply_rope`` of q (B, S, Hq, D) and of k (B, S, Hkv,
    D) in one launch, tables (S, D/2) or (B, S, D/2) fp32. Returns the
    rotated (q, k): on CUDA q and k themselves, rotated in place."""
    if build.all_cpu(q, k, sin, cos):
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    build.check_cuda("rope_qk_cuda", q, k, sin, cos)
    check_rope_args(q, k, sin, cos)
    build.extension().rope_qk_fwd(q, k, sin, cos)
    build.launches["rope_qk"] += 1
    return q, k


def swiglu_gate_cuda(g, u):
    """SwiGLU's gate in one pass: ``F.silu(g) * u``, silu rounded to g's
    dtype before the product as ``F.silu`` rounds it."""
    if build.all_cpu(g, u):
        return F.silu(g) * u
    build.check_cuda("swiglu_gate_cuda", g, u)
    check_swiglu_args(g, u)
    out = torch.empty_like(g)
    build.extension().swiglu_gate_fwd(g, u, out)
    build.launches["swiglu_gate"] += 1
    return out
