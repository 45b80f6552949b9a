"""Mixture-of-Experts FFN, counterpart of the no-mesh (``local``) path of
``repro.models.moe``.

Routing is top-k softmax (normalised over the k chosen experts) with a
fixed per-expert capacity C = ceil(T·k/E · capacity_factor); an assignment
whose rank among its expert's assignments, in (token, choice) order, is C
or more is dropped (its combine weight meets a zero row), as in
Switch/GShard. So capacity drops an assignment wherever more than C of a
step's T tokens pick one expert: at decode (T = 32, k = 10, E = 72, C = 6)
that happens in most steps. With ``MoEConfig.dropless`` C is T, which no
expert can exceed (a token picks an expert at most once): nothing is ever
dropped. Tokens are scattered into (E, C, D) buffers, every expert's
SwiGLU runs as one batched product (``torch.bmm``; the reference's
``einsum``s run outside any kernel, so there is no hand-written kernel
here), and the results are gathered back and weight-summed per token.

Everything is computed on the device from static shapes: the capacity is a
Python int of the token count, and there is no ``.item()``, no
``nonzero`` and no branch on a device value, so a decode step through this
layer can be captured as a CUDA graph. One exception, outside any decode
step: a dropless layer over more than ``DROPLESS_STATIC_T`` tokens (a
prefill, whose E x T rows would not fit beside the weights) reads the
step's largest per-expert count on the host and sizes C by it, which
still drops nothing.

Under a mesh, ``moe_apply`` takes the reference's expert-parallel
branches, each a ``shard_map`` whose routing and dispatch run on local
tensors through the pieces above:
  - ``a2a`` (train / prefill): tokens sequence-sharded over the experts'
    axis; dispatch buffers move to their experts' ranks by all-to-all, the
    local experts run, and the results come back the same way;
  - ``psum`` (decode, or a sequence that does not divide the axis): every
    rank routes the same tokens, runs only its own experts, and one psum
    combines the partial outputs; ``_moe_psum_multi`` when the experts
    span several mesh axes;
  - ``_moe_decode_2d``: experts over 'experts', their FF dim over
    'expert_ff' (the decode rules of the MoE giants), one psum over all.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import MoEConfig
from repro_torch.obs.ranges import profiler_range
from repro_torch.sharding import rules

# the most tokens over which a dropless layer keeps C = T (static, capture
# safe); above it C is the step's largest per-expert count, read on the host
DROPLESS_STATIC_T = 512


def route(x2d: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """(weights (T, k) fp32, experts (T, k) int64): the top-k of the fp32
    router logits, sorted in descending order, and the softmax over them.

    ``torch.topk`` and ``jax.lax.top_k`` both sort descending; on equal
    logits their order is not promised to agree. Seeded fp32 data has no
    ties."""
    logits = x2d.float() @ w_router.float()
    gates, experts = torch.topk(logits, top_k, dim=-1)
    return torch.softmax(gates, dim=-1), experts


def _capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Assignments an expert takes in a step of ``n_tokens``: all of them
    when ``dropless``, else ceil(T·k/E · capacity_factor)."""
    if cfg.dropless:
        return max(n_tokens, 1)
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(int(c), 1)


def _largest_count(experts: torch.Tensor, n_experts: int) -> int:
    """The most assignments any expert has in ``experts`` (T, k), read on
    the host: a dropless prefill's capacity."""
    counts = torch.bincount(experts.reshape(-1), minlength=n_experts)
    return max(int(counts.max()), 1)


def _dispatch_indices(experts: torch.Tensor, n_experts: int,
                      capacity: int) -> torch.Tensor:
    """Flat buffer slot (in [0, E*C); E*C = dropped) per (token, choice):
    ``e * C + rank``, where ``rank`` is the assignment's rank within its
    expert e in (token, choice) order: its place in a stable sort of the
    flat choices by expert, less the place where e's run starts. These are
    the integers of the reference's one-hot cumsum, without its (T·k, E)
    temporary and the scan across it."""
    t, k = experts.shape
    flat_e = experts.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(
        n_experts, device=flat_e.device, dtype=flat_e.dtype))
    ranks = torch.empty_like(flat_e).scatter_(
        0, order, torch.arange(t * k, device=flat_e.device,
                               dtype=flat_e.dtype) - starts[sorted_e])
    slot = (flat_e * capacity + ranks).masked_fill_(ranks >= capacity,
                                                    n_experts * capacity)
    return slot.reshape(t, k)


def _expert_ffn(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """buf (E, C, D) through each expert's SwiGLU: w_gate / w_up (E, D, F),
    w_down (E, F, D)."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _dispatch(x2d: torch.Tensor, slot: torch.Tensor, n_experts: int,
              capacity: int) -> torch.Tensor:
    """Scatter tokens (T, D) into buffers (E*C, D). Every dropped
    assignment writes row E*C, which is cut off and never read (so its
    duplicate writes do not matter)."""
    d = x2d.shape[1]
    k = slot.shape[1]
    buf = x2d.new_zeros((n_experts * capacity + 1, d))
    buf.index_copy_(0, slot.reshape(-1), x2d.repeat_interleave(k, dim=0))
    return buf[:-1]


def _combine(out_buf: torch.Tensor, slot: torch.Tensor,
             weights: torch.Tensor, t: int, d: int) -> torch.Tensor:
    """Gather the expert outputs (E*C, D) back per (token, choice), a
    dropped one as a zero row, and weight-sum them per token with the
    weights cast to the buffer's dtype."""
    k = slot.shape[1]
    padded = torch.cat([out_buf, out_buf.new_zeros((1, d))], dim=0)
    per_choice = padded[slot.reshape(-1)].reshape(t, k, d)
    return torch.einsum("tk,tkd->td", weights.to(per_choice.dtype),
                        per_choice)


def moe_local(x2d: torch.Tensor, params: dict, cfg: MoEConfig
              ) -> torch.Tensor:
    """x2d (T, D) -> (T, D) in its dtype. ``params``: ``router`` (D, E),
    ``w_gate`` / ``w_up`` (E, D, F), ``w_down`` (E, F, D). While a
    profiler records, its three parts are ranges (``moe/...``)."""
    t, d = x2d.shape
    with profiler_range("moe/route_dispatch"):
        weights, experts = route(x2d, params["router"], cfg.top_k)
        cap = _capacity(t, cfg)
        if cfg.dropless and t > DROPLESS_STATIC_T:
            cap = _largest_count(experts, cfg.n_experts)
        slot = _dispatch_indices(experts, cfg.n_experts, cap)
        buf = _dispatch(x2d, slot, cfg.n_experts, cap)
    with profiler_range("moe/experts"):
        out = _expert_ffn(buf.reshape(cfg.n_experts, cap, d),
                          params["w_gate"], params["w_up"], params["w_down"])
    with profiler_range("moe/combine"):
        return _combine(out.reshape(-1, d), slot, weights, t,
                        d).to(x2d.dtype)


def moe_dense_oracle(x2d: torch.Tensor, params: dict, cfg: MoEConfig
                     ) -> torch.Tensor:
    """Capacity-free reference: every token through its top-k experts, one
    expert at a time, accumulated in fp32."""
    weights, experts = route(x2d, params["router"], cfg.top_k)
    out = torch.zeros(x2d.shape, dtype=torch.float32, device=x2d.device)
    for e in range(cfg.n_experts):
        h = F.silu(x2d @ params["w_gate"][e]) * (x2d @ params["w_up"][e])
        y = (h @ params["w_down"][e]).float()
        w_e = torch.where(experts == e, weights, 0.0).sum(dim=-1)
        out += w_e[:, None] * y
    return out.to(x2d.dtype)


def moe_apply(x: torch.Tensor, params: dict, cfg: MoEConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D), the variant chosen from the sharding
    context: without a mesh (or with experts that do not divide their
    axes) :func:`moe_local` over the B·S tokens."""
    ctx = rules.current_ctx()
    mesh = ctx.mesh
    b, s, d = x.shape
    axes = ctx.mesh_axes("experts")
    if mesh is None or not axes or cfg.n_experts % ctx.axes_size("experts"):
        return moe_local(x.reshape(-1, d), params, cfg).reshape(b, s, d)
    bspec = ctx.spec(("batch",), (b,))[0]
    f_axes = tuple(a for a in ctx.mesh_axes("expert_ff")
                   if cfg.d_ff_expert % ctx.axes_size("expert_ff") == 0)
    if f_axes:
        return _moe_decode_2d(x, params, cfg, axes, f_axes)
    if len(axes) > 1:
        return _moe_psum_multi(x, params, cfg, axes, bspec)
    axis = axes[0]
    tp = rules.mesh_shape(mesh)[axis]
    e = cfg.n_experts
    wspec = ((None,), (axis, None, None), (axis, None, None),
             (axis, None, None))
    args = (x, params["router"], params["w_gate"], params["w_up"],
            params["w_down"])
    if s % tp:
        # psum variant (decode: S == 1, or a sequence that does not divide)
        xspec = (bspec, None, None)

        def f_psum(xx, router, w_gate, w_up, w_down):
            lo = rules.axis_index(mesh, axis) * (e // tp)
            y = _local_experts(xx, router, w_gate, w_up, w_down, cfg, lo,
                               e // tp)
            return rules.psum(y, mesh, axis).to(xx.dtype)

        return rules.shard_map(f_psum, mesh=mesh, in_specs=(xspec, *wspec),
                               out_specs=xspec)(*args)
    xspec = (bspec, axis, None)

    def f_a2a(xx, router, w_gate, w_up, w_down):
        bl, sl, _ = xx.shape
        x2d = xx.reshape(-1, d)
        t = x2d.shape[0]
        weights, experts = route(x2d, router, cfg.top_k)
        cap = _capacity(t, cfg)
        slot = _dispatch_indices(experts, e, cap)
        buf = _dispatch(x2d, slot, e, cap)
        # (E, C, D) -> (tp, E/tp, C, D) -> a2a -> (E/tp, tp*C, D)
        buf = rules.all_to_all(buf.reshape(tp, e // tp, cap, d), mesh, axis)
        buf = buf.transpose(0, 1).reshape(e // tp, tp * cap, d)
        out = _expert_ffn(buf, w_gate, w_up, w_down)
        out = out.reshape(e // tp, tp, cap, d).transpose(0, 1)
        out = rules.all_to_all(out, mesh, axis).reshape(e * cap, d)
        y = _combine(out, slot, weights, t, d)
        return y.reshape(bl, sl, d).to(xx.dtype)

    return rules.shard_map(f_a2a, mesh=mesh, in_specs=(xspec, *wspec),
                           out_specs=xspec)(*args)


def _local_experts(xx, router, w_gate, w_up, w_down, cfg: MoEConfig,
                   lo, e_local: int) -> torch.Tensor:
    """One rank's share of a psum MoE: every token routed over all
    experts, only the choices of experts lo .. lo + e_local - 1 (this
    rank's) dispatched to its local weights, the others weighted 0. Returns
    the fp32 partial output (B, S, D) for the psum."""
    bl, sl, d = xx.shape
    x2d = xx.reshape(-1, d)
    t = x2d.shape[0]
    weights, experts = route(x2d, router, cfg.top_k)
    local = (experts >= lo) & (experts < lo + e_local)
    weights = torch.where(local, weights, 0.0)
    cap = max(_capacity(t, cfg), 1)
    # the other ranks' choices rank in an extra bucket e_local, then drop
    slot = _dispatch_indices(torch.where(local, experts - lo, e_local),
                             e_local + 1, cap)
    slot = torch.where(slot < e_local * cap, slot, e_local * cap)
    buf = _dispatch(x2d, slot, e_local, cap)
    out = _expert_ffn(buf.reshape(e_local, cap, d), w_gate, w_up, w_down)
    y = _combine(out.reshape(-1, d), slot, weights, t, d)
    return y.float().reshape(bl, sl, d)


def _moe_decode_2d(x, params, cfg: MoEConfig, e_axes, f_axes):
    """2-D expert-sharded psum MoE: experts over ``e_axes``, the expert FF
    dim over ``f_axes``. Column-parallel through the SwiGLU nonlinearity
    (elementwise in F), row-parallel down-projection; one psum over all
    expert axes combines both shardings. Tokens replicated inside."""
    mesh = rules.current_ctx().mesh
    e_local = cfg.n_experts // rules.axis_count(mesh, e_axes)
    e_spec = e_axes if len(e_axes) > 1 else e_axes[0]
    f_spec = f_axes if len(f_axes) > 1 else f_axes[0]
    all_axes = tuple(e_axes) + tuple(f_axes)
    xspec = (None, None, None)
    wspec = ((None, None), (e_spec, None, f_spec), (e_spec, None, f_spec),
             (e_spec, f_spec, None))

    def f(xx, router, w_gate, w_up, w_down):
        lo = rules.axis_index(mesh, e_axes) * e_local
        y = _local_experts(xx, router, w_gate, w_up, w_down, cfg, lo,
                           e_local)
        return rules.psum(y, mesh, _mesh_ordered(mesh, all_axes)).to(
            xx.dtype)

    return rules.shard_map(f, mesh=mesh, in_specs=(xspec, *wspec),
                           out_specs=xspec)(
        x, params["router"], params["w_gate"], params["w_up"],
        params["w_down"])


def _moe_psum_multi(x, params, cfg: MoEConfig, axes, bspec):
    """psum MoE variant with experts sharded over several mesh axes."""
    mesh = rules.current_ctx().mesh
    e_local = cfg.n_experts // rules.axis_count(mesh, axes)
    xspec = (bspec, None, None)
    wspec = ((None,), (axes, None, None), (axes, None, None),
             (axes, None, None))

    def f(xx, router, w_gate, w_up, w_down):
        lo = rules.axis_index(mesh, axes) * e_local
        y = _local_experts(xx, router, w_gate, w_up, w_down, cfg, lo,
                           e_local)
        return rules.psum(y, mesh, tuple(axes)).to(xx.dtype)

    return rules.shard_map(f, mesh=mesh, in_specs=(xspec, *wspec),
                           out_specs=xspec)(
        x, params["router"], params["w_gate"], params["w_up"],
        params["w_down"])


def _mesh_ordered(mesh, axes) -> tuple:
    """``axes`` in the mesh's order (a psum over them is the same sum)."""
    names = list(rules.mesh_shape(mesh))
    return tuple(sorted(axes, key=names.index))
