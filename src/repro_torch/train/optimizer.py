"""Optimizers: AdamW with fp32 or int8 block-quantised moments, the port's
counterpart of ``repro.train.optimizer``.

The int8 variant (``adamw8``) stores both Adam moments as int8 with
per-block fp32 scales (blocks of 128 along the last axis); the second
moment is stored in the sqrt domain. Both are plain functions over nested
dicts of tensors, the reference's leaf names and layouts, so a state
checkpointed by one package restores into the other
(``repro_torch.ckpt``). All the arithmetic is fp32, as the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.sharding import rules

BLOCK = 128
# leaves with more elements are updated a dim-0 slice at a time, which
# bounds the fp32 transients (the reference's per-slice update,
# ``repro/train/optimizer.py``); the blocks run along the last axis, so the
# numbers are the same
SLICE_NUMEL = 1 << 28


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw8"           # 'adamw' | 'adamw8'
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay, an fp32 0-d tensor; ``step`` an int or
    a 0-d tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup,
                                               1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1 + torch.cos(math.pi * t)))


# ------------------------------------------------------- int8 block quant
def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (int8 values, fp32 per-block scales): the last axis padded
    to whole blocks of 128, each block scaled by max|x| / 127 (at least
    1e-12) and rounded half to even, as ``jnp.round``."""
    x = x.float()
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    blocks = x.reshape(*x.shape[:-1], -1, BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale[..., 0]


def dequantize(q: torch.Tensor, scale: torch.Tensor, orig_len: int
               ) -> torch.Tensor:
    blocks = q.reshape(*q.shape[:-1], -1, BLOCK).float()
    x = (blocks * scale[..., None]).reshape(q.shape)
    return x[..., :orig_len]


# ------------------------------------------------------------------ trees
def tree_leaves(tree) -> list[torch.Tensor]:
    """The leaves of nested dicts in the reference's (``jax.tree``) order:
    keys sorted at every level. A quantised moment ``{"q", "s"}`` is one
    leaf of the moment trees (``is_state``)."""
    if not isinstance(tree, dict) or is_state(tree):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest``
    (same structure), a quantised moment ``{"q", "s"}`` being one leaf."""
    if not isinstance(tree, dict) or is_state(tree):
        return fn(tree, *rest)
    return {k: tree_map(fn, v, *(r[k] for r in rest))
            for k, v in tree.items()}


def is_state(x) -> bool:
    return isinstance(x, dict) and "q" in x


# ------------------------------------------------------------------ adamw
def init_opt_state(params, cfg: OptConfig):
    """Zeroed moments: fp32 like each parameter (``adamw``), or an int8
    block-quantised zero, ``{"q": int8 padded, "s": fp32 scales}``
    (``adamw8``, equal to ``quantize`` of zeros); ``step`` an int32 0."""
    def zeros_fp32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def zeros_q8(p):
        padded = -(-p.shape[-1] // BLOCK) * BLOCK
        lead = tuple(p.shape[:-1])
        return {"q": torch.zeros(lead + (padded,), dtype=torch.int8,
                                 device=p.device),
                "s": torch.full(lead + (padded // BLOCK,), 1e-12,
                                dtype=torch.float32, device=p.device)}

    if cfg.name not in ("adamw", "adamw8"):
        raise ValueError(cfg.name)
    zeros = zeros_fp32 if cfg.name == "adamw" else zeros_q8
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (in the reference's order) of each
    leaf's sum of squares, in fp32."""
    total = None
    for g in tree_leaves(tree):
        sq = g.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(params, grads, opt_state, cfg: OptConfig):
    """One AdamW step. Returns (new_params, new_opt_state, metrics), new
    tensors throughout (the inputs are left as they are); metrics
    ``grad_norm`` and ``lr``, fp32 0-d tensors."""
    step = _whole(opt_state["step"]) + 1
    gnorm = _whole(global_norm(grads))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = lr_at(cfg, step)
    stepf = step.float()
    bc1 = 1 - torch.pow(cfg.b1, stepf)
    bc2 = 1 - torch.pow(cfg.b2, stepf)
    quantized = cfg.name == "adamw8"

    def upd_flat(p, g, m, v):
        g = g.float() * clip
        if quantized:
            m_f = dequantize(m["q"], m["s"], p.shape[-1])
            # v is stored in the sqrt domain: entries span decades within
            # a block and sit in the update's denominator, so linear int8
            # would round the small ones to zero and blow their updates up
            v_f = torch.square(dequantize(v["q"], v["s"], p.shape[-1]))
        else:
            m_f, v_f = m, v
        m_f = cfg.b1 * m_f + (1 - cfg.b1) * g
        v_f = cfg.b2 * v_f + (1 - cfg.b2) * torch.square(g)
        u = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        p32 = p.float()
        new_p = (p32 - lr * (u + cfg.weight_decay * p32)).to(p.dtype)
        if quantized:
            mq, ms = quantize(m_f)
            vq, vs = quantize(torch.sqrt(v_f))
            return new_p, {"q": mq, "s": ms}, {"q": vq, "s": vs}
        return new_p, m_f, v_f

    def upd(p, g, m, v):
        if rules.is_dtensor(p):
            return upd_sharded(p, g, m, v)
        if p.numel() <= SLICE_NUMEL:
            return upd_flat(p, g, m, v)
        n = p.shape[0]
        chunks = next((c for c in range(min(n, 64), 1, -1) if n % c == 0),
                      1)
        if chunks == 1:
            return upd_flat(p, g, m, v)
        rows = n // chunks
        out = (torch.empty_like(p), _moment_map(torch.empty_like, m),
               _moment_map(torch.empty_like, v))
        for i in range(0, n, rows):
            sl = slice(i, i + rows)
            parts = upd_flat(p[sl], g[sl], _moment_map(lambda t: t[sl], m),
                             _moment_map(lambda t: t[sl], v))
            for dst, src in zip(out, parts):
                _moment_map(lambda d, s_: d[sl].copy_(s_), dst, src)
        return out

    def upd_sharded(p, g, m, v):
        # AdamW is elementwise: each rank updates its own shard, laid out
        # as the moments are (ZeRO), and the new parameter goes back to
        # the parameter's layout. The int8 blocks run along the last dim,
        # which is gathered first only where a shard would cut a block.
        from torch.distributed.tensor import DTensor
        mesh = p.device_mesh
        pl = (_block_placements(m["q"], p.shape[-1]) if quantized
              else tuple(m.placements))

        def local(t):
            return _relayout(t, pl).to_local()

        def back(t, ref):
            return _relayout(DTensor.from_local(
                t, mesh, pl, run_check=False, shape=ref.shape,
                stride=ref.stride()), ref.placements)

        new_p, new_m, new_v = upd(local(p), local(g), _moment_map(local, m),
                                  _moment_map(local, v))
        return (back(new_p, p), _moment_map(back, new_m, m),
                _moment_map(back, new_v, v))

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"m": tree_map(lambda o: o[1], out),
                 "v": tree_map(lambda o: o[2], out), "step": step}
    return (tree_map(lambda o: o[0], out), new_state,
            {"grad_norm": gnorm, "lr": lr})


def _relayout(t, pl):
    """The DTensor ``t`` laid out by placements ``pl``: the new shards are
    cut first (a local slice, no collective), then the old ones gathered,
    so that a gather yields no more than the new shard."""
    from torch.distributed.tensor import Replicate
    pl = tuple(pl)
    cut = tuple(new if isinstance(old, Replicate) else old
                for old, new in zip(t.placements, pl))
    for step in (cut, pl):
        if tuple(t.placements) != step:
            t = t.redistribute(t.device_mesh, step)
    return t


def _block_placements(q, n: int) -> tuple:
    """The int8 moment ``q``'s placements (its parameter's last dim is
    ``n``), its last dim made whole unless every shard of it holds whole
    blocks of the parameter."""
    last = q.dim() - 1
    if n % (rules.dim_shards(q, last) * BLOCK) == 0:
        return tuple(q.placements)
    return rules.gathered(q.placements, {last})


def _whole(t):
    """A DTensor's whole value as a plain tensor; a tensor as it is."""
    return t.full_tensor() if rules.is_dtensor(t) else t


def _moment_map(fn, m, *rest):
    """``fn`` over a moment leaf: a tensor, or each part of a quantised
    ``{"q", "s"}``."""
    if isinstance(m, dict):
        return {k: fn(m[k], *(r[k] for r in rest)) for k in m}
    return fn(m, *rest)
