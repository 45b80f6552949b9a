"""Training step: microbatched gradient accumulation + AdamW update, the
port's counterpart of ``repro.train.step`` on one device.

One step:
  1. the global batch is split into ``n_microbatches`` chunks along batch;
  2. each chunk's loss is differentiated by ``torch.autograd.grad`` (the
     model's per-layer remat keeps one layer's activations per chunk), and
     the gradients are summed in ``grad_accum_dtype``, then averaged;
  3. the gradients are clipped by global norm and applied with AdamW
     (fp32 or int8 moments, ``train/optimizer.py``).
The state is ``{"params", "opt": {"m", "v", "step"}}`` with the
reference's leaf names.

Under a mesh the state's leaves are DTensors laid out by
``train_state_axes``: the optimizer moments carry the ZeRO axis ('zero' =
the pod/data axes) on their first free dimension that divides it, and
with ``fsdp_params`` so do the parameters. ``make_train_step``'s
``param_shardings`` / ``accum_shardings`` pin the gradient accumulator to
a layout by redistributing it (the reference's sharding constraint); with
``zero_grad_accum`` that layout is ``grad_accum_axes``'.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.transformer import Model
from repro_torch.sharding import rules
from repro_torch.train.optimizer import (
    BLOCK, OptConfig, apply_updates, init_opt_state, tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    # the dtype the microbatches' gradients are summed in
    grad_accum_dtype: str = "float32"
    # FSDP: also shard the parameters over the 'zero' (pod, data) axes
    fsdp_params: bool = False
    # ZeRO-sharded gradient accumulator (``grad_accum_axes``): the
    # per-microbatch gradient sum over the data axes becomes a
    # reduce-scatter
    zero_grad_accum: bool = False


def init_train_state(model: Model, seed: int, tcfg: TrainConfig,
                     device=None):
    """Parameters from ``model.init(seed, device)`` (``cuda`` unless the
    caller asks for another device) and zeroed optimizer state."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": init_opt_state(params, tcfg.opt)}


def abstract_train_state(model: Model, tcfg: TrainConfig):
    """The train state as meta tensors (shapes and dtypes, no storage)."""
    params = model.abstract_params()
    return {"params": params, "opt": init_opt_state(params, tcfg.opt)}


def _zero_axes(axes_leaf, shape):
    """Axes + 'zero' (the data/pod axes) on the first dimension that is
    still unsharded and divides the zero axes' size: layer counts like 61
    or 35 do not divide 16 or 32, so a fixed dim 0 would lose the ZeRO
    sharding."""
    ctx = rules.current_ctx()
    dp = ctx.axes_size("zero")
    axes = list(axes_leaf) + [None] * (len(shape) - len(axes_leaf))
    for i, a in enumerate(axes):
        free = a is None or not ctx.mesh_axes(a)
        if free and dp > 1 and shape[i] % dp == 0:
            axes[i] = "zero"
            break
    return tuple(axes)


def train_state_axes(model: Model, tcfg: TrainConfig):
    """Logical axes of the whole train state (params + optimizer), under
    the target mesh's context (the ZeRO dimension depends on the mesh):
    an ``adamw8`` moment's ``q`` (int8, its last dim padded to the
    quantisation block) and ``s`` (per-block scales) get their own."""
    p_axes = model.param_axes()
    shapes = model.abstract_params()

    def for_param(ax, t):
        return _zero_axes(ax, t.shape) if tcfg.fsdp_params else ax

    def for_moment(ax, t):
        if tcfg.opt.name != "adamw8":
            return _zero_axes(ax, t.shape)
        padded = -(-t.shape[-1] // BLOCK) * BLOCK
        qshape = tuple(t.shape[:-1]) + (padded,)
        sshape = tuple(t.shape[:-1]) + (padded // BLOCK,)
        return {"q": _zero_axes(ax, qshape),
                "s": _zero_axes(ax[:-1] + (None,), sshape)}

    m_axes = rules.tree_map2(lambda t, ax: for_moment(ax, t), shapes, p_axes)
    return {"params": rules.tree_map2(lambda t, ax: for_param(ax, t),
                                      shapes, p_axes),
            "opt": {"m": m_axes, "v": m_axes, "step": ()}}


def grad_accum_axes(model: Model):
    """ZeRO-style logical axes for the gradient accumulator."""
    return rules.tree_map2(lambda t, ax: _zero_axes(ax, t.shape),
                           model.abstract_params(), model.param_axes())


def shardings_of(tree, axes) -> dict:
    """The ``NamedSharding`` of every leaf of a tree of tensors by its
    logical axes under the current mesh (None without one)."""
    ctx = rules.current_ctx()
    return rules.tree_map2(lambda t, ax: ctx.sharding(ax, t.shape), tree,
                           axes)


def distribute_state(state, axes):
    """A tree of whole tensors (the same on every rank) as DTensors laid
    out by a tree of logical axes under the current mesh; as it is
    without one. A quantised moment's parts and ``step`` follow their own
    axes."""
    if isinstance(state, dict):
        return {k: distribute_state(v, axes[k]) for k, v in state.items()}
    return rules.distribute(state, axes)


def _constrain(tensors: list, shardings: list) -> list:
    """Each DTensor redistributed to its sharding's placements (the
    reference's ``with_sharding_constraint``); others as they are."""
    out = []
    for t, sh in zip(tensors, shardings):
        if sh is not None and rules.is_dtensor(t) and \
                tuple(t.placements) != sh.placements:
            t = t.redistribute(sh.mesh, sh.placements)
        out.append(t)
    return out


def make_train_step(model: Model, tcfg: TrainConfig, param_shardings=None,
                    accum_shardings=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: ``batch``
    a dict of tensors on the parameters' device (``tokens``, ``labels``,
    and a family's ``patches`` or ``frames``; another device raises);
    metrics ``loss``,
    ``grad_norm`` and ``lr``, fp32 0-d tensors. The returned state is new;
    the given one is left as it is.

    ``param_shardings`` / ``accum_shardings``: optional trees of
    ``NamedSharding`` (``shardings_of``) the gradients and their
    accumulator are redistributed to, the accumulator's if both are
    given; with neither, ``zero_grad_accum`` pins them to
    ``grad_accum_axes`` under the current mesh. Under a mesh the step
    runs on DTensors laid out by ``train_state_axes``."""
    acc_dt = getattr(torch, tcfg.grad_accum_dtype)
    pins = accum_shardings if accum_shardings is not None \
        else param_shardings

    def grads_of(params, mb):
        # aliases of the parameters that require a gradient: the model
        # takes its training path over them (``Model._training``)
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = model.loss(live, mb)
            grads = torch.autograd.grad(loss, tree_leaves(live),
                                        allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), grads

    def train_step(state, batch):
        params = state["params"]
        dev = tree_leaves(params)[0].device
        where = sorted({str(v.device) for v in batch.values()})
        if pins is not None:
            pin = tree_leaves(pins)
        elif tcfg.zero_grad_accum:    # the ZeRO layout of this mesh
            pin = tree_leaves(shardings_of(params, grad_accum_axes(model)))
        else:
            pin = [None] * len(tree_leaves(params))
        if where != [str(dev)]:
            raise ValueError(f"the batch lies on {where} and the parameters "
                             f"on {dev}: move the batch there")
        n_mb = tcfg.n_microbatches
        if n_mb <= 1:
            loss, grads = grads_of(params, batch)
            grads = _constrain([g.float() for g in grads], pin)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % n_mb:
                raise ValueError(f"batch {b} does not split into {n_mb} "
                                 "microbatches")
            size = b // n_mb
            loss_sum, acc = None, None
            for i in range(n_mb):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                loss, grads = grads_of(params, mb)
                grads = _constrain(grads, pin)
                if acc is None:
                    acc = [torch.zeros_like(g, dtype=acc_dt) for g in grads]
                for a, g in zip(acc, grads):
                    a.add_(g.to(acc_dt))
                del grads
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / n_mb
            grads = [a.div_(n_mb) for a in acc]
        grad_tree = _unflatten(params, iter(grads))
        new_params, new_opt, metrics = apply_updates(
            params, grad_tree, state["opt"], tcfg.opt)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _unflatten(tree, it):
    """A tree of ``tree``'s structure whose leaves, in ``tree_leaves``
    order, come from ``it``."""
    if not isinstance(tree, dict):
        return next(it)
    out = {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return {k: out[k] for k in tree}
