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
reference's leaf names. The reference's ZeRO / FSDP axes
(``train_state_axes``, ``grad_accum_axes``, ``abstract_train_state``) are
item 12's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models.transformer import Model
from repro_torch.train.optimizer import (
    OptConfig, apply_updates, init_opt_state, tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    # the dtype the microbatches' gradients are summed in
    grad_accum_dtype: str = "float32"


def init_train_state(model: Model, seed: int, tcfg: TrainConfig,
                     device=None):
    """Parameters from ``model.init(seed, device)`` (``cuda`` unless the
    caller asks for another device) and zeroed optimizer state."""
    params = model.init(seed, device=device)
    return {"params": params, "opt": init_opt_state(params, tcfg.opt)}


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: ``batch``
    a dict of tensors on the parameters' device (``tokens``, ``labels``,
    and a family's ``patches`` or ``frames``; another device raises);
    metrics ``loss``,
    ``grad_norm`` and ``lr``, fp32 0-d tensors. The returned state is new;
    the given one is left as it is."""
    acc_dt = getattr(torch, tcfg.grad_accum_dtype)

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
        if where != [str(dev)]:
            raise ValueError(f"the batch lies on {where} and the parameters "
                             f"on {dev}: move the batch there")
        n_mb = tcfg.n_microbatches
        if n_mb <= 1:
            loss, grads = grads_of(params, batch)
            grads = [g.float() for g in grads]
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
                if acc is None:
                    acc = [torch.zeros(g.shape, dtype=acc_dt, device=g.device)
                           for g in grads]
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
