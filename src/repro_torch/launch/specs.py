"""Abstract stand-ins for every (architecture x input-shape) cell: meta
tensors (shapes and dtypes, no storage), each a DTensor over a meta local
shard when a ``DeviceMesh`` is current, laid out by its logical axes (the
counterpart of ``repro.launch.specs``'s sharded ``ShapeDtypeStruct``s).
The ``*_axes`` companions give the logical axes themselves, so a spec can
be computed from a mesh shape alone.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig, ShapeSpec
from repro_torch.models.transformer import Model
from repro_torch.sharding import rules


def _sds(shape, dtype, axes):
    return rules.abstract_leaf(torch.empty(shape, dtype=dtype, device="meta"),
                               axes)


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """(shape, dtype, logical axes) of each leaf of one step's batch."""
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": ((b, s), torch.int32, ("batch", None)),
           "labels": ((b, s), torch.int32, ("batch", None))}
    cdt = getattr(torch, cfg.compute_dtype)
    if cfg.kind == "vlm":
        out["patches"] = ((b, cfg.n_patches, cfg.d_model), cdt,
                          ("batch", None, None))
    if cfg.kind in ("audio", "encdec"):
        out["frames"] = ((b, cfg.enc_len, cfg.d_model), cdt,
                         ("batch", None, None))
    return out


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict[str, Any]:
    """Abstract train/prefill batch for one step."""
    return {k: _sds(*v) for k, v in batch_axes(cfg, shape).items()}


def cache_specs(model: Model, shape: ShapeSpec) -> dict[str, Any]:
    """Abstract decode cache (KV / SSM state) laid out by ``cache_axes``."""
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             abstract=True)
    axes = model.cache_axes()
    return {k: rules.abstract_leaf(v, axes[k]) for k, v in cache.items()}


def decode_specs(model: Model, shape: ShapeSpec) -> tuple[Any, Any]:
    """(cache, tokens) abstract inputs for the serve step."""
    return (cache_specs(model, shape),
            _sds((shape.global_batch,), torch.int32, ("batch",)))


def abstract_params_sharded(model: Model):
    """Abstract params laid out by the logical axes' rules."""
    return rules.abstract_sharded(model.abstract_params(),
                                  model.param_axes())


def abstract_state_sharded(model: Model, tcfg) -> Any:
    """Abstract train state (params + optimizer) laid out by
    ``train_state_axes``."""
    from repro_torch.train.step import abstract_train_state, train_state_axes
    return rules.abstract_sharded(abstract_train_state(model, tcfg),
                                  train_state_axes(model, tcfg))
