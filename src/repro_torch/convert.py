"""Load ``repro``'s parameters into the port.

``params_from_jax`` takes the reference's parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``, done by the caller: the port does
not import JAX) and returns the port's parameter dict on ``device``. The
leaf names and stacked layouts are the same, so this is a checked copy;
bf16 leaves go through float32, which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model


def _leaf(arr, shape, dtype: torch.dtype, dev: torch.device, name: str):
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                         f"{tuple(shape)}")
    t = torch.from_numpy(np.array(arr, dtype=np.float32))
    return t.to(device=dev, dtype=dtype)


def params_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameters (nested dict of numpy arrays) as the
    port's, in ``cfg.param_dtype`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    shapes = Model(cfg).param_shapes()
    if set(tree) != set(shapes) or set(tree["layers"]) != set(shapes["layers"]):
        raise ValueError(f"leaf names {sorted(tree)} / "
                         f"{sorted(tree.get('layers', {}))} do not match "
                         f"{sorted(shapes)} / {sorted(shapes['layers'])}")
    out = {k: _leaf(tree[k], shapes[k], dtype, dev, k)
           for k in shapes if k != "layers"}
    out["layers"] = {k: _leaf(tree["layers"][k], s, dtype, dev, f"layers/{k}")
                     for k, s in shapes["layers"].items()}
    return out
