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


def _walk(tree, shapes, dtype, dev, path: str):
    """``tree`` against ``shapes`` (nested dicts): the same names at every
    level, every leaf of its shape."""
    if not isinstance(tree, dict) or set(tree) != set(shapes):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{path or 'params'}: leaf names {got} do not "
                         f"match {sorted(shapes)}")
    out = {}
    for k, shape in shapes.items():
        name = f"{path}/{k}" if path else k
        out[k] = (_walk(tree[k], shape, dtype, dev, name)
                  if isinstance(shape, dict)
                  else _leaf(tree[k], shape, dtype, dev, name))
    return out


def params_from_jax(tree, cfg: ModelConfig, device=None) -> dict:
    """The reference's parameters (nested dict of numpy arrays) as the
    port's, in ``cfg.param_dtype`` on ``device`` (default ``cuda``). Every
    group (``layers``; windowed dense ``local``, ``global``, ``tail``;
    hybrid ``mamba``, ``tail``, ``shared_attn``; encdec ``enc``, ``dec``)
    is walked against
    ``Model.param_shapes``; a missing or extra name or a
    wrong shape raises ``ValueError``."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    return _walk(tree, Model(cfg).param_shapes(), dtype, dev, "")
