"""The weights of a run, made by the benchmark on the card from the seed.

One ``torch.Generator`` on the device draws each leaf of the program's
parameter layout (``Model.param_shapes``) in one call, in the dtype it is
served in: N(0, 1 / fan-in) for products and the embedding table, zeros
for the norms' zero-centred scales. The program and the reference are
both handed these tensors.
"""
from __future__ import annotations

import math

import torch

def make(shapes: dict, stack_dims: dict, seed: int, device,
         dtype=torch.bfloat16) -> dict:
    """The parameter dict for ``shapes`` (group -> leaf -> shape, or
    group -> shape), ``stack_dims[group]`` leading dims of a group's
    leaves being its layer stack."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))

    def leaf(name, shape, n_stack):
        if name.startswith("ln_"):
            return torch.zeros(shape, dtype=dtype, device=device)
        # the embedding table's fan-in is its width, a product's its
        # first dim after the stack
        fan_in = shape[-1] if name == "embed" else shape[n_stack]
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(1.0 / math.sqrt(fan_in))

    out = {}
    for group, spec in shapes.items():
        if isinstance(spec, dict):
            out[group] = {name: leaf(name, shape, stack_dims[group])
                          for name, shape in spec.items()}
        else:
            out[group] = leaf(group, spec, 0)
    return out
