"""The serving cells of Zyphra's Zamba2: ``drivers/serve.py``'s driver with
the Zamba2 reference (``reference/zamba2.py``) in place of the dense one.

Set-up first checks the program's fields of Zyphra's hybrid layout
against the configuration file's ``as_run`` (``harness.port_config``
compares the fields every configuration has; these it does not know):
the hybrid layer ids, the shared blocks, the attention's input width, the
adapters' rank. A program without them fails here, before any weight is
made.

The weights are ``weights.make``'s but for the Mamba2 layers' three
per-head constants, which take the published model's initialisation
(:func:`published_ssm_init`). With N(0, 1 / fan-in) in their place (A
near -1 in every head, dt near 0.7) the random 81-layer stack turns a
1e-3 change of its input into an unrelated output, so bf16 serving and
the fp8 control land equally far from the fp32 reference and no limit
could tell them apart; with the published constants the same change moves
the output by a few percent.
"""
from __future__ import annotations

import math

import torch

from bench.drivers import serve
from bench.harness import port_config
from bench.reference.zamba2 import Reference

# the program's field of Zyphra's layout -> the as_run key it must equal
ZYPHRA_FIELDS = {"hybrid_layer_ids": "hybrid_layer_ids",
                 "n_mem_blocks": "n_mem_blocks", "attn_width": "attn_in",
                 "adapter_rank": "adapter_rank"}


def check_zyphra(cell) -> None:
    """Raises ``ValueError`` where the program's Zamba2 fields differ from
    the cell's ``as_run``, or the program has none."""
    cfg = port_config(cell)
    got = {k: getattr(cfg, k, None) for k in ZYPHRA_FIELDS}
    if got["hybrid_layer_ids"] is not None:
        got["hybrid_layer_ids"] = list(got["hybrid_layer_ids"])
    want = {k: cell.dims.get(v) for k, v in ZYPHRA_FIELDS.items()}
    if got != want:
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise ValueError(f"{cell.name}: the program's Zamba2 fields differ "
                         f"from {cell.config['name']}'s as_run: {diff}")


def published_ssm_init(params: dict, cell) -> None:
    """Every Mamba2 layer's A_log, D and dt_bias, in place, as transformers'
    ``Zamba2PreTrainedModel._init_weights`` sets them: A = -(1, 2, ..., H),
    D = 1, and dt_bias the inverse softplus of a dt drawn log-uniformly
    between the configuration's ``time_step_min`` and ``time_step_max``
    and floored at ``time_step_floor``, a draw a layer from the run's
    seed."""
    c, layers = cell.config, params["layers"]
    n, h = layers["A_log"].shape
    dev = layers["A_log"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed((cell.seed + 1) % (1 << 63))
    lo, hi = math.log(c["time_step_min"]), math.log(c["time_step_max"])
    dt = torch.exp(torch.rand((n, h), generator=gen, device=dev) * (hi - lo)
                   + lo).clamp(min=c["time_step_floor"])
    layers["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
    layers["A_log"].copy_(torch.log(torch.arange(
        1, h + 1, dtype=torch.float32, device=dev)).expand(n, h))
    layers["D"].fill_(1.0)


class Run(serve.Run):
    def setup(self) -> None:
        check_zyphra(self.cell)
        super().setup()

    def new_engine(self) -> None:
        """The base's engine, over the weights with the published SSM
        constants (set before the first engine captures its step; the same
        values again for a later one)."""
        published_ssm_init(self.params, self.cell)
        super().new_engine()

    def gaps(self, ks, control=False):
        """``serve.Run.gaps`` with the Zamba2 reference: the base builds
        ``serve.Reference`` inside it, so that name points at this one
        while it runs."""
        dense = serve.Reference
        serve.Reference = Reference
        try:
            return super().gaps(ks, control)
        finally:
            serve.Reference = dense
