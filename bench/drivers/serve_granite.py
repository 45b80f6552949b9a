"""The serving cells of IBM's Granite 4.0-H: ``drivers/serve.py``'s driver
with the Granite reference (``reference/granite.py``) in place of the dense
one.

Set-up first checks the program's configuration against the
configuration file's ``as_run`` here: ``harness.port_config`` compares a
MoE configuration (a ``MoEConfig``) with the file's dict and refuses it,
so it is handed the file's ``moe`` as a ``MoEConfig`` for the fields every
configuration has, and the MoE (as ``dataclasses.asdict``), the layer
pattern, NoPE, the softmax scale and the three multipliers are compared
here. A program without them fails here, before any weight is made.

The weights are drawn again, before the first engine captures its step,
as the published model's initialisation draws them
(:func:`published_init`: transformers' ``GraniteMoeHybridPreTrainedModel.
_init_weights``): every product's weight, the conv's, the router's and
every expert's N(0, s^2), s the configuration file's
``initializer_range``, the conv's bias 0, the Mamba2 layers' A_log =
log(1..H), D = 1 and dt_bias = 1, the norms' scales 1 (0 as the port
stores them). One departure: the embedding table is drawn at
N(0, (s / m)^2), m the embedding multiplier (12), so that the multiplied
embedding has the std of every other weight. At s itself the token's own
embedding, 12 times over in the residual stream,
outweighs what the 80 branches add in the tied head's logits: greedy
decoding repeats the input token whatever the layers compute (90 % of
positions at full width, NVIDIA H100 80GB HBM3), and the check would read
nothing of them.

Why not ``weights.make``'s draws (N(0, 1 / fan-in), the experts at the
fan-in of their expert dim): with them and the published SSM constants
the random 40-layer stack amplifies bf16's rounding until the bf16
program agrees with the fp32 reference on 14 % of greedy tokens (final
hidden states 68 % apart), against the fp8 control's 0.2 %, and the
widest gaps of the two, 4.5 and 5.9 logit stds, leave no room for a limit
between them. With the published draws the program agrees on 80 % (8 %
apart), the control on 19 %, and their widest gaps are 0.33 and 2.7 logit
stds (full width, 2 x 256 positions, NVIDIA H100 80GB HBM3).
"""
from __future__ import annotations

import dataclasses

import torch

from bench.drivers import serve
from bench.harness import port_config
from bench.reference.granite import Reference

# the program's fields of the layer pattern, compared with the as_run key of
# the same name
GRANITE_FIELDS = ("layer_types", "rope", "softmax_scale",
                  "embedding_multiplier", "residual_multiplier",
                  "logits_scaling", "moe")
# the Mamba2 layers' per-head constants, set rather than drawn
SSM_CONSTANTS = ("A_log", "D", "dt_bias")


def check_granite(cell):
    """The program's ``ModelConfig`` of the cell; raises ``ValueError``
    where it differs from the cell's ``as_run``, or has no such fields."""
    from repro_torch.models.config import MoEConfig

    dims = cell.dims
    config = {**cell.config, "as_run": {**dims,
                                        "moe": MoEConfig(**dims["moe"])}}
    cfg = port_config(dataclasses.replace(cell, config=config))
    got = {k: getattr(cfg, k, None) for k in GRANITE_FIELDS}
    got["layer_types"] = list(got["layer_types"] or ())
    got["moe"] = dataclasses.asdict(cfg.moe)
    want = {k: dims.get(k) for k in GRANITE_FIELDS}
    if got != want:
        diff = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
        raise ValueError(f"{cell.name}: the program's layer pattern differs "
                         f"from {cell.config['name']}'s as_run: {diff}")
    return cfg


def published_init(params: dict, cell) -> None:
    """Every leaf of ``params`` in place, as the published model's
    initialisation draws it (module docstring), from the run's seed, one
    leaf at a time in the parameter dict's order: the embedding table
    N(0, (s / m)^2), every other weight N(0, s^2), s the configuration
    file's ``initializer_range``, the conv's bias 0, A_log = log(1..H),
    D = 1, dt_bias = 1; the norms' scales as made (0: the port applies
    1 + w). The same values on every call."""
    std = cell.config["initializer_range"]
    gen = torch.Generator(device=params["embed"].device)
    gen.manual_seed((cell.seed + 2) % (1 << 63))
    params["embed"].normal_(0.0, std / cell.dims["embedding_multiplier"],
                            generator=gen)
    for group in ("ssm", "attn", "ffn"):
        for name, leaf in params[group].items():
            if name.startswith("ln_") or name == "ssm_norm" \
                    or name in SSM_CONSTANTS:
                continue
            if name == "conv_b":
                leaf.zero_()
            else:
                leaf.normal_(0.0, std, generator=gen)
    ssm = params["ssm"]
    n, h = ssm["A_log"].shape
    ssm["A_log"].copy_(torch.log(torch.arange(
        1, h + 1, dtype=torch.float32, device=ssm["A_log"].device)).expand(
            n, h))
    ssm["D"].fill_(1.0)
    ssm["dt_bias"].fill_(1.0)


class Run(serve.Run):
    def setup(self) -> None:
        """The base's set-up over the configuration checked here: the
        base's ``port_config`` points at it while it runs."""
        cfg = check_granite(self.cell)
        dense = serve.port_config
        serve.port_config = lambda cell: cfg
        try:
            super().setup()
        finally:
            serve.port_config = dense

    def new_engine(self) -> None:
        """The base's engine, over the weights of :func:`published_init`
        (set before the first engine captures its step; the same values
        again for a later one)."""
        published_init(self.params, self.cell)
        super().new_engine()

    def gaps(self, ks, control=False):
        """``serve.Run.gaps`` with the Granite reference: the base builds
        ``serve.Reference`` inside it, so that name points at this one
        while it runs."""
        dense = serve.Reference
        serve.Reference = Reference
        try:
            return super().gaps(ks, control)
        finally:
            serve.Reference = dense
