"""Training: AdamW with fp32 or int8 moments and the microbatched train
step, the port's counterpart of ``repro.train``, with its multi-device
axes (``step.train_state_axes``: ZeRO-sharded moments, FSDP parameters
and the ZeRO-sharded gradient accumulator under a device mesh)."""
from .optimizer import (  # noqa: F401
    OptConfig, apply_updates, global_norm, init_opt_state)
from .step import TrainConfig, init_train_state, make_train_step  # noqa: F401
