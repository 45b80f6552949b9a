"""Checkpoints, the port's counterpart of ``repro.ckpt``."""
from .manager import CheckpointManager  # noqa: F401
