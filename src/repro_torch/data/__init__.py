"""Synthetic data, the port's copy of ``repro.data``."""
from .synthetic import Prefetcher, SyntheticLM  # noqa: F401
