"""Profiler ranges that cost nothing outside a trace.

:func:`profiler_range` is the port's one way to open a
``torch.profiler`` range: a ``record_function`` while a profiler records
in this process, and a null context otherwise, so an untraced run opens no
range at all (``record_function`` would still enter and leave a dispatcher
op on every call).

The test is the process-wide flag ``torch.profiler`` sets while it runs,
not ``torch.autograd._profiler_enabled()``: that one reads the calling
thread's profiler state, which the executor's stage threads never have,
and reads False in every thread under ``profile_all_threads``, the
setting that records those threads' ranges."""
from __future__ import annotations

import contextlib

import torch


def profiler_range(name: str):
    """``torch.profiler.record_function(name)`` while a profiler is
    recording, else ``contextlib.nullcontext()``."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
