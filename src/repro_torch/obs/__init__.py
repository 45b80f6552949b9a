"""Observability, the port's counterpart of ``repro.obs``: the
:class:`Tracer` (monotonic-clock spans, instants and counter samples in
per-thread ring buffers) and the :class:`MetricsRegistry` (counters,
gauges and windowed histograms; ``window_summary`` is what the serving
scenario's governor reads).

Not carried yet: the trace exporters (``export``), trace analysis
(``report``) and measured-power ingestion (``power``).
"""
from .metrics import MetricsRegistry  # noqa: F401
from .trace import NULL_TRACER, TraceEvent, Tracer  # noqa: F401
