"""Observability, the port's counterpart of ``repro.obs``:

  - :mod:`~repro_torch.obs.trace`   — :class:`Tracer`: monotonic-clock
    spans, instants and counter samples in per-thread ring buffers;
  - :mod:`~repro_torch.obs.metrics` — :class:`MetricsRegistry`: counters,
    gauges and windowed histograms (``window_summary`` is what the serving
    scenario's governor reads);
  - :mod:`~repro_torch.obs.export`  — Chrome/Perfetto ``trace.json``
    writer and loader;
  - :mod:`~repro_torch.obs.report`  — trace analysis (per-stage
    utilization, replica imbalance, rebuild stall, over-cap intervals) and
    measured-energy attribution (:func:`attribute_energy`) against a power
    capture;
  - :mod:`~repro_torch.obs.power`   — measured-power ingestion: RAPL
    ``energy_uj`` logs and macOS ``powermetrics`` captures parsed into a
    :class:`PowerCapture` timeline, synthetic captures, and trace/schedule
    alignment into :class:`CaptureWindow` calibration rows;
  - :mod:`~repro_torch.obs.ranges`  — :func:`profiler_range`: a
    ``torch.profiler`` range only while a profiler records.
"""
from .export import load_trace, to_chrome_events, write_perfetto  # noqa: F401
from .metrics import MetricsRegistry  # noqa: F401
from .power import (  # noqa: F401
    CaptureWindow,
    PowerCapture,
    PowerSample,
    UtilizationWindow,
    capture_windows_from_trace,
    parse_powermetrics,
    parse_rapl_log,
    synthesize_powermetrics,
    synthesize_rapl_log,
    windows_from_schedule,
)
from .ranges import profiler_range  # noqa: F401
from .report import (  # noqa: F401
    EnergyAttribution,
    StageAttribution,
    TraceReport,
    WindowAttribution,
    analyze_trace,
    attribute_energy,
)
from .trace import NULL_TRACER, TraceEvent, Tracer  # noqa: F401
