"""Chrome/Perfetto trace export (and reload) for drained trace events.

Emits the Chrome trace-event JSON format (``{"traceEvents": [...]}``)
that both ``chrome://tracing`` and https://ui.perfetto.dev open
directly:

  - ``"X"`` complete spans land on one row per recorded thread
    (thread-per-replica rows in the runtime's case), with thread names
    from the tracer's ``"M"`` metadata records;
  - ``"i"`` instants render as markers (governor decisions);
  - ``"C"`` counter samples become counter tracks (``cap_w`` /
    ``power_w`` / ``battery/soc`` timelines) — scalar values are wrapped
    as ``{"value": v}``, mappings pass through as multi-series tracks.

Timestamps are converted from perf_counter seconds to the format's µs
and normalized to the earliest event (Perfetto handles absolute values,
but small numbers keep the JSON readable and diffable). The loader is
the exporter's inverse as far as :mod:`repro_torch.obs.report` needs — it
returns the raw event dicts.

Round-trip fidelity: mapping-valued counter samples survive
``load_trace(write_perfetto(...))`` sample-for-sample (every series key,
in order), numpy scalars are coerced to plain JSON numbers instead of
crashing the writer, and tracer-level metadata that is not itself an
event — today the ``dropped_records`` ring-overflow count — is embedded
as a ``trace_metadata`` ``"M"`` record so it reloads with the events
(:func:`repro_torch.obs.report.analyze_trace` surfaces it).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Mapping

from .trace import TraceEvent

PID = 1  # single-process traces; one pid keeps the Perfetto UI flat

#: Name of the synthetic ``"M"`` record carrying trace-level metadata
#: (``dropped_records`` etc.) through the file round trip.
METADATA_EVENT = "trace_metadata"


def _json_default(obj):
    """Coerce non-JSON scalars (numpy floats/ints/bools) to plain Python
    numbers; anything else still fails loudly."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(
        f"trace event value of type {type(obj).__name__} is not "
        f"JSON-serializable")


def to_chrome_events(events: Iterable[TraceEvent],
                     t0: float | None = None) -> list[dict]:
    """Convert drained :class:`TraceEvent` records to Chrome trace-event
    dicts. ``t0`` overrides the normalization epoch (default: earliest
    event timestamp)."""
    events = list(events)
    if t0 is None:
        t0 = min((e.ts for e in events), default=0.0)
    out: list[dict] = []
    for e in events:
        ts_us = (e.ts - t0) * 1e6
        if e.ph == "M":
            out.append({"ph": "M", "name": "thread_name", "pid": PID,
                        "tid": e.tid, "args": {"name": e.name}})
        elif e.ph == "X":
            rec = {"ph": "X", "name": e.name, "cat": e.cat or "span",
                   "pid": PID, "tid": e.tid, "ts": ts_us,
                   "dur": e.dur * 1e6}
            if e.args:
                rec["args"] = dict(e.args)
            out.append(rec)
        elif e.ph == "i":
            rec = {"ph": "i", "s": "p", "name": e.name,
                   "cat": e.cat or "instant", "pid": PID, "tid": e.tid,
                   "ts": ts_us}
            if e.args:
                rec["args"] = dict(e.args)
            out.append(rec)
        elif e.ph == "C":
            value = e.args
            args = dict(value) if isinstance(value, Mapping) \
                else {"value": value}
            out.append({"ph": "C", "name": e.name, "pid": PID,
                        "ts": ts_us, "args": args})
    return out


def write_perfetto(events: Iterable[TraceEvent], path,
                   t0: float | None = None, *,
                   dropped_records: int | None = None,
                   metadata: Mapping | None = None) -> Path:
    """Write a Perfetto-loadable ``trace.json``; returns the path.

    ``dropped_records`` (typically ``tracer.dropped_records``) and any
    extra ``metadata`` mapping are embedded as a :data:`METADATA_EVENT`
    record so they survive the file round trip — ring overflow would
    otherwise silently vanish between the tracer and the report.
    """
    chrome = to_chrome_events(events, t0=t0)
    meta_args = dict(metadata or {})
    if dropped_records is not None:
        meta_args["dropped_records"] = int(dropped_records)
    if meta_args:
        chrome.append({"ph": "M", "name": METADATA_EVENT, "pid": PID,
                       "tid": 0, "args": meta_args})
    path = Path(path)
    payload = {"traceEvents": chrome, "displayTimeUnit": "ms"}
    path.write_text(json.dumps(payload, default=_json_default) + "\n",
                    encoding="utf-8")
    return path


def load_trace(path) -> list[dict]:
    """Load a trace written by :func:`write_perfetto` (or any Chrome
    trace JSON); returns the ``traceEvents`` list."""
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    if isinstance(data, list):  # bare-array variant of the format
        return data
    return data.get("traceEvents", [])
