"""Trace analysis: turn an exported ``trace.json`` back into numbers.

The reporting half of the observability layer: load a Chrome/Perfetto
trace written by :func:`repro_torch.obs.export.write_perfetto` and compute

  - **per-stage utilization** — busy fraction of each stage's replica
    rows over the trace extent (frame-span durations summed per stage,
    divided by replicas x extent), plus the busy-dominant kernel
    variant (frame spans stamp a ``variant`` arg when the plan chose a
    non-base implementation);
  - **replica imbalance** — max/mean frames processed across a stage's
    replicas (work stealing should keep this near 1; a straggler shows
    up as the *other* replicas' ratio rising);
  - **rebuild stall time** — traffic-visible stall across
    ``runtime/rebuild`` spans: live-handoff rebuilds contribute only
    their fence exclusion (the span's ``stall_s`` arg — microseconds),
    with the span duration itself accumulated separately as
    ``rebuild_overlap_s`` (old/new stage sets running concurrently);
    drain-mode spans stall for their full duration;
  - **governor decisions** — every re-plan instant with trigger label;
  - **over-cap intervals** — scenario windows whose active plan was
    predicted over the window's cap floor (the same definition as
    ``ScenarioResult.over_cap_windows``), plus measured ``power_w``
    counter samples above the ``cap_w`` track.

The second half of this module is **measured-energy attribution**
(:func:`attribute_energy`): align a :class:`repro_torch.obs.power.
PowerCapture` timeline with the trace and split the measured joules
across stages / replicas / governor windows by busy-span weighting —
each span weighted by the same ``static + dynamic·f³`` watts
``repro_torch.energy.account`` charges (plus an allocated-idle term), so the
measured total is reconciled against the ``energy_report`` prediction
instead of replacing it. See docs/energy.md, "measured power & energy
attribution".

Event conventions consumed here (see docs/observability.md for the full
catalog): frame spans are ``ph=X, cat="frame"`` named by stage on
``{stage}/r{i}`` thread rows; rebuild spans ``ph=X`` named
``runtime/rebuild``; governor decisions ``ph=i, cat="governor"``;
scenario windows ``ph=X, cat="window"`` with an ``over_cap`` arg;
deadline misses ``ph=i`` named ``serve/deadline_miss``; tracer-level
metadata (``dropped_records``) rides the ``trace_metadata`` ``"M"``
record :func:`repro_torch.obs.export.write_perfetto` embeds.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class StageStats:
    name: str
    replicas: int
    frames: int
    busy_s: float
    utilization: float           # busy_s / (replicas * extent_s)
    imbalance: float             # max frames per replica / mean
    mean_queue_wait_s: float     # mean per-frame wait_s arg, 0 if absent
    p99_frame_s: float = 0.0     # p99 frame-span duration
    p99_period_s: float = 0.0    # p99 gap between span starts per replica
    # busy-dominant kernel variant over the stage's frame spans ("base"
    # when spans carry no variant arg). A plan swap that changes the
    # implementation rather than the replica count shows up here, so
    # trace diffs can tell the two apart.
    variant: str = "base"


@dataclasses.dataclass(frozen=True)
class TraceReport:
    extent_s: float              # wall span covered by frame/window spans
    stages: tuple[StageStats, ...]
    rebuild_count: int
    rebuild_stall_s: float       # total traffic-visible stall (see below)
    decisions: tuple[dict, ...]  # governor instants, ts-ordered
    over_cap_windows: int        # window spans flagged over their cap floor
    over_cap_s: float            # total duration of those windows
    over_cap_power_samples: int  # measured power_w samples above cap_w
    dropped_records: int = 0     # ring overflow (trace_metadata record)
    deadline_misses: int = 0     # serve/deadline_miss instants (summed)
    # live-handoff rebuilds overlap the old and new stage sets instead of
    # draining: their span duration is the overlap window (accumulated
    # here), while only their fence exclusion (args.stall_s) counts
    # toward rebuild_stall_s. Drain-mode spans stall for their whole
    # duration, so for them stall == span (and overlap contributes 0).
    rebuild_overlap_s: float = 0.0

    @property
    def p99_period_s(self) -> float:
        """Bottleneck p99 inter-frame period: the slowest stage sets the
        pipeline's delivered period, so regressions gate on the max."""
        return max((s.p99_period_s for s in self.stages), default=0.0)

    def describe(self) -> str:
        lines = [f"trace extent {self.extent_s:.3f} s, "
                 f"{len(self.stages)} stages, "
                 f"{self.rebuild_count} rebuilds "
                 f"({1e3 * self.rebuild_stall_s:.2f} ms stalled, "
                 f"{1e3 * self.rebuild_overlap_s:.2f} ms handoff overlap), "
                 f"{len(self.decisions)} governor decisions"]
        lines.append(f"  {'stage':>12} {'reps':>4} {'frames':>7} "
                     f"{'busy_s':>8} {'util':>6} {'imbal':>6} "
                     f"{'q_wait_ms':>9}")
        for s in self.stages:
            label = s.name if s.variant == "base" \
                else f"{s.name}#{s.variant}"
            lines.append(
                f"  {label:>12} {s.replicas:>4} {s.frames:>7} "
                f"{s.busy_s:>8.3f} {s.utilization:>6.1%} "
                f"{s.imbalance:>6.2f} {1e3 * s.mean_queue_wait_s:>9.3f}")
        for d in self.decisions:
            lines.append(
                f"  t={d['ts_s']:8.3f}s {d['trigger']:>11}"
                + (f" cap={d['cap_w']:.2f} W" if "cap_w" in d else "")
                + ("" if d.get("cap_met", True) else "  [CAP NOT MET]"))
        lines.append(
            f"  over-cap: {self.over_cap_windows} windows "
            f"({self.over_cap_s:.2f} s), "
            f"{self.over_cap_power_samples} measured samples above cap")
        if self.deadline_misses or self.dropped_records:
            lines.append(
                f"  {self.deadline_misses} deadline misses, "
                f"{self.dropped_records} dropped trace records")
        return "\n".join(lines)


def _p99(values: Sequence[float]) -> float:
    """Nearest-rank p99 (matches MetricsRegistry's histogram quantile)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(0, min(len(ordered) - 1,
                      int(round(0.99 * (len(ordered) - 1)))))
    return ordered[rank]


def _step_value_at(samples: list[tuple[float, float]], ts: float):
    """Step-hold lookup in an ascending (ts, value) series."""
    value = None
    for t, v in samples:
        if t <= ts:
            value = v
        else:
            break
    return value


def analyze_trace(events: list[dict]) -> TraceReport:
    """Compute a :class:`TraceReport` from loaded Chrome trace events."""
    frame_spans = [e for e in events
                   if e.get("ph") == "X" and e.get("cat") == "frame"]
    window_spans = [e for e in events
                    if e.get("ph") == "X" and e.get("cat") == "window"]
    rebuilds = [e for e in events if e.get("ph") == "X"
                and e.get("name") == "runtime/rebuild"]
    # stall accounting, handoff-aware: a span carrying a stall_s arg
    # (seconds) stalled traffic only for that long — its duration is the
    # old/new overlap window. Spans without the arg predate the handoff
    # protocol (or are drain-mode traces saved by older code): their
    # whole duration was the stall.
    rebuild_stall_s = 0.0
    rebuild_overlap_s = 0.0
    for e in rebuilds:
        args = e.get("args") or {}
        dur_s = e.get("dur", 0.0) / 1e6
        if "stall_s" in args:
            rebuild_stall_s += float(args["stall_s"])
            if args.get("mode") == "handoff":
                rebuild_overlap_s += dur_s
        else:
            rebuild_stall_s += dur_s
    decisions = sorted(
        (e for e in events
         if e.get("ph") == "i" and e.get("cat") == "governor"),
        key=lambda e: e.get("ts", 0.0))

    bounds = [(e["ts"], e["ts"] + e.get("dur", 0.0))
              for e in frame_spans + window_spans]
    extent_us = (max(b for _, b in bounds) - min(a for a, _ in bounds)) \
        if bounds else 0.0
    extent_s = extent_us / 1e6

    # ------------------------------------------------------ per-stage rows
    by_stage: dict[str, list[dict]] = {}
    for e in frame_spans:
        by_stage.setdefault(e["name"], []).append(e)
    stages = []
    for name in sorted(by_stage):
        spans = by_stage[name]
        per_tid: dict[int, int] = {}
        for e in spans:
            per_tid[e.get("tid", 0)] = per_tid.get(e.get("tid", 0), 0) + 1
        replicas = len(per_tid)
        frames = len(spans)
        busy_s = sum(e.get("dur", 0.0) for e in spans) / 1e6
        mean_frames = frames / replicas if replicas else 0.0
        waits = [e["args"]["wait_s"] for e in spans
                 if e.get("args") and "wait_s" in e["args"]]
        starts_by_tid: dict[int, list[float]] = {}
        for e in spans:
            starts_by_tid.setdefault(e.get("tid", 0), []).append(
                e.get("ts", 0.0))
        periods = [(b - a) / 1e6
                   for starts in starts_by_tid.values()
                   for a, b in zip(sorted(starts), sorted(starts)[1:])]
        var_busy: dict[str, float] = {}
        for e in spans:
            var = (e.get("args") or {}).get("variant") or "base"
            var_busy[var] = var_busy.get(var, 0.0) + e.get("dur", 0.0)
        variant = max(var_busy, key=var_busy.get) if var_busy else "base"
        stages.append(StageStats(
            name=name,
            replicas=replicas,
            frames=frames,
            busy_s=busy_s,
            utilization=busy_s / (replicas * extent_s)
            if replicas and extent_s > 0 else 0.0,
            imbalance=max(per_tid.values()) / mean_frames
            if mean_frames else 0.0,
            mean_queue_wait_s=sum(waits) / len(waits) if waits else 0.0,
            p99_frame_s=_p99([e.get("dur", 0.0) / 1e6 for e in spans]),
            p99_period_s=_p99(periods),
            variant=variant,
        ))

    # ------------------------------------------------- governor decisions
    decision_rows = []
    for e in decisions:
        args = e.get("args") or {}
        row = {"ts_s": e.get("ts", 0.0) / 1e6,
               "trigger": args.get("trigger",
                                   e.get("name", "").split("/")[-1])}
        for key in ("cap_w", "cap_met", "period_us", "watts",
                    "power_margin", "detail", "t_s"):
            if key in args:
                row[key] = args[key]
        decision_rows.append(row)

    # --------------------------------------------------- over-cap analysis
    over = [e for e in window_spans
            if (e.get("args") or {}).get("over_cap")]
    over_cap_s = sum(e.get("dur", 0.0) for e in over) / 1e6

    counters: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") != "C":
            continue
        args = e.get("args") or {}
        ts = e.get("ts", 0.0)
        if "value" in args:  # scalar track, wrapped by the exporter
            if args["value"] is not None:
                counters.setdefault(e["name"], []).append(
                    (ts, args["value"]))
            continue
        # multi-series track: one sub-series per mapping key
        for key, value in args.items():
            if isinstance(value, (int, float)):
                counters.setdefault(f"{e['name']}/{key}", []).append(
                    (ts, value))
    for series in counters.values():
        series.sort(key=lambda s: s[0])
    over_samples = 0
    cap_series = counters.get("cap_w", [])
    for ts, power in counters.get("power_w", []):
        cap = _step_value_at(cap_series, ts)
        if cap is not None and power > cap * (1 + 1e-9):
            over_samples += 1

    dropped = 0
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "trace_metadata":
            dropped += int((e.get("args") or {}).get("dropped_records", 0))
    misses = sum(
        int((e.get("args") or {}).get("count", 1)) for e in events
        if e.get("ph") == "i" and e.get("name") == "serve/deadline_miss")

    return TraceReport(
        extent_s=extent_s,
        stages=tuple(stages),
        rebuild_count=len(rebuilds),
        rebuild_stall_s=rebuild_stall_s,
        rebuild_overlap_s=rebuild_overlap_s,
        decisions=tuple(decision_rows),
        over_cap_windows=len(over),
        over_cap_s=over_cap_s,
        over_cap_power_samples=over_samples,
        dropped_records=dropped,
        deadline_misses=misses,
    )


# ===================================================================
# Measured-energy attribution (trace x PowerCapture alignment)
# ===================================================================
@dataclasses.dataclass(frozen=True)
class StageAttribution:
    """Measured joules assigned to one stage, with the model-side
    prediction it was weighted by."""

    name: str
    busy_s: float                # summed frame-span time in the extent
    attributed_j: float          # measured share (busy_j + idle_j)
    busy_j: float                # share charged to running frames
    idle_j: float                # share charged to allocated-idle cores
    predicted_j: float           # static + dynamic f^3 model prediction
    replicas: dict              # replica row -> busy joules share

    @property
    def residual_j(self) -> float:
        """attributed - predicted: positive means the stage drew more
        than the calibrated model expected."""
        return self.attributed_j - self.predicted_j


@dataclasses.dataclass(frozen=True)
class WindowAttribution:
    """Measured draw over one governor/scenario window span."""

    index: int
    t0_s: float
    t1_s: float
    measured_j: float
    measured_w: float
    predicted_w: float | None    # the plan's predicted draw, if recorded

    @property
    def error_w(self) -> float | None:
        if self.predicted_w is None:
            return None
        return self.measured_w - self.predicted_w


@dataclasses.dataclass(frozen=True)
class EnergyAttribution:
    """Measured joules reconciled against the trace.

    ``sum(s.attributed_j for s in stages) == measured_j`` holds exactly
    (pro-rata weighting); ``unattributed_j`` is capture energy outside
    the trace extent — draw the trace cannot explain.
    """

    t0_s: float
    t1_s: float
    measured_j: float            # capture energy inside the trace extent
    predicted_j: float           # model total over the same extent
    unattributed_j: float        # capture energy outside the extent
    stages: tuple[StageAttribution, ...]
    windows: tuple[WindowAttribution, ...]

    @property
    def extent_s(self) -> float:
        return self.t1_s - self.t0_s

    @property
    def measured_w(self) -> float:
        return self.measured_j / self.extent_s if self.extent_s > 0 else 0.0

    @property
    def prediction_error(self) -> float:
        """Relative model error vs measurement (0 when no model)."""
        if self.measured_j <= 0 or self.predicted_j <= 0:
            return 0.0
        return (self.predicted_j - self.measured_j) / self.measured_j

    def describe(self) -> str:
        lines = [f"measured {self.measured_j:.3f} J over "
                 f"{self.extent_s:.3f} s ({self.measured_w:.2f} W avg), "
                 f"model predicted {self.predicted_j:.3f} J "
                 f"({self.prediction_error:+.1%}), "
                 f"{self.unattributed_j:.3f} J outside the trace extent"]
        lines.append(f"  {'stage':>12} {'busy_s':>8} {'meas_J':>8} "
                     f"{'busy_J':>8} {'idle_J':>8} {'model_J':>8} "
                     f"{'resid':>7}")
        for s in self.stages:
            lines.append(
                f"  {s.name:>12} {s.busy_s:>8.3f} {s.attributed_j:>8.3f} "
                f"{s.busy_j:>8.3f} {s.idle_j:>8.3f} {s.predicted_j:>8.3f} "
                f"{s.residual_j:>+7.3f}")
        for w in self.windows:
            err = "" if w.error_w is None \
                else f"  err={w.error_w:+.2f} W vs plan"
            lines.append(
                f"  window {w.index:>3} [{w.t0_s:7.3f},{w.t1_s:7.3f}] "
                f"{w.measured_j:8.3f} J {w.measured_w:6.2f} W{err}")
        return "\n".join(lines)


def _thread_names(events: Sequence[Mapping]) -> dict[int, str]:
    names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            args = e.get("args") or {}
            if "name" in args:
                names[e.get("tid", 0)] = args["name"]
    return names


def attribute_energy(
    events: Sequence[Mapping],
    capture,
    *,
    stage_info: Mapping[str, Mapping] | None = None,
    power=None,
    domain: str | None = None,
    offset_s: float = 0.0,
) -> EnergyAttribution:
    """Split a measured power capture's joules across the trace.

    ``events`` are loaded Chrome dicts, ``capture`` a
    :class:`repro_torch.obs.power.PowerCapture` (duck-typed: anything with
    ``energy_between(t0, t1, domain)`` / ``total_energy(domain)``).
    Capture time is trace time plus ``offset_s``.

    Weighting: each stage gets weight ``busy_s x busy_watts(ctype, f) +
    (cores x extent - busy_s) x idle_watts(ctype)`` when ``power`` (a
    ``repro_torch.energy.model.PowerModel``-shaped object) and ``stage_info``
    (stage name -> ``{"ctype", "freq", "cores"}``, see
    ``repro_torch.control.calibrate.stage_info_from_plan``) are given — the
    exact ``static + dynamic f^3`` decomposition ``energy.account``
    charges, so the weights double as the model's predicted joules and
    the attribution is a reconciliation. Without a model, spans weight
    by busy time alone (idle draw folds into the busy shares).

    Measured joules inside the trace extent are assigned pro rata, so
    stage shares always sum to the measured total exactly; per-replica
    shares split each stage's busy portion by replica busy time.
    """
    stage_info = stage_info or {}
    frame_spans = [e for e in events
                   if e.get("ph") == "X" and e.get("cat") == "frame"]
    window_spans = sorted(
        (e for e in events
         if e.get("ph") == "X" and e.get("cat") == "window"),
        key=lambda e: e.get("ts", 0.0))
    bounds = [(e["ts"], e["ts"] + e.get("dur", 0.0))
              for e in frame_spans + window_spans]
    if bounds:
        t0_s = min(a for a, _ in bounds) / 1e6
        t1_s = max(b for _, b in bounds) / 1e6
    else:
        t0_s = t1_s = 0.0
    extent_s = t1_s - t0_s
    measured_j = capture.energy_between(
        t0_s + offset_s, t1_s + offset_s, domain) if extent_s > 0 else 0.0
    total_capture_j = capture.total_energy(domain)
    names = _thread_names(events)

    # per-stage busy time, per replica
    by_stage: dict[str, dict[int, float]] = {}
    for e in frame_spans:
        tids = by_stage.setdefault(e["name"], {})
        tid = e.get("tid", 0)
        tids[tid] = tids.get(tid, 0.0) + e.get("dur", 0.0) / 1e6

    # model-side weights per stage
    rows = []
    for name in sorted(by_stage):
        busy_s = sum(by_stage[name].values())
        info = stage_info.get(name)
        if power is not None and info is not None:
            bw = power.busy_watts(info["ctype"],
                                  float(info.get("freq", 1.0)))
            iw = power.idle_watts(info["ctype"])
            idle_core_s = max(
                0.0, info.get("cores", 1) * extent_s - busy_s)
            busy_weight = busy_s * bw
            idle_weight = idle_core_s * iw
            predicted_j = busy_weight + idle_weight
        else:
            busy_weight, idle_weight, predicted_j = busy_s, 0.0, 0.0
        rows.append((name, busy_s, busy_weight, idle_weight, predicted_j))

    total_weight = sum(bw + iw for _, _, bw, iw, _ in rows)
    stages = []
    for name, busy_s, busy_weight, idle_weight, predicted_j in rows:
        weight = busy_weight + idle_weight
        attributed = measured_j * weight / total_weight \
            if total_weight > 0 else 0.0
        busy_j = attributed * busy_weight / weight if weight > 0 else 0.0
        replicas = {}
        if busy_s > 0:
            for tid, rep_busy in sorted(by_stage[name].items()):
                row = names.get(tid, f"tid{tid}")
                replicas[row] = busy_j * rep_busy / busy_s
        stages.append(StageAttribution(
            name=name, busy_s=busy_s, attributed_j=attributed,
            busy_j=busy_j, idle_j=attributed - busy_j,
            predicted_j=predicted_j, replicas=replicas))

    windows = []
    for i, e in enumerate(window_spans):
        w0 = e.get("ts", 0.0) / 1e6
        w1 = w0 + e.get("dur", 0.0) / 1e6
        if w1 <= w0:
            continue
        wj = capture.energy_between(w0 + offset_s, w1 + offset_s, domain)
        args = e.get("args") or {}
        predicted_w = args.get("predicted_w")
        windows.append(WindowAttribution(
            index=int(args.get("index", i)), t0_s=w0, t1_s=w1,
            measured_j=wj, measured_w=wj / (w1 - w0),
            predicted_w=float(predicted_w)
            if predicted_w is not None else None))

    return EnergyAttribution(
        t0_s=t0_s, t1_s=t1_s,
        measured_j=measured_j,
        predicted_j=sum(s.predicted_j for s in stages),
        unattributed_j=max(0.0, total_capture_j - measured_j),
        stages=tuple(stages),
        windows=tuple(windows),
    )
