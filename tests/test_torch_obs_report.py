"""The port's trace exporters (``repro_torch.obs.export``) and trace
analysis (``repro_torch.obs.report.analyze_trace``) against ``repro.obs``:
the export, report and runtime-tracing cases of ``tests/test_obs.py``.
The same events (one tracer of each package fed the same timestamps, or
one port run's trace) go through both packages' exporters and analyses,
whose records and reports must be equal with ``==``
(``_torch_parity.canon``); the reference's checks then hold on the port's
result, and a governed scenario's trace reconciles with what
``run_scenario`` measured."""
import json
import time
import types

import numpy as np
import pytest

from _torch_parity import canon

import repro.obs as jobs
import repro.obs.export as jexport
import repro_torch.obs as tobs
import repro_torch.obs.export as texport
from repro_torch.control import Governor, ScriptedBudget, run_scenario
from repro_torch.core import TaskChain
from repro_torch.energy import CoreTypePower, PowerModel, pareto_frontier
from repro_torch.obs import (
    MetricsRegistry, Tracer, analyze_trace, load_trace, to_chrome_events,
    write_perfetto)
from repro_torch.pipeline import StageSpec, StreamingPipelineRuntime

REF = types.SimpleNamespace(obs=jobs, export=jexport)
PORT = types.SimpleNamespace(obs=tobs, export=texport)


def _script(pkg, ring_size=4096):
    """One tracer of ``pkg`` fed a fixed script: spans, instants, scalar,
    numpy and mapping counters, and (with a small ring) drops."""
    tr = pkg.obs.Tracer(ring_size=ring_size)
    tr.set_thread_name("stage/r0")
    t = 100.0
    for i in range(12):
        tr.complete(f"f{i}", t + i * 0.1, 0.05, cat="frame",
                    args={"seq": i})
    tr.instant("governor/cap", cat="governor", args={"trigger": "cap"},
               ts=t + 1.0)
    tr.counter("cap_w", np.float32(18.0), ts=t + 1.0)
    tr.counter("power_corrections", {"B": np.float64(1.5), "L": 1.0},
               ts=t + 2.0)
    tr.counter("multi", {"a": 1.0, "b": 2.0}, ts=t + 2.0)
    return tr


@pytest.mark.parametrize("ring_size", [4096, 8])
def test_export_records_match_reference(ring_size, tmp_path):
    """Chrome records, the written file and the loaded trace of the same
    script equal the reference's, ring overflow and metadata included."""
    out = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        tr = _script(pkg, ring_size)
        events = tr.drain()
        recs = pkg.export.to_chrome_events(events)
        path = pkg.export.write_perfetto(
            events, tmp_path / f"{name}.json",
            dropped_records=tr.dropped_records, metadata={"run": "unit"})
        loaded = pkg.export.load_trace(path)
        out[name] = (recs, json.loads(path.read_text()), loaded,
                     tr.dropped_records, pkg.obs.analyze_trace(loaded))
    assert canon(out["port"]) == canon(out["ref"])
    recs, data, loaded, dropped, report = out["port"]
    assert data["displayTimeUnit"] == "ms"
    assert (dropped > 0) == (ring_size == 8)
    assert report.dropped_records == dropped
    (meta,) = [e for e in loaded if e.get("ph") == "M"
               and e.get("name") == "trace_metadata"]
    assert meta["args"] == {"run": "unit", "dropped_records": dropped}
    rows = [e["args"] for e in loaded if e.get("ph") == "C"
            and e["name"] == "power_corrections"]
    assert rows == [{"B": 1.5, "L": 1.0}]


def test_chrome_export_format():
    tr = Tracer()
    tr.set_thread_name("stage/r0")
    t = tr.now()
    tr.complete("frame0", t, 0.25, cat="frame", args={"seq": 0})
    tr.instant("governor/cap", cat="governor", args={"trigger": "cap"},
               ts=t + 1.0)
    tr.counter("cap_w", 18.0, ts=t + 1.0)
    tr.counter("multi", {"a": 1.0, "b": 2.0}, ts=t + 2.0)
    events = tr.drain()
    recs = to_chrome_events(events)
    assert canon(recs) == canon(jexport.to_chrome_events(events))
    by_ph = {}
    for r in recs:
        by_ph.setdefault(r["ph"], []).append(r)
    assert by_ph["M"][0]["args"] == {"name": "stage/r0"}
    span, inst = by_ph["X"][0], by_ph["i"][0]
    assert span["cat"] == "frame" and span["dur"] == pytest.approx(0.25e6)
    assert inst["s"] == "p" and inst["args"]["trigger"] == "cap"
    counters = {c["name"]: c for c in by_ph["C"]}
    assert counters["cap_w"]["args"] == {"value": 18.0}
    assert counters["multi"]["args"] == {"a": 1.0, "b": 2.0}
    assert min(r.get("ts", 0.0) for r in recs) == 0.0
    assert inst["ts"] - span["ts"] == pytest.approx(1e6, rel=1e-6)


def test_write_and_load_round_trip(tmp_path):
    tr = Tracer()
    tr.complete("x", tr.now(), 0.001, cat="frame")
    path = write_perfetto(tr.drain(), tmp_path / "trace.json")
    events = load_trace(path)
    assert len(events) == 1 and events[0]["name"] == "x"
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps(events))
    assert load_trace(bare) == events == jexport.load_trace(bare)


def _span(name, cat, ts_us, dur_us, tid=1, args=None, ph="X"):
    e = {"ph": ph, "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts_us}
    if ph == "X":
        e["dur"] = dur_us
    if args:
        e["args"] = args
    return e


def test_analyze_synthetic_trace_like_reference():
    """Every section of a report on hand-made events: stage rows over
    replicas, rebuilds (stall summed), over-cap windows, decisions,
    deadline misses, counters and drop metadata."""
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": t,
               "args": {"name": f"s0-1/r{t - 1}"}} for t in (1, 2)]
    events += [_span("s0-1", "frame", i * 1e4, 6e3, tid=1 + i % 2,
                     args={"seq": i, "wait_s": 1e-3 * i})
               for i in range(40)]
    events += [_span("s2-3", "frame", i * 1e4 + 6e3, 3e3, tid=3,
                     args={"seq": i, "wait_s": 0.0}) for i in range(40)]
    events += [
        _span("runtime/rebuild", "control", 1e5, 5e4,
              args={"mode": "handoff", "stall_s": 2e-5, "fence": 10}),
        _span("runtime/rebuild", "control", 3e5, 1e4,
              args={"mode": "drain", "stall_s": 1e-2, "fence": 30}),
        _span("window", "window", 0.0, 2e5,
              args={"index": 0, "over_cap": False, "cap_w": 10.0}),
        _span("window", "window", 2e5, 2e5,
              args={"index": 1, "over_cap": True, "cap_w": 5.0}),
        _span("governor/cap", "governor", 2e5, 0, ph="i",
              args={"trigger": "cap", "cap_w": 5.0}),
        _span("serve/deadline_miss", "serve", 3e5, 0, ph="i",
              args={"count": 2}),
        {"ph": "C", "name": "cap_w", "pid": 1, "tid": 0, "ts": 0.0,
         "args": {"value": 10.0}},
        {"ph": "C", "name": "cap_w", "pid": 1, "tid": 0, "ts": 2e5,
         "args": {"value": 5.0}},
        {"ph": "M", "name": "trace_metadata", "pid": 1, "tid": 0,
         "args": {"dropped_records": 3}},
    ]
    ours, ref = analyze_trace(events), jobs.analyze_trace(events)
    assert canon(ours) == canon(ref)
    by_name = {s.name: s for s in ours.stages}
    assert by_name["s0-1"].replicas == 2 and by_name["s0-1"].frames == 40
    assert ours.rebuild_count == 2 and ours.deadline_misses == 2
    assert ours.over_cap_windows == 1 and ours.dropped_records == 3


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_runtime_trace_matches_run_stats(executor, tmp_path):
    """Perfetto round trip against ground truth: the per-stage busy time
    and queue waits the report reconstructs from the port's runtime trace
    match what ``run()`` measured, and the reference's analysis of the
    same file gives the same report."""
    tracer = Tracer()
    stages = [StageSpec("fast", lambda x: x),
              StageSpec("slow", lambda x: (time.sleep(0.002), x)[1],
                        replicas=2)]
    rt = StreamingPipelineRuntime(stages, tracer=tracer,
                                  executor=executor).start()
    stats = rt.run(list(range(40)), timeout_s=60.0)
    rt.stop()
    path = write_perfetto(tracer.drain(), tmp_path / "rt.json")
    report = analyze_trace(load_trace(path))
    assert canon(report) == canon(jobs.analyze_trace(jexport.load_trace(path)))
    by_name = {s.name: s for s in report.stages}
    assert set(by_name) == {"fast", "slow"}
    assert by_name["fast"].frames == by_name["slow"].frames == 40
    assert by_name["slow"].replicas == 2
    for name in ("fast", "slow"):
        busy = sum(v for (s, _), v in stats["busy_s"].items() if s == name)
        assert by_name[name].busy_s == pytest.approx(busy, rel=1e-3)
        wait = sum(v for (s, _), v in stats["queue_wait_s"].items()
                   if s == name)
        assert by_name[name].mean_queue_wait_s * by_name[name].frames \
            == pytest.approx(wait, rel=1e-3)
    assert by_name["slow"].utilization > 5 * by_name["fast"].utilization
    assert report.rebuild_count == 0 and report.over_cap_windows == 0
    assert tracer.dropped_records == 0


def test_tracer_rows_are_per_replica_threads():
    """Each worker thread is its own named ``{stage}/r{replica}`` row."""
    tracer = Tracer()
    rt = StreamingPipelineRuntime(
        [StageSpec("s", lambda x: (time.sleep(0.001), x)[1], replicas=3)],
        tracer=tracer).start()
    rt.run(list(range(30)))
    rt.stop()
    recs = to_chrome_events(tracer.drain())
    names = {r["args"]["name"] for r in recs if r["ph"] == "M"
             and r["name"] == "thread_name"}
    assert names == {"s/r0", "s/r1", "s/r2"}


def test_governed_scenario_trace_round_trip(tmp_path):
    """A reactive governor hit by a mid-window cap drop and a device loss:
    the exported trace carries frame spans, trigger-labelled decision
    instants, cap/power counter tracks and rebuilds, and both packages'
    reports of it agree with each other and with the ScenarioResult."""
    chain = TaskChain(w_big=[10.0, 40.0, 40.0, 10.0],
                      w_little=[25.0, 100.0, 100.0, 25.0],
                      replicable=[False, True, True, False])
    power = PowerModel("t", CoreTypePower(0.1, 0.9),
                       CoreTypePower(0.03, 0.32))
    front = pareto_frontier(chain, 3, 2, power)
    watts = [pt.energy / pt.period for pt in front]
    budget = ScriptedBudget(((0.0, watts[0] + 1.0), (1.5, watts[-1] * 1.001)))
    # measurement-driven triggers off: the plan sequence is the script's
    gov = Governor(chain, 3, 2, power, budget, drift_tolerance=100.0,
                   power_tolerance=100.0)
    tracer, metrics = Tracer(), MetricsRegistry()
    res = run_scenario(gov, time_scale=2e-6, n_windows=5, window_dt=1.0,
                       frames_per_window=20, device_loss_at={3: (0, 1)},
                       tracer=tracer, metrics=metrics)
    assert [e.trigger for e in res.replans] == ["cap", "device_loss"]
    assert len(res.over_cap_windows) >= 1

    path = write_perfetto(tracer.drain(), tmp_path / "gov.json")
    report = analyze_trace(load_trace(path))
    assert canon(report) == canon(jobs.analyze_trace(jexport.load_trace(path)))
    assert report.over_cap_windows == len(res.over_cap_windows)
    assert report.over_cap_s > 0
    assert report.rebuild_count == len(res.replans)
    assert report.rebuild_stall_s > 0
    triggers = [d["trigger"] for d in report.decisions]
    assert triggers == ["start"] + [e.trigger for e in res.replans]
    assert all("cap_w" in d for d in report.decisions)
    assert report.stages and all(s.frames > 0 for s in report.stages)
    assert sum(s.frames for s in report.stages) >= res.frames_fed
    counters = {e["name"] for e in load_trace(path) if e.get("ph") == "C"}
    assert {"cap_w", "power_w"} <= counters
    assert metrics.counter("scenario/frames_fed") == res.frames_fed
    assert metrics.counter("scenario/frames_dropped") == res.frames_dropped
    assert metrics.counter("scenario/replans") == len(res.replans)
    assert metrics.snapshot()["histograms"]["scenario/period_us"][
        "count"] == len(res.windows)
