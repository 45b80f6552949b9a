"""The program's spans on the profiler's clock (``bench/program_spans.py``),
on the CPU: the clock anchors map a tracer span onto the profiler range
around the same work, an idle gap is split over the program spans that
cover it, a trace without program spans reduces exactly as
``harness.reduce_trace`` does, each reader reads its number or nothing,
and ``given_tracer`` reaches the program the drivers build."""
import time
import types

import pytest
import smoke

from bench import harness
from bench import program_spans as ps

torch = pytest.importorskip("torch")

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from repro_torch.obs import TraceEvent, Tracer  # noqa: E402


def test_anchor_maps_a_span_onto_its_range():
    """A tracer span and a profiler range around the same sleep agree
    within 0.5 ms once mapped through the anchors."""
    tracing = ps.ProgramTracing(False)
    tracer = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing._anchor()
        with record_function("probe"):
            with tracer.span("probe"):
                time.sleep(0.05)
        tracing._anchor()
    events = list(prof.events())
    to_us, skew, drift = ps.clock_map(events, tracing.anchors)
    (rng,) = [e for e in events if e.name == "probe"]
    (span,) = [e for e in tracer.drain() if e.name == "probe"]
    assert abs(to_us(span.ts) - rng.time_range.start) < 500
    assert abs(to_us(span.ts + span.dur) - rng.time_range.end) < 500
    assert 0 <= skew < 500 and abs(drift) < 500


def _event(name, start, end, device=False, note=False, id=0):
    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=note, id=id)


# clock reads at 1..10 µs whose ranges sit on them: the two clocks agree
ANCHORS = [k * 1e-6 for k in range(1, 2 * ps.ANCHOR_TRIES + 1)]
CLOCK = [_event("bench/clock", t * 1e6 - 0.25, t * 1e6 + 0.25)
         for t in ANCHORS]


def _span(name, start_us, end_us, cat="serve", tid=1):
    return TraceEvent("X", name, start_us * 1e-6, (end_us - start_us) * 1e-6,
                      tid, cat)


def _synthetic():
    """Kernels at 0-100, 300-400 and 500-600 µs: a gap of 200 µs under
    ``serve/feed`` (100-180) and ``serve/wait`` (180-300) inside one
    ``serve/step``, and one of 100 µs that only a benchmark range
    covers."""
    events = CLOCK + [
        _event("k", 0, 100, device=True), _event("k", 300, 400, device=True),
        _event("k", 500, 600, device=True),
        _event("bench/engine.step", 380, 520)]
    spans = [_span("serve/step", 50, 350), _span("serve/feed", 80, 180),
             _span("serve/wait", 180, 330),
             _span("serve/decode", 0, 600, cat="request")]
    return events, spans


def test_gap_split_between_program_spans():
    events, spans = _synthetic()
    out = ps.reduce_program(events, 600e-6, spans, ANCHORS, 0.0, 600e-6)
    idle = out["idle_by_span"]
    assert set(idle) == {"serve/feed", "serve/wait", "bench/engine.step"}
    assert idle["serve/feed"] == pytest.approx(80e-6)
    assert idle["serve/wait"] == pytest.approx(120e-6)
    assert idle["bench/engine.step"] == pytest.approx(100e-6)
    assert out["idle_s"] == pytest.approx(out["window_s"] - out["busy_s"])
    assert out["busy_host_s"] == pytest.approx(out["busy_s"])
    assert [g[0] for g in out["breakdown"]["idle_gaps"]] == [
        "serve/wait", "bench/engine.step"]
    assert out["program_spans"]["serve/step"] == {
        "count": 1, "seconds": pytest.approx(300e-6), "cat": "serve"}
    assert out["clock_skew_us"] == pytest.approx(0.5)
    assert out["clock_drift_us"] == pytest.approx(0.0, abs=1e-6)
    assert out["dropped_records"] == 0


def _steps(drift, n=60, period=40_000.0):
    """Serve-like steps every ``period`` µs whose device work sits
    ``drift`` µs a µs late on the profiler's device clock: a token copy
    20 µs after its call, one kernel, and a blocking copy back that ends
    30 µs before its call returns."""
    events, k = [], 1
    for i in range(n):
        t = i * period
        late = lambda x: x + drift * x  # noqa: E731
        events += [
            _event("cudaMemcpyAsync", t, t + 10, id=k),
            _event("Memcpy HtoD (Pinned -> Device)", late(t + 20),
                   late(t + 22), device=True, id=k),
            _event("cudaGraphLaunch", t + 30, t + 400, id=k + 1),
            _event("k", late(t + 60), late(t + 30_000), device=True,
                   id=k + 1),
            _event("cudaMemcpyAsync", t + 30_100, t + 30_200, id=k + 2),
            _event("Memcpy DtoH (Device -> Pageable)", late(t + 30_160),
                   late(t + 30_170), device=True, id=k + 2)]
        k += 3
    return events


@pytest.mark.parametrize("drift", [0.0, 3.7e-3, -1e-3])
def test_device_clock_undoes_a_drift(drift):
    """The device work of each step lands back between its calls: the
    alignment takes the drift out, to the middle of the band the two
    bounds leave (here 20 µs below the truth and 30 above it), and a late
    return of one blocking copy does not move it."""
    events = _steps(drift)
    late = events[4 + 6 * 30]            # step 30 returns from its copy late
    late.time_range.end += 400
    to_host, summary = ps.device_clock(events)
    assert summary["drift_us_per_s"] == pytest.approx(-drift * 1e6, abs=2.0)
    # each H2D copy, 20 µs after its call, lands midway in its 50-µs band
    for t in (20.0, 1_200_020.0, 2_360_020.0):
        assert to_host(t + drift * t) == pytest.approx(t + 5.0, abs=1.0)
    assert summary["band_us"] == pytest.approx(50.0, abs=1.0)
    same, none = ps.device_clock(_steps(drift)[:3])
    assert none is None and same(1e6) == 1e6


def test_split_takes_the_innermost_span():
    pieces = ps.split([(0.0, 10.0)], [(0.0, 10.0, "outer", 1),
                                      (2.0, 6.0, "inner", 1),
                                      (2.0, 4.0, "innermost", 1),
                                      (-5.0, 20.0, "range", 0)])
    assert pieces == [(0.0, 2.0, "outer"), (2.0, 4.0, "innermost"),
                      (4.0, 6.0, "inner"), (6.0, 10.0, "outer")]
    assert ps.split([(0.0, 1.0)], [(2.0, 3.0, "later", 1)]) == [
        (0.0, 1.0, None)]


def test_trace_without_program_spans_reduces_as_today():
    events, _ = _synthetic()
    want = harness.reduce_trace(events, 600e-6)
    outside = [_span("serve/step", 700, 800)]
    for got in (None, [], outside):
        assert ps.reduce_program(events, 600e-6, got, ANCHORS, 0.0,
                                 600e-6) == want


def _record():
    sp = {"serve/step": (2, 0.1, "serve"), "serve/wait": (2, 0.06, "serve"),
          "serve/replay": (2, 0.01, "serve"), "s0-43": (2, 0.24, "frame"),
          "emit": (2, 0.1, "task"), "stage/sync": (2, 0.02, "task")}
    peaks = harness.load_json(harness.BENCH / "peaks.json")
    dims = harness.load_json(harness.BENCH / "configs"
                             / "phi3-medium-14b.json")["as_run"]
    return {"serve": {"prompt_stream_ms": [float(k) for k in range(101)]},
            "chain": {"tokens_per_frame": 2048},
            "peaks": next(iter(peaks.values())), "dims": dims,
            "trace": {"program_spans": {k: {"count": c, "seconds": s,
                                            "cat": cat}
                                        for k, (c, s, cat) in sp.items()},
                      "annotations": {"attention": {"count": 40,
                                                    "seconds": 0.02}},
                      "kernels": {"flash_fwd_tc<128>": {"launches": 40,
                                                        "seconds": 0.02}}}}


def test_readers_read_their_number_or_nothing():
    rec = _record()
    assert ps.prompt_stream_ms_p95(rec) == pytest.approx(95.0)
    assert ps.engine_host_ms_per_step(rec) == pytest.approx(20.0)
    assert ps.captured_step_ms(rec) == pytest.approx(35.0)
    assert ps.stage_issue_ms_per_frame(rec) == pytest.approx(60.0)
    # on the same device time, the range's roofline is the kernels'
    kernels = harness.load_module("metrics", "attention_roofline.chain")
    assert ps.attention_span_roofline(rec) == pytest.approx(
        kernels.read(rec)) and 0 < kernels.read(rec) < 100
    assert set(ps.READERS) == {
        "prompt_stream_ms_p95.serve", "engine_host_ms_per_step.serve",
        "captured_step_ms.serve", "stage_issue_ms_per_frame.chain",
        "attention_span_roofline.chain"}
    for reader in ps.READERS.values():
        assert reader({}) is None
        assert reader({"trace": {}, "serve": {}}) is None


@pytest.mark.parametrize("workload", ["phi3-14b.serve", "phi3-14b.chain"])
def test_given_tracer_reaches_the_program(workload):
    """A smoke cell set up inside ``given_tracer`` records the engine's or
    the stage's spans; outside it the drivers build with no tracer."""
    from repro_torch.serve import engine

    cell = smoke.smoke_cell(workload, seconds=1.0)
    tracer = Tracer()
    tracing = ps.ProgramTracing(False, tracer)
    run = harness.load_module("drivers", cell.mix["driver"]).Run(
        cell, tracing)
    with ps.given_tracer(tracer):
        run.setup()
    assert isinstance(engine.ServeEngine, type)
    rec = run.window(harness.Meter())
    run.free()
    assert rec["failed"] == 0
    names = {e.name for e in tracer.drain()}
    if cell.mix["driver"] == "serve":
        assert {"serve/step", "serve/admit", "serve/lane_reset",
                "serve/replay", "serve/wait", "serve/emit", "serve/prompt",
                "serve/decode"} <= names
        waits = ps.prompt_stream_ms(run, tracing)
        assert waits and all(w >= 0 for w in waits)
    else:
        assert {"ingest", "embed", "layer0", "head", "emit",
                "runtime/handoff"} <= names
