"""The program's own spans on the profiler's clock: one cell run with the
port's ``repro_torch.obs.Tracer`` switched on, beside the benchmark.

``bench/run.py`` builds the program with no tracer and labels each idle
gap of the card by the benchmark's own ranges (``bench/...``). This tool
runs a cell's driver the same way, with a tracer given to ``ServeEngine``,
``model_stage_builder`` and ``StreamingPipelineRuntime.from_plan``
(:func:`given_tracer`), and with ``--trace 1`` maps the spans the program
recorded in the profiled slice onto the profiler's timeline
(:class:`ProgramTracing`): the tracer's ``perf_counter`` times through
clock anchors (:func:`clock_map`), the device's times through causality
with the calls that issued its work (:func:`device_clock`). Its line adds
to the reduced trace:

  program_spans     {name: {count, seconds, cat}} of the spans inside the
                    slice
  idle_by_span      the card's idle seconds in the slice (the gaps between
                    its activity and at the slice's two ends), each part
                    given to the innermost host span of the program that
                    covers it, else to the innermost benchmark range
  idle_s            their sum: ``window_s`` less ``busy_host_s``, the
                    device's busy time on the host's clock (``busy_s`` is
                    on the device's)
  clock_skew_us     the width of the widest clock anchor used
  clock_drift_us    how far perf_counter moved from the profiler's host
                    clock over the slice
  device_clock      the device clock's shift onto the host's, its drift
                    and the band its bounds leave
  dropped_records   the tracer's ring overwrites inside the slice
  clock_agreement   (serve) the shares of steps whose token copy to the
                    device starts inside ``serve/replay``, whose copy back
                    ends inside ``serve/wait``, and whose graph launch
                    call lies inside ``serve/replay``

and labels the breakdown's ``idle_gaps`` by the program span covering
most of each gap. Request spans (cat ``request``) say what a request is
waiting for, not what the host is doing, and are left out of
``idle_by_span``. ``--all-threads 1`` records every thread's ranges (the
chain's ``attention`` ranges run in its stage threads). :data:`READERS`
reads five per-layer numbers from that record. With ``--trace 0`` the line
gives the window's host numbers and the spans' totals over the whole
window, so that runs with the tracer on and off measure what it costs.

    python3 bench/program_spans.py --workload phi3-14b.serve --seed 5 \\
        --seconds 30 --trace 1 --tracer 1

It needs a CUDA card, like ``bench/run.py``, and prints one JSON line.

The module is temporary: once ``bench/harness.py`` ``Tracing`` and the
drivers take in its tracer, anchors, ``device_clock`` and
``reduce_program`` (passing ``tracer=`` directly, with no patching) and
its readers become files under ``bench/metrics/``, it is deleted.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import json
import math
import re
import statistics
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
for _p in (CHECKOUT / "src", CHECKOUT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from bench import harness, work  # noqa: E402

# each anchor is this many ``bench/clock`` ranges; the narrowest is used
ANCHOR_TRIES = 20
HOST_GAP_LABEL = "host outside the benchmark's ranges"
H2D = re.compile(r"Memcpy HtoD")
D2H = re.compile(r"Memcpy DtoH")
# a copy to pageable memory blocks its call until the device has copied
BLOCKING = re.compile(r"Memcpy DtoH \(Device -> Pageable\)")
# a blocking copy whose call returns this much (µs) later than its
# neighbours' line says returned late, and is put back on the line
LATE_RETURN_US = 50.0


# ------------------------------------------------------------ the program
@contextlib.contextmanager
def given_tracer(tracer):
    """Inside the block, the program as the drivers build it, with
    ``tracer`` given to ``ServeEngine``, ``model_stage_builder`` and
    ``StreamingPipelineRuntime.from_plan`` (the drivers pass none)."""
    if tracer is None:
        yield
        return
    from unittest import mock

    from repro_torch.pipeline import StreamingPipelineRuntime, stages
    from repro_torch.serve import engine

    with mock.patch.object(engine, "ServeEngine", functools.partial(
            engine.ServeEngine, tracer=tracer)), \
        mock.patch.object(stages, "model_stage_builder", functools.partial(
            stages.model_stage_builder, tracer=tracer)), \
        mock.patch.object(StreamingPipelineRuntime, "from_plan",
                          functools.partial(
                              StreamingPipelineRuntime.from_plan,
                              tracer=tracer)):
        yield


class ProgramTracing(harness.Tracing):
    """``harness.Tracing`` with the program's tracer: clock anchors (a
    ``bench/clock`` range around a ``perf_counter`` read) as the profiler
    starts and before it stops, the tracer drained as the slice opens and
    as it closes, and :func:`reduce_program` over both."""

    def __init__(self, on: bool, tracer=None, all_threads: bool = False):
        super().__init__(on)
        self.tracer = tracer
        # record every thread's ranges (the chain's stage threads'), not
        # only those of the thread that starts the profiler
        self.all_threads = all_threads
        self.anchors: list[float] = []
        self.spans = None
        self.dropped = 0

    def _anchor(self) -> None:
        from torch.profiler import record_function

        for _ in range(ANCHOR_TRIES):
            with record_function("bench/clock"):
                self.anchors.append(time.perf_counter())

    def start(self) -> None:
        if self.all_threads:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import ProfilerActivity, profile

            begin = time.perf_counter()
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
            self.prof.start()
            self.t0 = time.perf_counter()
            self.blocked.append((begin, self.t0))
        else:
            super().start()
        begin = time.perf_counter()
        self._anchor()
        if self.tracer is not None:
            self.tracer.drain()
            self.dropped = self.tracer.dropped_records
        self.blocked.append((begin, time.perf_counter()))

    def stop(self) -> None:
        begin = time.perf_counter()
        self._anchor()
        self.blocked.append((begin, time.perf_counter()))
        super().stop()
        if self.tracer is not None:
            self.spans = self.tracer.drain()
            self.dropped = self.tracer.dropped_records - self.dropped

    def reduce(self) -> dict | None:
        if self.result is None and self.prof is not None:
            self.result = reduce_program(
                self.prof.events(), self.t1 - self.t0, self.spans,
                self.anchors, self.t0, self.t1, self.dropped)
            self.prof = None
        return self.result


# ------------------------------------------------------------- the clock
def clock_map(events, anchors: list[float]):
    """(to_us, skew_us, drift_us): ``to_us(t)`` maps a ``perf_counter``
    time onto the profiler's timeline (µs), from the ``bench/clock``
    ranges around the ``anchors`` reads, in order: the narrowest of the
    first ``ANCHOR_TRIES`` and of the last, the offset interpolated
    between them."""
    from torch.autograd import DeviceType

    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "bench/clock"
                    and e.device_type != DeviceType.CUDA)
    if len(ranges) != len(anchors) or not ranges:
        raise ValueError(f"{len(ranges)} bench/clock ranges for "
                         f"{len(anchors)} clock reads")
    pairs = list(zip(anchors, ranges))

    def best(group):
        t, (s, e) = min(group, key=lambda p: p[1][1] - p[1][0])
        return t, (s + e) / 2 - t * 1e6, e - s

    ta, oa, wa = best(pairs[:ANCHOR_TRIES])
    tb, ob, wb = best(pairs[-ANCHOR_TRIES:])
    rate = (ob - oa) / (tb - ta) if tb > ta else 0.0

    def to_us(t: float) -> float:
        return t * 1e6 + oa + (t - ta) * rate

    return to_us, max(wa, wb), ob - oa


def _curve(points):
    """The piecewise-linear function through ``(t, v)`` points sorted by
    ``t``, extended along its end segments."""
    ts = [t for t, _ in points]
    vs = [v for _, v in points]

    def at(t: float) -> float:
        i = min(max(bisect.bisect_left(ts, t), 1), len(ts) - 1)
        t0, t1, v0, v1 = ts[i - 1], ts[i], vs[i - 1], vs[i]
        return v0 + (v1 - v0) * (t - t0) / (t1 - t0) if t1 > t0 else v1

    return at


def device_clock(events):
    """(to_host, summary): ``to_host(t)`` puts a device time ``t`` (µs) on
    the profiler's host timeline, and the summary says what it rests on.

    The profiler's device clock can drift from its host clock (by
    milliseconds a second on the card), so the shift is read from the
    trace itself: each CUDA runtime call and its device work share a
    correlation id; a copy to pageable memory (one a serve step, two an
    emitted frame) ends before its call returns, an upper bound on the
    shift at that moment, and any work starts after its call starts, a
    lower bound. The shift follows the upper bounds from copy to copy (one
    that a late return lifts above its neighbours' line is put back on
    it), less half the band they leave with the lower bounds: the median,
    over the stretches between two copies, of the gap to the tightest
    lower bound in the stretch (a call made while the device was idle).
    Without two blocking copies, no shift and no summary."""
    from torch.autograd import DeviceType

    work = {}
    for e in events:
        if e.device_type == DeviceType.CUDA \
                and not getattr(e, "is_user_annotation", False):
            key = getattr(e, "id", None)
            w = work.get(key)
            start, end = e.time_range.start, e.time_range.end
            work[key] = (start, end, e.name) if w is None else (
                min(w[0], start), max(w[1], end), w[2])
    lower, upper = [], []
    for e in events:
        w = work.get(getattr(e, "id", None))
        if w is None or e.device_type == DeviceType.CUDA \
                or not e.name.startswith("cuda"):
            continue
        lower.append((e.time_range.start, e.time_range.start - w[0]))
        if BLOCKING.match(w[2]):
            upper.append((e.time_range.end, e.time_range.end - w[1]))
    if len(upper) < 2:
        return (lambda t: t), None
    upper.sort()
    for j in range(1, len(upper) - 1):
        (ta, va), (t, v), (tb, vb) = upper[j - 1], upper[j], upper[j + 1]
        line = va + (vb - va) * (t - ta) / (tb - ta) if tb > ta else v
        if v > line + LATE_RETURN_US:
            upper[j] = (t, line)
    bound = _curve(upper)
    # the tightest lower bound between each two copies (a call made while
    # the device was idle), and the median of their gaps to the upper one
    tightest: dict[int, float] = {}
    times = [t for t, _ in upper]
    for t, v in lower:
        k = bisect.bisect_left(times, t)
        r = bound(t) - v
        if r < tightest.get(k, math.inf):
            tightest[k] = r
    band = statistics.median(tightest.values())

    def shift(t: float) -> float:
        return bound(t) - band / 2

    def to_host(t: float) -> float:
        # the shift is a function of host time: two steps settle it
        return t + shift(t + shift(t))

    return to_host, {
        "shift_us": [shift(upper[0][0]), shift(upper[-1][0])],
        "band_us": band,
        "drift_us_per_s": (shift(upper[-1][0]) - shift(upper[0][0]))
        / (upper[-1][0] - upper[0][0]) * 1e6 if upper[-1][0] > upper[0][0]
        else 0.0,
        "calls": len(lower), "blocking_copies": len(upper)}


# ------------------------------------------------------------ the reduction
def split(gaps, spans):
    """Each gap ``(start, end)`` (sorted by start) cut where a span of
    ``spans`` (``(start, end, name, rank)``) starts or ends inside it:
    ``(a, b, name)`` pieces, ``name`` the covering span of the highest
    rank, the latest start and then the earliest end (the innermost), or
    None where no span covers the piece."""
    spans = sorted(spans)
    active, j, out = [], 0, []
    for gs, ge in gaps:
        while j < len(spans) and spans[j][0] < ge:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[1] > gs]
        cuts = sorted({gs, ge} | {t for sp in active for t in sp[:2]
                                  if gs < t < ge})
        for a, b in zip(cuts, cuts[1:]):
            cover = [sp for sp in active if sp[0] <= a and sp[1] >= b]
            inner = max(cover, key=lambda sp: (sp[3], sp[0], -sp[1]),
                        default=None)
            out.append((a, b, inner[2] if inner else None))
    return out


def span_totals(spans) -> dict:
    """``{name: {count, seconds, cat}}`` of the tracer's spans."""
    totals: dict[str, dict] = {}
    for s in spans:
        t = totals.setdefault(s.name, {"count": 0, "seconds": 0.0,
                                       "cat": s.cat})
        t["count"] += 1
        t["seconds"] += s.dur
    return totals


def inside(spans, t0: float, t1: float) -> list:
    """The complete spans of ``spans`` that lie within ``[t0, t1]``."""
    return [s for s in spans or () if s.ph == "X" and t0 <= s.ts
            and s.ts + s.dur <= t1]


def reduce_program(events, window_s: float, spans, anchors, t0: float,
                   t1: float, dropped: int = 0) -> dict:
    """``harness.reduce_trace`` of ``events``, and, where the tracer's
    ``spans`` hold any inside the slice ``[t0, t1]`` (``perf_counter``
    seconds), the program's keys (the module's docstring). Without such
    spans it is ``reduce_trace``'s result, unchanged."""
    from torch.autograd import DeviceType

    base = harness.reduce_trace(events, window_s)
    kept = inside(spans, t0, t1)
    if not kept:
        return base
    events = list(events)
    to_us, skew, drift = clock_map(events, anchors)
    to_host, aligned = device_clock(events)
    device, bench, notes, launches = [], [], {}, []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                c, s = notes.get(e.name, (0, 0.0))
                notes[e.name] = (c + 1, s + (end - start) * 1e-6)
            else:
                device.append((to_host(start), to_host(end), e.name))
        elif e.name.startswith("bench/"):
            bench.append((start, end, e.name, 0))
        elif e.name == "cudaGraphLaunch":
            launches.append((start, end))
    device.sort()
    # the gaps as reduce_trace finds them (moved onto the host's timeline),
    # then the slice's ends
    gaps, reach = [], None
    for start, end, _ in device:
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    ends, busy = [], 0.0
    if device:
        ends = [(to_us(t0), device[0][0]), (reach, to_us(t1))]
        busy = reach - device[0][0] - sum(b - a for a, b in gaps)
    host = [(to_us(s.ts), to_us(s.ts + s.dur), s.name, 1) for s in kept
            if s.cat != "request"]
    pieces = split(sorted(gaps + [g for g in ends if g[1] > g[0]]),
                   host + bench)
    idle: dict[str, float] = {}
    for a, b, name in pieces:
        key = name or HOST_GAP_LABEL
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-6
    # the breakdown's gaps, each labelled by the program span covering most
    # of it, else by the innermost benchmark range at its start
    top = sorted(gaps, key=lambda g: g[0] - g[1])[:harness.BREAKDOWN_ENTRIES]
    idle_gaps = []
    for gs, ge in top:
        covered: dict[str, float] = {}
        for a, b, name in split([(gs, ge)], host):
            if name is not None:
                covered[name] = covered.get(name, 0.0) + (b - a)
        name = max(covered, key=covered.get, default=None)
        if name is None or covered[name] <= (ge - gs) / 2:
            at = [r for r in bench if r[0] <= gs <= r[1]]
            name = max(at, key=lambda r: (r[0], -r[1]))[2] if at \
                else HOST_GAP_LABEL
        idle_gaps.append([name, (ge - gs) * 1e-6])
    out = {**base, "program_spans": span_totals(kept),
           "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
           "idle_s": sum(idle.values()), "busy_host_s": busy * 1e-6,
           "clock_skew_us": skew,
           "clock_drift_us": drift, "device_clock": aligned,
           "dropped_records": dropped,
           "annotations": {k: {"count": c, "seconds": s}
                           for k, (c, s) in notes.items()},
           "breakdown": {**base["breakdown"], "idle_gaps": idle_gaps}}
    agreement = clock_agreement(device, launches, kept, to_us)
    if agreement is not None:
        out["clock_agreement"] = agreement
    return out


def clock_agreement(device, launches, spans, to_us) -> dict | None:
    """Of the serve steps inside the slice: the share whose token copy to
    the device (the nearest ``Memcpy HtoD`` to its ``serve/replay``)
    starts after the replay span starts, the share whose copy back (the
    nearest ``Memcpy DtoH`` to its ``serve/wait``'s end) ends before the
    wait span ends, and the share whose replay span holds a whole
    ``cudaGraphLaunch`` call (both on the host: the anchors' own check);
    with the 1st, 50th and 99th percentiles of each device margin (µs).
    None without serve steps."""
    replays = [s for s in spans if s.name == "serve/replay"]
    waits = [s for s in spans if s.name == "serve/wait"]
    h2d = sorted(s for s, _, name in device if H2D.match(name))
    d2h = sorted(e for _, e, name in device if D2H.match(name))
    if not replays or not waits or not h2d or not d2h:
        return None

    def nearest(xs, t):
        i = bisect.bisect_left(xs, t)
        return min(xs[max(i - 1, 0):i + 1], key=lambda x: abs(x - t))

    def quantiles(xs):
        return [harness.percentile(xs, q) for q in (1, 50, 99)]

    lead = [nearest(h2d, to_us(s.ts)) - to_us(s.ts) for s in replays]
    margin = [to_us(s.ts + s.dur) - nearest(d2h, to_us(s.ts + s.dur))
              for s in waits]
    held = sum(any(to_us(s.ts) <= a and b <= to_us(s.ts + s.dur)
                   for a, b in launches) for s in replays)
    return {"steps": len(replays),
            "h2d_after_replay": sum(x >= 0 for x in lead) / len(lead),
            "d2h_before_wait_end": sum(x >= 0 for x in margin) / len(margin),
            "launch_inside_replay": held / len(replays),
            "h2d_lead_us": quantiles(lead), "d2h_margin_us": quantiles(margin)}


# --------------------------------------------------------------- readers
def _spans(rec) -> dict:
    trace = rec.get("trace") or {}
    return trace.get("program_spans") or {}


def prompt_stream_ms_p95(rec):
    """serve/engine.py ServeEngine (program_span, moves ttft_p95_ms): the
    p95 over the window's requests of ``first_token_s - admitted_s``, the
    prompt streamed one token a step."""
    ms = (rec.get("serve") or {}).get("prompt_stream_ms")
    return harness.percentile(ms, 95) if ms else None


def engine_host_ms_per_step(rec):
    """serve/engine.py ServeEngine (program_span, moves itl_p95_ms): the
    mean over the slice's steps of ``serve/step`` less its
    ``serve/wait``: the host's own work in a step."""
    sp = _spans(rec)
    if "serve/step" not in sp or "serve/wait" not in sp:
        return None
    return 1e3 * (sp["serve/step"]["seconds"] - sp["serve/wait"]["seconds"]) \
        / sp["serve/step"]["count"]


def captured_step_ms(rec):
    """serve/graph.py CapturedStep (program_span, moves itl_p95_ms): the
    mean of ``serve/replay`` + ``serve/wait`` a step, the decode graph as
    the host sees it."""
    sp = _spans(rec)
    if not {"serve/step", "serve/replay", "serve/wait"} <= set(sp):
        return None
    return 1e3 * (sp["serve/replay"]["seconds"]
                  + sp["serve/wait"]["seconds"]) / sp["serve/step"]["count"]


def stage_issue_ms_per_frame(rec):
    """pipeline/stages.py model_stage_builder (program_span, moves
    tokens_per_s): the mean over frames (one ``emit`` each) of the stages'
    spans less their ``emit`` and ``stage/sync`` spans, the host's time to
    issue a frame."""
    sp = _spans(rec)
    if "emit" not in sp:
        return None
    frames = sum(v["seconds"] for v in sp.values() if v["cat"] == "frame")
    waits = sum(sp[k]["seconds"] for k in ("emit", "stage/sync") if k in sp)
    return 1e3 * (frames - waits) / sp["emit"]["count"]


def attention_span_roofline(rec):
    """kernels/flash_attention (device_trace, moves tokens_per_s): the
    least time of one layer's causal attention over a frame
    (``work.frame_attention``) times the ``attention`` ranges, over the
    device time inside them."""
    trace, chain, peaks = rec.get("trace"), rec.get("chain"), rec.get("peaks")
    note = ((trace or {}).get("annotations") or {}).get("attention")
    if not note or not chain or not peaks or note["seconds"] <= 0:
        return None
    flops, nbytes = work.frame_attention(rec["dims"],
                                         chain["tokens_per_frame"])
    least = work.bound_s(flops, nbytes, (peaks["bf16_flops"],
                                         peaks["hbm_bytes_per_s"]))[0]
    return 100.0 * note["count"] * least / note["seconds"]


READERS = {
    "prompt_stream_ms_p95.serve": prompt_stream_ms_p95,
    "engine_host_ms_per_step.serve": engine_host_ms_per_step,
    "captured_step_ms.serve": captured_step_ms,
    "stage_issue_ms_per_frame.chain": stage_issue_ms_per_frame,
    "attention_span_roofline.chain": attention_span_roofline,
}
# the benchmark's own per-layer metrics printed beside them
BESIDE = ("step_ms.serve", "attention_roofline.chain", "idle_share",
          "stage_busy_share.chain", "mfu.serve", "mfu.chain")


def prompt_stream_ms(run, tracing) -> list[float]:
    """``first_token_s - admitted_s`` (ms) of each request due in the
    serve window, leaving out those whose prompt streamed across an
    interval in which the profiler held the host up."""
    out = []
    for k in run.ours:
        r = run.reqs[k]
        a, f = r.admitted_s, getattr(r, "first_token_s", None)
        if a is None or f is None:
            continue
        if any(lo <= f and a <= hi for lo, hi in tracing.blocked):
            continue
        out.append((f - a) * 1e3)
    return out


# ------------------------------------------------------------------ main
def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    p.add_argument("--all-threads", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def window_numbers(rec: dict) -> dict:
    """The window's host numbers: tokens a second, and the serve tails
    and mean step or the chain's steady period."""
    out = {"tokens_per_s": rec["tokens"] / rec["window_s"],
           "failed": rec["failed"]}
    if "serve" in rec:
        steps = rec["serve"]["steps"]
        out["step_ms"] = 1e3 * sum(b - a for a, b, *_ in steps) / len(steps)
        out["ttft_p95_ms"] = harness.percentile(rec["ttft_ms"], 95)
        out["itl_p95_ms"] = harness.percentile(rec["itl_ms"], 95)
    if "chain" in rec:
        out["period_ms"] = 1e3 * rec["chain"]["period_s"]
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from bench.run import setup_env

    setup_env()
    import torch

    spec = harness.load_spec()
    cell = harness.load_cell(spec, args.workload, args.seed, args.seconds,
                             bool(args.trace))
    if not torch.cuda.is_available():
        print(f"{cell.name} needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.obs import Tracer

    kind = torch.cuda.get_device_name(0)
    tracing = ProgramTracing(cell.trace, Tracer() if args.tracer else None,
                             bool(args.all_threads))
    run = harness.load_module("drivers", cell.mix["driver"]).Run(
        cell, tracing)
    with given_tracer(tracing.tracer):
        run.setup()
    meter = harness.Meter()
    rec = run.window(meter)
    trace = tracing.reduce()
    if trace is None and tracing.tracer is not None:
        # untraced: the spans of the whole window, on the host alone
        spans = inside(tracing.tracer.drain(), *meter.t)
        trace = {"program_spans": span_totals(spans),
                 "dropped_records": tracing.tracer.dropped_records}
    if cell.mix["driver"] == "serve":
        rec["serve"]["prompt_stream_ms"] = prompt_stream_ms(run, tracing)
    run.free()
    record = {**rec, "trace": trace, "dims": cell.dims, "mix": cell.mix,
              "peaks": harness.load_json(harness.BENCH / "peaks.json").get(
                  kind)}
    metrics = {}
    for name, reader in READERS.items():
        metrics[name] = reader(record)
    for m in spec["per_layer"] if cell.trace else ():
        if m["name"] in BESIDE and harness.reports(m, cell.name):
            metrics[m["name"]] = harness.load_module(
                "metrics", m["name"]).read(record)
    out = {"workload": cell.name, "seed": cell.seed, "trace": cell.trace,
           "tracer": bool(args.tracer), "all_threads": tracing.all_threads,
           "device": kind,
           "window": window_numbers(rec),
           "metrics": {k: v for k, v in metrics.items() if v is not None}}
    if trace is not None:
        out["trace_summary"] = {k: trace[k] for k in (
            "busy_s", "busy_host_s", "window_s", "idle_s", "idle_by_span",
            "program_spans",
            "host_launches", "device_events",
            "clock_skew_us", "clock_drift_us", "device_clock",
            "dropped_records",
            "clock_agreement", "annotations", "breakdown") if k in trace}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
