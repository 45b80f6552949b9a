"""End-to-end scenario harness: governor + sleep-simulated runtime, the
port's counterpart of ``repro.control.sim`` (both halves: the pipeline
scenarios here and the serving scenarios below).

Executes a scheduled chain on the real ``StreamingPipelineRuntime``
(:mod:`repro_torch.pipeline.runtime`) with
stage functions that sleep each stage's per-frame work (chain time units
scaled to wall seconds), while the :class:`~repro_torch.control.governor.
Governor` watches measured period/power against a scripted power budget.

Two clocks, deliberately decoupled:

  - the *scenario clock* advances by ``window_dt`` seconds per control
    window and drives the budget trace — so cap drops and battery
    crossings land on deterministic windows regardless of host speed;
  - the *wall clock* is what the runtime actually measures (periods,
    busy seconds, energy) — real threads, real queues, real sleeps.

``time_scale`` converts chain time units to simulated wall seconds (e.g.
2e-6 runs a 1128 µs DVB-S2 period as ~2.3 ms per frame). Stage latency
honors per-stage DVFS levels (sleep ∝ 1/f) and two drift knobs that apply
from a given window on — a global multiplier on every sleep (uniform
slowdown) and a per-task multiplier map (single hot task/stage) — the
measured-vs-predicted divergences the governor's uniform and per-stage
recalibration paths exist for. Metering can run off a *different* power
model than the governor plans with (``meter_power``), which is how the
measured-overshoot ("power" trigger) scenarios make the meter disagree
with the model.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Callable, Mapping, Sequence

import numpy as np

from repro_torch.core.chain import TaskChain
from repro_torch.pipeline.runtime import StreamingPipelineRuntime

from .budget import PowerBudget
from .governor import Governor, GovernorEvent, Observation


def sleep_stage_builder(
    chain: TaskChain, time_scale: float,
    knobs: dict | None = None,
) -> Callable:
    """A ``from_plan`` stage builder that sleeps each stage's work.

    One replica executing tasks [start, end] per frame costs the stage
    sum on its core type, scaled by 1/freq for DVFS stages and by
    ``time_scale`` into wall seconds. Two knobs inject drift at call
    time (so a mid-stream change needs no rebuild):
    ``knobs['latency_scale']`` (default 1.0) multiplies every sleep;
    ``knobs['task_latency_scale']`` maps task index -> multiplier for
    that task's share of its stage sum (the single-hot-stage injector
    the per-stage recalibration scenarios use)."""
    knobs = knobs if knobs is not None else {}

    def build(start: int, end: int, stage) -> Callable:
        freq = getattr(stage, "freq", 1.0)
        weights = [chain.w[stage.ctype][k] * time_scale / freq
                   for k in range(start, end + 1)]
        base = sum(weights)

        def fn(x):
            per_frame = base
            task_scale = knobs.get("task_latency_scale")
            if task_scale:
                per_frame += sum(
                    w * (task_scale.get(k, 1.0) - 1.0)
                    for k, w in zip(range(start, end + 1), weights))
            time.sleep(per_frame * knobs.get("latency_scale", 1.0))
            return x

        return fn

    return build


def _stage_busy_units(stats: dict, time_scale: float) -> dict[str, float]:
    """Per-stage measured per-frame busy time in chain units.

    Aggregates the runtime's per-(stage, replica) busy seconds and
    per-run frame counts: every frame is processed by exactly one replica
    of a stage, so total busy / total frames is the per-frame single-core
    latency of the stage interval — directly comparable to
    ``chain.stage_sum(start, end, ctype) / freq``."""
    busy: dict[str, float] = {}
    frames: dict[str, int] = {}
    for (name, _), s in stats.get("busy_s", {}).items():
        busy[name] = busy.get(name, 0.0) + s
    for (name, _), c in stats.get("replica_frames", {}).items():
        frames[name] = frames.get(name, 0) + c
    return {name: busy[name] / frames[name] / time_scale
            for name in busy if frames.get(name, 0) > 0}


def _min_cap_over(budget: PowerBudget, t0: float, t1: float) -> float:
    """The lowest cap anywhere in [t0, t1): caps are piecewise-constant
    between ``change_times()``, so sampling the window start plus every
    change point inside covers the whole interval. This is the floor a
    window's draw must respect for the zero-over-cap acceptance — the cap
    at the window *start* misses mid-window drops."""
    caps = [budget.cap_at(t0)]
    caps += [budget.cap_at(tc) for tc in budget.change_times()
             if t0 < tc < t1]
    return min(caps)


@dataclasses.dataclass(frozen=True)
class WindowRecord:
    """Measurements and control state of one scenario window."""

    index: int
    t: float                    # scenario time at window start (s)
    cap_w: float                # the budget's cap at window start
    measured_period: float      # chain time units
    predicted_period: float     # active plan's frontier prediction
    measured_watts: float
    predicted_watts: float
    frames: int
    events: tuple[GovernorEvent, ...]  # governor decisions taken this window
    # lowest cap anywhere inside the window: a scheduled drop mid-window
    # makes this < cap_w, and the over-cap acceptance checks against it
    min_cap_w: float = float("inf")

    @property
    def over_cap(self) -> bool:
        """Did the active plan's predicted draw exceed the window's cap
        floor? Deterministic (model-side) over-cap marker — a window that
        straddles a scheduled drop without predictive re-planning."""
        return self.predicted_watts > self.min_cap_w * (1 + 1e-9)

    @property
    def period_error(self) -> float:
        """Relative |measured - predicted| / predicted period."""
        if self.predicted_period <= 0:
            return 0.0
        return abs(self.measured_period - self.predicted_period) \
            / self.predicted_period


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    windows: tuple[WindowRecord, ...]
    events: tuple[GovernorEvent, ...]   # full governor history, start first
    frames_fed: int
    frames_delivered: int

    @property
    def frames_dropped(self) -> int:
        return self.frames_fed - self.frames_delivered

    @property
    def replans(self) -> tuple[GovernorEvent, ...]:
        return tuple(e for e in self.events if e.trigger != "start")

    @property
    def over_cap_windows(self) -> tuple[WindowRecord, ...]:
        """Windows whose plan was predicted over the window's cap floor
        (straddled a scheduled drop) — empty under predictive
        re-planning."""
        return tuple(w for w in self.windows if w.over_cap)

    def describe(self) -> str:
        lines = [f"{len(self.windows)} windows, {self.frames_fed} frames "
                 f"({self.frames_dropped} dropped), "
                 f"{len(self.replans)} re-plans"]
        for e in self.events:
            lines.append(
                f"  t={e.t:6.2f}s {e.trigger:>11}: cap={e.cap_w:7.2f} W -> "
                f"P={e.plan.predicted_period:8.1f} "
                f"{e.plan.predicted_watts:6.2f} W"
                + ("" if e.cap_met else "  [CAP NOT MET]")
                + (f"  ({e.detail})" if e.detail else ""))
        return "\n".join(lines)


def run_scenario(
    governor: Governor,
    *,
    time_scale: float = 2e-6,
    n_windows: int = 12,
    window_dt: float = 1.0,
    frames_per_window: int = 30,
    warmup: int = 8,
    queue_depth: int = 4,
    device_loss_at: Mapping[int, tuple[int, int]] | None = None,
    drift_at: Sequence[tuple[int, float | Mapping[int, float]]] = (),
    meter_power=None,
    tracer=None,
    metrics=None,
    executor: str = "thread",
) -> ScenarioResult:
    """Drive ``governor`` end to end against a sleep-simulated runtime.

    The governor must be freshly constructed (not started); its chain is
    the physical workload. Per window: one control tick on the previous
    window's measurement (so a cap step or drift re-plan lands before the
    frames that must respect it), then scripted device losses
    (``device_loss_at[window] = (big, little)``), then
    ``frames_per_window`` frames through the runtime. ``drift_at`` is a
    list of (window, slowdown) knob settings — the injected slowdowns the
    drift trigger must catch; a float slows every sleep uniformly, a
    ``{task_index: multiplier}`` map slows only those tasks (the
    single-hot-stage case per-stage recalibration converges on).

    ``meter_power`` (default: the governor's own model) is the power
    model the runtime *meters* with: passing a hotter model makes the
    measured draw exceed the planner's predictions — the
    measured-overshoot scenario behind the governor's "power" trigger.

    ``tracer`` (a ``repro_torch.obs.Tracer``) threads the whole scenario
    through the tracing layer: runtime frame spans, governor decision
    instants and cap/power counters, battery SoC samples, plus one
    wall-clock ``"window"`` span per control window (cat ``"window"``,
    args carrying the WindowRecord fields incl. ``over_cap``) — drain
    it into ``repro_torch.obs.export.write_perfetto`` for a Perfetto
    timeline. ``metrics`` (a ``repro_torch.obs.MetricsRegistry``) aggregates
    the same windows into counters (frames fed/delivered/dropped,
    re-plans) and histograms (``scenario/period_us``,
    ``scenario/period_err``, ``scenario/power_w``).

    ``executor`` selects the runtime backend (``"thread"`` or
    ``"process"``); the sleep-simulated stages are picklable-free under
    fork, so both backends run the same scenario. Note the sleep
    builder already scales by 1/freq itself, so the runtime's
    ``enforce_freq`` duty-cycle throttle stays off here.
    """
    base_chain = governor.chain
    knobs: dict = {"latency_scale": 1.0}
    builder = sleep_stage_builder(base_chain, time_scale, knobs)
    if tracer is not None:
        if governor.tracer is None:
            governor.tracer = tracer
        governor.budget.attach_tracer(tracer)
    governor.start(0.0)
    runtime = StreamingPipelineRuntime.from_plan(
        governor.plan, builder, queue_depth=queue_depth,
        power=meter_power if meter_power is not None else governor.power,
        tracer=tracer, executor=executor)
    governor.attach(runtime)
    runtime.start()

    device_loss_at = dict(device_loss_at or {})
    drift_schedule = dict(drift_at)
    windows: list[WindowRecord] = []
    fed = delivered = 0
    prev_stats = None
    try:
        for w in range(n_windows):
            t = w * window_dt
            n_before = len(governor.events)
            if prev_stats is not None:
                governor.observe(Observation(
                    t=t,
                    period=prev_stats["period_s"] / time_scale,
                    power_w=prev_stats.get("avg_power_w"),
                    frames=len(prev_stats["outputs"]),
                    dropped=prev_stats.get("frames_dropped", 0),
                    stage_busy=_stage_busy_units(prev_stats, time_scale),
                ))
            if w in device_loss_at:
                big, little = device_loss_at[w]
                governor.device_loss(t, big=big, little=little)
            if w in drift_schedule:
                slow = drift_schedule[w]
                if isinstance(slow, Mapping):
                    knobs["task_latency_scale"] = dict(slow)
                else:
                    knobs["latency_scale"] = slow
            # liveness deadline: a stalled swap (lost sentinel, dead
            # workers) surfaces as dropped frames, not a hung scenario —
            # 10x the active plan's expected window duration, floored
            # well above scheduler noise
            expected_s = frames_per_window \
                * governor.plan.predicted_period * time_scale
            t_wall0 = time.perf_counter()
            stats = runtime.run(list(range(frames_per_window)),
                                warmup=min(warmup, frames_per_window - 1),
                                timeout_s=max(5.0, 10.0 * expected_s))
            fed += frames_per_window
            delivered += len(stats["outputs"])
            plan = governor.plan
            rec = WindowRecord(
                index=w,
                t=t,
                cap_w=governor.budget.cap_at(t),
                measured_period=stats["period_s"] / time_scale,
                predicted_period=plan.predicted_period,
                measured_watts=stats.get("avg_power_w", 0.0),
                predicted_watts=plan.predicted_watts,
                frames=len(stats["outputs"]),
                events=tuple(governor.events[n_before:]),
                min_cap_w=_min_cap_over(governor.budget, t, t + window_dt),
            )
            windows.append(rec)
            if tracer is not None and tracer.enabled:
                tracer.complete(
                    "window", t_wall0, time.perf_counter() - t_wall0,
                    cat="window",
                    args={"index": w, "t_s": t, "cap_w": rec.cap_w,
                          "min_cap_w": rec.min_cap_w,
                          "predicted_w": rec.predicted_watts,
                          "measured_w": rec.measured_watts,
                          "over_cap": rec.over_cap,
                          "period_us": rec.measured_period,
                          "frames": rec.frames})
            if metrics is not None:
                metrics.inc("scenario/frames_fed", frames_per_window)
                metrics.inc("scenario/frames_delivered",
                            len(stats["outputs"]))
                metrics.inc("scenario/frames_dropped",
                            stats["frames_dropped"])
                metrics.inc("scenario/replans", sum(
                    1 for e in rec.events if e.trigger != "start"))
                metrics.observe("scenario/period_us", rec.measured_period)
                metrics.observe("scenario/period_err", rec.period_error)
                if rec.measured_watts:
                    metrics.observe("scenario/power_w", rec.measured_watts)
                metrics.set_gauge("scenario/cap_w", rec.cap_w)
            prev_stats = stats
            if stats["frames_dropped"] > 0:
                # a timed-out window leaves stragglers in flight; rebuild
                # to fresh queues/workers so later windows measure clean
                # (run() flushes the sink, but in-flight frames could
                # still land mid-batch otherwise)
                runtime.rebuild(governor.plan)
    finally:
        runtime.stop()
    return ScenarioResult(tuple(windows), tuple(governor.events),
                          fed, delivered)


# --------------------------------------------------------------------------
# Serving scenarios: arrival traces + the SLO-governed engine loop.
#
# A third clock joins the two above: the *engine clock* — a deterministic
# repro_torch.serve.SimClock the serving engine advances by its planned step
# time each decode step. Request deadlines live on it, so "no admitted
# request misses its deadline" is a property of the control logic, not of
# host speed.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request in an arrival trace (engine-clock seconds)."""

    t: float
    prompt: tuple[int, ...]
    max_new_tokens: int = 8
    latency_slo_s: float = 0.5   # per-request deadline: t + latency_slo_s


def _spread_arrivals(rates: Sequence[int], window_dt: float,
                     prompt_len: int, max_new_tokens: int,
                     latency_slo_s: float, seed: int,
                     vocab: int) -> tuple[Arrival, ...]:
    """``rates[w]`` arrivals in window ``w``, evenly spaced inside it,
    prompts drawn from a seeded rng — fully deterministic."""
    rng = np.random.default_rng(seed)
    out = []
    for w, n in enumerate(rates):
        for i in range(n):
            t = (w + (i + 0.5) / n) * window_dt
            prompt = tuple(int(x)
                           for x in rng.integers(1, vocab, prompt_len))
            out.append(Arrival(t, prompt, max_new_tokens, latency_slo_s))
    return tuple(out)


def bursty_arrivals(n_windows: int, *, window_dt: float = 1.0,
                    base_rate: int = 1, burst_rate: int = 4,
                    burst_windows: Sequence[int] = (),
                    prompt_len: int = 3, max_new_tokens: int = 8,
                    latency_slo_s: float = 0.5, seed: int = 0,
                    vocab: int = 256) -> tuple[Arrival, ...]:
    """A steady trickle of ``base_rate`` requests per window with
    ``burst_rate`` spikes in ``burst_windows`` — the admission layer's
    bread and butter: bursts queue up and must be admitted mid-run
    without starving or missing deadlines."""
    bursts = set(burst_windows)
    rates = [burst_rate if w in bursts else base_rate
             for w in range(n_windows)]
    return _spread_arrivals(rates, window_dt, prompt_len, max_new_tokens,
                            latency_slo_s, seed, vocab)


def diurnal_arrivals(n_windows: int, *, window_dt: float = 1.0,
                     trough_rate: int = 1, peak_rate: int = 4,
                     prompt_len: int = 3, max_new_tokens: int = 8,
                     latency_slo_s: float = 0.5, seed: int = 0,
                     vocab: int = 256) -> tuple[Arrival, ...]:
    """One sinusoidal day across the scenario: load climbs from
    ``trough_rate`` to ``peak_rate`` and back — the slow swing the
    energy-slack downshift (and later upshift) should track."""
    rates = [round(trough_rate + (peak_rate - trough_rate)
                   * 0.5 * (1 - math.cos(2 * math.pi * w / n_windows)))
             for w in range(n_windows)]
    return _spread_arrivals(rates, window_dt, prompt_len, max_new_tokens,
                            latency_slo_s, seed, vocab)


@dataclasses.dataclass(frozen=True)
class ServeWindowRecord:
    """Serving control state over one scenario window."""

    index: int
    t: float                   # scenario time at window start (s)
    cap_w: float
    step_s: float              # the engine's paced step time this window
    predicted_step_s: float    # active plan period x time_scale
    watts: float               # active plan's predicted draw
    p99_s: float               # previous window's measured p99 (nan first)
    steps: int
    completed: int
    missed: int
    rejected: int
    queue_depth: int           # at window end
    events: tuple[GovernorEvent, ...]


@dataclasses.dataclass(frozen=True)
class ServeScenarioResult:
    windows: tuple[ServeWindowRecord, ...]
    events: tuple[GovernorEvent, ...]
    requests: tuple = ()       # every Request object, submission order
    completed: int = 0
    rejected: int = 0
    deadline_misses: int = 0
    tokens: int = 0
    joules: float = 0.0        # serving energy: sum(plan watts x step dt)

    @property
    def replans(self) -> tuple[GovernorEvent, ...]:
        return tuple(e for e in self.events if e.trigger != "start")

    @property
    def joules_per_token(self) -> float:
        return self.joules / self.tokens if self.tokens else float("inf")

    def describe(self) -> str:
        lines = [f"{len(self.windows)} windows, {len(self.requests)} "
                 f"requests: {self.completed} completed, "
                 f"{self.rejected} rejected, "
                 f"{self.deadline_misses} deadline misses, "
                 f"{self.tokens} tokens, "
                 f"{self.joules_per_token:.4g} J/token, "
                 f"{len(self.replans)} re-plans"]
        for e in self.events:
            lines.append(
                f"  t={e.t:6.2f}s {e.trigger:>11}: cap={e.cap_w:7.2f} W -> "
                f"P={e.plan.predicted_period:8.1f} "
                f"{e.plan.predicted_watts:6.2f} W"
                + ("" if e.cap_met else "  [FELL BACK]")
                + (f"  ({e.detail})" if e.detail else ""))
        return "\n".join(lines)


def run_serve_scenario(
    governor: Governor,
    engine,
    arrivals: Sequence[Arrival],
    *,
    time_scale: float = 2e-6,
    n_windows: int = 12,
    window_dt: float = 1.0,
    inflation_at: Sequence[tuple[int, float]] = (),
    governed: bool = True,
    tracer=None,
    metrics=None,
) -> ServeScenarioResult:
    """Drive the SLO-governed serving loop end to end, deterministically.

    ``governor`` is freshly constructed with ``slo_period`` set (chain
    units); ``engine`` is a :class:`repro_torch.serve.ServeEngine` on a
    :class:`~repro_torch.serve.SimClock` with ``pace="fixed"`` and an
    :class:`~repro_torch.serve.AdmissionPlanner` over the governor's frontier.
    Per window: one governor tick on the previous window's measured
    ``serve/step_s`` p99 (from the metrics registry, converted to chain
    units) and the engine's tightest admitted-deadline budget
    (``need_period``); then the engine is paced at the adopted plan's
    period x ``time_scale`` x the injected ``inflation_at`` factor (the
    measured-slower-than-predicted divergence the SLO trigger must
    absorb — keep it below the planner's ``safety``), arrivals due are
    submitted, and the engine steps until the window closes. Serving
    energy accrues as the active plan's predicted watts x step time.

    ``governed=False`` pins the start plan (the fastest point under the
    cap — max-performance) for the whole run: the EAPS comparison arm
    that meets deadlines by brute speed. The governed arm must match its
    zero misses while spending strictly fewer joules per token.
    """
    from repro_torch.serve.engine import Request  # lazy: control -> serve only here

    if engine.clock is None:
        raise ValueError("run_serve_scenario needs an engine on a SimClock")
    if engine.pace != "fixed":
        raise ValueError('run_serve_scenario needs pace="fixed" (the '
                         "scenario owns the engine's step time)")
    if metrics is None:
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
    if engine.metrics is None:
        engine.metrics = metrics
    if tracer is not None:
        if governor.tracer is None:
            governor.tracer = tracer
        governor.budget.attach_tracer(tracer)
        if engine.tracer is None:
            engine.tracer = tracer
    governor.start(0.0)
    inflation_schedule = dict(inflation_at)
    inflation = 1.0
    clock = engine.clock
    pending = deque(sorted(arrivals, key=lambda a: a.t))
    requests: list = []
    windows: list[ServeWindowRecord] = []
    joules = 0.0
    prev_done = prev_missed = prev_rejected = prev_tokens = 0.0

    def submit_due() -> None:
        while pending and pending[0].t <= clock.now() + 1e-12:
            a = pending.popleft()
            req = Request(rid=len(requests), prompt=list(a.prompt),
                          max_new_tokens=a.max_new_tokens,
                          deadline_s=a.t + a.latency_slo_s, arrival_s=a.t)
            requests.append(req)
            engine.submit(req)

    for w in range(n_windows):
        t = w * window_dt
        n_before = len(governor.events)
        summ = metrics.window_summary(reset=True).get("serve/step_s")
        p99_s = summ["p99"] if summ and summ["count"] else float("nan")
        if governed and summ and summ["count"]:
            need = engine.min_step_need_s() / time_scale
            governor.observe(Observation(
                t=t,
                period=summ["mean"] / time_scale,
                power_w=governor.plan.predicted_watts,
                p99=p99_s / time_scale,
                need_period=need if math.isfinite(need) else None,
            ))
        if w in inflation_schedule:
            inflation = inflation_schedule[w]
        plan = governor.plan
        step_s = plan.predicted_period * time_scale * inflation
        engine.step_time_s = step_s
        if engine.planner is not None:
            engine.planner.cap_w = governor.budget.cap_at(t)
        t_end = (w + 1) * window_dt
        steps = 0
        t_wall0 = time.perf_counter()
        while clock.now() < t_end - 1e-12:
            submit_due()
            if engine.queue or any(s is not None for s in engine.slots):
                engine.step()
                joules += plan.predicted_watts * engine.last_step_s
                steps += 1
            else:
                nxt = pending[0].t if pending else t_end
                clock.advance(min(nxt, t_end) - clock.now())
        done = metrics.counter("serve/requests_done")
        missed = metrics.counter("serve/deadline_miss")
        rejected = metrics.counter("serve/rejected")
        rec = ServeWindowRecord(
            index=w, t=t, cap_w=governor.budget.cap_at(t),
            step_s=step_s,
            predicted_step_s=plan.predicted_period * time_scale,
            watts=plan.predicted_watts,
            p99_s=p99_s, steps=steps,
            completed=int(done - prev_done),
            missed=int(missed - prev_missed),
            rejected=int(rejected - prev_rejected),
            queue_depth=len(engine.queue),
            events=tuple(governor.events[n_before:]),
        )
        windows.append(rec)
        prev_done, prev_missed, prev_rejected = done, missed, rejected
        if tracer is not None and tracer.enabled:
            tracer.complete(
                "serve/window", t_wall0, time.perf_counter() - t_wall0,
                cat="window",
                args={"index": w, "t_s": t, "cap_w": rec.cap_w,
                      "step_s": step_s, "watts": rec.watts,
                      "steps": steps, "completed": rec.completed,
                      "missed": rec.missed,
                      "queue_depth": rec.queue_depth})
        if metrics is not None:
            metrics.set_gauge("serve/cap_w", rec.cap_w)
            metrics.set_gauge("serve/watts", rec.watts)
    # drain whatever the trace left in flight so every submitted request
    # resolves (completed, rejected, or — never, by construction — missed)
    while engine.queue or any(s is not None for s in engine.slots):
        engine.step()
        joules += governor.plan.predicted_watts * engine.last_step_s
        submit_due()
    metrics.window_summary(reset=True)
    return ServeScenarioResult(
        windows=tuple(windows),
        events=tuple(governor.events),
        requests=tuple(requests),
        completed=int(metrics.counter("serve/requests_done")),
        rejected=int(metrics.counter("serve/rejected")),
        deadline_misses=int(metrics.counter("serve/deadline_miss")),
        tokens=int(metrics.counter("serve/tokens")),
        joules=joules,
    )
