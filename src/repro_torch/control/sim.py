"""Serving scenarios: deterministic arrival traces and the SLO-governed
continuous-batching loop, the port's counterpart of the serving half of
``repro.control.sim``.

``run_serve_scenario`` drives a :class:`~repro_torch.serve.ServeEngine`
on a :class:`~repro_torch.serve.SimClock` under a
:class:`~repro_torch.control.governor.Governor` with an SLO period: each
control window the governor observes the engine's windowed p99 step
latency and re-plans off the (period, energy) Pareto frontier, and the
engine's admission planner queries the same frontier. Every decision is
made on the engine clock, so it depends on neither the model nor the
device that runs it.

The reference's sleep-simulated pipeline scenarios (``run_scenario`` and
its sleeping stage functions) need the pipeline runtime and are not
carried here.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Sequence

import numpy as np

from .governor import Governor, GovernorEvent, Observation


# The *engine clock* is a deterministic repro_torch.serve.SimClock the
# serving engine advances by its planned step time each decode step. Request
# deadlines live on it, so "no admitted request misses its deadline" is a
# property of the control logic, not of host speed.


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
