"""Continuous-batching serving engine over ``Model.decode_step``, the
port's counterpart of ``repro.serve.engine``.

A fixed pool of B slots shares one batched decode cache whose ``pos`` is
per-slot: every lane tracks its own position, so a waiting request is
admitted mid-run by resetting only the freed slot's cache lane
(``Model.reset_cache_lane``) while the other lanes keep decoding, and the
admitted request's tokens are the ones it would get served alone. Prompts
stream in token by token through the same ``decode_step``
(prefill-as-decode); completed slots free up and re-admit from the
arrival queue every step, or with ``admit_mode="step0"`` only once every
slot has drained. Greedy sampling.

The step: the reference jits ``decode_step`` with the cache donated, so
one engine step is one launch of one compiled program. Here, when the
cache lives on a CUDA device, ``_step`` is a
:class:`~repro_torch.serve.graph.CapturedStep`: ``decode_step`` captured
once over the engine's preallocated cache as one CUDA graph and replayed
every step, and ``_reset_lane`` zeroes a lane with index tensors made at
init. On the CPU both are the model's bound methods, run eagerly. The
cache is updated in place on both. A caller that wants the eager step on
CUDA sets ``engine._step = model.decode_step`` (what ``jax.disable_jit()``
does for the reference).

Deadline-safe admission (optional): give the engine an
:class:`~repro_torch.serve.slo.AdmissionPlanner` and per-request
``deadline_s`` values, and each admission queries the (period, energy)
frontier for the minimum-energy configuration whose step latency meets
every admitted deadline under the current power cap, falling back to
max-performance when that is infeasible and rejecting a request outright
when even max-performance would miss. The selected point lands on
``plan_point``. With ``pace="planner"`` and a :class:`SimClock` the
engine paces its own step time from it; with ``pace="fixed"`` an outer
loop (``repro_torch.control.sim.run_serve_scenario``) owns
``step_time_s``, and admission also checks the current pace, so a
mid-window arrival is never admitted into a miss. Without a planner, a
queued request that can no longer finish by its deadline at the engine's
step time is rejected.

Clocks: the wall clock by default; with a :class:`SimClock` every step
advances it by the planned step time exactly, so every admission decision
is independent of the model and of the device.

Observability (optional, duck-typed): a ``tracer`` with ``enabled``,
``complete``, ``counter`` and ``instant``, and a ``metrics`` registry with
``observe``, ``set_gauge`` and ``inc`` get the reference's ``serve/*``
spans, counters and histograms. An enabled tracer also gets the phases of
each ``serve/step`` as its children, which tile it: ``serve/admit`` (with
one ``serve/lane_reset`` inside it per admission), ``serve/feed`` (the
step's tokens assembled), ``serve/replay`` (their copy to the device and
the step's launch: one graph replay on CUDA), ``serve/wait`` (the host
blocked on the step's tokens) and ``serve/emit`` (the output
bookkeeping); and, on the wall clock, three spans of each request,
``serve/queued`` (arrival to admission), ``serve/prompt`` (admission to
its first token) and ``serve/decode`` (first token to finish), each with
its ``rid`` and recorded as its phase ends. Without an enabled tracer the
step reads the clock no more often than it did before these spans.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Optional

import torch

from repro_torch.models.transformer import Model

from .graph import CapturedStep
from .slo import AdmissionPlanner, step_need_s


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    deadline_s: float | None = None    # absolute engine-clock deadline
    arrival_s: float | None = None     # stamped by submit() if None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    rejected: bool = False             # dropped by admission control
    missed: bool = False               # finished past its deadline
    admitted_s: float | None = None
    first_token_s: float | None = None  # when its first output token came
    finished_s: float | None = None

    @property
    def total_steps(self) -> int:
        """Engine steps from admission to completion: the prompt streams
        through decode (len(prompt) steps, the last of which emits the
        first output token) plus max_new_tokens - 1 further steps."""
        return len(self.prompt) + self.max_new_tokens - 1


class SimClock:
    """Deterministic engine clock for scenario runs and property tests."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ServeEngine:
    def __init__(self, model: Model, params, batch_slots: int = 4,
                 max_len: int = 256, tracer=None, metrics=None,
                 clock: SimClock | None = None,
                 planner: AdmissionPlanner | None = None,
                 admit_mode: str = "continuous",
                 pace: str = "planner",
                 step_time_s: float | None = None):
        if admit_mode not in ("continuous", "step0"):
            raise ValueError(f"unknown admit_mode {admit_mode!r}")
        if pace not in ("planner", "fixed"):
            raise ValueError(f"unknown pace {pace!r}")
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.B = batch_slots
        self.max_len = max_len
        self.tracer = tracer
        self.metrics = metrics
        self.clock = clock
        self.planner = planner
        self.admit_mode = admit_mode
        self.pace = pace
        # sim-clock seconds per step; under pace="planner" it follows the
        # admission plan, under pace="fixed" the outer loop sets it
        self.step_time_s = step_time_s
        self.last_step_s = 0.0
        self.plan_point = None          # the planner's latest selection
        self.plan_feasible = True       # False: running the fallback
        self.cache = model.init_cache(batch_slots, max_len,
                                      device=self.device)
        self.queue: deque[Request] = deque()
        self.rejected: list[Request] = []
        self.slots: list[Optional[Request]] = [None] * batch_slots
        # per-slot prompt tokens still to stream through decode
        self._pending: list[list[int]] = [[] for _ in range(batch_slots)]
        # the step's tokens on the host, pinned on CUDA so that the copy to
        # the device is asynchronous (the step's ``.cpu()`` orders it)
        cuda = self.device.type == "cuda"
        self._tokens = torch.zeros((batch_slots,), dtype=torch.int32,
                                   pin_memory=cuda)
        if cuda:
            # the reference's jitted, cache-donating step: one CUDA graph
            # replay a step, and a lane reset by index tensors made here
            self._step = CapturedStep(model)
            lanes = torch.arange(batch_slots, device=self.device)[:, None]
            self._reset_lane = lambda cache, slot: model.reset_cache_lane(
                cache, lanes[slot])
        else:
            self._step = model.decode_step
            self._reset_lane = model.reset_cache_lane

    # ------------------------------------------------------------- clocking
    def now(self) -> float:
        return self.clock.now() if self.clock is not None \
            else time.perf_counter()

    def _planned_step_s(self) -> float:
        if self.pace == "planner" and self.planner is not None \
                and self.plan_point is not None:
            return self.planner.step_s(self.plan_point)
        if self.step_time_s is not None:
            return self.step_time_s
        return 0.0

    # ------------------------------------------------------------ admission
    def submit(self, req: Request) -> None:
        if req.arrival_s is None:
            req.arrival_s = self.now()
        self.queue.append(req)

    def _steps_remaining(self, i: int) -> int:
        req = self.slots[i]
        pend = len(self._pending[i])
        emit_left = req.max_new_tokens - len(req.out)
        # the step that consumes the last prompt token also emits
        return pend + emit_left - (1 if pend else 0)

    def _needs(self, now: float, extra: Request | None = None
               ) -> list[float]:
        """Per-step latency budgets (s) of every admitted deadline (plus
        an unadmitted candidate), derated by the planner's safety."""
        safety = self.planner.safety if self.planner is not None else 1.0
        needs = []
        for i, req in enumerate(self.slots):
            if req is not None and req.deadline_s is not None:
                needs.append(step_need_s(req.deadline_s, now,
                                         self._steps_remaining(i), safety))
        if extra is not None and extra.deadline_s is not None:
            needs.append(step_need_s(extra.deadline_s, now,
                                     extra.total_steps, safety))
        return needs

    def min_step_need_s(self, include_queued: bool = True) -> float:
        """The tightest admissible step latency over every admitted (and,
        with ``include_queued``, every queued) deadline: what the serving
        scenario feeds the governor as ``Observation.need_period``."""
        now = self.now()
        needs = self._needs(now)
        if include_queued:
            safety = self.planner.safety if self.planner is not None else 1.0
            needs += [step_need_s(req.deadline_s, now, req.total_steps,
                                  safety)
                      for req in self.queue if req.deadline_s is not None]
        return min(needs) if needs else math.inf

    def _reject(self, req: Request) -> None:
        req.rejected = True
        req.done = True
        self.rejected.append(req)
        if self.metrics is not None:
            self.metrics.inc("serve/rejected")
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.instant("serve/rejected", cat="serve",
                                args={"rid": req.rid})

    def _admissible(self, req: Request, now: float) -> bool:
        """Deadline-safe admission check for one queued candidate."""
        if self.planner is None or req.deadline_s is None:
            return True
        point, feasible = self.planner.plan_admission(
            self._needs(now, extra=req))
        if point is None:
            return False
        if self.pace == "fixed" and self.step_time_s is not None:
            # an outer loop owns the pace until its next re-plan: only
            # admit what the current step time also satisfies
            safety = self.planner.safety
            if step_need_s(req.deadline_s, now, req.total_steps,
                           safety) < self.step_time_s * (1 - 1e-9):
                return False
        self.plan_point = point
        self.plan_feasible = feasible
        return True

    def _expired(self, req: Request, now: float) -> bool:
        """A queued request no serving configuration can admit anymore.
        With a planner this mirrors the admission fallback exactly (same
        safety derate, same epsilon), so a queued request is either
        admitted or expires, never starves in between."""
        if req.deadline_s is None:
            return False
        if self.planner is not None:
            best = self.planner.step_s(self.planner.max_perf())
            need = step_need_s(req.deadline_s, now, req.total_steps,
                               self.planner.safety)
            return best > need * (1 + 1e-9)
        best = self._planned_step_s()
        return now + req.total_steps * best > req.deadline_s + 1e-12

    def _admit(self, tracer=None) -> tuple[int, int]:
        """Admit queued requests into free slots; returns how many were
        admitted and how many expired. ``tracer``: an enabled tracer that
        gets each lane reset (and, on the wall clock, each request's
        ``serve/queued``)."""
        if self.admit_mode == "step0" and \
                any(s is not None for s in self.slots):
            return 0, 0     # batch mode: refill only when every slot drained
        now = self.now()
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return 0, 0
        admitted = expired = 0
        # FIFO scan with skip: a head whose deadline needs a faster plan
        # than the current mix allows stays queued (until feasible or
        # expired) without starving later requests that fit
        kept: deque[Request] = deque()
        while self.queue and free:
            req = self.queue.popleft()
            if self._expired(req, now):
                self._reject(req)
                expired += 1
                continue
            if not self._admissible(req, now):
                kept.append(req)
                continue
            i = free.pop(0)
            t = time.perf_counter() if tracer is not None else 0.0
            self.cache = self._reset_lane(self.cache, i)
            if tracer is not None:
                tracer.complete("serve/lane_reset", t,
                                time.perf_counter() - t, cat="serve",
                                args={"slot": i, "rid": req.rid})
                if self.clock is None:
                    tracer.complete("serve/queued", req.arrival_s,
                                    now - req.arrival_s, cat="request",
                                    args={"rid": req.rid})
            self.slots[i] = req
            self._pending[i] = list(req.prompt)
            req.admitted_s = now
            admitted += 1
        kept.extend(self.queue)
        self.queue = kept
        return admitted, expired

    # ----------------------------------------------------------------- step
    def step(self) -> None:
        """One engine step = one decode_step over the slot batch."""
        t0 = time.perf_counter()
        tracer = self.tracer
        if tracer is not None and not tracer.enabled:
            tracer = None
        admitted, expired = self._admit(tracer)
        if tracer is not None:
            t_feed = time.perf_counter()
            tracer.complete("serve/admit", t0, t_feed - t0, cat="serve",
                            args={"admitted": admitted, "expired": expired,
                                  "queued": len(self.queue)})
        active = sum(1 for s in self.slots if s is not None)
        tokens = self._tokens.numpy()
        tokens[:] = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self._pending[i]:
                tokens[i] = self._pending[i].pop(0)
            elif req.out:
                tokens[i] = req.out[-1]
            else:
                tokens[i] = req.prompt[-1]
        if tracer is not None:
            t_replay = time.perf_counter()
            tracer.complete("serve/feed", t_feed, t_replay - t_feed,
                            cat="serve")
        nxt, self.cache = self._step(
            self.params, self.cache,
            self._tokens.to(self.device, non_blocking=True))
        if tracer is not None:
            t_wait = time.perf_counter()
            tracer.complete("serve/replay", t_replay, t_wait - t_replay,
                            cat="serve")
        nxt = nxt.cpu().numpy()
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.complete("serve/wait", t_wait, t1 - t_wait, cat="serve")
        if self.clock is not None:
            dt = self._planned_step_s()
            self.clock.advance(dt)
        else:
            dt = t1 - t0
        self.last_step_s = dt
        now = self.now()
        # the request spans are on the wall clock, as the tracer's are
        req_spans = tracer is not None and self.clock is None
        emitted = completed = missed = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if self._pending[i]:
                continue  # still prefills; ignore logits
            if not req.out:
                req.first_token_s = now
                if req_spans:
                    tracer.complete("serve/prompt", req.admitted_s,
                                    now - req.admitted_s, cat="request",
                                    args={"rid": req.rid})
            req.out.append(int(nxt[i]))
            emitted += 1
            if len(req.out) >= req.max_new_tokens:
                req.done = True
                req.finished_s = now
                completed += 1
                if req.deadline_s is not None and now > req.deadline_s \
                        + 1e-12:
                    req.missed = True
                    missed += 1
                self.slots[i] = None
                if req_spans:
                    tracer.complete("serve/decode", req.first_token_s,
                                    now - req.first_token_s, cat="request",
                                    args={"rid": req.rid})
        if tracer is not None:
            t_end = time.perf_counter()
            tracer.complete("serve/emit", t1, t_end - t1, cat="serve")
            tracer.complete("serve/step", t0, t_end - t0, cat="serve",
                            args={"active": active, "tokens": emitted})
            tracer.counter("serve/active_slots", active)
            tracer.counter("serve/queue_depth", len(self.queue))
            if missed:
                tracer.instant("serve/deadline_miss", cat="serve",
                               args={"count": missed})
        metrics = self.metrics
        if metrics is not None:
            metrics.observe("serve/step_s", dt)
            metrics.set_gauge("serve/queue_depth", float(len(self.queue)))
            if emitted:
                metrics.inc("serve/tokens", emitted)
            if completed:
                metrics.inc("serve/requests_done", completed)
            if missed:
                metrics.inc("serve/deadline_miss", missed)

    def run_until_idle(self, max_steps: int = 10_000) -> None:
        """Step until the queue and every slot are empty; waiting requests
        are admitted mid-run into freed slots."""
        for _ in range(max_steps):
            if not any(s is not None for s in self.slots):
                # nothing active: drop queued requests that already expired
                # so an infeasible backlog terminates instead of spinning
                now = self.now()
                self.queue = deque(
                    r for r in self.queue
                    if not (self._expired(r, now) and
                            (self._reject(r) or True)))
                if not self.queue:
                    return
            self.step()
