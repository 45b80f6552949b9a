"""Closed-loop governor: monitor, detect, re-plan, swap.

The bridge between the measured runtime (``repro_torch.pipeline.runtime``) and
the Pareto-frontier machinery (``repro_torch.energy.pareto``). The paper's
schedulers pick one static plan from an assumed power model; the governor
closes the loop:

    ┌─────────── observe ────────────┐
    │  measured period / power, t    │
    ▼                                │
  MONITOR ──trigger?──► RE-PLAN ──► SWAP (runtime.rebuild)
    │                      │
    │   cap change         └─ min_period_under_power(chain, b, l,
    │   drift > tolerance          power, cap_at(t), frontier=cached)
    │   device loss
    └── no trigger: keep streaming

Triggers, in priority order at each :meth:`Governor.observe` tick:

  1. **device loss** (:meth:`Governor.device_loss`): the (b, l) budget
     shrank; the frontier is rebuilt for the new pool and the fastest
     point under the current cap is swapped in.
  2. **power**: the *measured* draw ``Observation.power_w`` exceeded the
     cap by more than ``power_tolerance`` (hysteresis against metering
     noise). The model said the plan fits; the meter disagrees — the
     governor learns persistent **per-core-type corrections**
     (``Governor.corrections``, one multiplier per core type): every
     trusted metered window is recorded as a (big-watts, little-watts,
     measured-watts) row, and an overshoot re-fits the corrections by
     least squares over that history. One window can only identify the
     blend, so the first overshoot degenerates to the scalar ratchet
     (both active types scaled by measured/predicted — the old
     ``power_margin`` behaviour exactly); as soon as two rows with
     distinct type mixes exist the fit splits the miscalibration per
     type, so a meter that only under-reports BIG watts stops derating
     LITTLE-heavy plans. Admission then prices each frontier point at
     its *corrected* draw (``energy_report`` type split x corrections)
     and re-selects the fastest point that fits — convergence in at most
     two re-plans (one to learn the blend, one to split it).
     ``power_margin`` survives as the read-only scalar summary
     (``max(corrections)``).
  3. **cap** / **predictive**: the admissible cap dropped below the
     active plan's (margin-derated) predicted draw — or rose enough that
     a faster frontier point (by at least ``upshift_margin``) became
     admissible. With ``lookahead_s > 0`` the governor plans against the
     *minimum* cap over the trace's ``change_times()`` within the
     horizon: a scheduled drop (thermal throttle point, projected battery
     threshold crossing) is adopted one look-ahead early, trigger
     ``"predictive"``, so no control window ever straddles a transition
     over-cap.
  4. **slo** (serving objective, ``slo_period`` set): the governor
     steers the serving engine's windowed p99 step latency
     (``Observation.p99``, chain units) onto the SLO instead of chasing
     raw throughput. On a breach (p99 over ``slo_period`` by more than
     ``slo_tolerance``) it re-plans to the *minimum-energy* frontier
     point whose predicted period — derated by the measured
     p99/predicted pace ratio — meets the SLO and every admitted
     deadline (``Observation.need_period``, the engine's tightest
     per-step budget), falling back to **max-performance** when the cap
     makes that infeasible (EAPS: bust the cap, not the deadlines;
     flagged ``cap_met=False``). When the SLO holds with slack it
     downshifts to the min-energy point that still meets it, but only
     for an energy saving of at least ``upshift_margin`` (swap
     hysteresis), and upshifts immediately when ``need_period``
     tightens below the active plan (a queued tight-deadline request
     must not starve behind an energy-frugal plan).
  5. **drift**: the measured period strayed from the active plan's
     prediction by more than ``drift_tolerance`` (relative). The governor
     then *recalibrates*. When the observation carries per-stage measured
     busy times (``Observation.stage_busy``) and ``stage_recalibration``
     is on, each stage's tasks are rescaled by that stage's own
     measured/predicted ratio (vector rescale), so a single hot stage
     converges in one re-plan; otherwise chain weights are rescaled
     uniformly by the period ratio (co-located load, globally wrong
     tables). Either way the frontier is rebuilt on the recalibrated
     chain and the fastest admissible point re-selected; predictions then
     match measurements, so a persistent bias re-plans exactly once
     rather than every tick.

Measurement-based triggers (power, drift) skip the first observation
after any adopted plan: the window it measured straddles the swap and
mixes two plans' periods and draws, so acting on it would poison the
recalibration.

When no frontier point fits under the cap the governor falls back to the
frugalest point (min power) and flags the event ``cap_met=False`` — shed
throughput, keep the chain alive.

Budgets that support it (``PowerBudget.record``, e.g.
:class:`~repro_torch.control.budget.MeteredBatteryBudget`) are fed every
measured ``power_w`` window, closing the battery state of charge on
metered energy instead of an assumed drain.

Periods are in the chain's time unit (µs for the DVB-S2 tables); budget
trace times are seconds of scenario clock; predicted draws are watts
(energy per frame / period). The governor itself is pure control logic
over :class:`Observation` values — attach a
:class:`~repro_torch.pipeline.runtime.StreamingPipelineRuntime` and every
re-plan is also swapped in via ``runtime.rebuild(plan)``; leave it
detached and the same logic drives scripted scenario tests
deterministically.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.chain import BIG, LITTLE, Solution, TaskChain
from repro_torch.core.dvfs import FreqSolution
from repro_torch.core.variants import VariantSpec
from repro_torch.energy.account import energy_report
from repro_torch.energy.model import PowerModel
from repro_torch.energy.pareto import (
    CandidateTable,
    ParetoPoint,
    dvfs_frontier,
    min_energy_meeting_deadline,
    min_period_under_power,
    pareto_frontier,
    variant_frontier,
)

from .budget import PowerBudget

# sentinel: "the caller did not pre-select a point" (None is a valid
# selection result meaning the cap is infeasible)
_UNSELECTED = object()


@dataclasses.dataclass(frozen=True)
class Observation:
    """One control-tick measurement window.

    ``t`` is scenario time in seconds (the budget trace's clock);
    ``period`` the measured steady-state period in the chain's time unit;
    ``power_w`` the measured average draw (None if the runtime is not
    metered); ``frames`` how many frames the window completed;
    ``dropped`` how many it lost to the liveness deadline. A window with
    drops measured a degraded pipeline, not the workload — its period and
    power are never trusted for recalibration.

    ``stage_busy`` carries the runtime's per-stage measurement for
    per-stage drift recalibration: stage name (the runtime's
    ``s{start}-{end}``) to measured per-frame busy time in the *chain's
    time unit* (the scenario harness aggregates the runtime's
    per-(stage, replica) ``busy_s`` / ``replica_frames`` stats and
    divides out its wall-clock ``time_scale``).

    Serving scenarios add ``p99`` — the windowed p99 step latency from
    the metrics registry, converted to chain units — and
    ``need_period``, the engine's tightest admissible per-step budget
    over every admitted (and queued) deadline
    (:meth:`repro_torch.serve.engine.ServeEngine.min_step_need_s`, converted
    likewise); both drive the ``"slo"`` trigger."""

    t: float
    period: float
    power_w: float | None = None
    frames: int = 0
    dropped: int = 0
    stage_busy: Mapping[str, float] | None = None
    p99: float | None = None
    need_period: float | None = None


@dataclasses.dataclass(frozen=True)
class ActivePlan:
    """A frontier point adopted as the running plan.

    Quacks like a ``PipelinePlan`` as far as the runtime cares
    (``solution`` / ``chain`` / ``freq_solution``), and carries the
    frontier predictions the governor monitors against."""

    chain: TaskChain
    point: ParetoPoint

    @property
    def solution(self) -> Solution:
        sol = self.point.solution
        return sol.to_solution() if isinstance(sol, FreqSolution) else sol

    @property
    def freq_solution(self) -> FreqSolution | None:
        sol = self.point.solution
        return sol if isinstance(sol, FreqSolution) else None

    @property
    def predicted_period(self) -> float:
        return self.point.period

    @property
    def predicted_watts(self) -> float:
        return self.point.energy / self.point.period \
            if self.point.period > 0 else 0.0


@dataclasses.dataclass(frozen=True)
class GovernorEvent:
    """One governor decision: which trigger fired and what was adopted."""

    t: float
    # "start" | "power" | "cap" | "predictive" | "slo" | "drift"
    # | "device_loss"
    trigger: str
    cap_w: float                 # the planning cap the plan was picked under
    plan: ActivePlan
    cap_met: bool = True         # False: fell back to the min-power point
    detail: str = ""


class Governor:
    """Closed-loop re-planner over a (chain, pool, power model, budget).

    ``drift_tolerance`` is the relative measured-vs-predicted period
    deviation that triggers recalibration; ``upshift_margin`` the minimum
    relative period improvement worth a swap when the cap rises (swap
    hysteresis — re-planning drains the pipe, so marginal gains are not
    worth it); ``power_tolerance`` the relative measured-over-cap excess
    that fires the power trigger (metering-noise hysteresis);
    ``lookahead_s`` the predictive horizon over ``budget.change_times()``
    (0 = reactive only); ``stage_recalibration`` enables the per-stage
    drift rescale when observations carry ``stage_busy`` maps.
    ``dvfs=True`` plans off the frequency-swept frontier (per-stage DVFS
    levels, per-core-type ladders honored) instead of the nominal one.

    ``slo_period`` (chain units) arms the serving objective: observations
    carrying a ``p99`` are steered onto the SLO by the ``"slo"`` trigger
    (see module docstring) with ``slo_tolerance`` relative breach
    hysteresis.
    """

    def __init__(
        self,
        chain: TaskChain,
        b: int,
        l: int,
        power: PowerModel,
        budget: PowerBudget,
        *,
        runtime=None,
        drift_tolerance: float = 0.25,
        upshift_margin: float = 0.1,
        power_tolerance: float = 0.05,
        lookahead_s: float = 0.0,
        stage_recalibration: bool = True,
        dvfs: bool = False,
        freq_levels=None,
        variants: VariantSpec | None = None,
        slo_period: float | None = None,
        slo_tolerance: float = 0.1,
        tracer=None,
        rebuild_mode: str = "handoff",
    ):
        if drift_tolerance <= 0:
            raise ValueError("drift_tolerance must be positive")
        if upshift_margin < 0:
            raise ValueError("upshift_margin must be non-negative")
        if power_tolerance < 0:
            raise ValueError("power_tolerance must be non-negative")
        if lookahead_s < 0:
            raise ValueError("lookahead_s must be non-negative")
        if slo_period is not None and slo_period <= 0:
            raise ValueError("slo_period must be positive")
        if slo_tolerance < 0:
            raise ValueError("slo_tolerance must be non-negative")
        if rebuild_mode not in ("handoff", "drain"):
            raise ValueError(f"unknown rebuild_mode {rebuild_mode!r}")
        self.chain = chain
        self.b = b
        self.l = l
        self.power = power
        self.budget = budget
        self.runtime = runtime
        self.drift_tolerance = drift_tolerance
        self.upshift_margin = upshift_margin
        self.power_tolerance = power_tolerance
        self.lookahead_s = lookahead_s
        self.stage_recalibration = stage_recalibration
        self.dvfs = dvfs
        # kernel-variant axis: a VariantSpec plans off the 4-axis
        # variant_frontier (implies the DVFS grid); drift recalibration
        # then rescales the ACTIVE variant's multipliers for non-base
        # stages instead of the shared base weights
        self.variants = variants
        if variants is not None:
            self.dvfs = True
        self.freq_levels = freq_levels
        self.slo_period = slo_period
        self.slo_tolerance = slo_tolerance
        # how adopted plans are swapped into the runtime: "handoff"
        # (zero-drain live handoff — re-plans invisible to traffic) or
        # "drain" (conservative stop-the-world fallback)
        self.rebuild_mode = rebuild_mode
        # optional repro_torch.obs.Tracer: decision instants from every adopt,
        # cap_w / power_w / predicted_w / power_margin counter samples
        # from every metered observe tick (docs/observability.md)
        self.tracer = tracer
        self.events: list[GovernorEvent] = []
        self.calibration_scale = 1.0   # cumulative drift recalibration
        # cumulative per-task drift rescale (vector recalibration trail)
        self.task_scales = np.ones(chain.n)
        # learned per-core-type measured/predicted correction factors:
        # frontier points are admitted at their corrected draw
        # (sum_v corrections[v] * predicted_type_watts[v]) so a model
        # that under-reports one cluster's watts is corrected by
        # measurement, per type, instead of derating everything.
        # Ratcheted/fitted up on an overshoot from the recorded window
        # history; walked back toward the measured ratio by clean in-cap
        # windows, so a transient spike does not derate the governor
        # forever (the upshift hysteresis tracks the derated admission
        # cap and restores speed as the corrections decay)
        self.corrections: dict[str, float] = {BIG: 1.0, LITTLE: 1.0}
        # trusted metered windows as (big_w, little_w, measured_w) rows —
        # the online least-squares system the overshoot re-fit solves
        self._power_history: collections.deque = collections.deque(
            maxlen=8)
        # per-point type-split cache, invalidated with the frontier
        self._split_cache: dict = {}
        self._frontier: list[ParetoPoint] | None = None
        # the (stage, type, level) candidate table shared across every
        # frontier rebuild: budgets are per-query, so device loss reuses
        # it as-is; drift recalibration only rescales the weights
        self._candidates: CandidateTable | None = None
        self._plan: ActivePlan | None = None
        self._last_cap: float | None = None
        # the first observation after any swap measured a window that
        # straddles two plans; power/drift must not trust it
        self._measurement_stale = False

    def attach(self, runtime) -> "Governor":
        """Wire a runtime in after materializing the initial plan:
        subsequent re-plans are swapped in via ``runtime.rebuild``."""
        self.runtime = runtime
        return self

    # ------------------------------------------------------------- queries
    @property
    def plan(self) -> ActivePlan:
        if self._plan is None:
            raise RuntimeError("governor not started — call start() first")
        return self._plan

    @property
    def replans(self) -> list[GovernorEvent]:
        """Every adopted plan change after the initial one."""
        return [e for e in self.events if e.trigger != "start"]

    @property
    def power_margin(self) -> float:
        """Scalar summary of the learned meter corrections: the worst
        per-core-type factor. Read-only — the per-type ``corrections``
        are the state; this is what the scalar-margin era exposed and
        what conservative scalar derates (the slo branch, the upshift
        hysteresis reference) still use."""
        return max(self.corrections.values())

    def frontier(self) -> list[ParetoPoint]:
        """The cached (period, energy) frontier for the current pool and
        (possibly recalibrated) chain.

        Rebuilds share one :class:`~repro_torch.energy.pareto.CandidateTable`:
        the (stage, type, level) candidate precomputation is reused across
        every re-plan — device loss queries it at the shrunken budgets,
        drift recalibration rescales only the chain weights
        (:meth:`CandidateTable.rescale`) — so governor re-planning stays
        on the vectorized fast path end to end.
        """
        if self._frontier is None:
            if self._candidates is None:
                self._candidates = CandidateTable.build(
                    self.chain, self.power,
                    (self.freq_levels if self.freq_levels is not None
                     else self.power.freq_levels) if self.dvfs else (1.0,),
                    variants=self.variants)
            if self.variants is not None:
                self._frontier = variant_frontier(
                    self.chain, self.b, self.l, self.power, self.variants,
                    self.freq_levels, candidates=self._candidates)
            elif self.dvfs:
                self._frontier = dvfs_frontier(
                    self.chain, self.b, self.l, self.power, self.freq_levels,
                    candidates=self._candidates)
            else:
                self._frontier = pareto_frontier(
                    self.chain, self.b, self.l, self.power,
                    candidates=self._candidates)
            if not self._frontier:
                raise RuntimeError(
                    f"no feasible schedule at all on b={self.b}, l={self.l}")
        return self._frontier

    # ------------------------------------------------------------- control
    def start(self, t: float = 0.0) -> GovernorEvent:
        """Adopt the fastest admissible plan under the planning cap at
        ``t`` (the current cap, tightened by any scheduled drop within
        the look-ahead horizon)."""
        if self._plan is not None:
            raise RuntimeError("governor already started")
        return self._adopt(t, "start",
                           self._planning_cap(t, self.budget.cap_at(t)))

    def observe(self, obs: Observation) -> GovernorEvent | None:
        """One control tick; returns the event if a re-plan fired."""
        plan = self.plan  # raises if not started
        if obs.power_w is not None:
            # metered budgets integrate the measured draw into their
            # state of charge before the cap for this tick is read; a
            # lossy window's reading is garbage but its wall time is not
            # — record it as "time passed, draw unknown" so the next
            # trusted window's power is not stretched over the gap
            self.budget.record(
                obs.t, obs.power_w if obs.dropped == 0 else None)
        cap = self.budget.cap_at(obs.t)
        eff = self._planning_cap(obs.t, cap)
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.counter("cap_w", cap)
            if obs.power_w is not None:
                tracer.counter("power_w", obs.power_w)
        stale = self._measurement_stale
        self._measurement_stale = False
        # a trustworthy metered window: record it for the correction fit
        # and compare against the corrected (not raw) prediction
        trusted = not stale and obs.dropped == 0 \
            and obs.power_w is not None and plan.predicted_watts > 0
        split = corrected = None
        if trusted:
            split = self._type_split_watts(plan.point)
            corrected = self._corrected_watts(plan.point)
            self._power_history.append(
                (split[BIG], split[LITTLE], obs.power_w))
        overshoot = trusted \
            and obs.power_w > cap * (1 + self.power_tolerance)
        if trusted and not overshoot and corrected > 0 \
                and obs.power_w < corrected:
            # a window consistent with the cap walks the learned
            # corrections back DOWN toward the measured ratio: a
            # one-window transient spike must not derate every future
            # plan forever. EVERY type is relaxed by the blended
            # measured/corrected ratio — the active plan may not
            # exercise the type the spike derated (the fallback plan is
            # often single-type), and the scalar-margin era decayed the
            # whole derate on any clean window; per-type evidence is not
            # lost, it lives in the window history the next overshoot
            # re-fits from. With uniform corrections this is exactly the
            # scalar decay, and an exact per-type fit (measured ==
            # corrected) is a fixed point, so a fresh fit is never
            # thrashed away. (Upward moves are the overshoot ratchet's
            # job — nudging up from sub-tolerance noise would sneak past
            # the power_tolerance hysteresis via the cap branch.)
            s = obs.power_w / corrected
            for v in self.corrections:
                self.corrections[v] = max(
                    1.0, self.corrections[v] * (1 + 0.5 * (s - 1)))
        event = None
        if overshoot and corrected <= cap * (1 + 1e-9):
            # measured draw over a cap the model claims the plan fits:
            # the meter overrules the model. (When the model itself is
            # over — a cap drop — the cap branch below owns the event;
            # learning corrections from that window would conflate a
            # legitimate plan/cap mismatch with meter miscalibration.)
            # Re-fit the per-type corrections from the window history so
            # the re-selection (and every later one) prices each point
            # at its corrected draw — the re-plan converges in at most
            # two steps and metering noise below power_tolerance never
            # thrashes.
            self._fit_corrections(split, obs.power_w)
            candidate = self._select(eff)
            target = candidate if candidate is not None \
                else self.frontier()[-1]
            if target != plan.point:
                event = self._adopt(
                    obs.t, "power", eff,
                    detail=f"measured {obs.power_w:.2f} W over cap "
                           f"{cap:.2f} W; corrections "
                           f"B={self.corrections[BIG]:.3f} "
                           f"L={self.corrections[LITTLE]:.3f}",
                    point=candidate)
        elif self._corrected_watts(plan.point) > eff * (1 + 1e-9):
            # re-plan only if the selection actually changes: under a
            # persistently infeasible cap the min-power fallback IS the
            # active plan, and re-adopting it every tick would spam
            # identical events without any swap
            candidate = self._select(eff)
            target = candidate if candidate is not None \
                else self.frontier()[-1]
            if target != plan.point:
                if self._corrected_watts(plan.point) > cap * (1 + 1e-9):
                    event = self._adopt(
                        obs.t, "cap", eff,
                        detail=f"cap dropped to {cap:.2f} W",
                        point=candidate)
                else:
                    # the current cap still fits; a scheduled drop within
                    # the horizon does not — swap before it lands
                    event = self._adopt(
                        obs.t, "predictive", eff,
                        detail=f"cap drops to {eff:.2f} W within "
                               f"{self.lookahead_s:g} s",
                        point=candidate)
        elif self.slo_period is not None and obs.p99 is not None \
                and not stale and obs.dropped == 0:
            # serving objective: steer the measured p99 onto the SLO at
            # minimum energy. The measured/predicted pace ratio plays the
            # role of drift recalibration (the frontier query is derated
            # by it instead of rescaling the chain), and the engine's
            # need_period floors the target so an energy downshift never
            # violates an admitted deadline.
            ratio = max(obs.p99 / plan.predicted_period, 1e-9) \
                if plan.predicted_period > 0 else 1.0
            need = self.slo_period / ratio
            if obs.need_period is not None:
                need = min(need, obs.need_period)
            candidate = min_energy_meeting_deadline(
                self.chain, self.b, self.l, self.power,
                eff / self.power_margin, need,
                dvfs=self.dvfs, freq_levels=self.freq_levels,
                frontier=self.frontier())
            if obs.p99 > self.slo_period * (1 + self.slo_tolerance):
                target = candidate if candidate is not None \
                    else self.frontier()[0]
                if target != plan.point:
                    event = self._adopt(
                        obs.t, "slo", eff,
                        detail=f"p99 {obs.p99:.4g} over SLO "
                               f"{self.slo_period:.4g}; need {need:.4g}",
                        point=candidate, fallback="max_perf")
            elif candidate is not None and candidate != plan.point and (
                    plan.predicted_period > need * (1 + 1e-9)
                    or candidate.energy
                    < plan.point.energy * (1 - self.upshift_margin)):
                # within SLO: upshift when deadline pressure tightened
                # past the active plan, else downshift only for an energy
                # saving worth the pipe drain
                event = self._adopt(
                    obs.t, "slo", eff,
                    detail=f"within SLO; need {need:.4g}, energy "
                           f"{candidate.energy:.4g} vs "
                           f"{plan.point.energy:.4g}",
                    point=candidate)
        elif not stale and obs.dropped == 0 and self._drifted(obs.period):
            # windows that lost frames to the liveness deadline measured
            # a stalled pipeline, and the first window after a swap mixes
            # two plans: rescaling the chain from either would poison
            # every later prediction
            ratio = obs.period / plan.predicted_period
            detail = None
            if self.stage_recalibration and obs.stage_busy:
                detail = self._recalibrate_stages(obs)
                if detail is not None:
                    self.calibration_scale *= ratio
            if detail is None:
                self._recalibrate(ratio)
                detail = f"measured/predicted period = {ratio:.3f}; " \
                         f"chain rescaled"
            event = self._adopt(obs.t, "drift", eff, detail=detail)
        elif self._last_cap is not None \
                and eff / self.power_margin > self._last_cap * (1 + 1e-9):
            candidate = self._select(eff)
            if candidate is not None and candidate.period \
                    < plan.predicted_period * (1 - self.upshift_margin):
                event = self._adopt(obs.t, "cap", eff,
                                    detail=f"cap rose to {eff:.2f} W",
                                    point=candidate)
        # the hysteresis reference is the margin-derated ADMISSION cap:
        # a decaying margin (or a rising cap) both widen it, so the
        # upshift branch re-examines the frontier in either case
        self._last_cap = eff / self.power_margin
        if tracer is not None and tracer.enabled:
            tracer.counter("predicted_w", self._plan.predicted_watts)
            tracer.counter("power_margin", self.power_margin)
            tracer.counter("power_corrections",
                           {BIG: self.corrections[BIG],
                            LITTLE: self.corrections[LITTLE]})
        return event

    def device_loss(self, t: float, big: int = 0,
                    little: int = 0) -> GovernorEvent:
        """Shrink the pool and re-plan immediately (elastic scaling)."""
        if big < 0 or little < 0 or big + little == 0:
            raise ValueError("device_loss needs a positive core count")
        if big > self.b or little > self.l:
            raise ValueError(
                f"cannot lose {big}B+{little}L from a "
                f"{self.b}B+{self.l}L pool")
        self.b -= big
        self.l -= little
        self._frontier = None
        self._split_cache = {}
        return self._adopt(
            t, "device_loss",
            self._planning_cap(t, self.budget.cap_at(t)),
            detail=f"lost {big}B+{little}L -> {self.b}B+{self.l}L")

    # ------------------------------------------------------------ internals
    def _planning_cap(self, t: float, cap: float) -> float:
        """The cap a plan adopted at ``t`` must fit: the current cap,
        tightened by every scheduled change within the look-ahead horizon
        (caps are piecewise-constant between ``change_times()``, so
        sampling the change points covers the whole horizon)."""
        if self.lookahead_s <= 0:
            return cap
        eff = cap
        for tc in self.budget.change_times():
            if t < tc <= t + self.lookahead_s:
                eff = min(eff, self.budget.cap_at(tc))
        return eff

    def _drifted(self, measured_period: float) -> bool:
        predicted = self._plan.predicted_period
        if predicted <= 0:
            return False
        return abs(measured_period - predicted) / predicted \
            > self.drift_tolerance

    def _reweigh(self, ratios, variants: VariantSpec | None = None):
        """Swap in a reweighted chain (scalar or per-task ``ratios``),
        optionally together with a refit variant spec (the active-variant
        drift rescale).

        The cached candidate table survives the recalibration: only its
        weight-derived arrays are rebuilt on the rescaled chain — ladders,
        power constants, the variant axis, and replicability structure
        carry over."""
        self.task_scales = self.task_scales * ratios
        self.chain = TaskChain(
            w_big=self.chain.w[BIG] * ratios,
            w_little=self.chain.w[LITTLE] * ratios,
            replicable=self.chain.replicable,
            names=self.chain.names,
        )
        if variants is not None:
            self.variants = variants
        if self._candidates is not None:
            self._candidates = self._candidates.rescale(self.chain,
                                                        self.variants)
        self._frontier = None
        self._split_cache = {}

    def _recalibrate(self, ratio: float):
        """Uniform-slowdown recalibration: every weight scaled alike."""
        self.calibration_scale *= ratio
        self._reweigh(ratio)

    def _recalibrate_stages(self, obs: Observation) -> str | None:
        """Per-stage recalibration: each active stage's tasks rescaled by
        that stage's own measured/predicted busy ratio.

        Uses the same stage naming as the runtime's StageSpecs, so the
        measured map keys straight off ``run()`` stats. Returns the event
        detail, or None when no stage carries a usable measurement (the
        caller then falls back to the uniform model).

        Variant plans rescale the *active* variant only: a stage running
        a non-base kernel variant attributes its drift to that variant's
        multipliers on its own core type
        (:meth:`~repro_torch.core.variants.VariantSpec.with_multipliers`), not
        to the shared base weights — a slow chunked kernel must not slow
        the model's idea of every other implementation. Base-variant
        stages rescale the chain weights exactly as before."""
        ratios = np.ones(self.chain.n)
        # vname -> ctype -> per-task multiplier-ratio array
        vupdates: dict[str, dict[str, np.ndarray]] = {}
        hits: list[tuple[str, float]] = []
        for st in self._plan.point.solution.stages:
            measured = obs.stage_busy.get(f"s{st.start}-{st.end}")
            if measured is None or measured <= 0:
                continue
            variant = getattr(st, "variant", "base")
            on_variant = self.variants is not None and variant != "base"
            pred_chain = self.variants.scaled(self.chain, variant) \
                if on_variant else self.chain
            predicted = pred_chain.stage_sum(st.start, st.end, st.ctype) \
                / getattr(st, "freq", 1.0)
            if predicted <= 0:
                continue
            ratio = measured / predicted
            if on_variant:
                arr = vupdates.setdefault(variant, {}).setdefault(
                    st.ctype, np.ones(self.chain.n))
                arr[st.start:st.end + 1] = ratio
            else:
                ratios[st.start:st.end + 1] = ratio
            hits.append((f"s{st.start}-{st.end}", ratio))
        if not hits:
            return None
        spec = self.variants
        for vname, per_type in vupdates.items():
            ki = spec.index(vname)
            spec = spec.with_multipliers(
                vname,
                spec.mult[BIG][ki] * per_type.get(BIG, 1.0),
                spec.mult[LITTLE][ki] * per_type.get(LITTLE, 1.0))
        self._reweigh(ratios, variants=spec if vupdates else None)
        worst = max(hits, key=lambda h: abs(h[1] - 1.0))
        refit = f" ({len(vupdates)} variant(s) refit)" if vupdates else ""
        return (f"per-stage recalibration over {len(hits)} stages; "
                f"worst {worst[0]} x{worst[1]:.3f}{refit}")

    def _type_split_watts(self, point: ParetoPoint) -> dict[str, float]:
        """A frontier point's predicted draw split per core type, from
        the same ``energy_report`` accounting that priced the point (so
        the split sums to ``energy / period`` exactly)."""
        hit = self._split_cache.get(point)
        if hit is not None:
            return hit
        rep = energy_report(self.chain, point.solution, self.power,
                            period=point.period)
        split = {BIG: 0.0, LITTLE: 0.0}
        for se in rep.stages:
            split[se.stage.ctype] += se.total
        split = {v: (e / point.period if point.period > 0 else 0.0)
                 for v, e in split.items()}
        self._split_cache[point] = split
        return split

    def _corrected_watts(self, point: ParetoPoint) -> float:
        """The point's predicted draw derated by the learned per-type
        corrections — what admission prices the point at."""
        split = self._type_split_watts(point)
        return sum(self.corrections[v] * w for v, w in split.items())

    def _fit_corrections(self, split: dict[str, float], measured_w: float):
        """Re-fit the per-type corrections from the recorded window
        history (rows: big watts, little watts -> measured watts).

        With two or more rows of distinct type mixes the least-squares
        system identifies each type's factor exactly; a rank-deficient
        history (one row, or one plan mix) degenerates to the scalar
        ratchet over the current window — the old ``power_margin``
        behaviour. Either way the current overshoot window ends up
        satisfied (``corrected >= measured``), so the re-selection
        cannot re-admit the plan that just tripped the cap."""
        rows = np.asarray([[wb, wl] for wb, wl, _ in self._power_history],
                          dtype=np.float64)
        y = np.asarray([m for _, _, m in self._power_history],
                       dtype=np.float64)
        fitted = False
        if len(rows) >= 2:
            active = np.flatnonzero(np.abs(rows).sum(axis=0) > 0.0)
            if len(active) > 0 and np.linalg.matrix_rank(
                    rows[:, active]) == len(active):
                coef = np.zeros(2)
                coef[active], *_ = np.linalg.lstsq(
                    rows[:, active], y, rcond=None)
                for i, v in enumerate((BIG, LITTLE)):
                    if i in active:
                        self.corrections[v] = max(1.0, float(coef[i]))
                fitted = True
        if not fitted:
            total = sum(split.values())
            if total > 0:
                ratio = measured_w / total
                for v, w in split.items():
                    if w > 0:
                        self.corrections[v] = max(
                            self.corrections[v], ratio)
        # guarantee: the window that fired the trigger must be priced
        # over its own measurement (a noisy fit could undershoot it)
        corrected = sum(self.corrections[v] * w for v, w in split.items())
        if 0 < corrected < measured_w:
            scale = measured_w / corrected
            for v, w in split.items():
                if w > 0:
                    self.corrections[v] *= scale

    def _select(self, cap: float) -> ParetoPoint | None:
        cb, cl = self.corrections[BIG], self.corrections[LITTLE]
        if cb == cl:
            # uniform corrections divide out of the admission test:
            # delegate to the vectorized frontier query (bit-compatible
            # with the scalar-margin era, including corrections == 1)
            return min_period_under_power(
                self.chain, self.b, self.l, self.power, cap / cb,
                dvfs=self.dvfs, freq_levels=self.freq_levels,
                frontier=self.frontier())
        # per-type pricing: fastest frontier point whose corrected draw
        # fits (the frontier is sorted fastest -> frugalest, same
        # admission epsilon as min_period_under_power)
        for pt in self.frontier():
            if self._corrected_watts(pt) <= cap + 1e-9:
                return pt
        return None

    def _adopt(self, t: float, trigger: str, cap: float,
               detail: str = "", point=_UNSELECTED,
               fallback: str = "min_power") -> GovernorEvent:
        """Adopt the fastest admissible point under ``cap``.

        ``point`` short-circuits the selection when the caller already
        ran it to decide whether to re-plan (pass the raw ``_select``
        result — ``None`` still means "fall back"). Throughput triggers
        fall back to the min-power point (shed speed, keep the chain
        alive); the SLO trigger passes ``fallback="max_perf"`` (EAPS:
        bust the cap rather than the deadlines)."""
        if point is _UNSELECTED:
            point = self._select(cap)
        cap_met = point is not None
        if point is None:
            if fallback == "max_perf":
                point = self.frontier()[0]
                detail = (detail + "; " if detail else "") + \
                    "infeasible under cap, fell back to max-performance"
            else:
                point = self.frontier()[-1]  # min-power: shed speed
                detail = (detail + "; " if detail else "") + \
                    "cap infeasible, fell back to min-power point"
        old = self._plan
        self._plan = ActivePlan(self.chain, point)
        event = GovernorEvent(t, trigger, cap, self._plan, cap_met, detail)
        self.events.append(event)
        if self.tracer is not None and self.tracer.enabled:
            # wall-clock instant on the trace timeline; the scenario-time
            # decision stamp rides along as t_s
            self.tracer.instant(
                f"governor/{trigger}", cat="governor",
                args={"trigger": trigger, "t_s": t, "cap_w": cap,
                      "cap_met": cap_met,
                      "period_us": self._plan.predicted_period,
                      "watts": self._plan.predicted_watts,
                      "power_margin": self.power_margin,
                      "detail": detail})
        self._last_cap = cap / self.power_margin
        self._measurement_stale = True
        if self.runtime is not None and (
                old is None
                or old.point.solution != point.solution
                or trigger == "drift"):
            # drift rebuilds even on an identical decomposition: stage fns
            # may embed recalibrated latencies
            if old is not None:  # the initial plan is materialized outside
                self.runtime.rebuild(self._plan, mode=self.rebuild_mode)
        return event
