"""Time-varying power budgets P_max(t) for the runtime governor.

The paper's energy-aware schedules assume one fixed power envelope; real
SDR deployments run off batteries, behind thermal limits, or under
operator policy — the cap the scheduler must respect is a *trace*, not a
constant. Every budget here exposes the same small interface:

  - ``cap_at(t)``       — the admissible average power (watts) at scenario
                          time ``t`` (seconds, t >= 0);
  - ``change_times()``  — the (finite) times at which the cap steps, so
                          harnesses can align control windows with the
                          interesting moments of a trace and the governor's
                          predictive look-ahead can re-plan *before* a
                          scheduled drop;
  - ``record(t, power_w)`` — measured-draw feedback. A no-op for the
                          open-loop traces; :class:`MeteredBatteryBudget`
                          integrates it into its state of charge.

Caps are piecewise-constant between consecutive ``change_times()`` in all
provided traces — the invariant the governor's predictive re-planning
relies on (``tests/test_control.py`` property-checks it for every trace
class); the governor only samples ``cap_at`` at its control ticks, so any
monotone interpolation a subclass might add is also fine. The traces are
deliberately tiny, deterministic objects: scenario tests script them
exactly, and the DVB-S2 presets (``repro_torch.configs.dvbs2.budget_presets``)
derive their watt levels from the platform's own Pareto frontier so each
step forces a re-plan.
"""
from __future__ import annotations

import dataclasses


class PowerBudget:
    """Interface: a power cap trace P_max(t) in watts over seconds."""

    def attach_tracer(self, tracer) -> "PowerBudget":
        """Attach a ``repro_torch.obs.Tracer`` so stateful budgets can emit
        counter samples (``battery/soc``, ``battery/drain_est_w``) from
        :meth:`record`. Open-loop traces accept and ignore it. Uses
        ``object.__setattr__`` so the frozen trace dataclasses accept
        the attachment too; returns ``self`` for chaining."""
        object.__setattr__(self, "_tracer", tracer)
        return self

    @property
    def tracer(self):
        return getattr(self, "_tracer", None)

    def cap_at(self, t: float) -> float:
        raise NotImplementedError

    def change_times(self) -> tuple[float, ...]:
        """Times (s, ascending) at which the cap changes; empty if never."""
        return ()

    def record(self, t: float, power_w: float | None) -> None:
        """Feed a measured average draw over the window ending at ``t``.

        Open-loop traces ignore it; metered budgets integrate it (the
        governor calls this on every metered observation).
        ``power_w=None`` means "time passed but the measurement is not
        trusted" (a lossy window): metered budgets advance their clock at
        the current drain estimate so the next trusted window's power is
        not stretched over the distrusted gap."""


@dataclasses.dataclass(frozen=True)
class ConstantBudget(PowerBudget):
    """A fixed operator-set cap — the degenerate (steady-state) trace."""

    cap_w: float

    def __post_init__(self):
        if self.cap_w <= 0:
            raise ValueError("cap_w must be positive")

    def cap_at(self, t: float) -> float:
        return self.cap_w


@dataclasses.dataclass(frozen=True)
class ScriptedBudget(PowerBudget):
    """A piecewise-constant schedule: ``points[i] = (t_i, cap_i)`` means
    the cap is ``cap_i`` from ``t_i`` (inclusive) until the next point.

    Times must be strictly ascending and start at 0 so every t >= 0 is
    covered; caps must be positive. This is the fully-general trace the
    governor scenario tests script against."""

    points: tuple[tuple[float, float], ...]

    def __post_init__(self):
        pts = tuple((float(t), float(c)) for t, c in self.points)
        if not pts:
            raise ValueError("ScriptedBudget needs at least one point")
        if pts[0][0] != 0.0:
            raise ValueError("first point must be at t=0")
        times = [t for t, _ in pts]
        if any(t1 >= t2 for t1, t2 in zip(times, times[1:])):
            raise ValueError("point times must be strictly ascending")
        if any(c <= 0 for _, c in pts):
            raise ValueError("caps must be positive")
        object.__setattr__(self, "points", pts)

    def cap_at(self, t: float) -> float:
        cap = self.points[0][1]
        for ti, ci in self.points:
            if ti <= t:
                cap = ci
            else:
                break
        return cap

    def change_times(self) -> tuple[float, ...]:
        return tuple(t for t, _ in self.points[1:])


@dataclasses.dataclass(frozen=True)
class ThermalThrottleBudget(PowerBudget):
    """A thermal-limit step: nominal cap until ``t_throttle``, the
    throttled cap while the package sheds heat, and (optionally) back to
    nominal at ``t_recover`` — the classic skin-temperature governor
    pattern on passively cooled parts."""

    nominal_w: float
    throttled_w: float
    t_throttle: float
    t_recover: float | None = None

    def __post_init__(self):
        if self.nominal_w <= 0 or self.throttled_w <= 0:
            raise ValueError("caps must be positive")
        if self.throttled_w >= self.nominal_w:
            raise ValueError("throttled cap must be below nominal")
        if self.t_throttle < 0:
            raise ValueError("t_throttle must be >= 0")
        if self.t_recover is not None and self.t_recover <= self.t_throttle:
            raise ValueError("t_recover must be after t_throttle")

    def cap_at(self, t: float) -> float:
        if t < self.t_throttle:
            return self.nominal_w
        if self.t_recover is not None and t >= self.t_recover:
            return self.nominal_w
        return self.throttled_w

    def change_times(self) -> tuple[float, ...]:
        times = (self.t_throttle,)
        if self.t_recover is not None:
            times += (self.t_recover,)
        return times


def _validated_levels(
    levels: tuple[tuple[float, float], ...],
) -> tuple[tuple[float, float], ...]:
    """Shared (min SoC, cap) ladder validation for the battery traces."""
    lv = tuple((float(s), float(c)) for s, c in levels)
    if not lv:
        raise ValueError("battery budget needs at least one level")
    socs = [s for s, _ in lv]
    if any(s1 <= s2 for s1, s2 in zip(socs, socs[1:])):
        raise ValueError("SoC thresholds must be strictly descending")
    if lv[-1][0] != 0.0:
        raise ValueError("last level must cover SoC 0.0 (empty)")
    if socs[0] > 1.0:
        raise ValueError("SoC thresholds cannot exceed 1.0 (full)")
    caps = [c for _, c in lv]
    if any(c <= 0 for c in caps):
        raise ValueError("caps must be positive")
    if any(c1 < c2 for c1, c2 in zip(caps, caps[1:])):
        raise ValueError("caps must be non-increasing as SoC falls")
    return lv


def _cap_from_crossings(t: float, crossings, levels) -> float:
    """Cap at ``t`` given the per-boundary crossing times (one per
    ``levels[1:]``, ascending; None = never reached). Comparing ``t``
    against the *same float values* ``change_times()`` reports — instead
    of re-deriving the band from a SoC threshold comparison — makes
    ``cap_at(change_time)`` return the post-drop cap exactly (the
    right-inclusive step convention of the scripted and thermal traces,
    which the governor's predictive look-ahead samples); a threshold
    comparison is off by one ULP of drain arithmetic at the boundary."""
    cap = levels[0][1]
    for tc, (_, c) in zip(crossings, levels[1:]):
        if tc is not None and t >= tc:
            cap = c
        else:
            break
    return cap


@dataclasses.dataclass(frozen=True)
class BatteryBudget(PowerBudget):
    """Drain-to-empty: the cap steps down as the state of charge falls.

    The battery starts full with ``capacity_j`` joules and is drained at
    an assumed average ``drain_w`` (the system draw the trace models, not
    necessarily what the governor achieves — this is an open-loop trace
    like the others, which keeps scenarios reproducible; see
    :class:`MeteredBatteryBudget` for the closed-loop variant). ``levels``
    maps minimum state-of-charge thresholds to caps:

        levels = ((0.6, 35.0), (0.3, 20.0), (0.0, 8.0))

    reads "35 W while SoC is above 60%, 20 W while above 30%, 8 W to
    empty" (at the crossing instant itself the lower cap already applies,
    matching the other traces' step convention). Thresholds must be
    strictly descending and end at 0.0 so the trace is total; caps must
    be positive and non-increasing (a dying battery never raises the
    cap)."""

    capacity_j: float
    drain_w: float
    levels: tuple[tuple[float, float], ...]

    def __post_init__(self):
        if self.capacity_j <= 0 or self.drain_w <= 0:
            raise ValueError("capacity_j and drain_w must be positive")
        object.__setattr__(self, "levels", _validated_levels(self.levels))

    def soc_at(self, t: float) -> float:
        """State of charge in [0, 1] at time ``t`` under the assumed drain."""
        return max(0.0, 1.0 - self.drain_w * t / self.capacity_j)

    def cap_at(self, t: float) -> float:
        return _cap_from_crossings(t, self.change_times(), self.levels)

    def change_times(self) -> tuple[float, ...]:
        """Times at which the SoC falls past a level threshold."""
        times = []
        for i in range(1, len(self.levels)):
            s_prev = self.levels[i - 1][0]
            times.append((1.0 - s_prev) * self.capacity_j / self.drain_w)
        return tuple(times)


class MeteredBatteryBudget(PowerBudget):
    """A battery whose state of charge is closed on *measured* energy.

    :class:`BatteryBudget` drains at an assumed constant ``drain_w`` no
    matter what the governor actually does — re-planning to a frugaler
    schedule cannot buy back runtime. This variant integrates the draw the
    governor reports (:meth:`record`, fed from each
    ``Observation.power_w`` window), so the SoC is what the metered
    runtime actually consumed, and ``change_times()`` re-projects the
    upcoming threshold crossings from a live drain estimate (an EWMA of
    the recorded windows, seeded with ``drain_w``): after a downshift the
    projected crossings move out, exactly the feedback the predictive
    look-ahead plans against.

    Semantics of the trace interface on a metered (stateful) budget:

      - ``cap_at(t)`` for ``t`` at or before the last recorded time
        returns the cap at the *current* (integrated) SoC — the history is
        not replayed;
      - for future ``t`` the SoC is projected forward at the live drain
        estimate;
      - ``change_times()`` are the projected future crossings only
        (strictly after the last recorded time); crossings already passed
        are gone. The piecewise-constant invariant between consecutive
        change times therefore still holds at any fixed state.

    ``levels`` follows :class:`BatteryBudget` (strictly descending
    thresholds ending at 0.0, non-increasing positive caps).

    The drain estimate is a *duration-weighted* EWMA: ``smoothing`` is
    the weight a one-second window contributes, and a window of ``dt``
    seconds contributes ``1 - (1 - smoothing)**dt`` — so a 100 ms
    window nudges the estimate ~10x less than a 1 s one, and two
    back-to-back windows at the same draw move it exactly as far as one
    window of their combined duration. Without the weighting, a single
    short glitchy window would swing the projected ``change_times()``
    as hard as a long clean one (``smoothing=1.0`` still means "last
    window only" for any positive duration).
    """

    def __init__(self, capacity_j: float, drain_w: float,
                 levels: tuple[tuple[float, float], ...],
                 smoothing: float = 0.5):
        if capacity_j <= 0 or drain_w <= 0:
            raise ValueError("capacity_j and drain_w must be positive")
        if not 0.0 < smoothing <= 1.0:
            raise ValueError("smoothing must be in (0, 1]")
        self.capacity_j = float(capacity_j)
        self.drain_w = float(drain_w)
        self.levels = _validated_levels(levels)
        self.smoothing = float(smoothing)
        self._consumed_j = 0.0
        self._t = 0.0
        self._drain_est = float(drain_w)

    @property
    def consumed_j(self) -> float:
        """Measured energy integrated so far (joules)."""
        return self._consumed_j

    @property
    def drain_estimate_w(self) -> float:
        """The live drain estimate future crossings are projected with."""
        return self._drain_est

    def record(self, t: float, power_w: float | None) -> None:
        if power_w is not None and power_w < 0:
            raise ValueError("power_w must be non-negative")
        if t < self._t:
            raise ValueError(
                f"record times must be non-decreasing (got {t} after "
                f"{self._t})")
        dt = t - self._t
        if dt <= 0:
            return
        if power_w is None:
            # distrusted window (e.g. lossy): the time passed and energy
            # certainly flowed, but the meter reading is garbage — charge
            # the window at the current drain estimate and leave the
            # estimate itself untouched
            self._consumed_j += self._drain_est * dt
            self._t = t
            self._emit_counters(t)
            return
        self._consumed_j += power_w * dt
        self._t = t
        # duration-weighted EWMA: a dt-second window carries the weight
        # of dt consecutive one-second windows at the same draw
        weight = 1.0 - (1.0 - self.smoothing) ** dt
        self._drain_est += weight * (power_w - self._drain_est)
        self._emit_counters(t)

    def _emit_counters(self, t: float) -> None:
        tracer = self.tracer
        if tracer is not None and tracer.enabled:
            tracer.counter("battery/soc", self.soc_at(t))
            tracer.counter("battery/drain_est_w", self._drain_est)

    def soc_at(self, t: float) -> float:
        """State of charge in [0, 1]: integrated consumption, projected
        forward at the live drain estimate for ``t`` beyond the last
        record."""
        projected = self._drain_est * max(0.0, t - self._t)
        return max(0.0, 1.0 - (self._consumed_j + projected)
                   / self.capacity_j)

    def _crossings(self) -> list[float | None]:
        """One entry per ``levels[1:]`` boundary: -inf if the integrated
        consumption already crossed it, the projected crossing time under
        the live drain estimate otherwise (None = never, zero drain)."""
        out: list[float | None] = []
        for i in range(1, len(self.levels)):
            s_prev = self.levels[i - 1][0]
            need_j = (1.0 - s_prev) * self.capacity_j - self._consumed_j
            if need_j <= 0:
                out.append(float("-inf"))
            elif self._drain_est > 0:
                out.append(self._t + need_j / self._drain_est)
            else:
                out.append(None)
        return out

    def cap_at(self, t: float) -> float:
        return _cap_from_crossings(t, self._crossings(), self.levels)

    def change_times(self) -> tuple[float, ...]:
        """Projected future threshold crossings under the live estimate."""
        return tuple(tc for tc in self._crossings()
                     if tc is not None and tc > self._t)
