"""Exact per-schedule energy accounting.

For a solution S operated at period P (one frame enters every P time
units), each stage (tasks [s, e], r cores of type v) contributes per frame:

    busy energy  =  w([s, e], 1, v)            * P_busy(v)
    idle energy  = (r * P - w([s, e], 1, v))   * P_idle(v)

The busy term is the total work of the stage per frame — with r replicas
each core runs at utilization w/(r*P), so the aggregate busy time per
period is exactly w regardless of the replica count (the runtime's shared
work queue is work-conserving). The idle term charges allocated-but-waiting
cores: a stage owns r cores for the whole period but only w of core-time is
spent computing. Cores never allocated to any stage draw nothing (they are
assumed parked / available to other jobs).

Energies are in watt x chain-time-unit (µJ for the µs DVB-S2 tables).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.chain import Solution, Stage, TaskChain
from repro_torch.core.dvfs import FreqSolution, FreqStage

from .model import PowerModel


def stage_energy_terms(
    work: float, cores: int, ctype: str, period: float, power: PowerModel,
    freq: float = 1.0,
) -> tuple[float, float]:
    """(busy, idle) energy of one stage per frame at operating ``period``.

    Single source of truth for the stage cost — used by the accounting
    report below, the scalar energad/freqherad reference DPs, and the
    vectorized candidate tables (repro_torch.energy.pareto), so the DP's
    objective and the reported energy cannot drift apart. ``work`` and
    ``cores`` may be numpy arrays (one entry per candidate stage); the
    elementwise float operations are identical to the scalar ones, which
    is what keeps the vectorized kernels bit-compatible with these
    scalars. The idle term is clamped at zero: required_cores' ceil
    epsilon can let ``cores * period`` undershoot ``work`` by a rounding
    hair.
    """
    busy = work * power.busy_watts(ctype, freq)
    idle = np.maximum(cores * period - work, 0.0) * power.idle_watts(ctype)
    return busy, idle


@dataclasses.dataclass(frozen=True)
class StageEnergy:
    """Energy breakdown of one stage per frame.

    ``stage`` is the costed :class:`repro_torch.core.Stage`, or a
    :class:`repro_torch.core.dvfs.FreqStage` when a frequency-annotated solution
    was accounted — its per-stage DVFS level is then ``stage.freq``.
    """

    stage: Stage | FreqStage
    busy: float
    idle: float
    utilization: float  # per-core busy fraction in [0, 1]

    @property
    def total(self) -> float:
        return self.busy + self.idle


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Per-frame energy of a schedule evaluated at ``period``."""

    period: float
    freq_big: float
    freq_little: float
    stages: tuple[StageEnergy, ...]

    @property
    def busy(self) -> float:
        return sum(s.busy for s in self.stages)

    @property
    def idle(self) -> float:
        return sum(s.idle for s in self.stages)

    @property
    def total(self) -> float:
        return self.busy + self.idle

    @property
    def avg_watts(self) -> float:
        """Average power draw while streaming (energy per frame / period)."""
        return self.total / self.period if self.period > 0 else 0.0

    def describe(self) -> str:
        return (f"E={self.total:.1f} (busy={self.busy:.1f} "
                f"idle={self.idle:.1f}) over P={self.period:.1f} "
                f"-> {self.avg_watts:.2f} W")


def energy_report(
    chain: TaskChain,
    solution: Solution | FreqSolution,
    power: PowerModel,
    period: float | None = None,
    f_big: float = 1.0,
    f_little: float = 1.0,
) -> EnergyReport:
    """Per-stage energy accounting for ``solution`` on ``chain``.

    ``period`` is the operating period; it defaults to the schedule's
    achieved period and must be >= it (idle time is measured against the
    beat the pipeline actually runs at). ``f_big``/``f_little`` are
    normalized DVFS levels applied globally per core type: they scale task
    latencies by 1/f and dynamic power by f**3 (see repro_torch.energy.model).

    Frequency-annotated solutions (:class:`repro_torch.core.dvfs.FreqSolution`,
    e.g. from the ``freqherad`` strategy) are costed at their own
    per-stage levels; the global ``f_big``/``f_little`` knobs must then be
    left at 1.0, and the report's ``freq_big``/``freq_little`` stay 1.0 —
    the levels live on each ``StageEnergy.stage.freq`` instead.
    """
    if solution.is_empty():
        raise ValueError("cannot account energy of an empty solution")
    if isinstance(solution, FreqSolution):
        if f_big != 1.0 or f_little != 1.0:
            raise ValueError(
                "frequency-annotated solutions carry per-stage levels; "
                "leave f_big/f_little at 1.0")
        return _freq_energy_report(chain, solution, power, period)
    dvfs = power.scale_chain(chain, f_big, f_little)
    achieved = solution.period(dvfs)
    if period is None:
        period = achieved
    elif achieved - period > 1e-9 * max(1.0, achieved):
        # relative guard: required_cores certifies stages with a relative
        # epsilon on work/period, so the achieved period may legitimately
        # overshoot a large requested period by O(P * eps)
        raise ValueError(
            f"operating period {period} is below the achieved period "
            f"{achieved}")
    stages = []
    for st in solution.stages:
        freq = f_big if st.ctype == "B" else f_little
        work = dvfs.stage_sum(st.start, st.end, st.ctype)
        busy, idle = stage_energy_terms(work, st.cores, st.ctype, period,
                                        power, freq)
        util = work / (st.cores * period) if period > 0 else 0.0
        stages.append(StageEnergy(st, busy, idle, min(util, 1.0)))
    return EnergyReport(period=period, freq_big=f_big, freq_little=f_little,
                        stages=tuple(stages))


def _freq_energy_report(
    chain: TaskChain,
    solution: FreqSolution,
    power: PowerModel,
    period: float | None = None,
) -> EnergyReport:
    """Accounting for per-stage-frequency solutions.

    Uses the same :func:`stage_energy_terms` the freqherad / variant DPs
    optimize (work = stage sum * m_k / f, busy watts at the stage's
    level), so reported energies match the DP objective bit for bit. When
    the solution carries a :class:`~repro_torch.core.variants.VariantSpec`, each
    stage's work is evaluated under its own chosen variant — the report's
    per-type energy split (and with it the governor's per-point frontier
    re-pricing) reflects the point's variant mix automatically.
    """
    achieved = solution.period(chain)
    if period is None:
        period = achieved
    elif achieved - period > 1e-9 * max(1.0, achieved):
        raise ValueError(
            f"operating period {period} is below the achieved period "
            f"{achieved}")
    stages = []
    for st in solution.stages:
        work = st.work(chain, solution.variants)
        busy, idle = stage_energy_terms(work, st.cores, st.ctype, period,
                                        power, st.freq)
        util = work / (st.cores * period) if period > 0 else 0.0
        stages.append(StageEnergy(st, busy, idle, min(util, 1.0)))
    return EnergyReport(period=period, freq_big=1.0, freq_little=1.0,
                        stages=tuple(stages))


def energy(
    chain: TaskChain,
    solution: Solution | FreqSolution,
    power: PowerModel,
    period: float | None = None,
) -> float:
    """Total energy per frame of ``solution`` (see :func:`energy_report`)."""
    return energy_report(chain, solution, power, period).total
