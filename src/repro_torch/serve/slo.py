"""Deadline-safe energy-aware admission for the serving engine.

The EAPS recipe (SNIPPETS.md Snippet 1) applied to the repo's
(period, energy) frontier machinery: among all (freq, replicas)
configurations on the Pareto frontier, pick the *minimum-energy* one
whose step latency meets every admitted request's deadline under the
current power cap, and fall back to max-performance when no
configuration is feasible.

The planner converts between the frontier's chain time units (µs for
the DVB-S2 tables) and engine seconds via ``time_scale``, and derates
every deadline by ``safety`` (>= 1): a request is only admitted when its
deadline holds even if real steps run ``safety``x slower than the
frontier predicts — the headroom that absorbs measurement inflation
(thermal noise, batch effects) between governor re-plans, and the
reason "no admitted request ever misses its deadline" holds by
construction in the deterministic sim clock
(``tests/test_serve_slo.py``).

Pure control logic over a frontier list — no jax, no engine import; the
engine (:class:`repro_torch.serve.engine.ServeEngine`) calls
:meth:`plan_admission` with per-request step budgets and adopts the
returned point; the governor's ``"slo"`` trigger
(:mod:`repro_torch.control.governor`) runs the same frontier query on
measured p99s.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.energy.pareto import ParetoPoint


def step_need_s(deadline_s: float, now_s: float, steps_remaining: int,
                safety: float = 1.0) -> float:
    """The slowest admissible per-step latency (seconds) for a request
    needing ``steps_remaining`` more engine steps by ``deadline_s``,
    derated by ``safety``. Non-positive when the deadline already
    passed."""
    if steps_remaining <= 0:
        return math.inf
    return (deadline_s - now_s) / (steps_remaining * safety)


@dataclasses.dataclass
class AdmissionPlanner:
    """Frontier-backed deadline admission: minimum-energy feasible
    (freq, replicas), max-perf fallback (EAPS).

    ``frontier`` is a (period, energy) Pareto frontier as the functions in
    :mod:`repro_torch.energy.pareto` return it (period ascending, energy and
    average watts strictly descending); ``time_scale`` converts its
    periods to engine seconds per step; ``cap_w`` is the current power
    cap (update it when the budget moves); ``safety`` derates deadlines
    (see module docstring).
    """

    frontier: Sequence[ParetoPoint]
    time_scale: float
    cap_w: float
    safety: float = 1.5

    def __post_init__(self):
        if not self.frontier:
            raise ValueError("AdmissionPlanner needs a non-empty frontier")
        if self.time_scale <= 0:
            raise ValueError("time_scale must be positive")
        if self.safety < 1.0:
            raise ValueError("safety must be >= 1")

    # ------------------------------------------------------------- queries
    def step_s(self, point: ParetoPoint) -> float:
        """A frontier point's predicted engine step latency in seconds."""
        return point.period * self.time_scale

    def max_perf(self) -> ParetoPoint:
        """The fastest configuration, cap be damned — the EAPS fallback."""
        return self.frontier[0]

    def select(self, need_s: float) -> ParetoPoint | None:
        """Minimum-energy frontier point with step latency <= ``need_s``
        under ``cap_w``, or ``None`` when infeasible.

        Same contiguous-segment bisection as
        :func:`repro_torch.energy.pareto.min_energy_meeting_deadline`, run on
        the planner's own (already-built) frontier in engine seconds."""
        if not math.isfinite(need_s):
            # no deadline pressure: the cheapest point under the cap
            for pt in reversed(self.frontier):
                if self._under_cap(pt):
                    return pt
            return None
        need_units = need_s / self.time_scale
        best = None
        lo, hi = 0, len(self.frontier)
        while lo < hi:                       # first index under the cap
            mid = (lo + hi) // 2
            if self._under_cap(self.frontier[mid]):
                hi = mid
            else:
                lo = mid + 1
        cap_lo = lo
        limit = need_units * (1 + 1e-9)
        lo, hi = 0, len(self.frontier)
        while lo < hi:                       # first index past the deadline
            mid = (lo + hi) // 2
            if self.frontier[mid].period <= limit:
                lo = mid + 1
            else:
                hi = mid
        if cap_lo <= lo - 1:
            best = self.frontier[lo - 1]
        return best

    def plan_admission(self, needs_s: Sequence[float]
                       ) -> tuple[ParetoPoint | None, bool]:
        """Plan for a set of per-request step budgets (seconds).

        Returns ``(point, feasible)``:

        - a feasible minimum-energy point and ``True`` when one exists
          under the cap;
        - ``(max_perf(), False)`` when the cap makes the deadlines
          infeasible but flat-out still meets them — EAPS busts the cap
          rather than the deadlines;
        - ``(None, False)`` when even max-performance misses: the caller
          must reject (never admit a request into a guaranteed miss).
        """
        need = min(needs_s) if needs_s else math.inf
        if need <= 0:
            return None, False
        point = self.select(need)
        if point is not None:
            return point, True
        fastest = self.max_perf()
        if self.step_s(fastest) <= need * (1 + 1e-9):
            return fastest, False
        return None, False

    def _under_cap(self, pt: ParetoPoint) -> bool:
        return pt.period > 0 and pt.energy / pt.period <= self.cap_w + 1e-9
