"""DVFS-aware scheduling primitives: frequency-annotated solutions and
frequency-indexed HeRAD tables.

This module adds the frequency dimension to the paper's scheduling model
(the ROADMAP's "DVFS-aware HeRAD" item). A stage is extended from
(tasks, replicas, core type) to (tasks, replicas, core type, frequency):
running at normalized DVFS level ``f`` multiplies task latency by ``1/f``
(and, in the energy layer, dynamic power by ``f**3`` — see
``repro_torch.energy.model``). Everything here is pure period machinery with no
power-model dependency; joule-costing of frequency-annotated solutions
lives in ``repro_torch.energy`` (account / pareto), which builds on this module.

Two building blocks:

- :class:`FreqSolution` / :class:`FreqStage`: a schedule whose stages each
  carry a frequency level. ``FreqSolution.period`` evaluates stage weights
  as ``w(s, e, r, v) / f`` in the chain's own time unit (µs for the DVB-S2
  tables).
- :func:`dvfs_tables` / :func:`extract_dvfs_solution`: the
  frequency-indexed HeRAD table. For each global per-core-type profile
  (f_big, f_little) drawn from the level grid it runs the vectorized
  ``herad_table`` on the 1/f-scaled chain, so one call yields the
  period-optimal decomposition for EVERY sub-budget (b', l') AND every
  profile — the third axis the energy layer's DVFS Pareto sweep
  (``repro_torch.energy.pareto.sweep_budgets_freq``) enumerates.

Per-stage (rather than per-profile) frequency choice only matters for the
energy objective — latency is monotone in f, so a period-optimal schedule
always clocks every stage at the highest level. The exact per-stage
frequency assignment is therefore done by the min-energy DP in
``repro_torch.energy.pareto.min_energy_under_period_freq`` (the FreqHeRAD
strategy), which reuses this module's representation.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping

from .chain import BIG, LITTLE, Solution, Stage, TaskChain
from .herad import _Matrix, extract_solution, herad_tables
from .variants import DEFAULT_VARIANT, VariantSpec


def scale_chain(chain: TaskChain, f_big: float = 1.0,
                f_little: float = 1.0, variant: str | None = None,
                variants: VariantSpec | None = None) -> TaskChain:
    """DVFS view of a chain: task latencies scale as ``1/f`` per core type.

    Returns ``chain`` itself when both frequencies are nominal (1.0), so
    the scaled view is free on the common path. Frequencies must be
    positive; arbitrarily small values are allowed (weights grow as 1/f
    but stay finite and positive, so the scaled chain is still a valid
    ``TaskChain``).

    When ``variant``/``variants`` are given the kernel-variant multipliers
    are applied first and the 1/f scaling second, composing the two axes:
    ``w' = (w * m_k) / f``. The base variant (and any identity variant)
    leaves the chain untouched before the frequency scaling, so the pure
    DVFS path is bit-identical to the two-argument call.
    """
    if f_big <= 0 or f_little <= 0:
        raise ValueError("frequencies must be positive")
    if variant is not None and variant != DEFAULT_VARIANT:
        if variants is None:
            raise ValueError("variant given without a VariantSpec")
        chain = variants.scaled(chain, variant)
    elif variant is not None and variants is not None:
        chain = variants.scaled(chain, variant)  # validates the name
    if f_big == 1.0 and f_little == 1.0:
        return chain
    return TaskChain(
        w_big=chain.w[BIG] / f_big,
        w_little=chain.w[LITTLE] / f_little,
        replicable=chain.replicable,
        names=chain.names,
    )


@dataclasses.dataclass(frozen=True)
class FreqStage:
    """One pipeline stage with a DVFS level and a kernel variant: tasks
    [start, end] on ``cores`` cores of ``ctype`` clocked at normalized
    frequency ``freq`` running implementation ``variant``."""

    start: int
    end: int
    cores: int
    ctype: str
    freq: float = 1.0
    variant: str = DEFAULT_VARIANT

    def n_tasks(self) -> int:
        return self.end - self.start + 1

    def weight(self, chain: TaskChain,
               variants: VariantSpec | None = None) -> float:
        """Stage weight at this stage's frequency and variant:
        w(s, e, r, v) * m_k / f. Without a spec the variant annotation is
        ignored (multiplier 1, the pre-variant behaviour)."""
        ch = chain if variants is None else variants.scaled(chain, self.variant)
        return ch.weight(self.start, self.end, self.cores, self.ctype) \
            / self.freq

    def work(self, chain: TaskChain,
             variants: VariantSpec | None = None) -> float:
        """Total per-frame busy time of the stage: sum(w * m_k) / f (all
        replicas)."""
        ch = chain if variants is None else variants.scaled(chain, self.variant)
        return ch.stage_sum(self.start, self.end, self.ctype) / self.freq


@dataclasses.dataclass(frozen=True)
class FreqSolution:
    """A pipelined + replicated + frequency-scaled solution S = (s, r, v, f).

    The DVFS analogue of :class:`repro_torch.core.Solution`; all methods mirror
    it with latencies divided by the per-stage frequency. Periods are in
    the chain's time unit (µs for the DVB-S2 tables).

    ``variants`` carries the resolved kernel-variant table the stage
    ``variant`` names refer to; it is None for pre-variant solutions and
    excluded from equality (stages already name their variants — the spec
    only supplies the multipliers needed to *evaluate* them).
    """

    stages: tuple[FreqStage, ...]
    variants: VariantSpec | None = dataclasses.field(
        default=None, compare=False, repr=False)

    # -------------------------------------------------------------- queries
    def is_empty(self) -> bool:
        return len(self.stages) == 0

    def period(self, chain: TaskChain) -> float:
        """Max frequency/variant-scaled stage weight (Eq. 2 with
        w -> w * m_k / f)."""
        if self.is_empty():
            return math.inf
        return max(st.weight(chain, self.variants) for st in self.stages)

    def cores_used(self, ctype: str) -> int:
        return sum(st.cores for st in self.stages if st.ctype == ctype)

    def core_usage(self) -> tuple[int, int]:
        return self.cores_used(BIG), self.cores_used(LITTLE)

    def covers(self, chain: TaskChain) -> bool:
        """True iff the stages exactly partition [0, n-1]."""
        if self.is_empty():
            return False
        nxt = 0
        for st in self.stages:
            if st.start != nxt or st.end < st.start or st.cores < 1:
                return False
            nxt = st.end + 1
        return nxt == chain.n

    def freq_profile(self) -> tuple[float, ...]:
        """Per-stage frequency levels, in stage order."""
        return tuple(st.freq for st in self.stages)

    def freq_profile_str(self) -> str:
        """Human/CSV form of the profile: "nominal" or e.g. "1/0.75/1"."""
        if self.is_nominal():
            return "nominal"
        return "/".join(f"{f:g}" for f in self.freq_profile())

    def is_nominal(self) -> bool:
        """True iff every stage runs at the nominal frequency (1.0)."""
        return all(st.freq == 1.0 for st in self.stages)

    def variant_profile(self) -> tuple[str, ...]:
        """Per-stage kernel-variant names, in stage order."""
        return tuple(st.variant for st in self.stages)

    def variant_profile_str(self) -> str:
        """Human/CSV form of the variant profile: "base" or e.g.
        "base/chunked/base"."""
        if self.is_base_variant():
            return DEFAULT_VARIANT
        return "/".join(self.variant_profile())

    def is_base_variant(self) -> bool:
        """True iff every stage runs its base implementation."""
        return all(st.variant == DEFAULT_VARIANT for st in self.stages)

    def to_solution(self) -> Solution:
        """Drop the frequency annotation (stages keep cores and type)."""
        return Solution(tuple(
            Stage(st.start, st.end, st.cores, st.ctype) for st in self.stages
        ))

    # --------------------------------------------------------- post-passes
    def merge_replicable(self, chain: TaskChain) -> "FreqSolution":
        """Merge consecutive replicable stages on the same type AND level
        AND variant.

        The merge invariance of ``Solution.merge_replicable`` only holds
        when both stages run at the same frequency and implementation:
        then the combined weight (w1 + w2) * m_k / (f * (r1 + r2)) <= max
        of the parts, and both busy and idle energy are additive. Across
        different variants the combined stage would have to pick ONE
        implementation for the union, which can raise the period.
        """
        if self.is_empty():
            return self
        merged: list[FreqStage] = [self.stages[0]]
        for st in self.stages[1:]:
            last = merged[-1]
            if (
                st.ctype == last.ctype
                and st.freq == last.freq
                and st.variant == last.variant
                and chain.is_rep(last.start, st.end)
            ):
                merged[-1] = FreqStage(last.start, st.end,
                                       last.cores + st.cores, st.ctype,
                                       st.freq, st.variant)
            else:
                merged.append(st)
        return FreqSolution(tuple(merged), variants=self.variants)

    def describe(self, chain: TaskChain) -> str:
        if self.is_empty():
            return "<no solution>"
        parts = [
            f"({st.n_tasks()},{st.cores}{st.ctype}@{st.freq:g}"
            + ("" if st.variant == DEFAULT_VARIANT else f"#{st.variant}")
            + ")"
            for st in self.stages
        ]
        b_used, l_used = self.core_usage()
        return (
            f"P={self.period(chain):.4f} stages={len(self.stages)} "
            f"b={b_used} l={l_used} :: " + ",".join(parts)
        )


EMPTY_FREQ_SOLUTION = FreqSolution(())


def annotate_frequency(solution: Solution, f_big: float = 1.0,
                       f_little: float = 1.0) -> FreqSolution:
    """Lift a nominal :class:`Solution` to a :class:`FreqSolution` with a
    global per-core-type frequency profile."""
    if f_big <= 0 or f_little <= 0:
        raise ValueError("frequencies must be positive")
    return FreqSolution(tuple(
        FreqStage(st.start, st.end, st.cores, st.ctype,
                  f_big if st.ctype == BIG else f_little)
        for st in solution.stages
    ))


# ------------------------------------------------- frequency-indexed tables
def _ladder(levels: Iterable[float]) -> list[float]:
    out = sorted(set(float(f) for f in levels))
    if not out or out[0] <= 0:
        raise ValueError("freq_levels must be positive")
    return out


def dvfs_tables(
    chain: TaskChain, b: int, l: int,
    freq_levels: Iterable[float] | Mapping[str, Iterable[float]],
) -> dict[tuple[float, float], tuple[_Matrix, TaskChain]]:
    """Frequency-indexed HeRAD tables over the (f_big, f_little) grid.

    For every profile in the cross product of ``freq_levels`` (deduplicated,
    ascending) this runs the vectorized HeRAD DP on the 1/f-scaled chain —
    all profiles fill through ONE stacked ``herad_tables`` pass, since the
    scaled chains share the replicable structure. ``freq_levels`` is one
    ladder shared by both core types, or a ``{BIG: ladder, LITTLE: ladder}``
    mapping when the types expose different OPP tables — the grid is then
    the cross product of the two per-type ladders. Each ladder is
    deduplicated up front, so ladder specs carrying repeated levels never
    fill or sweep a (f_big, f_little) profile twice. Each entry maps the
    profile to its filled solution matrix plus
    the scaled chain it was computed on, ready for
    :func:`extract_dvfs_solution` — which, like plain ``extract_solution``,
    can read out the optimum for ANY sub-budget (b', l') <= (b, l). The
    energy layer sweeps this (budget x budget x profile) cube to build
    DVFS Pareto frontiers.
    """
    # same contract as repro_torch.energy.model.normalize_freq_levels: a partial
    # per-type mapping is a bug, not a request for nominal
    big_levels, little_levels = variant_grid_levels(freq_levels)
    # _ladder deduped both axes, so the cross product has no repeats
    profiles = [(fb, fl) for fb in big_levels for fl in little_levels]
    scaled_chains = [scale_chain(chain, fb, fl) for fb, fl in profiles]
    matrices = herad_tables(scaled_chains, b, l)
    return {profile: (matrix, scaled)
            for profile, matrix, scaled
            in zip(profiles, matrices, scaled_chains)}


def extract_dvfs_solution(
    tables: Mapping[tuple[float, float], tuple[_Matrix, TaskChain]],
    profile: tuple[float, float],
    b: int, l: int,
    merge: bool = True,
) -> FreqSolution:
    """Read the period-optimal schedule for ``profile`` at sub-budget (b, l)
    out of a :func:`dvfs_tables` result, annotated with the profile's
    frequencies."""
    table, scaled = tables[profile]
    sol = extract_solution(table, scaled, b, l, merge=merge)
    if sol.is_empty():
        return EMPTY_FREQ_SOLUTION
    return annotate_frequency(sol, *profile)


# --------------------------------------------- variant-indexed tables (4-axis)
def variant_grid_levels(
    freq_levels: Iterable[float] | Mapping[str, Iterable[float]],
) -> tuple[list[float], list[float]]:
    """The deduplicated ascending (big, little) ladders of a level spec —
    the same normalization :func:`dvfs_tables` applies internally."""
    if isinstance(freq_levels, Mapping):
        unknown = set(freq_levels) - {BIG, LITTLE}
        if unknown:
            raise ValueError(f"unknown core types in freq_levels: "
                             f"{sorted(unknown)} (use {BIG!r}/{LITTLE!r})")
        missing = {BIG, LITTLE} - set(freq_levels)
        if missing:
            raise ValueError(f"per-core-type freq_levels must cover both "
                             f"types; missing {sorted(missing)}")
        return _ladder(freq_levels[BIG]), _ladder(freq_levels[LITTLE])
    ladder = _ladder(freq_levels)
    return ladder, list(ladder)


def variant_tables(
    chain: TaskChain, b: int, l: int,
    freq_levels: Iterable[float] | Mapping[str, Iterable[float]],
    variants: VariantSpec | None = None,
) -> dict[tuple[str, float, float], tuple[_Matrix, TaskChain]]:
    """HeRAD tables over the (variant, f_big, f_little) grid.

    The 4-axis analogue of :func:`dvfs_tables`: every (global variant k,
    frequency profile) cell runs the vectorized HeRAD DP on the chain
    scaled by the variant multipliers AND 1/f — and since variant scaling
    preserves the replicable structure, ALL K x P cells fill through one
    stacked ``herad_tables`` pass. Keys are (variant name, f_big,
    f_little); with a trivial (or absent) spec the grid degenerates to
    ``dvfs_tables`` keyed with a leading "base".

    A *global* variant per cell is enough for the sweep stage — like the
    global (f_big, f_little) profiles, the cells seed the Pareto cloud
    whose survivors the per-stage min-energy DP then refines with free
    per-stage variant mixing (``repro_torch.energy.pareto``).
    """
    big_levels, little_levels = variant_grid_levels(freq_levels)
    names = variants.names if variants is not None else (DEFAULT_VARIANT,)
    profiles = [(fb, fl) for fb in big_levels for fl in little_levels]
    keys = [(k, fb, fl) for k in names for fb, fl in profiles]
    scaled_chains = [scale_chain(chain, fb, fl, variant=k, variants=variants)
                     for k, fb, fl in keys]
    matrices = herad_tables(scaled_chains, b, l)
    return {key: (matrix, scaled)
            for key, matrix, scaled in zip(keys, matrices, scaled_chains)}


def extract_variant_solution(
    tables: Mapping[tuple[str, float, float], tuple[_Matrix, TaskChain]],
    key: tuple[str, float, float],
    b: int, l: int,
    variants: VariantSpec | None = None,
    merge: bool = True,
) -> FreqSolution:
    """Read the period-optimal schedule for grid cell ``key`` at sub-budget
    (b, l) out of a :func:`variant_tables` result, annotated with the
    cell's variant and frequencies."""
    vname, f_big, f_little = key
    table, scaled = tables[key]
    sol = extract_solution(table, scaled, b, l, merge=merge)
    if sol.is_empty():
        return EMPTY_FREQ_SOLUTION
    return FreqSolution(tuple(
        FreqStage(st.start, st.end, st.cores, st.ctype,
                  f_big if st.ctype == BIG else f_little, vname)
        for st in sol.stages
    ), variants=variants)
