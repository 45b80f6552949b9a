"""(period, energy) Pareto frontiers, energy-constrained and DVFS-aware
scheduling — vectorized budget-plane kernels with scalar reference oracles.

Units follow the chain: task weights are in the chain's time unit (µs for
the DVB-S2 tables), powers in watts, so energies are watt x time-unit
(µJ per frame for µs chains) and periods are in the same unit as weights.

This module is the planning layer the runtime governor re-plans through
(``repro_torch.control``), so every entry point is built as a *fast path*,
mirroring the lexicographic-min-as-elementwise-select recipe documented in
``repro_torch.core.herad``. Kernel layout:

- :class:`CandidateTable`: the (stage interval, core type, frequency)
  candidate precomputation shared by every period-bound query. Interval
  sums and replicability come from one vectorized prefix-sum expression
  (``TaskChain.stage_sum_matrix`` / ``rep_matrix``); a query at ``p_max``
  prices all candidates at once with the same
  :func:`repro_torch.energy.account.stage_energy_terms` arithmetic the
  accounting report uses. Frontier refinement and governor re-planning
  reuse one table across all ``p_max`` queries; drift recalibration only
  rescales the weights (:meth:`CandidateTable.rescale` — uniformly, or
  per task for the governor's per-stage recalibration).

- :func:`min_energy_under_period` / :func:`min_energy_under_period_freq`
  (strategy names ``"energad"`` / ``"freqherad"``): exact min-sum DPs over
  the ``(b+1, l+1)`` budget plane. For a fixed operating period the energy
  of a schedule is additive over stages (see repro_torch.energy.account), so the
  optimal substructure of Eq. (4) carries over with min-sum replacing
  min-max; each candidate stage is a shift-add of the predecessor plane
  (``E[j][ub, ul] = min(E[i-1][ub-db, ul-dl] + cost)``) instead of the
  former Python ``for pb / for pl`` loops. The scalar implementations are
  retained as ``*_reference`` oracles; the vectorized DPs replay their
  float operations and candidate enumeration order exactly, so schedules,
  energies, and tie-breaking are bit-identical.

- :func:`sweep_budgets` / :func:`sweep_budgets_freq`: HeRAD's solution
  matrix already contains the period-optimal schedule for EVERY sub-budget
  (b', l') <= (b, l); the sweeps cost all of them straight from the DP
  field arrays (``repro_torch.core.herad.plane_merged_stages`` walks every
  cell's merged stage sequence in lockstep) instead of extracting a
  ``Solution`` per cell. :class:`ParetoPoint.solution` is *lazy*: real
  schedule objects are only materialized for the points something actually
  reads — in practice the frontier survivors. Filtering the resulting
  (period, energy) cloud to its non-dominated subset yields the trade-off
  frontier of the paper's Section VII (heterogeneous schedules beat the
  best homogeneous ones in energy by ~8%).

- :func:`pareto_frontier` / :func:`dvfs_frontier`: the non-dominated
  subset, optionally re-optimized per surviving period level by the exact
  DP. Refinement is ONE batched DP across all S surviving period levels
  (:func:`min_energy_under_period_freq_batch` — a shared ``(S, b+1,
  l+1)`` budget volume with per-bound masked plane updates), not S
  sequential queries; all bounds share one :class:`CandidateTable` and
  the result is bit-identical per bound to the scalar entry points.

A final tool inverts the constraint: :func:`min_period_under_power`
returns the fastest frontier point whose average draw fits under an
operator power cap — the re-planning query of the runtime governor
(``repro_torch.control``) and of ``plan_pipeline(..., power_cap_w=...)``.
Average power is strictly decreasing along a frontier, so the query is a
bisection, not a scan.

Complexity (n tasks, budgets b/l, |F| frequency levels): one
``CandidateTable`` build is O(n^2 |F|) vectorized; a DP query is
O(n^2 |F|) candidate plane-updates of O(b l) each; a budget sweep is
O(n b l) vectorized steps per frequency profile. See docs/energy.md for
the before/after table and BENCH_sched.json for measured latencies.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core.chain import (
    BIG,
    LITTLE,
    _CEIL_EPS,
    EMPTY_SOLUTION,
    Solution,
    TaskChain,
    cores_for_work,
)
from repro_torch.core.dvfs import (
    EMPTY_FREQ_SOLUTION,
    FreqSolution,
    FreqStage,
    annotate_frequency,
    dvfs_tables,
    extract_dvfs_solution,
    extract_variant_solution,
    scale_chain,
    variant_tables,
)
from repro_torch.core.herad import (
    extract_solution,
    herad,
    herad_table,
    herad_tables,
    plane_merged_stages,
)
from repro_torch.core.variants import DEFAULT_VARIANT, VariantSpec

from .account import energy, stage_energy_terms
from .model import (
    DEFAULT_DVFS_POWER,
    DEFAULT_POWER,
    PowerModel,
    normalize_freq_levels,
)


class ParetoPoint:
    """One (period, energy) operating point and the schedule achieving it.

    ``solution`` is a :class:`repro_torch.core.Solution` for nominal-frequency
    sweeps or a :class:`repro_torch.core.dvfs.FreqSolution` for DVFS sweeps;
    both expose ``core_usage()`` / ``period(chain)``. ``period`` is in the
    chain's time unit (µs for the DVB-S2 tables), ``energy`` in watt x
    time-unit (µJ) per frame.

    Extraction is lazy: budget sweeps cost every sub-budget point straight
    from the DP field arrays and attach an extractor instead of a
    materialized schedule, so only the points something actually reads
    (the frontier survivors, the governor's adopted plans) pay the O(n)
    reconstruction. The first ``solution`` access caches the result;
    hashing and ordering by (period, energy) never trigger extraction,
    but ``==`` between points compares the schedules and therefore does.
    """

    __slots__ = ("period", "energy", "budget", "_solution", "_extract")

    def __init__(self, period: float, energy: float,
                 solution: Solution | FreqSolution | None = None,
                 budget: tuple[int, int] = (0, 0), *, extract=None):
        if solution is None and extract is None:
            raise ValueError("ParetoPoint needs a solution or an extractor")
        self.period = float(period)
        self.energy = float(energy)
        # (big, little) cores this point was produced under: the swept
        # sub-budget for sweep points, or the schedule's own core usage
        # for points re-optimized by the min-energy refinement pass.
        self.budget = (int(budget[0]), int(budget[1]))
        self._solution = solution
        self._extract = extract

    @property
    def solution(self) -> Solution | FreqSolution:
        if self._solution is None:
            self._solution = self._extract()
        return self._solution

    def is_heterogeneous(self) -> bool:
        used_b, used_l = self.solution.core_usage()
        return used_b > 0 and used_l > 0

    def __eq__(self, other) -> bool:
        if not isinstance(other, ParetoPoint):
            return NotImplemented
        return (self.period == other.period
                and self.energy == other.energy
                and self.budget == other.budget
                and self.solution == other.solution)

    def __hash__(self) -> int:
        return hash((self.period, self.energy, self.budget))

    def __repr__(self) -> str:
        lazy = "" if self._solution is not None else ", lazy"
        return (f"ParetoPoint(period={self.period!r}, "
                f"energy={self.energy!r}, budget={self.budget!r}{lazy})")


def _resolve_levels(
    power: PowerModel, freq_levels=None,
) -> dict[str, tuple[float, ...]]:
    """Normalize a frequency-ladder spec into per-core-type ladders.

    Defaults to the model's ladder; accepts one shared tuple or a
    per-core-type mapping (``normalize_freq_levels``), deduplicates and
    sorts each ladder ascending, rejects non-positive levels. Single
    source for every frequency-aware entry point; always returns a
    ``{B: ladder, L: ladder}`` dict."""
    spec = freq_levels if freq_levels is not None else power.freq_levels
    norm = normalize_freq_levels(spec)
    if not isinstance(norm, dict):
        norm = {BIG: norm, LITTLE: norm}
    return {v: tuple(sorted(set(levels))) for v, levels in norm.items()}


# ----------------------------------------------------------- candidate table
class CandidateTable:
    """Precomputed (stage [i, j], core type, frequency, variant) candidates.

    Everything about a candidate that does NOT depend on the period bound
    or the core budgets — interval work sums, replicability, per-level
    busy/idle watts — computed once as numpy arrays and shared across all
    ``p_max`` queries: the min-energy DPs, every refinement pass of a
    frontier build, and the governor's re-plan queries all draw from one
    table instead of re-enumerating candidates from scratch.

    ``levels`` is the resolved ``{B: ladder, L: ladder}`` dict
    (:func:`_resolve_levels`); budgets are supplied per query so one table
    serves a shrinking device pool (governor device loss). After drift
    recalibration only the chain weights change: :meth:`rescale` rebuilds
    the weight-derived arrays on the new chain and reuses the rest.

    The kernel-variant axis is folded into the frequency axis: per core
    type the candidates are laid out along ONE flat axis of K * |F_v|
    entries, variant-major (variant 0 = base first, ladder ascending
    within each variant — ``axis_f`` / ``axis_kidx`` name each entry).
    Variant scaling multiplies interval sums exactly like 1/f divides
    them, so every downstream kernel (queries, DP plane updates, the
    dominance pruning) is unchanged modulo the longer axis; with a
    trivial (or absent) spec the layout reduces to today's pure-frequency
    table bit for bit.
    """

    def __init__(self, chain: TaskChain, power: PowerModel,
                 levels: dict[str, tuple[float, ...]],
                 variants: VariantSpec | None = None):
        self.chain = chain
        self.power = power
        self.levels = levels
        self.variants = variants
        self.vnames = variants.names if variants is not None \
            else (DEFAULT_VARIANT,)
        # flat candidate axis per core type: variant-major, ladder within
        self.axis_f = {v: [float(f) for _ in self.vnames
                           for f in levels[v]] for v in (BIG, LITTLE)}
        self.axis_kidx = {v: np.repeat(np.arange(len(self.vnames)),
                                       len(levels[v]))
                          for v in (BIG, LITTLE)}
        self.rep = chain.rep_matrix()
        self.works = self._build_works(chain, levels, variants)
        self._tri = np.tri(chain.n, dtype=bool).T  # j >= i

    def _build_works(self, chain, levels, variants):
        """works[v][ci, i, j] = stage_sum(i, j, v) * m_k / f — the per-frame
        busy time of candidate stage [i, j] on type v at flat-axis entry ci
        = (variant k, level f). Shared by the constructor and
        :meth:`rescale` so the two can never diverge."""
        out = {}
        for v in (BIG, LITTLE):
            f = np.asarray(levels[v], dtype=np.float64)
            mats = np.stack([
                (variants.scaled(chain, k) if variants is not None
                 else chain).stage_sum_matrix(v)
                for k in self.vnames])                     # (K, n, n)
            out[v] = (mats[:, None, :, :] / f[None, :, None, None]) \
                .reshape(len(self.vnames) * len(f), chain.n, chain.n)
        return out

    @classmethod
    def build(cls, chain: TaskChain, power: PowerModel,
              freq_levels=None,
              variants: VariantSpec | None = None) -> "CandidateTable":
        """Resolve the ladder spec (one shared tuple, a per-core-type
        mapping, or the model's default) and build the table."""
        return cls(chain, power, _resolve_levels(power, freq_levels),
                   variants)

    def rescale(self, chain: TaskChain,
                variants: VariantSpec | None = None) -> "CandidateTable":
        """The same table on a reweighted chain (drift recalibration).

        The new chain's task weights are arbitrary — a uniform slowdown
        multiplies every weight alike, the governor's *per-stage* drift
        recalibration applies a different factor per task (vector
        rescale); both land here. Only the weight-derived ``works``
        arrays are rebuilt (from the new chain's prefix sums, so the
        result is bit-identical to a fresh build) — ladders, power
        constants, the variant axis, and the replicability structure
        carry over as-is. The chain must have the same length and
        replicable partition.

        Pass ``variants`` to swap in refit multipliers at the same time
        (the governor's active-variant drift recalibration); the spec
        must list the same variant names so the flat candidate axis is
        unchanged."""
        if chain.n != self.chain.n or \
                not np.array_equal(chain.replicable, self.chain.replicable):
            raise ValueError("rescale needs an equal-structure chain")
        if variants is None:
            variants = self.variants
        elif variants.names != self.vnames:
            raise ValueError("rescale needs an equal variant-name set")
        other = CandidateTable.__new__(CandidateTable)
        other.chain = chain
        other.power = self.power
        other.levels = self.levels
        other.variants = variants
        other.vnames = self.vnames
        other.axis_f = self.axis_f
        other.axis_kidx = self.axis_kidx
        other.rep = self.rep
        other._tri = self._tri
        other.works = self._build_works(chain, self.levels, variants)
        return other

    def query(self, b: int, l: int, p_max: float) -> dict:
        """Price and filter every candidate for one (budget, period) query.

        Returns ``{v: (r, cost, feasible)}`` arrays of shape
        ``(K * |F_v|, n, n)``: minimum replica counts (``cores_for_work``),
        stage energies (:func:`stage_energy_terms` — busy at the
        candidate's level, idle against the ``p_max`` beat), and the
        feasibility mask (budget caps, sequential stages capped at one
        core). All arithmetic is elementwise-identical to the scalar
        reference DP's, which is what keeps the vectorized DP bit-exact.

        The feasibility mask is additionally pruned of candidates that
        provably never win a DP cell: within one (stage, type, replica
        count) group, a later flat-axis candidate whose cost is >= an
        earlier member's can never strictly beat a plane the earlier
        member already updated (float addition is monotone and the DP
        compares with strict <), so dropping it changes nothing —
        including tie-breaking. Along one variant this is the dominated-
        ladder-level rule; across variants it is the variant-dominance
        rule (a variant slower AND no cheaper at the same replica count
        is dropped — in particular, unregistered tasks' duplicate base
        candidates vanish here).
        """
        out = {}
        for v in (BIG, LITTLE):
            cap = b if v == BIG else l
            work = self.works[v]
            r_real = np.maximum(1.0, np.ceil(work / p_max - _CEIL_EPS))
            feas = self._tri[None, :, :] & np.where(
                self.rep[None, :, :], r_real <= cap, r_real <= 1.0)
            if cap <= 0:
                feas &= False
            r = np.where(self.rep[None, :, :], r_real, 1.0)
            r = np.minimum(r, max(cap, 1)).astype(np.int64)
            cost = np.zeros_like(work)
            for ci, f in enumerate(self.axis_f[v]):
                busy, idle = stage_energy_terms(
                    work[ci], r[ci], v, p_max, self.power, f)
                cost[ci] = busy + idle
            for ci in range(1, len(self.axis_f[v])):
                dominated = np.zeros(feas.shape[1:], dtype=bool)
                for cj in range(ci):
                    dominated |= feas[cj] & (r[cj] == r[ci]) \
                        & (cost[cj] <= cost[ci])
                feas[ci] &= ~dominated
            out[v] = (r, cost, feas)
        return out

    def query_batch(self, b: int, l: int, p_maxes) -> dict:
        """:meth:`query` over a whole vector of period bounds at once.

        Returns ``{v: (r, cost, feasible)}`` arrays of shape
        ``(S, K * |F_v|, n, n)`` for ``S = len(p_maxes)`` — the ``s``-th
        slice is elementwise identical to ``query(b, l, p_maxes[s])``:
        every operation below is the scalar query's with a broadcast
        leading axis, and numpy elementwise float ops are deterministic
        per element regardless of batching. Frontier refinement prices
        all of a frontier's period levels through one call instead of S
        sequential queries.
        """
        p = np.asarray(p_maxes, dtype=np.float64)[:, None, None, None]
        out = {}
        for v in (BIG, LITTLE):
            cap = b if v == BIG else l
            work = self.works[v]
            r_real = np.maximum(1.0, np.ceil(work[None] / p - _CEIL_EPS))
            feas = self._tri[None, None, :, :] & np.where(
                self.rep[None, None, :, :], r_real <= cap, r_real <= 1.0)
            if cap <= 0:
                feas &= False
            r = np.where(self.rep[None, None, :, :], r_real, 1.0)
            r = np.minimum(r, max(cap, 1)).astype(np.int64)
            cost = np.zeros(r_real.shape)
            for ci, f in enumerate(self.axis_f[v]):
                busy, idle = stage_energy_terms(
                    work[ci], r[:, ci], v, p[:, 0], self.power, f)
                cost[:, ci] = busy + idle
            for ci in range(1, len(self.axis_f[v])):
                dominated = np.zeros(feas[:, ci].shape, dtype=bool)
                for cj in range(ci):
                    dominated |= feas[:, cj] & (r[:, cj] == r[:, ci]) \
                        & (cost[:, cj] <= cost[:, ci])
                feas[:, ci] &= ~dominated
            out[v] = (r, cost, feas)
        return out


def _min_energy_dp(table: CandidateTable, b: int, l: int,
                   p_max: float) -> FreqSolution:
    """Vectorized min-sum DP over the (b+1, l+1) budget plane.

    Bit-identical to :func:`min_energy_under_period_freq_reference`:
    candidates are applied in the same (stage start, core type, level)
    order with the same strict-< tie-breaking, each as one shift-add
    plane update; parents store candidate ids for O(n) reconstruction.
    """
    chain = table.chain
    n = chain.n
    q = table.query(b, l, p_max)
    # enumerate the surviving candidates once with numpy, in exactly the
    # scalar reference's order: stage start ascending, big before little,
    # flat candidate axis ascending = variant registration order, ladder
    # ascending within a variant (lexsort keys are read last-to-first)
    jjs, iis, rrs, vvs, aas, ffs, kks, ccs = \
        [], [], [], [], [], [], [], []
    for vflag, v in enumerate((BIG, LITTLE)):
        rv, cv, fev = q[v]
        aa, ii, jj = np.nonzero(fev)
        jjs.append(jj)
        iis.append(ii)
        rrs.append(rv[aa, ii, jj])
        vvs.append(np.full(len(jj), vflag, dtype=np.int8))
        aas.append(aa)
        ffs.append(np.asarray(table.axis_f[v])[aa])
        kks.append(table.axis_kidx[v][aa])
        ccs.append(cv[aa, ii, jj])
    jj = np.concatenate(jjs)
    ii = np.concatenate(iis)
    rr = np.concatenate(rrs)
    vv = np.concatenate(vvs)
    order = np.lexsort((np.concatenate(aas), vv, ii, jj))
    jj, ii, rr, vv = jj[order], ii[order], rr[order], vv[order]
    recs_all = list(zip(
        ii.tolist(), rr.tolist(), vv.tolist(),
        np.concatenate(ffs)[order].tolist(),
        np.concatenate(kks)[order].tolist(),
        np.where(vv == 0, rr, 0).tolist(),
        np.where(vv == 0, 0, rr).tolist(),
        np.concatenate(ccs)[order].tolist()))
    bounds = np.searchsorted(jj, np.arange(n + 1))
    E = np.full((n, b + 1, l + 1), math.inf)
    pid = np.full((n, b + 1, l + 1), -1, dtype=np.int32)
    nbuf = np.empty((b + 1, l + 1))
    mbuf = np.empty((b + 1, l + 1), dtype=bool)
    cands: list[list[tuple]] = []
    for j in range(n):
        recs = recs_all[bounds[j]:bounds[j + 1]]
        Ej, pj = E[j], pid[j]
        for cidx, (i, r, vflag, f, kidx, db, dl, cost) in enumerate(recs):
            if i == 0:
                if cost < Ej[db, dl]:
                    Ej[db, dl] = cost
                    pj[db, dl] = cidx
                continue
            nE = nbuf[: b + 1 - db, : l + 1 - dl]
            np.add(E[i - 1][: b + 1 - db, : l + 1 - dl], cost, out=nE)
            tgt = Ej[db:, dl:]
            m = mbuf[: b + 1 - db, : l + 1 - dl]
            np.less(nE, tgt, out=m)
            if m.any():
                np.copyto(tgt, nE, where=m)
                np.copyto(pj[db:, dl:], cidx, where=m, casting="unsafe")
        cands.append(recs)
    end = E[n - 1]
    k = int(np.argmin(end))  # C-order first min == (energy, ub, ul) lex min
    ub, ul = divmod(k, l + 1)
    if not math.isfinite(end[ub, ul]):
        return EMPTY_FREQ_SOLUTION
    stages: list[FreqStage] = []
    j = n - 1
    while j >= 0:
        i, r, vflag, f, kidx, db, dl, _ = cands[j][pid[j][ub, ul]]
        stages.append(FreqStage(i, j, r, BIG if vflag == 0 else LITTLE, f,
                                table.vnames[kidx]))
        j, ub, ul = i - 1, ub - db, ul - dl
    # merging adjacent same-type same-frequency same-variant replicable
    # stages changes neither period nor energy (both terms are additive)
    # but saves runtime stage hops
    return FreqSolution(tuple(reversed(stages)),
                        variants=table.variants).merge_replicable(chain)


def _min_energy_dp_batch(table: CandidateTable, b: int, l: int,
                         p_maxes) -> list[FreqSolution]:
    """S period-bound DPs over one shared (S, b+1, l+1) budget volume.

    Per bound ``s`` this is bit-identical to ``_min_energy_dp(table, b,
    l, p_maxes[s])``: candidates are priced for all bounds in one
    :meth:`CandidateTable.query_batch`, the union of per-bound feasible
    candidates is enumerated once in the scalar DP's (stage start, core
    type, level) order, and each candidate updates only the planes of
    the bounds it is feasible for (grouped by its per-bound replica
    count, since the replica count fixes the budget shift). A candidate
    infeasible for bound ``s`` is a masked no-op there, so the effective
    update sequence per bound — and with it every strict-< tie-break —
    matches the scalar run's exactly. Frontier refinement calls this
    once across all S surviving period levels instead of S sequential
    ``_min_energy_dp`` runs.
    """
    chain = table.chain
    n = chain.n
    p = np.asarray(p_maxes, dtype=np.float64)
    S = len(p)
    ok = np.isfinite(p) & (p > 0)
    if S == 0:
        return []
    if b + l <= 0 or not ok.any():
        return [EMPTY_FREQ_SOLUTION] * S
    # invalid bounds get a dummy 1.0 query and a fully masked-off plane
    q = table.query_batch(b, l, np.where(ok, p, 1.0))
    # union candidate enumeration, in the scalar DP's order: stage start
    # ascending, big before little, flat (variant, ladder) axis ascending
    jjs, iis, vvs, aas, ffs, kks, rss, css, mss = \
        [], [], [], [], [], [], [], [], []
    for vflag, v in enumerate((BIG, LITTLE)):
        rv, cv, fev = q[v]
        fev &= ok[:, None, None, None]
        aa, ii, jj = np.nonzero(fev.any(axis=0))
        jjs.append(jj)
        iis.append(ii)
        vvs.append(np.full(len(jj), vflag, dtype=np.int8))
        aas.append(aa)
        ffs.append(np.asarray(table.axis_f[v])[aa])
        kks.append(table.axis_kidx[v][aa])
        rss.append(rv[:, aa, ii, jj])
        css.append(cv[:, aa, ii, jj])
        mss.append(fev[:, aa, ii, jj])
    jj = np.concatenate(jjs)
    ii = np.concatenate(iis)
    vv = np.concatenate(vvs)
    aa = np.concatenate(aas)
    fv = np.concatenate(ffs)
    kk = np.concatenate(kks)
    order = np.lexsort((aa, vv, ii, jj))
    jj, ii, vv, fv, kk = \
        jj[order], ii[order], vv[order], fv[order], kk[order]
    rr = np.concatenate(rss, axis=1)[:, order]   # (S, m) replica counts
    cc = np.concatenate(css, axis=1)[:, order]   # (S, m) costs
    mm = np.concatenate(mss, axis=1)[:, order]   # (S, m) feasibility
    bounds = np.searchsorted(jj, np.arange(n + 1))
    E = np.full((n, S, b + 1, l + 1), math.inf)
    pid = np.full((n, S, b + 1, l + 1), -1, dtype=np.int32)
    for j in range(n):
        lo_, hi_ = int(bounds[j]), int(bounds[j + 1])
        Ej, pj = E[j], pid[j]
        for cidx in range(lo_, hi_):
            i = int(ii[cidx])
            vbig = vv[cidx] == 0
            rs, costs, smask = rr[:, cidx], cc[:, cidx], mm[:, cidx]
            # bounds sharing this candidate's replica count share its
            # budget shift — one masked plane update per distinct count
            for r_ in np.unique(rs[smask]).tolist():
                db, dl = (int(r_), 0) if vbig else (0, int(r_))
                g = smask & (rs == r_)
                if i == 0:
                    tgt = Ej[:, db, dl]
                    m = g & (costs < tgt)
                    if m.any():
                        np.copyto(tgt, costs, where=m)
                        np.copyto(pj[:, db, dl], cidx - lo_, where=m,
                                  casting="unsafe")
                    continue
                nE = E[i - 1][:, : b + 1 - db, : l + 1 - dl] \
                    + costs[:, None, None]
                tgt = Ej[:, db:, dl:]
                m = (nE < tgt) & g[:, None, None]
                if m.any():
                    np.copyto(tgt, nE, where=m)
                    np.copyto(pj[:, db:, dl:], cidx - lo_, where=m,
                              casting="unsafe")
    end = E[n - 1].reshape(S, -1)
    ks = np.argmin(end, axis=1)  # C-order first min == lex min, per s
    sols: list[FreqSolution] = []
    for s in range(S):
        if not ok[s] or not math.isfinite(end[s, ks[s]]):
            sols.append(EMPTY_FREQ_SOLUTION)
            continue
        ub, ul = divmod(int(ks[s]), l + 1)
        stages: list[FreqStage] = []
        j = n - 1
        while j >= 0:
            cidx = int(bounds[j]) + int(pid[j][s, ub, ul])
            i, r_ = int(ii[cidx]), int(rr[s, cidx])
            vt = BIG if vv[cidx] == 0 else LITTLE
            stages.append(FreqStage(i, j, r_, vt, float(fv[cidx]),
                                    table.vnames[int(kk[cidx])]))
            db, dl = (r_, 0) if vt == BIG else (0, r_)
            j, ub, ul = i - 1, ub - db, ul - dl
        sols.append(
            FreqSolution(tuple(reversed(stages)),
                         variants=table.variants).merge_replicable(chain))
    return sols


# ------------------------------------------------------- energy-constrained
def min_energy_under_period_freq(
    chain: TaskChain, b: int, l: int, p_max: float,
    power: PowerModel = DEFAULT_DVFS_POWER,
    freq_levels=None,
    candidates: CandidateTable | None = None,
    variants: VariantSpec | None = None,
) -> FreqSolution:
    """Minimum-energy (schedule, per-stage DVFS level, per-stage kernel
    variant) with period <= p_max.

    The exact min-sum DP of :func:`min_energy_under_period` with the
    candidate set widened by the frequency axis: a stage [i, j] on type v
    at level f contributes work w/f (so its minimum replica count is
    ceil((w/f) / p_max)) and is costed with
    ``stage_energy_terms(w/f, r, v, p_max, power, f)`` — the same single
    source of truth the accounting report uses, so the DP's objective and
    the reported energy cannot drift apart. A ``variants`` spec widens it
    once more: every candidate is also priced under each kernel variant's
    per-core-type weight multipliers (w -> w * m_k), so the DP mixes
    implementations per stage exactly like it mixes DVFS levels; without
    a spec (or with a trivial one) the DP is today's 3-axis FreqHeRAD bit
    for bit.

    ``freq_levels`` defaults to ``power.freq_levels`` and may be one
    shared tuple or a per-core-type mapping (``{"big": ..., "little":
    ...}``) — each type's candidates are drawn from its own ladder.
    Passing ``(1.0,)`` reproduces the nominal energad DP exactly
    (identical candidate enumeration order and tie-breaking). Ties break
    on (energy, big cores used, little cores used), then lowest
    frequency. Returns EMPTY_FREQ_SOLUTION when no assignment meets the
    bound — including ``p_max=inf``, where idle energy against the beat
    diverges.

    Vectorized over the (b+1, l+1) budget plane; bit-identical results to
    :func:`min_energy_under_period_freq_reference` (the retained scalar
    oracle). ``candidates`` short-circuits the per-call precomputation
    with a shared :class:`CandidateTable` (its chain/power/ladders/spec
    take precedence over the ``chain``/``power``/``freq_levels``/
    ``variants`` arguments) — frontier refinement and the governor reuse
    one table across all ``p_max`` queries.
    """
    if b + l <= 0 or not math.isfinite(p_max) or p_max <= 0:
        return EMPTY_FREQ_SOLUTION
    if candidates is None:
        candidates = CandidateTable.build(chain, power, freq_levels,
                                          variants)
    return _min_energy_dp(candidates, b, l, p_max)


def min_energy_under_period_freq_batch(
    chain: TaskChain, b: int, l: int, p_maxes,
    power: PowerModel = DEFAULT_DVFS_POWER,
    freq_levels=None,
    candidates: CandidateTable | None = None,
    variants: VariantSpec | None = None,
) -> list[FreqSolution]:
    """:func:`min_energy_under_period_freq` over a vector of bounds.

    Returns one :class:`~repro_torch.core.dvfs.FreqSolution` per entry of
    ``p_maxes``, bit-identical — schedules, energies, tie-breaking — to
    S independent calls of the scalar entry point, but solved in one
    shared DP volume (:func:`_min_energy_dp_batch`): one batched
    candidate pricing, one candidate enumeration, and plane updates
    masked per bound. Non-finite or non-positive bounds yield
    ``EMPTY_FREQ_SOLUTION`` at their slot, matching the scalar guard.
    This is the refinement kernel of :func:`pareto_frontier` and
    :func:`dvfs_frontier`; the governor's single-bound re-plan queries
    stay on the scalar path.
    """
    if b + l <= 0:
        return [EMPTY_FREQ_SOLUTION] * len(list(p_maxes))
    if candidates is None:
        candidates = CandidateTable.build(chain, power, freq_levels,
                                          variants)
    return _min_energy_dp_batch(candidates, b, l, p_maxes)


def min_energy_under_period_freq_reference(
    chain: TaskChain, b: int, l: int, p_max: float,
    power: PowerModel = DEFAULT_DVFS_POWER,
    freq_levels=None,
    variants: VariantSpec | None = None,
) -> FreqSolution:
    """Scalar-loop oracle for :func:`min_energy_under_period_freq`.

    The original pure-Python DP, kept as the certification reference:
    the vectorized kernel must reproduce its schedules, energies, and
    tie-breaking bit for bit (see tests/test_pareto_equiv). The variant
    axis enumerates per stage and type as an outer loop around the
    ladder — variant registration order first, level ascending within —
    matching the vectorized table's flat candidate axis; without a spec
    the loop body collapses to the pre-variant reference verbatim.
    Prefer the vectorized entry point everywhere else.
    """
    levels = _resolve_levels(power, freq_levels)
    if b + l <= 0 or not math.isfinite(p_max) or p_max <= 0:
        return EMPTY_FREQ_SOLUTION
    vnames = variants.names if variants is not None else (DEFAULT_VARIANT,)
    n = chain.n
    INF = (math.inf, math.inf, math.inf)
    # best[j][ub][ul] = (energy, big used, little used) for tasks [0, j]
    # using exactly ub big and ul little cores; parent[j][ub][ul] is the
    # (stage start, cores, ctype, freq, variant, prev ub, prev ul)
    # reconstruction record.
    best = [[[INF] * (l + 1) for _ in range(b + 1)] for _ in range(n)]
    parent: list[list[list[tuple | None]]] = [
        [[None] * (l + 1) for _ in range(b + 1)] for _ in range(n)]
    for j in range(n):
        # feasible stage candidates [i, j]:
        # (i, r, v, f, k, delta_b, delta_l, cost)
        cands: list[tuple[int, int, str, float, str, int, int, float]] = []
        for i in range(j + 1):
            rep = chain.is_rep(i, j)
            for v in (BIG, LITTLE):
                cap = b if v == BIG else l
                if cap == 0:
                    continue
                for k in vnames:
                    total = (variants.scaled(chain, k)
                             if variants is not None
                             else chain).stage_sum(i, j, v)
                    for f in levels[v]:
                        work = total / f
                        r = cores_for_work(work, p_max)
                        if not rep:
                            if r > 1:  # sequential stage cannot replicate
                                continue
                            r = 1
                        elif r > cap:
                            continue
                        cost = sum(stage_energy_terms(work, r, v, p_max,
                                                      power, f))
                        db, dl = (r, 0) if v == BIG else (0, r)
                        cands.append((i, r, v, f, k, db, dl, cost))
        for i, r, v, f, k, db, dl, cost in cands:
            if i == 0:
                key = (cost, db, dl)
                if key < best[j][db][dl]:
                    best[j][db][dl] = key
                    parent[j][db][dl] = (0, r, v, f, k, 0, 0)
                continue
            prev = best[i - 1]
            for pb in range(b + 1 - db):
                for pl in range(l + 1 - dl):
                    pe = prev[pb][pl][0]
                    if pe == math.inf:
                        continue
                    ub, ul = pb + db, pl + dl
                    key = (pe + cost, ub, ul)
                    if key < best[j][ub][ul]:
                        best[j][ub][ul] = key
                        parent[j][ub][ul] = (i, r, v, f, k, pb, pl)
    # pick the cheapest end state
    end = min(
        ((best[n - 1][ub][ul], ub, ul)
         for ub in range(b + 1) for ul in range(l + 1)),
        key=lambda t: t[0],
    )
    if end[0][0] == math.inf:
        return EMPTY_FREQ_SOLUTION
    ub, ul = end[1], end[2]
    stages: list[FreqStage] = []
    j = n - 1
    while j >= 0:
        rec = parent[j][ub][ul]
        assert rec is not None
        i, r, v, f, k, pb, pl = rec
        stages.append(FreqStage(i, j, r, v, f, k))
        j, ub, ul = i - 1, pb, pl
    # merging adjacent same-type same-frequency same-variant replicable
    # stages changes neither period nor energy (both terms are additive)
    # but saves runtime stage hops
    return FreqSolution(tuple(reversed(stages)),
                        variants=variants).merge_replicable(chain)


def min_energy_under_period(
    chain: TaskChain, b: int, l: int, p_max: float,
    power: PowerModel = DEFAULT_POWER,
    candidates: CandidateTable | None = None,
) -> Solution:
    """Minimum-energy schedule with period <= ``p_max`` (exact DP).

    Energy is evaluated at the operating period ``p_max`` (the pipeline is
    fed one frame every P_max, so allocated cores idle against that beat).
    Ties break on (big cores used, total cores used), mirroring Algo. 6's
    little-core preference. Returns EMPTY_SOLUTION when no schedule meets
    the bound within the budgets — including ``p_max=inf``, where idle
    energy against the beat diverges (pick a finite bound instead).

    This is the nominal-frequency specialization of
    :func:`min_energy_under_period_freq` (``freq_levels=(1.0,)``); both
    run the identical (vectorized) DP, so a single-level FreqHeRAD
    reproduces these solutions stage for stage. ``candidates`` shares a
    nominal-ladder :class:`CandidateTable` across queries.
    """
    fsol = min_energy_under_period_freq(chain, b, l, p_max, power,
                                        freq_levels=(1.0,),
                                        candidates=candidates)
    if fsol.is_empty():
        return EMPTY_SOLUTION
    return fsol.to_solution()


def min_energy_under_period_reference(
    chain: TaskChain, b: int, l: int, p_max: float,
    power: PowerModel = DEFAULT_POWER,
) -> Solution:
    """Scalar-loop oracle for :func:`min_energy_under_period`."""
    fsol = min_energy_under_period_freq_reference(chain, b, l, p_max, power,
                                                  freq_levels=(1.0,))
    if fsol.is_empty():
        return EMPTY_SOLUTION
    return fsol.to_solution()


def energad(
    chain: TaskChain, b: int, l: int,
    p_max: float | None = None,
    power: PowerModel = DEFAULT_POWER,
) -> Solution:
    """ENERgy-Aware Dynamic programming: min energy under a period bound.

    With ``p_max=None`` the bound defaults to the optimal achievable
    period (HeRAD's optimum), i.e. "cheapest schedule that is still
    throughput-optimal". This is the entry registered in
    ``repro_torch.core.STRATEGIES`` as ``"energad"``. Periods are in the chain's
    time unit (µs for the DVB-S2 tables).
    """
    if b + l <= 0:
        return EMPTY_SOLUTION
    if p_max is None:
        ref = herad(chain, b, l)
        if ref.is_empty():
            return EMPTY_SOLUTION
        p_max = ref.period(chain)
    return min_energy_under_period(chain, b, l, p_max, power)


# --------------------------------------------------------------- FreqHeRAD
def freqherad(
    chain: TaskChain, b: int, l: int,
    power: PowerModel | None = None,
    p_max: float | None = None,
    freq_levels=None,
) -> FreqSolution:
    """DVFS-aware HeRAD: per-stage (core type, replicas, frequency level),
    lexicographically optimizing (period, energy).

    With ``p_max=None`` the bound is the minimum achievable period over
    ALL frequency assignments. Latency is monotone in f, so that optimum
    is attained with every stage at the highest level — i.e. plain HeRAD
    on the 1/f_max-scaled chain (``repro_torch.core.dvfs.scale_chain``), reusing
    the vectorized ``herad_table`` machinery. The min-energy DP with the
    frequency axis (:func:`min_energy_under_period_freq`) then spends any
    per-stage slack on downclocking: a stage whose weight sits below the
    period bound can drop to a lower level (dynamic energy scales f**2 per
    unit work) as long as its replica count still fits the budget.

    ``power`` defaults to :data:`repro_torch.energy.model.DEFAULT_DVFS_POWER`;
    ``freq_levels`` to ``power.freq_levels`` (shared tuple or
    per-core-type mapping). At ``freq_levels=(1.0,)`` this degenerates to
    ``energad`` exactly. Registered in
    ``repro_torch.core.STRATEGIES`` as ``"freqherad"``. Returns a
    :class:`repro_torch.core.dvfs.FreqSolution`; periods in the chain's time
    unit (µs), energies costed in watt x time-unit (µJ).
    """
    if power is None:
        power = DEFAULT_DVFS_POWER
    levels = _resolve_levels(power, freq_levels)
    if b + l <= 0:
        return EMPTY_FREQ_SOLUTION
    if p_max is None:
        fb_max, fl_max = levels[BIG][-1], levels[LITTLE][-1]
        ref = herad(scale_chain(chain, fb_max, fl_max), b, l)
        if ref.is_empty():
            return EMPTY_FREQ_SOLUTION
        # period via the FreqSolution weight formula so the bound and the
        # DP's feasibility checks use consistent arithmetic
        p_max = annotate_frequency(ref, fb_max, fl_max).period(chain)
    return min_energy_under_period_freq(chain, b, l, p_max, power, levels)


# ------------------------------------------------------------- VariantHeRAD
class _MinVariantChain:
    """Chain-like view whose interval sums are the elementwise minimum over
    variant-scaled chains.

    Each stage picks its kernel variant independently, so the minimum
    achievable period over per-stage variant assignments is the min-max DP
    run on ``min_k sum(w * m_k) / f`` interval sums — this object feeds
    exactly those sums to ``herad_tables``, which only reads ``n``,
    ``replicable``, ``is_rep`` and ``stage_sum_matrix`` (the min is not
    additive over tasks, so no real ``TaskChain`` could represent it).
    With a single variant the min over one chain is that chain's own
    matrix, bit for bit.
    """

    def __init__(self, scaled_chains, sums):
        self._base = scaled_chains[0]
        self.n = self._base.n
        self.replicable = self._base.replicable
        self._mats = {v: np.min(sums[v], axis=0) for v in (BIG, LITTLE)}

    def stage_sum_matrix(self, v):
        return self._mats[v]

    def is_rep(self, s, e):
        return self._base.is_rep(s, e)


def variant_herad(
    chain: TaskChain, b: int, l: int,
    power: PowerModel | None = None,
    variants: VariantSpec | None = None,
    p_max: float | None = None,
    freq_levels=None,
) -> FreqSolution:
    """Variant-aware FreqHeRAD: per-stage (core type, replicas, frequency
    level, kernel variant), lexicographically optimizing (period, energy).

    The 4-axis generalization of :func:`freqherad`. With ``p_max=None``
    the bound is the minimum achievable period over ALL frequency AND
    variant assignments: latency is monotone in f (every stage clocks at
    the top level for the bound) and each stage's variant choice is
    independent, so the optimum is plain HeRAD on the elementwise
    ``min_k`` of the variant-scaled interval sums
    (:class:`_MinVariantChain`) — one more stacked-fill reuse of the
    ``herad_table`` machinery. Stages of that reference schedule are
    annotated with their argmin variant (ties to the earliest-registered
    one) and the bound is re-evaluated through the ``FreqStage.weight``
    formula, keeping the bound and the DP's feasibility checks on
    consistent arithmetic, exactly as freqherad does. The 4-axis
    min-energy DP (:func:`min_energy_under_period_freq` with
    ``variants``) then spends per-stage slack on downclocking *or* on a
    cheaper implementation.

    Without a spec (or with a trivial single-variant one) every step
    degenerates to :func:`freqherad`'s bit for bit — the same
    specialization property energad ⊂ freqherad established, certified in
    tests/test_variants.py. Registered in ``repro_torch.core.STRATEGIES`` as
    ``"variant_herad"``.
    """
    if power is None:
        power = DEFAULT_DVFS_POWER
    levels = _resolve_levels(power, freq_levels)
    if b + l <= 0:
        return EMPTY_FREQ_SOLUTION
    if p_max is None:
        fb_max, fl_max = levels[BIG][-1], levels[LITTLE][-1]
        vnames = variants.names if variants is not None \
            else (DEFAULT_VARIANT,)
        scaled = [scale_chain(chain, fb_max, fl_max, variant=k,
                              variants=variants) for k in vnames]
        sums = {v: np.stack([c.stage_sum_matrix(v) for c in scaled])
                for v in (BIG, LITTLE)}
        minchain = _MinVariantChain(scaled, sums)
        table = herad_tables([minchain], b, l)[0]
        # merge AFTER variant annotation: only same-variant neighbours
        # may fuse (FreqSolution.merge_replicable), since a merged stage
        # runs one implementation
        ref = extract_solution(table, minchain, b, l, merge=False)
        if ref.is_empty():
            return EMPTY_FREQ_SOLUTION
        ref_fsol = FreqSolution(tuple(
            FreqStage(st.start, st.end, st.cores, st.ctype,
                      fb_max if st.ctype == BIG else fl_max,
                      vnames[int(np.argmin(
                          sums[st.ctype][:, st.start, st.end]))])
            for st in ref.stages
        ), variants=variants).merge_replicable(chain)
        p_max = ref_fsol.period(chain)
    return min_energy_under_period_freq(chain, b, l, p_max, power, levels,
                                        variants=variants)


# ----------------------------------------------------------- budget sweeps
class _StackedTables:
    """Per-profile HeRAD matrices stacked along a leading axis, in the
    field layout ``plane_merged_stages`` walks (shapes (n, P, b+1, l+1)).

    Matrices fresh out of one ``herad_tables`` call already share stacked
    base arrays — those are adopted directly; anything else is re-stacked.
    """

    __slots__ = ("P", "accb", "accl", "prevb", "prevl", "v", "start")

    def __init__(self, matrices):
        base = getattr(matrices[0], "stacked", None)
        if (base is not None
                and base[0].shape[1] == len(matrices)
                and all(getattr(m, "stacked", None) is base
                        and m.stacked_index == p
                        for p, m in enumerate(matrices))):
            (self.P, self.accb, self.accl, self.prevb, self.prevl,
             self.v, self.start) = base
            return
        for f in self.__slots__:
            setattr(self, f,
                    np.stack([getattr(m, f) for m in matrices], axis=1))


def _plane_point_fields(table, table_chain: TaskChain, chain: TaskChain,
                        f_big, f_little, bw_big, bw_little,
                        power: PowerModel):
    """(feasible, period, energy) arrays for every sub-budget cell.

    Walks the merged stage sequences of all cells in lockstep
    (``plane_merged_stages``) and replays, per cell, exactly the float
    operations ``Solution.period`` / ``energy_report`` would apply to the
    extracted schedule: stage weights from the original chain's interval
    sums, busy/idle terms accumulated in stage order, total = busy + idle.
    ``table_chain`` is the (possibly 1/f-scaled) chain the DP table was
    filled on; weights and works are priced on ``chain`` at the global
    per-type profile (f_big, f_little), matching
    ``FreqSolution.period(chain)`` / ``FreqStage.work(chain)``.
    ``f_big``/``f_little`` and the matching busy watts are floats for one
    table or broadcastable (P, 1, 1) arrays for a profile-stacked one.
    """
    feasible, steps = plane_merged_stages(table, table_chain)
    shape = feasible.shape
    period = np.full(shape, -math.inf)
    busy = np.zeros(shape)
    idle = np.zeros(shape)
    if not steps:
        return feasible, period, busy
    mat = {v: chain.stage_sum_matrix(v) for v in (BIG, LITTLE)}
    repm = chain.rep_matrix()
    iw_b = power.idle_watts(BIG)
    iw_l = power.idle_watts(LITTLE)
    cached = []
    for s, e, r, vb, emit in steps:
        if not emit.any():
            cached.append(None)
            continue
        tot = np.where(vb, mat[BIG][s, e], mat[LITTLE][s, e])
        rsafe = np.maximum(r, 1)
        f_v = np.where(vb, f_big, f_little)
        # chain.weight: total / r for replicable stages, plain total for
        # sequential ones; FreqStage.weight then divides by the level
        w = np.where(repm[s, e], tot / rsafe, tot) / f_v
        period = np.where(emit, np.maximum(period, w), period)
        cached.append((tot / f_v, rsafe, vb, emit))
    for entry in cached:
        if entry is None:
            continue
        work, r, vb, emit = entry
        stage_busy = work * np.where(vb, bw_big, bw_little)
        stage_idle = np.maximum(r * period - work, 0.0) \
            * np.where(vb, iw_b, iw_l)
        busy = np.where(emit, busy + stage_busy, busy)
        idle = np.where(emit, idle + stage_idle, idle)
    return feasible, period, busy + idle


def _sweep_fields(chain: TaskChain, b: int, l: int, power: PowerModel):
    """One nominal table plus per-cell (feasible, period, energy)."""
    table = herad_table(chain, b, l)
    feasible, period, en = _plane_point_fields(
        table, chain, chain, 1.0, 1.0,
        power.busy_watts(BIG, 1.0), power.busy_watts(LITTLE, 1.0), power)
    return table, feasible, period, en


def _survivor_points(feasible, period, en, cell_info):
    """Non-dominated subset straight from sweep field arrays.

    Selects exactly the points ``_non_dominated(sorted full sweep)``
    would — stable (period, energy) sort over generation (C) order, then
    the strictly-monotone scan with the same 1e-12 margin — but
    materializes ``ParetoPoint`` objects only for the survivors, so
    frontier builds skip the per-cell Python object churn of a full
    sweep. ``cell_info(flat_index) -> (budget, extractor)`` resolves a
    surviving cell of the C-ordered ``feasible`` array.
    """
    idx = np.nonzero(feasible.reshape(-1))[0]
    pers = period.reshape(-1)[idx]
    ens = en.reshape(-1)[idx]
    order = np.lexsort((ens, pers))  # stable: ties keep generation order
    out: list[ParetoPoint] = []
    last_e = math.inf
    for p_, e_, fi in zip(pers[order].tolist(), ens[order].tolist(),
                          idx[order].tolist()):
        if out and e_ >= last_e - 1e-12:
            continue
        budget, extract = cell_info(fi)
        out.append(ParetoPoint(p_, e_, budget=budget, extract=extract))
        last_e = e_
    return out


def sweep_budgets(
    chain: TaskChain, b: int, l: int, power: PowerModel,
) -> list[ParetoPoint]:
    """All sub-budget HeRAD optima with their energies, one DP run.

    Returns one point per non-empty sub-budget (b', l') <= (b, l),
    b' + l' >= 1, sorted by (period, energy). Energy is evaluated at each
    schedule's own achieved period. Empty when no cores are budgeted,
    matching energad's EMPTY_SOLUTION convention.

    All points are costed straight from the DP field arrays
    (:func:`_plane_point_fields`); schedules are extracted lazily on
    first ``ParetoPoint.solution`` access. Bit-identical to
    :func:`sweep_budgets_reference`.
    """
    if b < 0 or l < 0 or b + l <= 0:
        return []
    table, feasible, period, en = _sweep_fields(chain, b, l, power)
    points: list[ParetoPoint] = []
    for bb in range(b + 1):
        for ll in range(l + 1):
            if bb + ll == 0 or not feasible[bb, ll]:
                continue

            def ex(bb=bb, ll=ll):
                return extract_solution(table, chain, bb, ll)

            points.append(ParetoPoint(period[bb, ll], en[bb, ll],
                                      budget=(bb, ll), extract=ex))
    points.sort(key=lambda pt: (pt.period, pt.energy))
    return points


def sweep_budgets_reference(
    chain: TaskChain, b: int, l: int, power: PowerModel,
) -> list[ParetoPoint]:
    """Scalar oracle for :func:`sweep_budgets`: one extraction + one
    accounting call per sub-budget cell."""
    if b < 0 or l < 0 or b + l <= 0:
        return []
    table = herad_table(chain, b, l)
    points: list[ParetoPoint] = []
    for bb in range(b + 1):
        for ll in range(l + 1):
            if bb + ll == 0:
                continue
            sol = extract_solution(table, chain, bb, ll)
            if sol.is_empty():
                continue
            p = sol.period(chain)
            points.append(ParetoPoint(p, energy(chain, sol, power), sol,
                                      (bb, ll)))
    points.sort(key=lambda pt: (pt.period, pt.energy))
    return points


def _sweep_fields_freq(chain: TaskChain, b: int, l: int, power: PowerModel,
                       freq_levels=None):
    """Profile-grid tables plus per-(profile, cell) point fields."""
    tables = dvfs_tables(chain, b, l, _resolve_levels(power, freq_levels))
    profiles = list(tables)
    stacked = _StackedTables([tables[p][0] for p in profiles])
    col = np.array(profiles)[:, :, None, None]           # (P, 2, 1, 1)
    bw_b = np.array([power.busy_watts(BIG, fb)
                     for fb, _ in profiles])[:, None, None]
    bw_l = np.array([power.busy_watts(LITTLE, fl)
                     for _, fl in profiles])[:, None, None]
    feasible, period, en = _plane_point_fields(
        stacked, chain, chain, col[:, 0], col[:, 1], bw_b, bw_l, power)
    return tables, profiles, feasible, period, en


def sweep_budgets_freq(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    freq_levels=None,
) -> list[ParetoPoint]:
    """All (sub-budget x frequency-profile) HeRAD optima with energies.

    The frequency axis of the Pareto enumeration: for every global
    per-core-type profile (f_big, f_little) on the level grid — distinct
    profiles only, duplicates in the ladder spec are swept once — one
    vectorized HeRAD table over the 1/f-scaled chain
    (``repro_torch.core.dvfs.dvfs_tables``) yields the period-optimal schedule
    of every sub-budget (b', l') <= (b, l). Each core type draws its
    profile entry from its own ladder when ``freq_levels`` (or the
    model's) is a per-core-type mapping. Points carry lazily-extracted
    :class:`~repro_torch.core.dvfs.FreqSolution` schedules annotated with the
    profile, costed at their own achieved period; sorted by
    (period, energy). Bit-identical to
    :func:`sweep_budgets_freq_reference`.
    """
    if b < 0 or l < 0 or b + l <= 0:
        return []
    tables, profiles, feasible, period, en = _sweep_fields_freq(
        chain, b, l, power, freq_levels)
    points: list[ParetoPoint] = []
    for pi, profile in enumerate(profiles):
        for bb in range(b + 1):
            for ll in range(l + 1):
                if bb + ll == 0 or not feasible[pi, bb, ll]:
                    continue

                def ex(profile=profile, bb=bb, ll=ll):
                    return extract_dvfs_solution(tables, profile, bb, ll)

                points.append(ParetoPoint(period[pi, bb, ll],
                                          en[pi, bb, ll],
                                          budget=(bb, ll), extract=ex))
    points.sort(key=lambda pt: (pt.period, pt.energy))
    return points


def sweep_budgets_freq_reference(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    freq_levels=None,
) -> list[ParetoPoint]:
    """Scalar oracle for :func:`sweep_budgets_freq`."""
    if b < 0 or l < 0 or b + l <= 0:
        return []
    tables = dvfs_tables(chain, b, l, _resolve_levels(power, freq_levels))
    points: list[ParetoPoint] = []
    for profile in tables:
        for bb in range(b + 1):
            for ll in range(l + 1):
                if bb + ll == 0:
                    continue
                fsol = extract_dvfs_solution(tables, profile, bb, ll)
                if fsol.is_empty():
                    continue
                p = fsol.period(chain)
                points.append(
                    ParetoPoint(p, energy(chain, fsol, power), fsol,
                                (bb, ll)))
    points.sort(key=lambda pt: (pt.period, pt.energy))
    return points


def _sweep_fields_variant(chain: TaskChain, b: int, l: int,
                          power: PowerModel, freq_levels=None,
                          variants: VariantSpec | None = None):
    """(variant x profile)-grid tables plus per-cell point fields.

    One stacked ``herad_tables`` fill over all K x P grid cells
    (:func:`repro_torch.core.dvfs.variant_tables`), then one vectorized pricing
    pass per variant — each variant's cells are priced on its own scaled
    chain, replaying the ``FreqStage.weight`` / ``energy_report`` float
    operations of the annotated extraction. Returns the tables, the grid
    keys (in table order, variant-major), the profile list, and the
    concatenated (feasible, period, energy) arrays of shape
    ``(K * P, b + 1, l + 1)`` whose leading axis follows the key order.
    """
    levels = _resolve_levels(power, freq_levels)
    tables = variant_tables(chain, b, l, levels, variants)
    keys = list(tables)
    vnames = variants.names if variants is not None else (DEFAULT_VARIANT,)
    profiles = [(fb, fl) for (k, fb, fl) in keys if k == vnames[0]]
    col = np.array(profiles)[:, :, None, None]           # (P, 2, 1, 1)
    bw_b = np.array([power.busy_watts(BIG, fb)
                     for fb, _ in profiles])[:, None, None]
    bw_l = np.array([power.busy_watts(LITTLE, fl)
                     for _, fl in profiles])[:, None, None]
    feas_parts, per_parts, en_parts = [], [], []
    for k in vnames:
        stacked = _StackedTables([tables[(k, fb, fl)][0]
                                  for fb, fl in profiles])
        chain_k = variants.scaled(chain, k) if variants is not None \
            else chain
        feasible, period, en = _plane_point_fields(
            stacked, chain, chain_k, col[:, 0], col[:, 1], bw_b, bw_l,
            power)
        feas_parts.append(feasible)
        per_parts.append(period)
        en_parts.append(en)
    return (tables, keys, profiles, np.concatenate(feas_parts),
            np.concatenate(per_parts), np.concatenate(en_parts))


def sweep_budgets_variant(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    freq_levels=None,
    variants: VariantSpec | None = None,
) -> list[ParetoPoint]:
    """All (sub-budget x frequency-profile x variant) HeRAD optima.

    The kernel-variant axis of the Pareto enumeration: for every global
    variant k and per-core-type profile (f_big, f_little), the
    period-optimal schedule of every sub-budget (b', l') <= (b, l) —
    all K x P tables filled through ONE stacked DP pass. Points carry
    lazily-extracted variant/frequency-annotated schedules costed at
    their own achieved period; sorted by (period, energy). A global
    variant per point is enough here — the refinement DP of
    :func:`variant_frontier` mixes variants per stage. Bit-identical to
    :func:`sweep_budgets_variant_reference`; with a trivial (or absent)
    spec, numerically identical to :func:`sweep_budgets_freq`.
    """
    if b < 0 or l < 0 or b + l <= 0:
        return []
    tables, keys, _profiles, feasible, period, en = _sweep_fields_variant(
        chain, b, l, power, freq_levels, variants)
    points: list[ParetoPoint] = []
    for gi, key in enumerate(keys):
        for bb in range(b + 1):
            for ll in range(l + 1):
                if bb + ll == 0 or not feasible[gi, bb, ll]:
                    continue

                def ex(key=key, bb=bb, ll=ll):
                    return extract_variant_solution(tables, key, bb, ll,
                                                    variants)

                points.append(ParetoPoint(period[gi, bb, ll],
                                          en[gi, bb, ll],
                                          budget=(bb, ll), extract=ex))
    points.sort(key=lambda pt: (pt.period, pt.energy))
    return points


def sweep_budgets_variant_reference(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    freq_levels=None,
    variants: VariantSpec | None = None,
) -> list[ParetoPoint]:
    """Scalar oracle for :func:`sweep_budgets_variant`: one extraction +
    one accounting call per (grid cell, sub-budget)."""
    if b < 0 or l < 0 or b + l <= 0:
        return []
    tables = variant_tables(chain, b, l,
                            _resolve_levels(power, freq_levels), variants)
    points: list[ParetoPoint] = []
    for key in tables:
        for bb in range(b + 1):
            for ll in range(l + 1):
                if bb + ll == 0:
                    continue
                fsol = extract_variant_solution(tables, key, bb, ll,
                                                variants)
                if fsol.is_empty():
                    continue
                p = fsol.period(chain)
                points.append(
                    ParetoPoint(p, energy(chain, fsol, power), fsol,
                                (bb, ll)))
    points.sort(key=lambda pt: (pt.period, pt.energy))
    return points


# --------------------------------------------------------------- frontiers
def _non_dominated(points: list[ParetoPoint]) -> list[ParetoPoint]:
    """Strictly monotone frontier: period increases, energy decreases."""
    frontier: list[ParetoPoint] = []
    for pt in sorted(points, key=lambda p: (p.period, p.energy)):
        if frontier and pt.energy >= frontier[-1].energy - 1e-12:
            continue  # dominated (equal-or-worse energy at a worse period)
        frontier.append(pt)
    return frontier


def pareto_frontier(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    refine: bool = True,
    candidates: CandidateTable | None = None,
) -> list[ParetoPoint]:
    """The (period, energy) Pareto frontier over all sub-budgets of (b, l).

    With ``refine=True`` each surviving period level is re-optimized with
    the exact min-energy DP (:func:`min_energy_under_period`) — the
    period-optimal schedule at a sub-budget is not necessarily the
    energy-optimal one at its own period, so refinement can only lower the
    curve. All refinement queries share one nominal-ladder
    :class:`CandidateTable` (pass ``candidates`` to reuse a caller-held
    one, e.g. the governor's across re-plans). All schedules run at the
    nominal frequency; see :func:`dvfs_frontier` for the frequency-swept
    frontier.
    """
    if b < 0 or l < 0 or b + l <= 0:
        return []
    table, feasible, period, en = _sweep_fields(chain, b, l, power)

    def cell_info(fi):
        bb, ll = divmod(fi, l + 1)
        return (bb, ll), lambda: extract_solution(table, chain, bb, ll)

    points = _survivor_points(feasible, period, en, cell_info)
    if not refine or not points:
        return points
    if candidates is None:
        candidates = CandidateTable.build(chain, power, (1.0,))
    # all surviving period levels re-optimized by ONE batched DP
    fsols = _min_energy_dp_batch(candidates, b, l,
                                 [pt.period for pt in points])
    refined: list[ParetoPoint] = []
    for pt, fsol in zip(points, fsols):
        if fsol.is_empty():
            refined.append(pt)
            continue
        sol = fsol.to_solution()
        e = energy(chain, sol, power, period=pt.period)
        refined.append(
            ParetoPoint(pt.period, e, sol, sol.core_usage())
            if e < pt.energy else pt)
    return _non_dominated(refined)


def dvfs_frontier(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    freq_levels=None,
    refine: bool = True,
    candidates: CandidateTable | None = None,
) -> list[ParetoPoint]:
    """The (period, energy) frontier with frequency as a third sweep axis.

    Like :func:`pareto_frontier` but enumerating
    (b', l', f_big, f_little) via :func:`sweep_budgets_freq`; with
    ``refine=True`` each surviving period level is re-optimized by the
    exact per-stage-frequency DP (:func:`min_energy_under_period_freq`),
    which can mix levels within one schedule and therefore only lowers
    the curve. All refinement queries share one :class:`CandidateTable`
    instead of re-enumerating the (i, j, type, freq) candidates per
    frontier point. Every point of the nominal frontier is weakly
    dominated by this one; on platforms with real DVFS headroom the
    domination is strict (see examples/dvfs_frontier.py).
    """
    if b < 0 or l < 0 or b + l <= 0:
        return []
    tables, profiles, feasible, period, en = _sweep_fields_freq(
        chain, b, l, power, freq_levels)
    cells = (b + 1) * (l + 1)

    def cell_info(fi):
        pi, rem = divmod(fi, cells)
        bb, ll = divmod(rem, l + 1)
        profile = profiles[pi]
        return ((bb, ll),
                lambda: extract_dvfs_solution(tables, profile, bb, ll))

    points = _survivor_points(feasible, period, en, cell_info)
    if not refine or not points:
        return points
    if candidates is None:
        candidates = CandidateTable.build(chain, power, freq_levels)
    # all surviving period levels re-optimized by ONE batched DP
    fsols = _min_energy_dp_batch(candidates, b, l,
                                 [pt.period for pt in points])
    refined: list[ParetoPoint] = []
    for pt, fsol in zip(points, fsols):
        if fsol.is_empty():
            refined.append(pt)
            continue
        e = energy(chain, fsol, power, period=pt.period)
        refined.append(
            ParetoPoint(pt.period, e, fsol, fsol.core_usage())
            if e < pt.energy else pt)
    return _non_dominated(refined)


def variant_frontier(
    chain: TaskChain, b: int, l: int, power: PowerModel,
    variants: VariantSpec | None = None,
    freq_levels=None,
    refine: bool = True,
    candidates: CandidateTable | None = None,
) -> list[ParetoPoint]:
    """The (period, energy) frontier with kernel variant as a fourth axis.

    Like :func:`dvfs_frontier` but sweeping the full (b', l', f_big,
    f_little, variant) grid (:func:`sweep_budgets_variant` machinery —
    one stacked DP fill); with ``refine=True`` each surviving period
    level is re-optimized by the exact 4-axis DP, which mixes levels AND
    implementations per stage and therefore only lowers the curve. Every
    point of the best *fixed-variant* frontier is weakly dominated by
    this one; when variants trade speed for per-core-type efficiency the
    domination is strict under tight power caps (the planner swaps in
    the slower-but-cooler kernel — see examples/kernel_frontier.py).
    With a trivial (or absent) spec this degenerates to
    :func:`dvfs_frontier` numerically.
    """
    if b < 0 or l < 0 or b + l <= 0:
        return []
    tables, keys, _profiles, feasible, period, en = _sweep_fields_variant(
        chain, b, l, power, freq_levels, variants)
    cells = (b + 1) * (l + 1)

    def cell_info(fi):
        gi, rem = divmod(fi, cells)
        bb, ll = divmod(rem, l + 1)
        key = keys[gi]
        return ((bb, ll),
                lambda: extract_variant_solution(tables, key, bb, ll,
                                                 variants))

    points = _survivor_points(feasible, period, en, cell_info)
    if not refine or not points:
        return points
    if candidates is None:
        candidates = CandidateTable.build(chain, power, freq_levels,
                                          variants)
    # all surviving period levels re-optimized by ONE batched 4-axis DP
    fsols = _min_energy_dp_batch(candidates, b, l,
                                 [pt.period for pt in points])
    refined: list[ParetoPoint] = []
    for pt, fsol in zip(points, fsols):
        if fsol.is_empty():
            refined.append(pt)
            continue
        e = energy(chain, fsol, power, period=pt.period)
        refined.append(
            ParetoPoint(pt.period, e, fsol, fsol.core_usage())
            if e < pt.energy else pt)
    return _non_dominated(refined)


# ---------------------------------------------------------- power-cap query
def min_period_under_power(
    chain: TaskChain, b: int, l: int, power: PowerModel, cap_w: float,
    dvfs: bool = False,
    freq_levels=None,
    frontier: list[ParetoPoint] | None = None,
    variants: VariantSpec | None = None,
) -> ParetoPoint | None:
    """Fastest frontier point whose average power fits under ``cap_w``.

    The dual of :func:`min_energy_under_period` and the re-planning query
    of the runtime governor (``repro_torch.control``): among the (period,
    energy) Pareto frontier of (``chain``, b, l), return the
    minimum-period point with average draw ``energy / period <= cap_w``
    (watts, since energies are watt x time-unit per frame and periods are
    in the same time unit). Average power is strictly decreasing along the
    frontier (energy falls while period rises), so admissibility is
    monotone in the frontier index and the fastest feasible point is
    found by bisection — O(log F) comparisons per query instead of a
    linear scan; the ``cap + 1e-9`` admission epsilon matches the
    governor's cap-trigger epsilon on the other side.

    ``dvfs=True`` queries the frequency-swept frontier
    (:func:`dvfs_frontier`, per-stage levels from ``freq_levels`` /
    ``power.freq_levels``) instead of the nominal one; the returned
    point then carries a :class:`~repro_torch.core.dvfs.FreqSolution`. Passing
    a precomputed ``frontier`` (sorted ascending by period, as the
    frontier functions return it) skips the sweep — the governor caches it
    across control ticks. Returns ``None`` when even the frugalest
    frontier point exceeds the cap (or the frontier is empty); callers
    decide the fallback policy. A ``variants`` spec (implies the DVFS
    grid) queries the 4-axis :func:`variant_frontier` instead.
    """
    if frontier is None:
        if variants is not None:
            frontier = variant_frontier(chain, b, l, power, variants,
                                        freq_levels)
        else:
            frontier = dvfs_frontier(chain, b, l, power, freq_levels) \
                if dvfs else pareto_frontier(chain, b, l, power)

    def admissible(pt: ParetoPoint) -> bool:
        return pt.period > 0 and pt.energy / pt.period <= cap_w + 1e-9

    lo, hi = 0, len(frontier)
    while lo < hi:
        mid = (lo + hi) // 2
        if admissible(frontier[mid]):
            hi = mid
        else:
            lo = mid + 1
    return frontier[lo] if lo < len(frontier) else None


def min_energy_meeting_deadline(
    chain: TaskChain, b: int, l: int, power: PowerModel, cap_w: float,
    period_need: float,
    dvfs: bool = False,
    freq_levels=None,
    frontier: list[ParetoPoint] | None = None,
    variants: VariantSpec | None = None,
) -> ParetoPoint | None:
    """Minimum-energy frontier point with period <= ``period_need`` under
    ``cap_w`` — the deadline-safe serving query (EAPS shape).

    The feasible set {period <= period_need} ∩ {watts <= cap_w} is a
    contiguous frontier segment: periods ascend along the frontier while
    energy and average watts strictly descend, so the cap admits a
    suffix (found by the same bisection as :func:`min_period_under_power`)
    and the deadline admits a prefix. The minimum-energy feasible point
    is then the *slowest* point of the intersection — the last one whose
    period still meets the deadline. Returns ``None`` when the segment is
    empty (no configuration both meets the deadline and fits the cap);
    callers fall back to max-performance, exactly the EAPS recipe: run
    the cheapest feasible (freq, replicas), or flat-out when nothing is.

    Admission epsilons match the governor's on both axes
    (``cap + 1e-9`` watts, ``period_need * (1 + 1e-9)`` time units).
    """
    if frontier is None:
        if variants is not None:
            frontier = variant_frontier(chain, b, l, power, variants,
                                        freq_levels)
        else:
            frontier = dvfs_frontier(chain, b, l, power, freq_levels) \
                if dvfs else pareto_frontier(chain, b, l, power)
    if not frontier:
        return None

    def admissible(pt: ParetoPoint) -> bool:
        return pt.period > 0 and pt.energy / pt.period <= cap_w + 1e-9

    lo, hi = 0, len(frontier)
    while lo < hi:           # first index admitted by the cap
        mid = (lo + hi) // 2
        if admissible(frontier[mid]):
            hi = mid
        else:
            lo = mid + 1
    cap_lo = lo
    limit = period_need * (1 + 1e-9)
    lo, hi = 0, len(frontier)
    while lo < hi:           # first index whose period exceeds the deadline
        mid = (lo + hi) // 2
        if frontier[mid].period <= limit:
            lo = mid + 1
        else:
            hi = mid
    deadline_hi = lo - 1     # last index meeting the deadline
    if cap_lo > deadline_hi:
        return None
    return frontier[deadline_hi]
