"""Task-chain model for partially-replicable chains on two resource types.

Implements the formulation of Section III of the paper:
  - a linear chain of n tasks, each with a per-core-type weight (latency)
    ``w_i^v`` for v in {BIG, LITTLE};
  - a partition into replicable (stateless) and sequential (stateful) tasks;
  - stage weight  w(s, r, v)  (Eq. 1);
  - period        P(s, r, v)  (Eq. 2);
  - resource validity          (Eq. 3).

All interval arithmetic is backed by prefix sums so that every algorithm
(greedy heuristics, the HeRAD dynamic program, and the brute-force oracle)
computes stage weights with *identical* floating-point operations — this makes
the exact tie-breaking comparisons of Algo. 10 deterministic and consistent
across implementations.

Indices are 0-based internally; intervals [s, e] are inclusive.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

# Core types (the paper's v ∈ {B, L}).
BIG = "B"
LITTLE = "L"
CORE_TYPES = (BIG, LITTLE)

_CEIL_EPS = 1e-9  # guards ceil() against float round-off on exact divisions


class TaskChain:
    """A partially-replicable task chain on two types of resources."""

    def __init__(
        self,
        w_big: Sequence[float],
        w_little: Sequence[float],
        replicable: Sequence[bool],
        names: Sequence[str] | None = None,
    ):
        self.w = {
            BIG: np.asarray(w_big, dtype=np.float64),
            LITTLE: np.asarray(w_little, dtype=np.float64),
        }
        self.replicable = np.asarray(replicable, dtype=bool)
        self.n = int(self.w[BIG].shape[0])
        if self.w[LITTLE].shape[0] != self.n or self.replicable.shape[0] != self.n:
            raise ValueError("w_big, w_little and replicable must have equal length")
        if self.n == 0:
            raise ValueError("empty task chain")
        if (self.w[BIG] <= 0).any() or (self.w[LITTLE] <= 0).any():
            raise ValueError("task weights must be positive")
        self.names = tuple(names) if names is not None else tuple(
            f"t{i}" for i in range(self.n)
        )
        # Prefix sums: pre[v][i] = sum of w^v over tasks [0, i).
        self._pre = {
            v: np.concatenate([[0.0], np.cumsum(self.w[v])]) for v in CORE_TYPES
        }
        # seq_count[i] = number of sequential tasks in [0, i).
        self._seq_count = np.concatenate(
            [[0], np.cumsum(~self.replicable)]
        ).astype(np.int64)
        # next_seq[i] = smallest j >= i with task j sequential, else n.
        nxt = np.full(self.n + 1, self.n, dtype=np.int64)
        for i in range(self.n - 1, -1, -1):
            nxt[i] = i if not self.replicable[i] else nxt[i + 1]
        self._next_seq = nxt

    # ---------------------------------------------------------------- basics
    def stage_sum(self, s: int, e: int, v: str) -> float:
        """Sum of task weights over the inclusive interval [s, e] on type v."""
        return float(self._pre[v][e + 1] - self._pre[v][s])

    def is_rep(self, s: int, e: int) -> bool:
        """IsRep (Algo. 3): True iff [s, e] contains no sequential task."""
        return bool(self._seq_count[e + 1] - self._seq_count[s] == 0)

    def first_seq_at_or_after(self, s: int) -> int:
        """Smallest index >= s holding a sequential task (n if none)."""
        return int(self._next_seq[s])

    def final_rep_task(self, s: int, e: int) -> int:
        """FinalRepTask (Algo. 3): max i >= e such that [s, i] is replicable."""
        if not self.is_rep(s, e):
            raise ValueError("FinalRepTask called on a non-replicable stage")
        return self.first_seq_at_or_after(e) - 1 if self.first_seq_at_or_after(e) > e else e

    def weight(self, s: int, e: int, r: int, v: str) -> float:
        """Stage weight w([τ_s, τ_e], r, v) per Eq. (1)."""
        if r < 1:
            return math.inf
        total = self.stage_sum(s, e, v)
        if self.is_rep(s, e):
            return total / r
        return total

    # --------------------------------------------------- vectorized interval views
    def stage_sum_matrix(self, v: str) -> np.ndarray:
        """All interval sums at once: ``M[s, e] = stage_sum(s, e, v)``.

        An (n, n) float64 array built from the same prefix sums
        :meth:`stage_sum` reads, so ``M[s, e]`` is bit-identical to the
        scalar call for every s <= e (entries with s > e are meaningless).
        This is the input of the energy layer's vectorized candidate
        tables (repro_torch.energy.pareto), which cost every (stage, core type,
        frequency) candidate in one numpy expression instead of O(n^2)
        scalar calls.
        """
        pre = self._pre[v]
        return pre[1:][None, :] - pre[:-1][:, None]

    def rep_matrix(self) -> np.ndarray:
        """All replicability flags at once: ``R[s, e] = is_rep(s, e)``.

        (n, n) bool array from the sequential-task prefix counts backing
        :meth:`is_rep`; entries with s > e are meaningless.
        """
        sc = self._seq_count
        return (sc[1:][None, :] - sc[:-1][:, None]) == 0

    # ------------------------------------------------------------- utilities
    def max_weight(self, v: str) -> float:
        return float(self.w[v].max())

    def total(self, v: str) -> float:
        return float(self._pre[v][self.n])

    def seq_indices(self) -> np.ndarray:
        return np.nonzero(~self.replicable)[0]

    def stateless_ratio(self) -> float:
        return float(self.replicable.mean())

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:
        return (
            f"TaskChain(n={self.n}, SR={self.stateless_ratio():.2f}, "
            f"totalB={self.total(BIG):.1f}, totalL={self.total(LITTLE):.1f})"
        )


@dataclasses.dataclass(frozen=True)
class Stage:
    """One pipeline stage: tasks [start, end] on ``cores`` cores of ``ctype``."""

    start: int
    end: int
    cores: int
    ctype: str

    def n_tasks(self) -> int:
        return self.end - self.start + 1


@dataclasses.dataclass(frozen=True)
class Solution:
    """A pipelined + replicated solution S = (s, r, v)."""

    stages: tuple[Stage, ...]

    # -------------------------------------------------------------- queries
    def is_empty(self) -> bool:
        return len(self.stages) == 0

    def period(self, chain: TaskChain) -> float:
        """P(s, r, v) per Eq. (2)."""
        if self.is_empty():
            return math.inf
        return max(
            chain.weight(st.start, st.end, st.cores, st.ctype) for st in self.stages
        )

    def cores_used(self, ctype: str) -> int:
        return sum(st.cores for st in self.stages if st.ctype == ctype)

    def core_usage(self) -> tuple[int, int]:
        return self.cores_used(BIG), self.cores_used(LITTLE)

    def is_valid(self, chain: TaskChain, b: int, l: int, period: float) -> bool:
        """IsValid (Algo. 3): non-empty, period met, resources respected."""
        if self.is_empty():
            return False
        if self.period(chain) > period:
            return False
        return self.cores_used(BIG) <= b and self.cores_used(LITTLE) <= l

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

    def energy_proxy(self, big_power: float = 1.0, little_power: float = 0.35
                     ) -> float:
        """Relative power draw: the paper's proxy is 'prefer little cores'.

        We expose a parameterized proxy (default big:little = 1:0.35, roughly
        the P-core/E-core draw ratio of contemporary hybrid parts) so that
        deployments can plug real wattage in.
        """
        b_used, l_used = self.core_usage()
        return b_used * big_power + l_used * little_power

    # --------------------------------------------------------- post-passes
    def merge_replicable(self, chain: TaskChain) -> "Solution":
        """Merge consecutive replicable stages using the same core type.

        The paper applies this post-pass after HeRAD ("no impact in the
        minimum period ... leads to solutions with fewer stages"): for two
        consecutive replicable stages on the same type,
        (w1 + w2) / (r1 + r2) <= max(w1/r1, w2/r2).
        """
        if self.is_empty():
            return self
        merged: list[Stage] = [self.stages[0]]
        for st in self.stages[1:]:
            last = merged[-1]
            if (
                st.ctype == last.ctype
                and chain.is_rep(last.start, st.end)
            ):
                merged[-1] = Stage(last.start, st.end, last.cores + st.cores, st.ctype)
            else:
                merged.append(st)
        return Solution(tuple(merged))

    def describe(self, chain: TaskChain) -> str:
        if self.is_empty():
            return "<no solution>"
        parts = [
            f"({st.n_tasks()},{st.cores}{st.ctype})" for st in self.stages
        ]
        b_used, l_used = self.core_usage()
        return (
            f"P={self.period(chain):.4f} stages={len(self.stages)} "
            f"b={b_used} l={l_used} :: " + ",".join(parts)
        )


EMPTY_SOLUTION = Solution(())


def cores_for_work(work: float, period: float) -> int:
    """Minimum cores so that ``work`` replicated over them meets ``period``.

    The scalar core of RequiredCores (Algo. 3): max(1, ceil(work / period))
    with a tiny epsilon guarding against float round-off when the division
    is exact. Exposed separately so DVFS-scaled work (work / f, see
    repro_torch.core.dvfs) is priced with bit-identical arithmetic.
    """
    if period <= 0:
        return 10**9
    q = work / period
    return max(1, int(math.ceil(q - _CEIL_EPS)))


def required_cores(chain: TaskChain, s: int, e: int, v: str, period: float) -> int:
    """RequiredCores (Algo. 3): ceil(w([τ_s, τ_e], 1, v) / P).

    A tiny epsilon guards against float round-off when the division is exact
    (the paper uses integer weights in simulation; the real-world tables use
    0.1 µs-precision floats).
    """
    return cores_for_work(chain.stage_sum(s, e, v), period)


def max_packing(chain: TaskChain, s: int, c: int, v: str, period: float) -> int:
    """MaxPacking (Algo. 3): max(s, max{ i : w([τ_s, τ_i], c, v) <= P }).

    O(log n) via binary search on prefix sums. With c cores, a fully
    replicable prefix weighs sum/c; as soon as a sequential task is included
    the weight snaps back to the plain sum (Eq. 1).
    """
    if c < 1:
        return s  # at-least-one-task convention of Algo. 3 (max with s)
    pre = chain._pre[v]
    base = pre[s]
    fs = chain.first_seq_at_or_after(s)
    best = s - 1
    # Replicable region: indices [s, fs-1], condition sum <= P * c.
    if fs > s:
        hi = int(np.searchsorted(pre, base + period * c + _CEIL_EPS, side="right")) - 1
        i = min(hi - 1, fs - 1)
        if i >= s:
            best = max(best, i)
    # Sequential-containing region: indices [fs, n-1], condition sum <= P.
    if fs < chain.n:
        hi = int(np.searchsorted(pre, base + period + _CEIL_EPS, side="right")) - 1
        i = min(hi - 1, chain.n - 1)
        if i >= fs:
            best = max(best, i)
    return max(s, best)


# ------------------------------------------------------------- constructors
def make_chain(
    rng: np.random.Generator,
    n_tasks: int,
    stateless_ratio: float,
    w_low: int = 1,
    w_high: int = 100,
    slowdown_low: float = 1.0,
    slowdown_high: float = 5.0,
) -> TaskChain:
    """Synthetic chain generator matching the paper's simulation setup.

    Weights uniform integers in [1, 100] for big cores; little-core weight is
    the big weight times a uniform slowdown in [1, 5], rounded with ceil.
    The stateless ratio fixes the exact number of replicable tasks.
    """
    w_big = rng.integers(w_low, w_high + 1, size=n_tasks).astype(np.float64)
    slow = rng.uniform(slowdown_low, slowdown_high, size=n_tasks)
    w_little = np.ceil(w_big * slow)
    n_rep = int(round(stateless_ratio * n_tasks))
    rep = np.zeros(n_tasks, dtype=bool)
    rep[rng.permutation(n_tasks)[:n_rep]] = True
    return TaskChain(w_big, w_little, rep)


def chain_from_rows(rows: Iterable[tuple[str, bool, float, float]]) -> TaskChain:
    """Build a chain from (name, replicable, w_big, w_little) rows."""
    rows = list(rows)
    return TaskChain(
        w_big=[r[2] for r in rows],
        w_little=[r[3] for r in rows],
        replicable=[r[1] for r in rows],
        names=[r[0] for r in rows],
    )
