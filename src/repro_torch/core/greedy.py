"""Greedy scheduling strategies: FERTAC, 2CATAC and the OTAC baselines.

Faithful implementations of Algorithms 1-6 of the paper:
  - Schedule            (Algo. 1) — binary search over the target period;
  - ComputeStage        (Algo. 2) — greedy stage packing, common method;
  - support methods     (Algo. 3) — in repro_torch.core.chain;
  - FERTAC              (Algo. 4) — little-cores-first stage building;
  - 2CATAC              (Algo. 5) — both core types tried per stage;
  - ChooseBestSolution  (Algo. 6) — energy-aware tie-breaking.

OTAC (the homogeneous-resources optimal strategy the heuristics are built on)
is obtained by restricting the resources to a single type.
"""
from __future__ import annotations

import math
from typing import Callable

from .chain import (
    BIG,
    LITTLE,
    EMPTY_SOLUTION,
    Solution,
    Stage,
    TaskChain,
    max_packing,
    required_cores,
)

ComputeSolutionFn = Callable[[TaskChain, int, int, int, float], Solution]


# ------------------------------------------------------------------ Algo. 2
def compute_stage(
    chain: TaskChain, s: int, c: int, v: str, period: float
) -> tuple[int, int]:
    """ComputeStage (Algo. 2): where to end a stage starting at ``s`` and how
    many cores of type ``v`` (at most ``c``) it needs to respect ``period``.

    Returns (e, u): inclusive end index and cores used.
    """
    n = chain.n
    e = max_packing(chain, s, 1, v, period)  # pack with a single core
    u = required_cores(chain, s, e, v, period)
    if e != n - 1 and chain.is_rep(s, e):
        e = chain.final_rep_task(s, e)  # extend over all following replicable
        u = required_cores(chain, s, e, v, period)
        if u > c:  # not enough cores for the long stage: shrink to c cores
            e = max_packing(chain, s, c, v, period)
            u = c
        elif e != n - 1 and u > 1:
            # A sequential task follows. Check if trimming this stage to use
            # one fewer core still lets the trimmed tail + next task fit on a
            # single core — if so, saving the core is always at least as good.
            # (The u > 1 guard avoids the degenerate 0-core packing, and the
            # trimmed stage must itself respect the period: MaxPacking's
            # at-least-one-task convention can otherwise return a stage that
            # does not fit on u-1 cores. The paper's pseudo-code implicitly
            # assumes both.)
            f = max_packing(chain, s, u - 1, v, period)
            if (
                f + 1 <= e
                and chain.weight(s, f, u - 1, v) <= period
                and required_cores(chain, f + 1, e + 1, v, period) == 1
            ):
                e, u = f, u - 1
    return e, u


# ------------------------------------------------------------------ Algo. 4
def fertac_compute_solution(
    chain: TaskChain, s: int, b: int, l: int, period: float
) -> Solution:
    """FERTAC's ComputeSolution: little cores first, big only when needed."""
    n = chain.n
    e, u = compute_stage(chain, s, l, LITTLE, period)
    v = LITTLE
    if not _stage_valid(chain, s, e, u, v, b, l, period):
        e, u = compute_stage(chain, s, b, BIG, period)
        v = BIG
        if not _stage_valid(chain, s, e, u, v, b, l, period):
            return EMPTY_SOLUTION
    stage = Stage(s, e, u, v)
    if e == n - 1:
        return Solution((stage,))
    nb = b - u if v == BIG else b
    nl = l - u if v == LITTLE else l
    rest = fertac_compute_solution(chain, e + 1, nb, nl, period)
    if rest.is_valid(chain, nb, nl, period):
        return Solution((stage,) + rest.stages)
    return EMPTY_SOLUTION


# ------------------------------------------------------------- Algos. 5 + 6
def twocatac_compute_solution(
    chain: TaskChain, s: int, b: int, l: int, period: float,
    _memo: dict | None = None,
) -> Solution:
    """2CATAC's ComputeSolution: build the stage with BOTH core types, recurse
    on each, and keep the best per ChooseBestSolution (Algo. 6).

    ``_memo``: optional (s, b, l) -> Solution memo table. The paper's 2CATAC
    is the un-memoized exponential recursion; passing a dict makes it a
    polynomial-size DP over reachable states with identical results (same
    comparison order) — used as a beyond-paper optimization (see
    EXPERIMENTS.md §Perf-algorithms).
    """
    if _memo is not None:
        key = (s, b, l)
        hit = _memo.get(key)
        if hit is not None:
            return hit
    n = chain.n
    candidates: dict[str, Solution] = {}
    for v in (BIG, LITTLE):
        r = b if v == BIG else l
        e, u = compute_stage(chain, s, r, v, period)
        if not _stage_valid(chain, s, e, u, v, b, l, period):
            candidates[v] = EMPTY_SOLUTION
            continue
        stage = Stage(s, e, u, v)
        if e == n - 1:
            candidates[v] = Solution((stage,))
            continue
        nb = b - u if v == BIG else b
        nl = l - u if v == LITTLE else l
        rest = twocatac_compute_solution(chain, e + 1, nb, nl, period, _memo)
        if rest.is_valid(chain, nb, nl, period):
            candidates[v] = Solution((stage,) + rest.stages)
        else:
            candidates[v] = EMPTY_SOLUTION
    best = choose_best_solution(
        chain, candidates[BIG], candidates[LITTLE], b, l, period
    )
    if _memo is not None:
        _memo[key] = best
    return best


def choose_best_solution(
    chain: TaskChain, s_big: Solution, s_little: Solution,
    b: int, l: int, period: float,
) -> Solution:
    """ChooseBestSolution (Algo. 6)."""
    big_ok = s_big.is_valid(chain, b, l, period)
    little_ok = s_little.is_valid(chain, b, l, period)
    if big_ok and little_ok:
        bb, bl = s_big.core_usage()
        lb, ll = s_little.core_usage()
        if bl > ll and bb < lb:
            return s_big        # S_B better exchanges big cores for little
        if bl < ll and bb > lb:
            return s_little     # S_L better exchanges big cores for little
        if bb + bl < lb + ll:
            return s_big        # S_B uses fewer cores
        return s_little         # S_L uses fewer (or equal) cores
    if big_ok:
        return s_big
    if little_ok:
        return s_little
    return EMPTY_SOLUTION


# ------------------------------------------------------------------ Algo. 1
def schedule(
    chain: TaskChain,
    b: int,
    l: int,
    compute_solution: ComputeSolutionFn,
    eps_scale: float = 1.0,
) -> Solution:
    """Schedule (Algo. 1): binary search over the target period.

    ``eps_scale`` scales the paper's epsilon = 1/(b+l); values < 1 tighten the
    search for sub-integer weight precision (the real-world tables use 0.1 µs
    precision).
    """
    if b + l <= 0:
        return EMPTY_SOLUTION
    seq = chain.seq_indices()
    p_min = chain.total(BIG) / (b + l)
    if len(seq):
        p_min = max(p_min, float(chain.w[BIG][seq].max()))
    p_max = p_min + max(chain.max_weight(BIG), chain.max_weight(LITTLE))
    eps = eps_scale / (b + l)
    best = EMPTY_SOLUTION
    while p_max - p_min >= eps:
        p_mid = (p_max + p_min) / 2
        sol = compute_solution(chain, 0, b, l, p_mid)
        if sol.is_valid(chain, b, l, p_mid):
            best = sol
            p_max = sol.period(chain)
        else:
            p_min = p_mid
    if best.is_empty():
        # Safety net beyond the paper's bounds: a single stage on one core of
        # the fastest available type is always feasible; retry with that as
        # the upper bound if the paper's P_max was not achievable.
        ub = min(
            chain.total(BIG) if b > 0 else math.inf,
            chain.total(LITTLE) if l > 0 else math.inf,
        )
        if math.isfinite(ub) and ub > p_max:
            sol = compute_solution(chain, 0, b, l, ub)
            if sol.is_valid(chain, b, l, ub):
                best = sol
                p_max, p_min = sol.period(chain), p_min
                while p_max - p_min >= eps:
                    p_mid = (p_max + p_min) / 2
                    sol = compute_solution(chain, 0, b, l, p_mid)
                    if sol.is_valid(chain, b, l, p_mid):
                        best = sol
                        p_max = sol.period(chain)
                    else:
                        p_min = p_mid
    return best


# ------------------------------------------------------------- entry points
def fertac(chain: TaskChain, b: int, l: int, eps_scale: float = 1.0) -> Solution:
    """FERTAC: First Efficient Resources for TAsk Chains (Algos. 1 + 4).

    Greedy heuristic: packs stages little-cores-first inside the binary
    search over the period, O(n log(n * w_max) ) per probe. ``b``/``l``
    are the big/little core budgets; periods are in the chain's time unit
    (µs for the DVB-S2 tables). Near-optimal in the paper's simulations
    (< 1.6% mean slowdown vs HeRAD); may return EMPTY_SOLUTION when its
    greedy packing finds no feasible split even though one exists.
    """
    return schedule(chain, b, l, fertac_compute_solution, eps_scale)


def twocatac(
    chain: TaskChain, b: int, l: int, eps_scale: float = 1.0,
    memoize: bool = False,
) -> Solution:
    """2CATAC: Two-Choice Allocation for TAsk Chains (Algos. 1 + 5 + 6).

    Greedy heuristic trying BOTH core types per stage and keeping the
    better suffix per ChooseBestSolution. ``b``/``l`` are the big/little
    core budgets; periods are in the chain's time unit (µs for the DVB-S2
    tables). ``memoize=False`` is the paper's exponential recursion;
    ``memoize=True`` is the result-identical DP variant (beyond-paper
    speedup — see EXPERIMENTS.md §Perf-algorithms).
    """

    def cs(c: TaskChain, s: int, bb: int, ll: int, p: float) -> Solution:
        return twocatac_compute_solution(c, s, bb, ll, p, {} if memoize else None)

    return schedule(chain, b, l, cs, eps_scale)


def otac(chain: TaskChain, p: int, ctype: str, eps_scale: float = 1.0) -> Solution:
    """OTAC restricted-homogeneous baseline: all ``p`` cores of one type.

    ``ctype`` is ``BIG`` ("B") or ``LITTLE`` ("L"); periods are in the
    chain's time unit (µs for the DVB-S2 tables). Schedules through the
    same binary search + greedy packing machinery with the other resource
    count at 0 (FERTAC's ComputeSolution degenerates to OTAC's greedy
    packing on a single type).
    """
    if ctype == BIG:
        return schedule(chain, p, 0, fertac_compute_solution, eps_scale)
    return schedule(chain, 0, p, fertac_compute_solution, eps_scale)


# -------------------------------------------------------------------- local
def _stage_valid(
    chain: TaskChain, s: int, e: int, u: int, v: str,
    b: int, l: int, period: float,
) -> bool:
    """IsValid (Algo. 3) specialized for a single candidate stage."""
    if u < 1:
        return False
    if chain.weight(s, e, u, v) > period:
        return False
    if v == BIG:
        return u <= b
    return u <= l
