"""Brute-force exhaustive oracle for small instances.

Enumerates every interval partition of the chain, every per-stage core type,
and every per-stage core count within the budgets. Used by the test-suite to
certify HeRAD's period optimality (Theorem 1) on small random instances.

The returned key is the lexicographic minimum over (period, big cores used,
little cores used). Note: HeRAD guarantees the *period* component (Theorem 1);
its secondary little-core preference is defined through the CompareCells
partial-solution order, which is not in general the global lexicographic
optimum over core usage — tests therefore assert period equality plus
validity, not stage-list equality.
"""
from __future__ import annotations

import math
from itertools import combinations

from .chain import BIG, LITTLE, EMPTY_SOLUTION, Solution, Stage, TaskChain


def brute_force(chain: TaskChain, b: int, l: int
                ) -> tuple[float, tuple[int, int], Solution]:
    """Returns (best period, (big used, little used), a best solution)."""
    n = chain.n
    best_key = (math.inf, math.inf, math.inf)
    best_sol = EMPTY_SOLUTION

    def alloc(stages: list[tuple[int, int]], si: int, rb: int, rl: int,
              cur_period: float, cur: list[Stage], used: tuple[int, int]):
        nonlocal best_key, best_sol
        if cur_period >= best_key[0] and (cur_period, used[0], used[1]) >= best_key:
            # prune: period already no better and can only grow
            if cur_period > best_key[0]:
                return
        if si == len(stages):
            key = (cur_period, used[0], used[1])
            if key < best_key:
                best_key = key
                best_sol = Solution(tuple(cur))
            return
        s, e = stages[si]
        rep = chain.is_rep(s, e)
        for ctype, budget in ((BIG, rb), (LITTLE, rl)):
            max_u = budget if rep else min(1, budget)
            for u in range(1, max_u + 1):
                w = chain.weight(s, e, u, ctype)
                nb = rb - u if ctype == BIG else rb
                nl = rl - u if ctype == LITTLE else rl
                cur.append(Stage(s, e, u, ctype))
                alloc(stages, si + 1, nb, nl, max(cur_period, w),
                      cur, (used[0] + (u if ctype == BIG else 0),
                            used[1] + (u if ctype == LITTLE else 0)))
                cur.pop()

    # all interval partitions = all subsets of cut positions 1..n-1
    for k in range(n):
        for cuts in combinations(range(1, n), k):
            bounds = [0, *cuts, n]
            stages = [(bounds[i], bounds[i + 1] - 1) for i in range(len(bounds) - 1)]
            alloc(stages, 0, b, l, 0.0, [], (0, 0))
    return best_key[0], (int(best_key[1]), int(best_key[2])), best_sol
