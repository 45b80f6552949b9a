"""HeRAD: Heterogeneous Resource Allocation using Dynamic programming.

Optimal solution (period + little-core preference) per Section V of the paper,
implementing Eq. (4) through Algorithms 7-11:

    P*(j, b, l) = min over stage starts i and core counts u of
                  max(P*(i-1, b-u, l), w([τ_i, τ_j], u, B))   (big cores)
                  max(P*(i-1, b, l-u), w([τ_i, τ_j], u, L))   (little cores)

Two result-equivalent implementations are provided:

- ``herad_reference``: scalar loops following the pseudo-code line by line
  (Algo. 7 main loop, Algo. 8 SingleStageSolution, Algo. 9 RecomputeCell,
  Algo. 10 CompareCells, Algo. 11 ExtractSolution).
- ``herad``: numpy-vectorized over the (big, little) budget plane.

Vectorization note (beyond-paper, see EXPERIMENTS.md §Perf-algorithms): the
CompareCells rule of Algo. 10 — "N on strictly smaller period; on ties, N if it
exchanges big for little or uses fewer-or-equal of both" — is exactly the
lexicographic order on (period, big-cores-used, little-cores-used):

  * if the periods differ, the smaller wins;
  * else if the big usages differ, the smaller-big side wins: when n_b < c_b,
    either c_l < n_l (N trades a big core for little ones → rule 2 → N) or
    c_l >= n_l (N dominates → rule 3 → N); symmetrically C is kept when
    c_b < n_b;
  * else the smaller little usage wins (rule 3 / keep C).

A lexicographic min is total and associative, so (a) the per-cell candidate
scan vectorizes as elementwise selects over the budget plane, and (b) the
neighbour propagation of Algo. 9 lines 2-3 is a 2D running-min (cummin along
each budget axis). Periods are compared exactly; all implementations derive
stage weights from the same prefix sums (repro_torch.core.chain), so float equality
is deterministic.
"""
from __future__ import annotations

import math

import numpy as np

from .chain import BIG, LITTLE, EMPTY_SOLUTION, Solution, Stage, TaskChain

_V_LITTLE = 0  # matches the paper's init S_v <- L
_V_BIG = 1


class _Matrix:
    """Solution matrix S: parallel field arrays over (task, big, little)."""

    def __init__(self, n: int, b: int, l: int):
        shape = (n, b + 1, l + 1)
        self.P = np.full(shape, math.inf, dtype=np.float64)
        self.accb = np.zeros(shape, dtype=np.int64)
        self.accl = np.zeros(shape, dtype=np.int64)
        self.prevb = np.zeros(shape, dtype=np.int64)
        self.prevl = np.zeros(shape, dtype=np.int64)
        self.v = np.full(shape, _V_LITTLE, dtype=np.int8)
        self.start = np.zeros(shape, dtype=np.int64)

    def cell(self, j: int, rb: int, rl: int):
        idx = (j, rb, rl)
        return (
            self.P[idx], self.accb[idx], self.accl[idx],
            self.prevb[idx], self.prevl[idx], self.v[idx], self.start[idx],
        )

    def set_cell(self, j: int, rb: int, rl: int, cell) -> None:
        idx = (j, rb, rl)
        (self.P[idx], self.accb[idx], self.accl[idx],
         self.prevb[idx], self.prevl[idx], self.v[idx], self.start[idx]) = cell


def _compare_cells(c, n):
    """CompareCells (Algo. 10): lexicographic (period, big used, little used).

    Returns the winning cell; on a full key tie the new cell N is returned
    (paper rule 3 with all-equal usage).
    """
    cP, cab, cal = c[0], c[1], c[2]
    nP, nab, nal = n[0], n[1], n[2]
    if (nP < cP
            or (nP == cP and (nab < cab or (nab == cab and nal <= cal)))):
        return n
    return c


# ------------------------------------------------------------------ Algo. 8
def _single_stage_solution(t: int, S: _Matrix, chain: TaskChain,
                           b: int, l: int) -> None:
    """All tasks [0, t] in one stage, for every core budget."""
    rep = chain.is_rep(0, t)
    sum_l = chain.stage_sum(0, t, LITTLE)
    sum_b = chain.stage_sum(0, t, BIG)
    for rl in range(1, l + 1):
        wl = sum_l / rl if rep else sum_l
        S.set_cell(t, 0, rl, (wl, 0, rl if rep else 1, 0, 0, _V_LITTLE, 0))
    for rb in range(1, b + 1):
        wb = sum_b / rb if rep else sum_b
        ub = rb if rep else 1
        for rl in range(0, l + 1):
            if wb < S.P[t, 0, rl]:  # strict <: ties favour little cores
                S.set_cell(t, rb, rl, (wb, ub, 0, 0, 0, _V_BIG, 0))
            else:
                S.set_cell(t, rb, rl, S.cell(t, 0, rl))


# ------------------------------------------------------------------ Algo. 9
def _recompute_cell(j: int, S: _Matrix, chain: TaskChain, b: int, l: int
                    ) -> None:
    """Best P*(j, b, l) over stage starts, core counts and both types."""
    c = S.cell(j, b, l)  # initial value from SingleStageSolution
    if l > 0:
        c = _compare_cells(c, S.cell(j, b, l - 1))
    if b > 0:
        c = _compare_cells(c, S.cell(j, b - 1, l))
    for i in range(j, 0, -1):  # stage [i, j]; prefix [0, i-1]
        rep = chain.is_rep(i, j)
        wsum_b = chain.stage_sum(i, j, BIG)
        wsum_l = chain.stage_sum(i, j, LITTLE)
        # Paper's optimization: a sequential stage gains nothing from extra
        # cores — restrict u to 1.
        for u in range(1, (b if rep else min(1, b)) + 1):
            pP = S.P[i - 1, b - u, l]
            w = wsum_b / u if rep else wsum_b
            nP = pP if pP > w else w
            ab = S.accb[i - 1, b - u, l] + (u if rep else 1)
            al = S.accl[i - 1, b - u, l]
            c = _compare_cells(c, (nP, ab, al, b - u, l, _V_BIG, i))
        for u in range(1, (l if rep else min(1, l)) + 1):
            pP = S.P[i - 1, b, l - u]
            w = wsum_l / u if rep else wsum_l
            nP = pP if pP > w else w
            ab = S.accb[i - 1, b, l - u]
            al = S.accl[i - 1, b, l - u] + (u if rep else 1)
            c = _compare_cells(c, (nP, ab, al, b, l - u, _V_LITTLE, i))
    S.set_cell(j, b, l, c)


# ----------------------------------------------------------------- Algo. 11
def _extract_solution(S: _Matrix, chain: TaskChain, b: int, l: int) -> Solution:
    e, rb, rl = chain.n - 1, b, l
    stages: list[Stage] = []
    guard = 0
    while e >= 0:
        guard += 1
        if guard > chain.n + 1:
            return EMPTY_SOLUTION  # malformed matrix (no valid solution)
        if not math.isfinite(S.P[e, rb, rl]):
            return EMPTY_SOLUTION
        s = int(S.start[e, rb, rl])
        ub = int(S.accb[e, rb, rl])
        ul = int(S.accl[e, rb, rl])
        v = BIG if S.v[e, rb, rl] == _V_BIG else LITTLE
        pb = int(S.prevb[e, rb, rl])
        pl = int(S.prevl[e, rb, rl])
        if s > 0:
            ub -= int(S.accb[s - 1, pb, pl])
            ul -= int(S.accl[s - 1, pb, pl])
        r = ub if v == BIG else ul
        stages.append(Stage(s, e, r, v))
        e, rb, rl = s - 1, pb, pl
    return Solution(tuple(reversed(stages)))


# ------------------------------------------------------------------ Algo. 7
def herad_reference(chain: TaskChain, b: int, l: int,
                    merge: bool = True) -> Solution:
    """Faithful scalar-loop HeRAD (Algos. 7-11).

    ``b``/``l`` are the big/little core budgets (the paper's R_B, R_L);
    the returned Solution's period is in the chain's own time unit (µs
    for the DVB-S2 tables). ``merge`` applies the paper's replicable-stage
    merge post-pass. Returns EMPTY_SOLUTION when no core is budgeted.
    Prefer :func:`herad` (identical optimum, vectorized) outside of
    pseudo-code conformance tests.
    """
    if b + l <= 0 or (b <= 0 and l <= 0):
        return EMPTY_SOLUTION
    n = chain.n
    S = _Matrix(n, b, l)
    _single_stage_solution(0, S, chain, b, l)
    for e in range(1, n):
        _single_stage_solution(e, S, chain, b, l)
        for ub in range(0, b + 1):
            for ul in range(0, l + 1):
                if ub != 0 or ul != 0:
                    _recompute_cell(e, S, chain, ub, ul)
    sol = _extract_solution(S, chain, b, l)
    if merge and not sol.is_empty():
        sol = sol.merge_replicable(chain)
    return sol


# ------------------------------------------------- vectorized implementation
def lex_better(newP, newab, newal, curP, curab, cural):
    """CompareCells (Algo. 10) as an elementwise mask over budget planes.

    True where the new cell wins the lexicographic (period, big used,
    little used) order; <= on the last key matches the paper's "return N"
    on full ties. Exported for reuse: any DP whose tie-breaking is a total
    lexicographic order vectorizes as this select (the energy layer's
    budget-plane kernels in repro_torch.energy.pareto use the same recipe).
    """
    return (newP < curP) | (
        (newP == curP)
        & ((newab < curab) | ((newab == curab) & (newal <= cural)))
    )


def cummin_plane(P, ints, inplace: bool = False):
    """Algo. 9 lines 2-3 over a whole budget plane: running lexicographic
    min along the little axis then the big axis (the order is total and
    associative, so a 2D cummin propagates every neighbour dominance).

    ``P`` is the period plane whose LAST TWO axes are the (big, little)
    budget grid; ``ints`` stacks the integer payload fields along one
    extra LEADING axis (``ints[0]``/``ints[1]`` must be the big/little
    used-core counts — the tie-break keys — followed by any fields that
    ride along, e.g. the parent pointers of ``herad_tables``). Leading
    axes of ``P`` itself (the DVFS profile axis) batch independent
    planes. The scan is a doubling (Hillis-Steele) prefix pass —
    ceil(log2(size)) selects per axis instead of one per index, and the
    whole integer block moves in a single select. The combine prefers
    the lower-index cell on full-key ties, exactly like the sequential
    neighbour walk: selection (not aggregation) over a total order is
    associative and idempotent, so the overlapping doubling windows
    reproduce the sequential result bit for bit. ``inplace=True`` skips
    the defensive copies when the caller owns the arrays.

    Returns ``(P, ints)`` (the same arrays when ``inplace``).
    """
    if not inplace:
        P, ints = P.copy(), ints.copy()
    nd = P.ndim
    for axis in (nd - 1, nd - 2):
        size = P.shape[axis]
        shift = 1
        while shift < size:
            ip = [slice(None)] * nd
            ih = [slice(None)] * nd
            ip[axis] = slice(0, size - shift)
            ih[axis] = slice(shift, size)
            ip, ih = tuple(ip), tuple(ih)
            m = lex_better(P[ip], ints[0][ip], ints[1][ip],
                           P[ih], ints[0][ih], ints[1][ih])
            if m.any():
                P[ih] = np.where(m, P[ip], P[ih])
                iip = (slice(None),) + ip
                iih = (slice(None),) + ih
                ints[iih] = np.where(m, ints[iip], ints[iih])
            elif shift == 1:
                # no neighbour dominated its successor: the axis is already
                # strictly increasing in the total order, so wider shifts
                # (transitive closures of this one) cannot change anything
                break
            shift *= 2
    return P, ints


def herad_tables(chains, b: int, l: int) -> list[_Matrix]:
    """Fill HeRAD solution matrices for several equal-structure chains at
    once (one stacked DP pass).

    ``chains`` must share length and replicable partition but may differ
    in weights — exactly the shape of a DVFS profile grid, where every
    profile is the same chain 1/f-scaled per core type
    (``repro_torch.core.dvfs.dvfs_tables``). All per-candidate plane updates and
    the neighbour cummin run once over a stacked (chain, big, little)
    array instead of once per chain, amortizing the Python/numpy dispatch
    overhead that dominates at practical budget sizes. Results are
    bit-identical to per-chain :func:`herad_table` calls (every operation
    is elementwise along the stacked axis).

    Returns one :class:`_Matrix` view per chain, each usable with
    :func:`extract_solution` for ANY sub-budget (b', l') <= (b, l).
    """
    if b < 0 or l < 0 or b + l <= 0:
        raise ValueError("need at least one core (b + l >= 1)")
    chains = list(chains)
    if not chains:
        return []
    base = chains[0]
    n = base.n
    for ch in chains[1:]:
        if ch.n != n or not np.array_equal(ch.replicable, base.replicable):
            raise ValueError(
                "herad_tables needs chains sharing length and replicable "
                "structure")
    P = len(chains)
    # sums[v][p, i, j] = chains[p].stage_sum(i, j, v)
    sums = {v: np.stack([ch.stage_sum_matrix(v) for ch in chains])
            for v in (BIG, LITTLE)}
    shape = (n, P, b + 1, l + 1)
    SP = np.full(shape, math.inf, dtype=np.float64)
    # the six integer fields (accb, accl, prevb, prevl, v, start) live in
    # one array so selects move them in a single ufunc call
    SI = np.zeros((6,) + shape, dtype=np.int64)
    brange = np.arange(b + 1)
    lrange = np.arange(l + 1)

    def plane(j):
        return (SP[j], SI[0, j], SI[1, j], SI[2, j], SI[3, j], SI[4, j],
                SI[5, j])

    def single_stage_plane(t):
        rep = base.is_rep(0, t)
        sum_l = sums[LITTLE][:, 0, t][:, None]                     # (P, 1)
        sum_b = sums[BIG][:, 0, t][:, None]
        Pp = np.full((P, b + 1, l + 1), math.inf)
        ints = np.zeros((6, P, b + 1, l + 1), dtype=np.int64)
        ab, al, vv = ints[0], ints[1], ints[4]
        if l > 0:
            wl = sum_l / lrange[1:] if rep \
                else np.broadcast_to(sum_l, (P, l))
            Pp[:, 0, 1:] = wl
            al[:, 0, 1:] = lrange[1:] if rep else 1
        if b > 0:
            wb = (sum_b / brange[1:] if rep
                  else np.broadcast_to(sum_b, (P, b)))[:, :, None]
            ub = (brange[1:] if rep
                  else np.ones(b, dtype=np.int64))[None, :, None]
            p0 = Pp[:, 0][:, None, :]
            use_big = wb < p0
            Pp[:, 1:] = np.where(use_big, wb, p0)
            ab[:, 1:] = np.where(use_big, ub, 0)
            al[:, 1:] = np.where(use_big, 0, al[:, 0][:, None, :])
            vv[:, 1:] = np.where(use_big, _V_BIG, _V_LITTLE)
        return Pp, ints

    INT_SENTINEL = np.iinfo(np.int64).max
    # reusable buffers for the u=1 fast path (fixed shapes per axis)
    _bufs = {}

    def _buf(key, shape, dtype):
        buf = _bufs.get(key)
        if buf is None:
            buf = _bufs[key] = np.empty(shape, dtype=dtype)
        return buf

    def single_u_update(cur, prevplane, w, u_delta, vcode, i, big_axis, u):
        """Apply one candidate (fixed core count) as a shifted plane select.

        Inlines :func:`lex_better` with preallocated buffers — this is the
        innermost operation of the table fill (one call per sequential
        stage candidate), so allocation churn dominates without it.
        """
        if big_axis:
            pP = prevplane[0][:, : b + 1 - u]
            nab = np.add(prevplane[1][:, : b + 1 - u], u_delta,
                         out=_buf(("ab", True), pP.shape, np.int64))
            nal = prevplane[2][:, : b + 1 - u]
            sl = (slice(None), slice(u, b + 1))
            npb = (brange[u:] - u)[None, :, None]
            npl = lrange[None, None, :]
        else:
            pP = prevplane[0][:, :, : l + 1 - u]
            nab = prevplane[1][:, :, : l + 1 - u]
            nal = np.add(prevplane[2][:, :, : l + 1 - u], u_delta,
                         out=_buf(("al", False), pP.shape, np.int64))
            sl = (slice(None), slice(None), slice(u, l + 1))
            npb = brange[None, :, None]
            npl = (lrange[u:] - u)[None, None, :]
        nP = np.maximum(pP, w, out=_buf(("P", big_axis), pP.shape,
                                        np.float64))
        cP, cab, cal = cur[0][sl], cur[1][sl], cur[2][sl]
        # lex_better with scratch buffers: m = P< | (P== & (ab< | (ab== & al<=)))
        m = _buf(("m1", big_axis), pP.shape, bool)
        t = _buf(("m2", big_axis), pP.shape, bool)
        np.less_equal(nal, cal, out=m)
        np.equal(nab, cab, out=t)
        np.logical_and(m, t, out=m)
        np.less(nab, cab, out=t)
        np.logical_or(m, t, out=m)
        np.equal(nP, cP, out=t)
        np.logical_and(m, t, out=m)
        np.less(nP, cP, out=t)
        np.logical_or(m, t, out=m)
        if not m.any():
            return
        for dst, src in zip(cur, (nP, nab, nal, npb, npl, vcode, i)):
            np.copyto(dst[sl], src, where=m, casting="unsafe")

    def group_update(cur, prevplane, wsum, cap, vcode, i, big_axis):
        """All core counts u = 1..cap of one (stage, type) candidate group,
        reduced over the u axis before one plane select.

        Lexicographically equivalent to applying u ascending one at a
        time: the reduction keeps, per cell, the (period, big, little)
        minimum with the LARGEST u on full-key ties — exactly the survivor
        of the sequential new-wins-ties applications — and infeasible or
        infinite-period entries never overwrite anything a reader can
        reach (extraction and the plane walk gate on finite periods).
        """
        U = cap
        urange1 = np.arange(1, U + 1)
        axis = 1 if big_axis else 2
        rng = brange if big_axis else lrange
        rows = rng[None, :] - urange1[:, None]                 # (U, size)
        rc = np.clip(rows, 0, rng[-1] if len(rng) else 0)
        srcP = np.take(prevplane[0], rc, axis=axis)
        srcAB = np.take(prevplane[1], rc, axis=axis)
        srcAL = np.take(prevplane[2], rc, axis=axis)
        if not big_axis:  # (P, b+1, U, l+1) -> (P, U, b+1, l+1)
            srcP = srcP.transpose(0, 2, 1, 3)
            srcAB = srcAB.transpose(0, 2, 1, 3)
            srcAL = srcAL.transpose(0, 2, 1, 3)
            valid = (rows >= 0)[None, :, None, :]
            du = urange1[None, :, None, None]
            nab, nal = srcAB, srcAL + du
        else:
            valid = (rows >= 0)[None, :, :, None]
            du = urange1[None, :, None, None]
            nab, nal = srcAB + du, srcAL
        w = (wsum[:, None] / urange1)[:, :, None, None]
        nP = np.where(valid, np.maximum(srcP, w), math.inf)
        # lexicographic min over u, largest u on full ties (the sequential
        # survivor under new-wins-ties)
        bP = nP.min(axis=1)
        t = nP == bP[:, None]
        bAB = np.where(t, nab, INT_SENTINEL).min(axis=1)
        t &= nab == bAB[:, None]
        bAL = np.where(t, nal, INT_SENTINEL).min(axis=1)
        t &= nal == bAL[:, None]
        u_sel = U - np.argmax(t[:, ::-1], axis=1)              # actual u
        m = lex_better(bP, bAB, bAL, cur[0], cur[1], cur[2]) \
            & np.isfinite(bP)
        if not m.any():
            return
        if big_axis:
            npb = brange[None, :, None] - u_sel
            npl = np.broadcast_to(lrange[None, None, :], npb.shape)
        else:
            npl = lrange[None, None, :] - u_sel
            npb = np.broadcast_to(brange[None, :, None], npl.shape)
        for dst, src in zip(cur, (bP, bAB, bAL, npb, npl, vcode, i)):
            np.copyto(dst, src, where=m, casting="unsafe")

    Pp0, ints0 = single_stage_plane(0)
    SP[0] = Pp0
    SI[:, 0] = ints0
    for j in range(1, n):
        Pp, ints = single_stage_plane(j)
        cur = [Pp, ints[0], ints[1], ints[2], ints[3], ints[4], ints[5]]
        for i in range(j, 0, -1):  # candidate stage [i, j]
            rep = base.is_rep(i, j)
            prevplane = plane(i - 1)
            wsum_b = sums[BIG][:, i, j]                        # (P,)
            wsum_l = sums[LITTLE][:, i, j]
            ub_max = b if rep else min(1, b)
            ul_max = l if rep else min(1, l)
            if ub_max == 1:
                w = (wsum_b / 1 if rep else wsum_b)[:, None, None]
                single_u_update(cur, prevplane, w, 1, _V_BIG, i, True, 1)
            elif ub_max > 1:
                group_update(cur, prevplane, wsum_b, ub_max, _V_BIG, i, True)
            if ul_max == 1:
                w = (wsum_l / 1 if rep else wsum_l)[:, None, None]
                single_u_update(cur, prevplane, w, 1, _V_LITTLE, i, False, 1)
            elif ul_max > 1:
                group_update(cur, prevplane, wsum_l, ul_max, _V_LITTLE, i,
                             False)
        cummin_plane(Pp, ints, inplace=True)
        SP[j] = Pp
        SI[:, j] = ints
    out = []
    # the (n, chain, b+1, l+1) base arrays, shared by all views: lets
    # whole-grid consumers (the energy layer's profile sweep) walk all
    # chains at once without re-stacking
    stacked = (SP, SI[0], SI[1], SI[2], SI[3], SI[4], SI[5])
    for p in range(P):
        S = _Matrix.__new__(_Matrix)
        (S.P, S.accb, S.accl, S.prevb, S.prevl, S.v, S.start) = (
            f[:, p] for f in stacked)
        S.stacked = stacked
        S.stacked_index = p
        out.append(S)
    return out


def herad_table(chain: TaskChain, b: int, l: int) -> _Matrix:
    """Fill and return the full HeRAD solution matrix (vectorized).

    The returned matrix holds the period-optimal solution for EVERY
    sub-budget (b', l') <= (b, l) at once — cell (n-1, b', l') is the
    optimum for budgets (b', l'). ``extract_solution`` reads any of them
    out in O(n), which is what the energy subsystem's Pareto sweep
    (repro_torch.energy.pareto) exploits to enumerate the whole budget plane
    from a single DP run.

    For each prefix j the whole (b+1, l+1) budget plane is updated at once:
    stage candidates are shifted slices of the prefix plane, the lexicographic
    CompareCells order is an elementwise select (:func:`lex_better`), and the
    neighbour propagation is a doubling running lexicographic min along each
    budget axis (:func:`cummin_plane`). Several equal-structure chains — e.g.
    a DVFS profile grid — fill faster through one stacked :func:`herad_tables`
    call.
    """
    return herad_tables([chain], b, l)[0]


def extract_solution(S: _Matrix, chain: TaskChain, b: int, l: int,
                     merge: bool = True) -> Solution:
    """Read the optimal solution for sub-budget (b, l) out of a filled table.

    ``S`` must be a matrix returned by :func:`herad_table` for ``chain``
    with budgets >= (b, l); extraction is O(n) per call (Algo. 11 plus
    the ``merge`` post-pass). Returns EMPTY_SOLUTION for an empty budget
    or an infeasible cell.
    """
    if b < 0 or l < 0 or b + l <= 0:
        return EMPTY_SOLUTION
    sol = _extract_solution(S, chain, b, l)
    if merge and not sol.is_empty():
        sol = sol.merge_replicable(chain)
    return sol


def plane_merged_stages(
    S: _Matrix, chain: TaskChain,
) -> tuple[np.ndarray, list[tuple[np.ndarray, ...]]]:
    """Reconstruct the merged stage sequence of EVERY budget cell at once.

    The vectorized counterpart of running Algo. 11 plus
    ``Solution.merge_replicable`` on each sub-budget (b', l') of a filled
    table: instead of O(b*l) Python extractions, a lockstep walk over the
    parent-pointer arrays gathers all cells' stage records simultaneously
    (O(n) vector steps of O(b*l) work). The energy layer's budget sweeps
    (repro_torch.energy.pareto) cost every sub-budget point straight from these
    record arrays and defer real ``Solution`` objects to the Pareto
    survivors.

    Returns ``(feasible, stages)``:

    - ``feasible``: (b+1, l+1) bool — cells holding a finite solution
      (cell (0, 0) and infeasible budgets are False);
    - ``stages``: a list of ``(start, end, cores, vbig, emit)`` tuples of
      (b+1, l+1) arrays. ``emit`` masks the cells that emit a stage in
      that step; per cell, emitted records appear in exactly the stage
      order ``extract_solution(..., merge=True)`` would produce, with
      identical (start, end, cores) fields (``vbig`` is True for big-core
      stages). Fields of non-emitting cells are meaningless.

    ``S`` may also stack several equal-structure tables (field shapes
    (n, ..., b+1, l+1), e.g. the DVFS profile grid of ``herad_tables``
    re-stacked along a leading axis); all returned arrays then carry the
    same leading axes.
    """
    n = S.P.shape[0]
    dims = S.P.shape[1:]  # (..., b+1, l+1)
    B, L = dims[-2], dims[-1]
    feasible = np.isfinite(S.P[n - 1])
    lead = tuple(np.indices(dims)[:-2])  # leading-axis coordinates, if any
    # -------- backward walk: gather raw (unmerged) stages, last stage first
    e = np.full(dims, n - 1, dtype=np.int64)
    rb = np.broadcast_to(
        np.arange(B)[:, None], dims).astype(np.int64)
    rl = np.broadcast_to(np.arange(L), dims).astype(np.int64)
    alive = feasible.copy()
    rev: list[tuple[np.ndarray, ...]] = []
    counts = np.zeros(dims, dtype=np.int64)
    while alive.any() and len(rev) < n:
        ec = np.clip(e, 0, n - 1)
        idx = (ec, *lead, rb, rl)
        s = S.start[idx]
        v = S.v[idx]
        ub = S.accb[idx].copy()
        ul = S.accl[idx].copy()
        pb = S.prevb[idx]
        pl = S.prevl[idx]
        inner = s > 0
        pidx = (np.clip(s - 1, 0, n - 1), *lead, pb, pl)
        ub[inner] -= S.accb[pidx][inner]
        ul[inner] -= S.accl[pidx][inner]
        r = np.where(v == _V_BIG, ub, ul)
        rev.append((s, e.copy(), r, v == _V_BIG, alive.copy()))
        counts[alive] += 1
        e = np.where(alive, s - 1, e)
        rb = np.where(alive, pb, rb)
        rl = np.where(alive, pl, rl)
        alive = alive & (e >= 0)
    feasible = feasible & ~alive  # malformed cells never terminated
    if not rev:
        return feasible, []
    # -------- flip to forward order: stage t of a cell with c stages is the
    # reversed record c-1-t (cells align on t, padding masked out)
    K = len(rev)
    stacked = [np.stack([step[f] for step in rev]) for f in range(5)]
    cells = tuple(np.indices(dims))
    seq = chain._seq_count
    cur_s = np.zeros(dims, dtype=np.int64)
    cur_e = np.zeros(dims, dtype=np.int64)
    cur_r = np.zeros(dims, dtype=np.int64)
    cur_vb = np.zeros(dims, dtype=bool)
    cur_valid = np.zeros(dims, dtype=bool)
    out: list[tuple[np.ndarray, ...]] = []
    for t in range(K):
        k = np.clip(counts - 1 - t, 0, K - 1)
        fs, fe, fr, fvb, _ = (a[(k,) + cells] for a in stacked)
        m = (counts - 1 - t) >= 0
        # merge_replicable's rule: same core type AND [last.start, new.end]
        # still replicable
        rep = (seq[np.clip(fe + 1, 0, n)] - seq[np.clip(cur_s, 0, n)]) == 0
        can = m & cur_valid & (fvb == cur_vb) & rep
        emit = m & cur_valid & ~can
        out.append((cur_s.copy(), cur_e.copy(), cur_r.copy(),
                    cur_vb.copy(), emit))
        cur_e = np.where(m, fe, cur_e)
        cur_s = np.where(m & ~can, fs, cur_s)
        cur_r = np.where(can, cur_r + fr, np.where(m, fr, cur_r))
        cur_vb = np.where(m, fvb, cur_vb)
        cur_valid = cur_valid | m
    out.append((cur_s, cur_e, cur_r, cur_vb, cur_valid & feasible))
    return feasible, out


def herad(chain: TaskChain, b: int, l: int, merge: bool = True) -> Solution:
    """Period-optimal schedule of ``chain`` on ``b`` big + ``l`` little cores.

    Vectorized HeRAD: identical optimum as ``herad_reference``,
    orders-of-magnitude faster (see ``herad_table``). The solution's
    period — Eq. (2), the pipeline's reciprocal throughput — is in the
    chain's time unit (µs for the DVB-S2 tables); secondary tie-breaking
    prefers trading big cores for little ones (CompareCells, Algo. 10).
    """
    if b + l <= 0:
        return EMPTY_SOLUTION
    return extract_solution(herad_table(chain, b, l), chain, b, l, merge=merge)
