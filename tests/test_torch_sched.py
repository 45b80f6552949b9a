"""The port's scheduling core (``repro_torch.core``) against ``repro.core``:
every ``STRATEGIES`` entry gives the reference's solution (stages, core
types, replicas and, for the DVFS and variant strategies, frequencies and
variants) and the same period, compared with ``==``; the paper's Table II
periods hold for the port's own HeRAD, FERTAC and 2CATAC; and the port's
HeRAD is period-optimal against the port's brute force."""
import numpy as np
import pytest

from _torch_parity import canon, outcome

from repro.configs import dvbs2 as jdvbs2
from repro.core import STRATEGIES as JSTRATEGIES
from repro.core import brute_force as jbrute
from repro.core import chain_from_rows as jchain_from_rows
from repro.core import make_chain as jmake_chain
from repro_torch.configs import dvbs2
from repro_torch.core import (
    BIG,
    LITTLE,
    STRATEGIES,
    brute_force,
    chain_from_rows,
    fertac,
    herad,
    make_chain,
    twocatac,
)

# (b, l) pools, zeros included: an empty pool must fail (or come back
# empty) the way the reference's does
POOLS = [(0, 0), (0, 2), (2, 0), (1, 1), (3, 2), (2, 3)]
RANDOM = [(n, sr) for n in range(1, 9) for sr in (0.0, 0.5, 1.0)]
DVBS2 = [(p, res) for p in ("mac", "x7") for res in ("half", "full")]


def _chains(n, sr):
    """The same seeded chain built by each package's ``make_chain``."""
    seed = 100 * n + int(10 * sr)
    jc = jmake_chain(np.random.default_rng(seed), n, sr)
    tc = make_chain(np.random.default_rng(seed), n, sr)
    assert canon(tc) == canon(jc)
    return jc, tc


def _same(strategy, jc, tc, b, l):
    want = outcome(JSTRATEGIES[strategy], jc, b, l)
    got = outcome(STRATEGIES[strategy], tc, b, l)
    assert got == want, (strategy, b, l)
    if want[0] != "raised":
        sol = STRATEGIES[strategy](tc, b, l)
        ref = JSTRATEGIES[strategy](jc, b, l)
        if not ref.is_empty():
            assert sol.period(tc) == ref.period(jc)


def test_strategy_table_has_the_reference_names():
    assert list(STRATEGIES) == list(JSTRATEGIES)


@pytest.mark.parametrize("n,sr", RANDOM)
@pytest.mark.parametrize("strategy", list(JSTRATEGIES))
def test_strategy_matches_reference_on_random_chains(strategy, n, sr):
    jc, tc = _chains(n, sr)
    for b, l in POOLS:
        _same(strategy, jc, tc, b, l)


@pytest.mark.parametrize("platform,res", DVBS2)
@pytest.mark.parametrize("strategy", list(JSTRATEGIES))
def test_strategy_matches_reference_on_dvbs2(strategy, platform, res):
    jc, tc = jdvbs2.dvbs2_chain(platform), dvbs2.dvbs2_chain(platform)
    assert canon(tc) == canon(jc)
    b, l = dvbs2.RESOURCES[platform][res]
    _same(strategy, jc, tc, b, l)


@pytest.mark.parametrize("platform,res", DVBS2)
@pytest.mark.parametrize("strategy", ["herad", "fertac", "twocatac"])
def test_table2_periods_hold_for_the_port(strategy, platform, res):
    """Table II's published periods (0.1 µs table rounding, the reference
    test's tolerance) for the port's own strategies."""
    fn = {"herad": herad, "fertac": fertac, "twocatac": twocatac}[strategy]
    ch = dvbs2.dvbs2_chain(platform)
    b, l = dvbs2.RESOURCES[platform][res]
    sol = fn(ch, b, l)
    assert sol.covers(ch)
    assert sol.cores_used(BIG) <= b and sol.cores_used(LITTLE) <= l
    assert sol.period(ch) == pytest.approx(
        dvbs2.TABLE2_PERIODS[(platform, (b, l))][strategy], abs=0.2)


def test_dvbs2_tables_equal_the_reference():
    assert dvbs2.TABLE2_PERIODS == jdvbs2.TABLE2_PERIODS
    assert dvbs2.RESOURCES == jdvbs2.RESOURCES
    assert dvbs2.TOTALS == jdvbs2.TOTALS
    for p in ("mac", "x7"):
        assert canon(dvbs2.platform_power(p)) == canon(
            jdvbs2.platform_power(p))
        assert dvbs2.throughput_mbps(1128.75, p) == \
            jdvbs2.throughput_mbps(1128.75, p)
    rows = [("a", True, 1.0, 2.0), ("b", False, 3.5, 7.0), ("c", True, 2.0, 4.5)]
    assert canon(chain_from_rows(rows)) == canon(jchain_from_rows(rows))


@pytest.mark.parametrize("trial", range(12))
def test_herad_is_optimal_against_brute_force(trial):
    """The port's HeRAD reaches the port's brute-force optimum (n <= 6; the
    reference test's relative tolerance), and the port's brute force equals
    the reference's exactly."""
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(2, 7))
    b, l = int(rng.integers(0, 4)), int(rng.integers(0, 4))
    if b + l == 0:
        l = 1
    sr = float(rng.uniform(0, 1))
    seed = int(rng.integers(1 << 30))
    ch = make_chain(np.random.default_rng(seed), n, sr)
    jch = jmake_chain(np.random.default_rng(seed), n, sr)
    best = brute_force(ch, b, l)
    assert canon(best) == canon(jbrute(jch, b, l))
    sol = herad(ch, b, l)
    assert sol.period(ch) == pytest.approx(best[0], rel=1e-12)
    assert sol.covers(ch)
    assert sol.cores_used(BIG) <= b and sol.cores_used(LITTLE) <= l
