"""The port's energy subsystem (``repro_torch.energy``) against
``repro.energy``: the power-model presets, energy accounting, every
frontier and planner of ``energy/pareto.py`` point for point (period,
energy, budget and schedule, all ``==``), on a seeded grid of random chains
and frequency ladders and on the DVB-S2 tables; and the port's vectorised
planners against the port's own scalar ``*_reference`` oracles."""
import math

import numpy as np
import pytest

from _torch_parity import canon, outcome

import repro.energy as jenergy
from repro.configs import dvbs2 as jdvbs2
from repro.core import herad as jherad
from repro.core import make_chain as jmake_chain
from repro.core.variants import VariantRegistry as JRegistry
import repro_torch.energy as energy_mod
from repro_torch.configs import dvbs2
from repro_torch.core import herad, herad_reference, make_chain
from repro_torch.core.variants import VariantRegistry

LADDERS = [
    (1.0,),
    (0.6, 1.0),
    (0.5, 0.75, 1.0),
    {"big": (0.6, 0.8, 1.0), "little": (0.75, 1.0)},
]


def _grid():
    """(seed, n, stateless ratio, b, l, ladder index, variant count)."""
    rng = np.random.default_rng(4242)
    cases = []
    for i in range(16):
        cases.append((i, int(rng.integers(1, 7)),
                      float(rng.choice([0.0, 0.5, 1.0])),
                      int(rng.integers(0, 4)), int(rng.integers(0, 4)),
                      i % len(LADDERS), i % 3))
    return cases


CASES = _grid() + [("mac", 23, None, 8, 2, 0, 1), ("x7", 23, None, 3, 4, 2, 1)]


class _Side:
    """One package's view of a case: chain, power model, variant spec and
    the energy module."""

    def __init__(self, case, ref: bool):
        seed, n, sr, b, l, ladder, k = case
        self.mod = jenergy if ref else energy_mod
        make = jmake_chain if ref else make_chain
        cfg = jdvbs2 if ref else dvbs2
        if isinstance(seed, str):
            self.chain = cfg.dvbs2_chain(seed)
            base = cfg.platform_power(seed)
        else:
            self.chain = make(np.random.default_rng(seed), n, sr)
            base = self.mod.DEFAULT_POWER
        self.power = self.mod.PowerModel("equiv", base.big, base.little,
                                         freq_levels=LADDERS[ladder])
        reg = (JRegistry if ref else VariantRegistry)()
        vrng = np.random.default_rng(7000 + n + 31 * k)
        for ki in range(k):
            for task in self.chain.names:
                reg.register(task, f"v{ki}",
                             big=float(vrng.uniform(0.6, 1.5)),
                             little=float(vrng.uniform(0.6, 1.5)))
        self.spec = reg.spec_for(self.chain)
        self.b, self.l = b, l
        self.herad = (jherad if ref else herad)(self.chain, b, l) \
            if b + l else None


def _sides(case):
    ref, port = _Side(case, True), _Side(case, False)
    assert canon(port.chain) == canon(ref.chain)
    assert canon(port.power) == canon(ref.power)
    assert canon(port.spec) == canon(ref.spec)
    return ref, port


def _both(ref, port, name, *args, **kw):
    """Call ``name`` on each side (arguments are functions of the side)
    and require equal outcomes."""
    want = outcome(getattr(ref.mod, name), *(a(ref) for a in args),
                   **{k: v(ref) for k, v in kw.items()})
    got = outcome(getattr(port.mod, name), *(a(port) for a in args),
                  **{k: v(port) for k, v in kw.items()})
    assert got == want, name
    return got


CH, B, L = (lambda s: s.chain), (lambda s: s.b), (lambda s: s.l)
PW, SPEC = (lambda s: s.power), (lambda s: s.spec)


def _const(v):
    return lambda s: v


def _p_maxes(side):
    out = [math.inf, 0.0, 75.0]
    if side.herad is not None and not side.herad.is_empty():
        p = side.herad.period(side.chain)
        out += [p, 0.5 * p, 1.5 * p, 4.0 * p]
    return out


def test_power_presets_equal_the_reference():
    for name in ("DEFAULT_POWER", "DEFAULT_DVFS_POWER", "POWER_AMD_RYZEN_AI9",
                 "POWER_APPLE_M1_ULTRA", "POWER_ARM_BIG_LITTLE",
                 "POWER_INTEL_ULTRA9_185H", "PLATFORM_POWER"):
        assert canon(getattr(energy_mod, name)) == canon(
            getattr(jenergy, name)), name
    for spec in ((1.0,), (0.5, 1.0, 0.75), {"big": (1.0, 0.6), "L": (1.0,)}):
        assert canon(energy_mod.normalize_freq_levels(spec)) == canon(
            jenergy.normalize_freq_levels(spec))
    assert dvbs2.POWER.keys() == jdvbs2.POWER.keys()
    for p in dvbs2.POWER:
        assert canon(dvbs2.POWER[p]) == canon(jdvbs2.POWER[p])


@pytest.mark.parametrize("case", CASES, ids=str)
def test_frontiers_match_reference(case):
    ref, port = _sides(case)
    _both(ref, port, "pareto_frontier", CH, B, L, PW)
    _both(ref, port, "pareto_frontier", CH, B, L, PW, refine=_const(False))
    _both(ref, port, "dvfs_frontier", CH, B, L, PW)
    _both(ref, port, "variant_frontier", CH, B, L, PW, variants=SPEC)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_budget_sweeps_match_reference(case):
    ref, port = _sides(case)
    for name in ("sweep_budgets", "sweep_budgets_reference",
                 "sweep_budgets_freq", "sweep_budgets_freq_reference"):
        _both(ref, port, name, CH, B, L, PW)
    for name in ("sweep_budgets_variant", "sweep_budgets_variant_reference"):
        _both(ref, port, name, CH, B, L, PW, variants=SPEC)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_planners_match_reference(case):
    ref, port = _sides(case)
    for p_max in _p_maxes(ref):
        pm = _const(p_max)
        for name in ("min_energy_under_period",
                     "min_energy_under_period_reference",
                     "min_energy_under_period_freq",
                     "min_energy_under_period_freq_reference"):
            _both(ref, port, name, CH, B, L, pm, PW)
        _both(ref, port, "min_energy_under_period_freq", CH, B, L, pm, PW,
              variants=SPEC)
        if p_max > 0 and math.isfinite(p_max):
            _both(ref, port, "energad", CH, B, L, p_max=pm, power=PW)
            _both(ref, port, "freqherad", CH, B, L, power=PW, p_max=pm)
            _both(ref, port, "variant_herad", CH, B, L, power=PW,
                  variants=SPEC, p_max=pm)
    _both(ref, port, "min_energy_under_period_freq_batch", CH, B, L,
          _const(_p_maxes(ref)), PW)
    _both(ref, port, "energad", CH, B, L)
    _both(ref, port, "freqherad", CH, B, L, power=PW)
    _both(ref, port, "variant_herad", CH, B, L, power=PW, variants=SPEC)
    front = ref.mod.dvfs_frontier(ref.chain, ref.b, ref.l, ref.power)
    watts = sorted({pt.energy / pt.period for pt in front if pt.period > 0})
    caps = [w * f for w in watts[:3] for f in (0.999, 1.0, 1.001)] + [1e9,
                                                                     1e-6]
    periods = sorted({pt.period for pt in front})[:3]
    needs = [p * f for p in periods for f in (0.999, 1.0, 2.0)] + [math.inf]
    _both(ref, port, "min_period_under_power", CH, B, L, PW, _const(caps[0]),
          dvfs=_const(True), variants=SPEC)
    for dvfs in (False, True):
        # each side's own frontier, built once, then queried on the grid
        build = "dvfs_frontier" if dvfs else "pareto_frontier"
        fronts = {s: getattr(s.mod, build)(s.chain, s.b, s.l, s.power)
                  for s in (ref, port)}
        assert canon(fronts[port]) == canon(fronts[ref])
        _both(ref, port, "min_period_under_power", CH, B, L, PW,
              _const(caps[0]), dvfs=_const(dvfs))
        _both(ref, port, "min_energy_meeting_deadline", CH, B, L, PW,
              _const(caps[0]), _const(needs[0]), dvfs=_const(dvfs))
        for cap in caps:
            _both(ref, port, "min_period_under_power", CH, B, L, PW,
                  _const(cap), frontier=fronts.get)
            for need in needs:
                _both(ref, port, "min_energy_meeting_deadline", CH, B, L,
                      PW, _const(cap), _const(need), frontier=fronts.get)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_energy_accounting_matches_reference(case):
    ref, port = _sides(case)
    if ref.herad is None:
        return
    sols = {s: [s.herad, s.mod.freqherad(s.chain, s.b, s.l, s.power),
                s.mod.variant_herad(s.chain, s.b, s.l, s.power,
                                    variants=s.spec)]
            for s in (ref, port)}
    for i in range(3):
        sol = (lambda s, i=i: sols[s][i])
        for period in (None, 1.5 * ref.herad.period(ref.chain)):
            kw = {} if period is None else {"period": _const(period)}
            _both(ref, port, "energy", CH, sol, PW, **kw)
            _both(ref, port, "energy_report", CH, sol, PW, **kw)


def _close_points(fast, ref):
    """Exact schedules and budgets, periods and energies to 1e-12."""
    assert len(fast) == len(ref)
    for a, r in zip(fast, ref):
        assert a.budget == r.budget
        assert a.solution == r.solution
        assert math.isclose(a.period, r.period, rel_tol=1e-12)
        assert math.isclose(a.energy, r.energy, rel_tol=1e-12)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_vectorised_planners_match_the_ports_scalar_oracles(case):
    """The port's vectorised sweeps and DPs against its own scalar
    ``*_reference`` oracles: schedules exactly, periods and energies to a
    relative 1e-12. The reference's own two paths already differ in the
    last ulp (e.g. 71.51999999999998 against 71.52: the vectorised sweep
    sums its energy terms in another order), so the port, which keeps the
    reference's arithmetic operation for operation, inherits that gap by
    construction; the cross-package tests above are exact."""
    _, s = _sides(case)
    m = s.mod
    _close_points(m.sweep_budgets(s.chain, s.b, s.l, s.power),
                  m.sweep_budgets_reference(s.chain, s.b, s.l, s.power))
    _close_points(m.sweep_budgets_freq(s.chain, s.b, s.l, s.power),
                  m.sweep_budgets_freq_reference(s.chain, s.b, s.l, s.power))
    if s.spec.names != ("base",):
        _close_points(
            m.sweep_budgets_variant(s.chain, s.b, s.l, s.power,
                                    variants=s.spec),
            m.sweep_budgets_variant_reference(s.chain, s.b, s.l, s.power,
                                              variants=s.spec))
    for p_max in _p_maxes(s):
        assert m.min_energy_under_period_freq(
            s.chain, s.b, s.l, p_max, s.power) == \
            m.min_energy_under_period_freq_reference(
                s.chain, s.b, s.l, p_max, s.power)
        assert m.min_energy_under_period_freq(
            s.chain, s.b, s.l, p_max, s.power, variants=s.spec) == \
            m.min_energy_under_period_freq_reference(
                s.chain, s.b, s.l, p_max, s.power, variants=s.spec)
        assert m.min_energy_under_period(s.chain, s.b, s.l, p_max,
                                         s.power) == \
            m.min_energy_under_period_reference(s.chain, s.b, s.l, p_max,
                                                s.power)
    if s.b + s.l:
        for bb in range(s.b + 1):
            for ll in range(s.l + 1):
                if bb + ll:
                    assert herad(s.chain, bb, ll) == \
                        herad_reference(s.chain, bb, ll)
