"""The port's control layer (``repro_torch.control``) against
``repro.control``: every power budget's ``cap_at`` on a time grid and its
``change_times`` (the metered battery with recorded draw as well), the
DVB-S2 serving and budget presets, and the governor's event logs on the
observation sequences of the reference's governor unit tests, all ``==``.
The port's copies are also checked directly, not only by equality with
the reference, on the properties those unit tests assert."""
import types

import numpy as np
import pytest

from _torch_parity import canon

import repro.configs.dvbs2 as jdvbs2
import repro.control as jcontrol
import repro.energy as jenergy
from repro.core import TaskChain as JTaskChain
import repro_torch.configs.dvbs2 as tdvbs2
import repro_torch.control as tcontrol
import repro_torch.energy as tenergy
from repro_torch.core import TaskChain

REF = types.SimpleNamespace(control=jcontrol, energy=jenergy, dvbs2=jdvbs2,
                            TaskChain=JTaskChain)
PORT = types.SimpleNamespace(control=tcontrol, energy=tenergy, dvbs2=tdvbs2,
                             TaskChain=TaskChain)
TIMES = [float(t) for t in np.linspace(0.0, 12.0, 49)]


# ----------------------------------------------------------------- budgets
def _budgets(pkg):
    c = pkg.control
    levels = ((0.65, 10.0), (0.35, 7.0), (0.0, 5.0))
    return {
        "constant": c.ConstantBudget(12.5),
        "scripted": c.ScriptedBudget(((0.0, 10.0), (2.0, 7.5), (5.0, 12.0),
                                      (9.25, 3.0))),
        "thermal": c.ThermalThrottleBudget(nominal_w=10.0, throttled_w=6.0,
                                           t_throttle=3.0, t_recover=7.0),
        "battery": c.BatteryBudget(capacity_j=100.0, drain_w=10.0,
                                   levels=levels),
        "metered_battery": c.MeteredBatteryBudget(
            capacity_j=100.0, drain_w=10.0, levels=levels, smoothing=0.3),
    }


def _trace(budget):
    out = [budget.change_times()]
    times = sorted(set(TIMES) | {t + d for t in budget.change_times()
                                 for d in (-1e-9, 0.0, 1e-9)})
    out += [(t, budget.cap_at(t)) for t in times]
    if hasattr(budget, "soc_at"):
        out += [budget.soc_at(t) for t in times]
    return out


@pytest.mark.parametrize("name", list(_budgets(REF)))
def test_budget_traces_match_reference(name):
    ref, port = _budgets(REF)[name], _budgets(PORT)[name]
    assert canon(_trace(port)) == canon(_trace(ref))
    if name == "metered_battery":
        # closed on measured draw: record windows and re-read the trace
        draws = [(0.5, 12.0), (1.0, 9.0), (2.5, None), (3.0, 4.0),
                 (4.5, 15.0), (6.0, 8.0)]
        for t, w in draws:
            ref.record(t, w)
            port.record(t, w)
            assert canon(_trace(port)) == canon(_trace(ref))
            assert port.consumed_j == ref.consumed_j
            assert port.drain_estimate_w == ref.drain_estimate_w


@pytest.mark.parametrize("platform", ["mac", "x7"])
def test_presets_match_reference(platform):
    sp, jsp = (tdvbs2.serving_preset(platform),
               jdvbs2.serving_preset(platform))
    assert sp.keys() == jsp.keys()
    for k in sp:
        v, jv = sp[k], jsp[k]
        assert canon(_trace(v) if k == "budget" else v) == \
            canon(_trace(jv) if k == "budget" else jv), k
    bp, jbp = tdvbs2.budget_presets(platform), jdvbs2.budget_presets(platform)
    assert bp.keys() == jbp.keys()
    assert bp["_levels"] == jbp["_levels"]
    for k in ("constant", "battery", "metered_battery", "thermal"):
        assert canon(_trace(bp[k])) == canon(_trace(jbp[k])), k
    # what the serving scenario relies on, held on the port's own copy
    front = sp["frontier"]
    assert front[0].energy / front[0].period < sp["cap_w"]
    assert front[0].period < sp["slo_period"] < front[-1].period


# ---------------------------------------------------------------- governor
def _small_chain(pkg):
    return pkg.TaskChain(w_big=[10.0, 40.0, 40.0, 10.0],
                         w_little=[25.0, 100.0, 100.0, 25.0],
                         replicable=[False, True, True, False])


def _power(pkg):
    e = pkg.energy
    return e.PowerModel("t", e.CoreTypePower(0.1, 0.9),
                        e.CoreTypePower(0.03, 0.32))


def _steady(gov, t, obs_cls):
    return obs_cls(t=t, period=gov.plan.predicted_period)


def _scenario(name, pkg):
    """Drive one governor through one of the reference unit tests'
    observation sequences; return (governor, returned events)."""
    c = pkg.control
    obs = c.Observation
    ch, power = _small_chain(pkg), _power(pkg)
    front = pkg.energy.pareto_frontier(ch, 3, 2, power)
    watts = [pt.energy / pt.period for pt in front]
    got = []
    if name == "steady":
        gov = c.Governor(ch, 3, 2, power, c.ConstantBudget(1000.0))
        got.append(gov.start())
        got += [gov.observe(_steady(gov, float(t), obs)) for t in range(1, 20)]
    elif name == "cap_drop":
        budget = c.ScriptedBudget(((0.0, watts[0] + 1.0),
                                   (5.0, watts[1] * 1.001)))
        gov = c.Governor(ch, 3, 2, power, budget)
        got.append(gov.start())
        got += [gov.observe(_steady(gov, t, obs)) for t in (1.0, 5.0, 6.0)]
    elif name == "drift":
        gov = c.Governor(ch, 3, 2, power, c.ConstantBudget(1000.0),
                         drift_tolerance=0.25)
        got.append(gov.start())
        p0 = gov.plan.predicted_period
        got += [gov.observe(obs(t=float(t), period=p0 * 1.4))
                for t in range(1, 10)]
        got.append(gov.observe(obs(t=20.0, period=p0 * 1.4 * 1.1)))
    elif name == "lossy":
        gov = c.Governor(ch, 3, 2, power, c.ConstantBudget(1000.0))
        got.append(gov.start())
        p0 = gov.plan.predicted_period
        got.append(gov.observe(obs(t=1.0, period=p0 * 10.0, frames=3,
                                   dropped=27)))
        got.append(gov.observe(obs(t=2.0, period=p0 * 10.0, frames=30)))
    elif name == "device_loss":
        gov = c.Governor(ch, 3, 2, power, c.ConstantBudget(1000.0))
        got.append(gov.start())
        got.append(gov.device_loss(2.0, little=2))
        for kw in ({"big": 5}, {}):
            try:
                gov.device_loss(3.0, **kw)
            except ValueError as e:
                got.append(("raised", str(e)))
    elif name == "infeasible_cap":
        gov = c.Governor(ch, 3, 2, power,
                         c.ConstantBudget(watts[-1] * 0.5))
        got.append(gov.start())
        got += [gov.observe(_steady(gov, float(t), obs)) for t in range(1, 6)]
    elif name == "upshift":
        budget = c.ThermalThrottleBudget(nominal_w=watts[0] + 1.0,
                                         throttled_w=watts[-1] * 1.001,
                                         t_throttle=2.0, t_recover=6.0)
        gov = c.Governor(ch, 3, 2, power, budget)
        got.append(gov.start())
        got += [gov.observe(_steady(gov, t, obs)) for t in (2.0, 6.0)]
    elif name == "slo":
        # the serving objective on the DVB-S2 serving preset: measured p99s
        # below, at and above the SLO, with and without an admitted
        # deadline floor (need_period)
        sp = pkg.dvbs2.serving_preset("mac")
        slo, fast = sp["slo_period"], sp["frontier"][0].period
        gov = c.Governor(sp["chain"], sp["b"], sp["l"], sp["power"],
                         sp["budget"], slo_period=slo, upshift_margin=0.02)
        got.append(gov.start())
        for t, f, need in ((1.0, 1.0, None), (2.0, 1.0, None),
                           (3.0, 1.3, None), (4.0, 1.3, slo * 0.8),
                           (5.0, 1.0, None), (6.0, 0.7, slo * 2.0),
                           (7.0, 1.0, fast * 1.01), (8.0, 1.0, None)):
            p = gov.plan.predicted_period
            got.append(gov.observe(obs(t=t, period=p * f, p99=p * f,
                                       need_period=need)))
    else:
        raise KeyError(name)
    return gov, got


SCENARIOS = ["steady", "cap_drop", "drift", "lossy", "device_loss",
             "infeasible_cap", "upshift", "slo"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_governor_event_logs_match_reference(name):
    jgov, want = _scenario(name, REF)
    gov, got = _scenario(name, PORT)
    assert canon(got) == canon(want)
    assert canon(gov.events) == canon(jgov.events)
    assert (gov.b, gov.l, gov.calibration_scale, gov.power_margin) == \
        (jgov.b, jgov.l, jgov.calibration_scale, jgov.power_margin)
    assert canon(gov.chain) == canon(jgov.chain)
    assert canon(gov.frontier()) == canon(jgov.frontier())
    triggers = [e.trigger for e in gov.replans]
    expect = {"steady": [], "cap_drop": ["cap"], "drift": ["drift"],
              "lossy": ["drift"], "device_loss": ["device_loss"],
              "infeasible_cap": [], "upshift": ["cap", "cap"]}
    if name in expect:
        assert triggers == expect[name]
    else:
        assert "slo" in triggers
