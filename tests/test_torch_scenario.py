"""The port's sleep-simulated pipeline scenarios (``run_scenario``,
``sleep_stage_builder``, the pipeline half of ``repro_torch.control.sim``)
and its calibration (``repro_torch.control.calibrate``) against
``repro.control``.

What is deterministic is compared with ``==``: the sleep each stage fn
asks for, the per-stage busy aggregation, the window cap floors, every
calibration fit, and, with the measurement-driven triggers switched off
(drift and power tolerances of 100), the whole plan sequence of a
scenario under scripted caps, battery and thermal budgets and device
losses, its window count and frames per window, against the reference's
``run_scenario`` on the same inputs. The measurement-driven triggers
(drift, power) are held with margins several times the noise the sleep
simulation shows, and compared with the reference's trigger kinds."""
import types

import numpy as np
import pytest

from _torch_parity import canon, outcome

import repro.configs.dvbs2 as jdvbs2
import repro.control as jcontrol
import repro.control.sim as jsim
import repro.core as jcore
import repro.energy as jenergy
import repro_torch.configs.dvbs2 as tdvbs2
import repro_torch.control as tcontrol
import repro_torch.control.sim as tsim
import repro_torch.core as tcore
import repro_torch.energy as tenergy
from repro_torch.control import (
    TraceSample, fit_power_model, sample_from_run, stage_info_from_plan,
    synthesize_samples)
from repro_torch.core import BIG, LITTLE, herad
from repro_torch.energy import POWER_APPLE_M1_ULTRA
from repro_torch.pipeline import StageSpec, StreamingPipelineRuntime

REF = types.SimpleNamespace(control=jcontrol, sim=jsim, core=jcore,
                            energy=jenergy, dvbs2=jdvbs2)
PORT = types.SimpleNamespace(control=tcontrol, sim=tsim, core=tcore,
                             energy=tenergy, dvbs2=tdvbs2)
OFF = 100.0   # a tolerance no measurement reaches: the trigger is off


def both(case):
    ours, ref = outcome(case, PORT), outcome(case, REF)
    assert ours == ref
    return case(PORT)


def small_chain(pkg):
    return pkg.core.TaskChain(w_big=[10.0, 40.0, 40.0, 10.0],
                              w_little=[25.0, 100.0, 100.0, 25.0],
                              replicable=[False, True, True, False])


# ================================================================ builder
def test_sleep_stage_builder_requests_reference_sleeps(monkeypatch):
    """Every stage fn of a DVFS plan, under both drift knobs, asks
    ``time.sleep`` for exactly the reference's duration."""
    def case(pkg):
        asked = []
        monkeypatch.setattr(pkg.sim.time, "sleep", asked.append)
        ch = pkg.dvbs2.dvbs2_chain("mac")
        power = pkg.dvbs2.platform_power("mac")
        fsol = pkg.energy.pareto.freqherad(ch, 4, 4, power=power)
        knobs = {"latency_scale": 1.0}
        build = pkg.sim.sleep_stage_builder(ch, 4e-6, knobs)
        fns = [build(st.start, st.end, st) for st in fsol.stages]
        for step in ({}, {"latency_scale": 1.5},
                     {"task_latency_scale": {0: 2.0, 5: 1.3}}):
            knobs.update(step)
            assert [fn(7) for fn in fns] == [7] * len(fns)
        monkeypatch.undo()
        return fsol, asked

    fsol, asked = both(case)
    assert len(asked) == 3 * len(fsol.stages) and min(asked) > 0


def test_stage_busy_units_and_cap_floor_match_reference():
    stats = {"busy_s": {("s0-0", 0): 0.004, ("s1-2", 0): 0.03,
                        ("s1-2", 1): 0.029, ("s3-3", 0): 0.0},
             "replica_frames": {("s0-0", 0): 10, ("s1-2", 0): 5,
                                ("s1-2", 1): 5}}

    def case(pkg):
        budget = pkg.control.ScriptedBudget(((0.0, 9.0), (1.5, 4.0),
                                             (1.7, 6.0), (3.0, 2.0)))
        floors = [pkg.sim._min_cap_over(budget, t, t + 1.0)
                  for t in (0.0, 1.0, 2.0, 3.0, 1.5)]
        return pkg.sim._stage_busy_units(stats, 4e-6), floors

    units, floors = both(case)
    assert set(units) == {"s0-0", "s1-2"}
    assert floors == [9.0, 4.0, 6.0, 2.0, 4.0]


# ============================================================== scenarios
def _scenario(pkg, *, budget, b=None, l=None, chain=None, power=None,
              executor="thread", **kw):
    """One ``run_scenario`` of ``pkg``, and what a scripted run decides:
    each governor event (trigger, scenario time, cap, the adopted plan's
    period, watts and stages), each window's index, time, cap, cap floor,
    plan and frame count, and the frames fed and delivered."""
    platform = "mac"
    if chain is None:
        chain = pkg.dvbs2.dvbs2_chain(platform)
        power = pkg.dvbs2.platform_power(platform)
        b, l = pkg.dvbs2.RESOURCES[platform]["half"]
    gov_kw = {k: kw.pop(k) for k in ("lookahead_s", "dvfs") if k in kw}
    gov = pkg.control.Governor(chain, b, l, power, budget(pkg),
                               drift_tolerance=OFF, power_tolerance=OFF,
                               **gov_kw)
    res = pkg.control.run_scenario(gov, executor=executor, **kw)
    events = tuple((e.trigger, e.t, e.cap_w, e.cap_met,
                    e.plan.predicted_period, e.plan.predicted_watts,
                    canon(e.plan.point.solution)) for e in res.events)
    windows = tuple((w.index, w.t, w.cap_w, w.min_cap_w, w.predicted_period,
                     w.predicted_watts, w.frames, w.over_cap,
                     tuple(e.trigger for e in w.events))
                    for w in res.windows)
    return events, windows, res.frames_fed, res.frames_delivered


def _dvbs2_budget(kind, horizon_s=9.0):
    def make(pkg):
        presets = pkg.dvbs2.budget_presets("mac", "half", horizon_s=horizon_s)
        if kind == "cap_drop":
            hi, mid, _ = presets["_levels"]
            return pkg.control.ScriptedBudget(((0.0, hi), (2.0, mid)))
        return presets[kind]
    return make


@pytest.mark.parametrize("name,budget,kw,triggers", [
    ("cap_drop_device_loss", _dvbs2_budget("cap_drop"),
     dict(n_windows=6, device_loss_at={4: (0, 1)}),
     ["cap", "device_loss"]),
    ("battery", _dvbs2_budget("battery"), dict(n_windows=9), None),
    ("battery_predictive", _dvbs2_budget("battery", 10.0),
     dict(n_windows=9, lookahead_s=1.0), None),
    ("thermal", _dvbs2_budget("thermal"), dict(n_windows=9), None),
])
def test_scripted_scenarios_decide_like_reference(name, budget, kw, triggers):
    """DVB-S2 ``mac`` on half its cores, 30 frames a window: every
    decision, window and frame count equals the reference's run."""
    args = dict(time_scale=2e-6, window_dt=1.0, frames_per_window=30, **kw)
    ours = _scenario(PORT, budget=budget, **dict(args))
    ref = _scenario(REF, budget=budget, **dict(args))
    assert ours == ref
    events, windows, fed, delivered = ours
    assert fed == delivered == 30 * len(windows)
    kinds = [e[0] for e in events[1:]]
    if triggers is not None:
        assert kinds == triggers
    if name == "battery":
        assert len(kinds) >= 2 and len({w[2] for w in windows}) == 3
        assert any(w[7] for w in windows)      # reactive: straddles a drop
    if name == "battery_predictive":
        assert "predictive" in kinds
        assert not any(w[7] for w in windows)  # no window over its floor
    if name == "thermal":   # throttle, then recover to the first cap
        assert kinds == ["cap", "cap"]
        assert events[2][2] == events[0][2] > events[1][2]
    assert all(e[3] for e in events)           # every plan met its cap


@pytest.mark.parametrize("executor", ["thread", "process"])
def test_small_chain_scenario_decides_like_reference(executor):
    """The small chain on 3 + 2 under a cap drop and a device loss, on
    both executors (the reference's run on threads)."""
    def budget(pkg):
        front = pkg.energy.pareto_frontier(small_chain(pkg), 3, 2,
                                           _power(pkg))
        watts = [pt.energy / pt.period for pt in front]
        return pkg.control.ScriptedBudget(((0.0, watts[0] + 1.0),
                                           (1.5, watts[-1] * 1.001)))

    args = dict(time_scale=2e-5, n_windows=5, window_dt=1.0,
                frames_per_window=20, device_loss_at={3: (0, 1)})
    ours = _scenario(PORT, budget=budget, b=3, l=2,
                     chain=small_chain(PORT), power=_power(PORT),
                     executor=executor, **dict(args))
    ref = _scenario(REF, budget=budget, b=3, l=2, chain=small_chain(REF),
                    power=_power(REF), **dict(args))
    assert ours == ref
    assert [e[0] for e in ours[0][1:]] == ["cap", "device_loss"]
    assert ours[3] == ours[2] == 100


def _power(pkg):
    return pkg.energy.PowerModel("t", pkg.energy.CoreTypePower(0.1, 0.9),
                                 pkg.energy.CoreTypePower(0.03, 0.32))


# The measurement-driven triggers' margins. A steady window's period error
# reached 0.285 at time scale 4e-6 with three test processes beside it
# (40 runs); at 8e-6 (~9 ms a frame) the sleeps' overheads weigh half as
# much. The drift tolerance is three times the bound the steady test
# holds, and the injected slowdown four times the plan's period.
MEASURED_TIME_SCALE = 8e-6
DRIFT_TOL = 1.0
DRIFT_SLOWDOWN = 4.0


def _measured(pkg, **kw):
    """A DVB-S2 ``mac`` scenario with one measurement-driven trigger armed
    (the other off), and its governor."""
    chain = pkg.dvbs2.dvbs2_chain("mac")
    power = pkg.dvbs2.platform_power("mac")
    b, l = pkg.dvbs2.RESOURCES["mac"]["half"]
    front = pkg.energy.pareto_frontier(chain, b, l, power)
    cap = front[0].energy / front[0].period * 1.05
    meter = kw.pop("meter", None)
    gov = pkg.control.Governor(
        chain, b, l, power, pkg.control.ConstantBudget(cap),
        drift_tolerance=kw.pop("drift_tolerance", OFF),
        power_tolerance=kw.pop("power_tolerance", OFF))
    res = pkg.control.run_scenario(
        gov, time_scale=MEASURED_TIME_SCALE, window_dt=1.0,
        frames_per_window=30,
        meter_power=meter(pkg, power) if meter else None, **kw)
    return gov, res


def test_steady_scenario_period_error_is_small():
    """No trigger armed and nothing injected: after the first window the
    measured period stays within a third of the drift tolerance of the
    plan's, the margin the drift test below relies on."""
    gov, res = _measured(PORT, n_windows=4)
    assert res.replans == ()
    assert res.frames_dropped == 0
    assert max(w.period_error for w in res.windows[1:]) <= DRIFT_TOL / 3


def test_drift_trigger_fires_once_like_reference():
    """A 4x uniform slowdown from window 3: exactly one drift re-plan, at
    the next window's tick, recalibrated to ~4x, in both packages."""
    for pkg in (PORT, REF):
        gov, res = _measured(pkg, n_windows=6, drift_tolerance=DRIFT_TOL,
                             drift_at=((3, DRIFT_SLOWDOWN),))
        assert [e.trigger for e in res.replans] == ["drift"]
        assert res.replans[0].t == 4.0
        assert gov.calibration_scale == pytest.approx(DRIFT_SLOWDOWN,
                                                      rel=DRIFT_TOL / 3)


def test_power_trigger_learns_big_correction_like_reference():
    """The meter draws 3x the planner's BIG watts: the "power" trigger
    fires (in both packages) and the BIG correction exceeds LITTLE's."""
    def hot(pkg, power):
        return pkg.energy.PowerModel(
            "hot-big", pkg.energy.CoreTypePower(power.big.static_watts * 3,
                                                power.big.dynamic_watts * 3),
            power.little, freq_levels=power.freq_levels)

    for pkg in (PORT, REF):
        gov, res = _measured(pkg, n_windows=5, meter=hot,
                             power_tolerance=0.05)
        kinds = [e.trigger for e in res.replans]
        assert kinds and set(kinds) == {"power"}
        assert gov.corrections[BIG] > 1.5
        assert gov.corrections[LITTLE] <= gov.corrections[BIG]


# ============================================================ calibration
@pytest.mark.parametrize("name", ["exact", "noisy", "dvfs"])
def test_calibration_fits_match_reference(name):
    def case(pkg):
        truth = pkg.energy.POWER_APPLE_M1_ULTRA
        if name == "exact":
            samples = pkg.control.synthesize_samples(
                truth, [(0.1, 0.9), (0.9, 0.1), (0.5, 0.5), (0.2, 0.2),
                        (1.0, 0.0), (0.0, 1.0), (0.7, 0.3)],
                window_s=2.0, cores=[(4, 2), (2, 4), (6, 1)])
        elif name == "noisy":
            rng = np.random.default_rng(7)
            samples = pkg.control.synthesize_samples(
                truth, [(rng.uniform(), rng.uniform()) for _ in range(60)],
                noise=0.02, rng=rng, cores=[(8, 2), (4, 4), (2, 8), (6, 6)])
        else:
            samples = pkg.control.synthesize_samples(
                truth, [(0.2, 0.8), (0.8, 0.2), (0.5, 0.5), (1.0, 0.3),
                        (0.3, 1.0)], freqs=(0.6, 0.8),
                cores=[(4, 4), (2, 6), (6, 2)])
        fitted = pkg.control.fit_power_model(samples)
        return samples, fitted, pkg.control.fit_report(samples, fitted)

    samples, fitted, report = both(case)
    truth = POWER_APPLE_M1_ULTRA
    rel = 0.1 if name == "noisy" else 1e-6
    for v in (BIG, LITTLE):
        assert fitted.busy_watts(v) == pytest.approx(truth.busy_watts(v),
                                                     rel=rel)
    if name == "exact":
        assert report["rel_rms"] < 1e-9


@pytest.mark.parametrize("utils,cores", [
    ([(0.5, 0.5)] * 6, (4, 4)),
    ([(0.7, 0.2)], (4, 4)),
    ([(0.0, 0.0), (1.0, 1.0), (0.3, 0.3)], (4, 0)),
    ([(0.0, 0.0), (1.0, 1.0)], (4, 4)),
])
def test_degenerate_calibration_matches_reference(utils, cores):
    """The fallback fit of rank-deficient windows, and the strict mode's
    raise, as the reference's; the fallback stays bounded and reproduces
    every window's energy."""
    def case(pkg):
        truth = pkg.energy.POWER_APPLE_M1_ULTRA
        samples = pkg.control.synthesize_samples(truth, utils, cores=cores)
        fitted = pkg.control.fit_power_model(samples)
        return (fitted, pkg.control.fit_report(samples, fitted),
                outcome(pkg.control.fit_power_model, samples,
                        on_degenerate="raise"))

    fitted, report, _ = both(case)
    assert report["rel_max"] < 1e-6
    samples = synthesize_samples(POWER_APPLE_M1_ULTRA, utils, cores=cores)
    bound = max(s.energy_j for s in samples) + 1.0
    for v in (BIG, LITTLE):
        assert 0.0 <= fitted.busy_watts(v) <= bound


def test_fallback_clamp_misses_energy_like_reference():
    """An input on which the fallback fit does not reproduce the windows'
    energies, in both packages alike: two windows, (0, 1) and (0.5, 0.5)
    on 4 + 4 cores. The minimum-norm solution has a negative coefficient,
    and the clamp to 0 moves the fit off the data (rel_max 0.89): the
    reference's property ``test_calibration_fallback_never_amplifies``
    fails whenever hypothesis draws it (ROADMAP Queue C, carry-in 3)."""
    def case(pkg):
        samples = pkg.control.synthesize_samples(
            pkg.energy.POWER_APPLE_M1_ULTRA, [(0.0, 1.0), (0.5, 0.5)],
            cores=(4, 4))
        fitted = pkg.control.fit_power_model(samples)
        return fitted, pkg.control.fit_report(samples, fitted)

    fitted, report = both(case)
    assert report["rel_max"] > 0.5
    assert min(fitted.idle_watts(BIG), fitted.idle_watts(LITTLE),
               fitted.busy_watts(BIG), fitted.busy_watts(LITTLE)) >= 0.0


def test_calibration_rejects_what_the_reference_rejects():
    def cases(pkg):
        c, truth = pkg.control, pkg.energy.POWER_APPLE_M1_ULTRA
        same = c.synthesize_samples(truth, [(0.5, 0.5)] * 6)
        big, little = pkg.core.BIG, pkg.core.LITTLE
        return [outcome(c.fit_power_model, [], on_degenerate="raise"),
                outcome(c.fit_power_model, same, on_degenerate="explode"),
                outcome(c.TraceSample, {big: 1.0}, {(big, 1.0): 2.0}, 1.0),
                outcome(c.TraceSample, {big: -1.0}, {}, 1.0),
                outcome(c.TraceSample, {big: 1.0}, {(big, 0.0): 0.5}, 1.0),
                outcome(c.TraceSample, {little: 1.0}, {(little, 1.0): 0.5},
                        1.0),
                outcome(c.sample_from_run, [], {"total_s": 1.0,
                                                "busy_s": {}}),
                outcome(c.synthesize_samples, truth, [(1.5, 0.0)])]

    got = both(cases)
    assert got[:5] == [("raised", "ValueError")] * 5
    with pytest.raises(ValueError, match="busy core-seconds exceed"):
        TraceSample({BIG: 1.0}, {(BIG, 1.0): 2.0}, 1.0)


def test_sample_from_metered_run_fits_runtime_watts():
    """The recorded-trace path on the port's runtime: two metered runs at
    two utilizations fit the stage's busy watts, and the same stats give
    the reference's samples and fit."""
    import time

    samples, stats_runs = [], []
    for sleep_s in (0.004, 0.001):
        rt = StreamingPipelineRuntime([
            StageSpec("s", lambda x, d=sleep_s: (time.sleep(d), x)[1],
                      replicas=2, device_class="big",
                      busy_watts=5.0, idle_watts=0.5)]).start()
        stats = rt.run(list(range(30)))
        rt.stop()
        samples.append(sample_from_run(rt.stages, stats))
        stats_runs.append((rt.stages, stats))
    fitted = fit_power_model(samples)
    assert fitted.busy_watts(BIG) == pytest.approx(5.0, rel=0.35)
    # the reference reads the same StageSpec fields off the port's specs
    ref = [jcontrol.sample_from_run(st, stats) for st, stats in stats_runs]
    assert canon(samples) == canon(ref)
    assert canon(fitted) == canon(jcontrol.fit_power_model(ref))


def test_variant_fits_match_reference():
    """``fit_variant_multipliers`` (pooling, frequency normalization, the
    raise without a base), ``observations_from_run`` and
    ``samples_from_capture(by_variant=True)`` as the reference's."""
    class Spec:
        def __init__(self, name, device_class, variant, freq=1.0):
            self.name, self.device_class = name, device_class
            self.variant, self.freq = variant, freq

    stages = [Spec("s0-1", "big", "base"),
              Spec("s2-3", "big", "chunked", freq=0.5),
              Spec("s4-4", "little", "chunked"), Spec("s5-5", "little",
                                                       "base")]
    stats = {"busy_s": {("s0-1", 0): 2.0, ("s0-1", 1): 2.0,
                        ("s2-3", 0): 3.0, ("s4-4", 0): 1.5,
                        ("s5-5", 0): 2.5},
             "replica_frames": {("s0-1", 0): 5, ("s0-1", 1): 5,
                                ("s2-3", 0): 10, ("s4-4", 0): 10,
                                ("s5-5", 0): 10}}

    class Win:
        def __init__(self, variant, alloc, busy, e):
            self.variant, self.alloc_s, self.busy_s = variant, alloc, busy
            self.energy_j = e

    def case(pkg):
        c, big, little = pkg.control, pkg.core.BIG, pkg.core.LITTLE
        O = c.VariantObservation
        pooled = [O("base", big, busy_s=10.0, frames=10),
                  O("base", little, busy_s=30.0, frames=10),
                  O("chunked", big, busy_s=6.0, frames=5),
                  O("chunked", big, busy_s=7.0, frames=5),
                  O("chunked", little, busy_s=4.92, frames=1, freq=0.5)]
        obs = c.observations_from_run(stages, stats)
        wins = [Win("base", {big: 1.0}, {(big, 1.0): 0.5}, 2.0),
                Win("chunked", {big: 1.0}, {(big, 1.0): 0.4}, 1.8),
                Win(None, {little: 1.0}, {(little, 1.0): 0.7}, 1.0),
                Win("chunked", {}, {}, 5.0)]
        return (c.fit_variant_multipliers(pooled),
                c.fit_variant_multipliers(pooled[:2]), obs,
                c.fit_variant_multipliers(obs),
                outcome(c.fit_variant_multipliers,
                        [O("base", big, busy_s=10.0, frames=10),
                         O("chunked", little, busy_s=5.0, frames=10)]),
                c.samples_from_capture(wins, by_variant=True),
                c.samples_from_capture(wins))

    pooled, empty, obs, fit, raised, grouped, flat = both(case)
    assert pooled["chunked"][BIG] == pytest.approx(1.3)
    assert pooled["chunked"][LITTLE] == pytest.approx(0.82)
    assert empty == {} and raised == ("raised", "ValueError")
    assert fit["chunked"] == {BIG: pytest.approx(0.15 / 0.4),
                              LITTLE: pytest.approx(0.15 / 0.25)}
    assert set(grouped) == {"base", "chunked"} and len(flat) == 3


def test_stage_info_from_plan_matches_reference():
    def case(pkg):
        ch = small_chain(pkg)
        fsol = pkg.energy.pareto.freqherad(
            ch, 4, 4, power=pkg.energy.model.DEFAULT_DVFS_POWER)
        return (pkg.control.stage_info_from_plan(pkg.core.herad(ch, 3, 2)),
                pkg.control.stage_info_from_plan(fsol))

    plain, dvfs = both(case)
    assert all(v["freq"] == 1.0 and v["variant"] == "base"
               for v in plain.values())
    assert any(v["freq"] < 1.0 for v in dvfs.values())
    assert set(plain) == {f"s{st.start}-{st.end}"
                          for st in herad(small_chain(PORT), 3, 2).stages}


def test_runtime_stages_name_like_stage_info():
    """The names ``from_plan`` gives its StageSpecs are the keys of
    ``stage_info_from_plan``: a runtime's trace lines up with the plan."""
    ch = small_chain(PORT)
    sol = herad(ch, 3, 2)

    class Plan:
        chain, solution = ch, sol

    rt = StreamingPipelineRuntime.from_plan(Plan, lambda s, e: (lambda x: x))
    assert [s.name for s in rt.stages] == list(stage_info_from_plan(sol))
