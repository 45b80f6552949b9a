"""The port's measured-power ingestion (``repro_torch.obs.power``) and
energy attribution (``repro_torch.obs.report.attribute_energy``) against
``repro.obs``: the reference's cases of ``tests/test_obs_power.py`` (the
golden RAPL and powermetrics fixtures, capture semantics, the synthesize ->
parse -> refit round trip, trace/capture alignment, attribution closure),
each run through both packages on the same input and compared with ``==``
(``_torch_parity.canon``), with the reference's own checks on the port's
result. The CLI tools' gates (``tools/trace_diff.py``,
``tools/trace_report.py``) belong to the reference and are not ported."""
import types
from pathlib import Path

import pytest

from _torch_parity import canon, outcome

import repro.control as jcontrol
import repro.core as jcore
import repro.energy as jenergy
import repro.obs as jobs
import repro.obs.power as jpower
import repro_torch.control as tcontrol
import repro_torch.core as tcore
import repro_torch.energy as tenergy
import repro_torch.obs as tobs
import repro_torch.obs.power as tpower

FIXTURES = Path(__file__).parent / "fixtures"
REF = types.SimpleNamespace(power=jpower, obs=jobs, control=jcontrol,
                            energy=jenergy, core=jcore)
PORT = types.SimpleNamespace(power=tpower, obs=tobs, control=tcontrol,
                             energy=tenergy, core=tcore)


def cap_form(cap):
    """A capture's canonical content: domains, every sample, the extent."""
    return (cap.domains, tuple(canon(cap.series(d)) for d in cap.domains),
            canon(cap.extent))


def both(case):
    """``case(pkg)`` through the port and the reference; their canonical
    outcomes must be equal. Returns the port's value."""
    ours, ref = outcome(case, PORT), outcome(case, REF)
    assert ours == ref
    return case(PORT)


def test_constants_match_reference():
    assert tpower.DEFAULT_RAPL_MAX_UJ == jpower.DEFAULT_RAPL_MAX_UJ
    assert [n for n in dir(tpower) if n.isupper()] == \
        [n for n in dir(jpower) if n.isupper()]


# =========================================================== golden fixtures
def test_rapl_golden_fixture_parses_exactly():
    text = (FIXTURES / "rapl_wraparound.log").read_text()

    def case(pkg):
        cap = pkg.power.parse_rapl_log(text)
        return cap_form(cap), cap.total_energy("package"), \
            cap.total_energy(), cap.avg_watts()

    form, pkg_j, total_j, _ = both(case)
    cap = tpower.parse_rapl_log(text)
    assert set(cap.domains) == {"core", "package"}
    assert [(s.t0, s.t1) for s in cap.series("package")] == [
        (0.0, 0.5), (0.5, 1.0), (1.0, 1.5)]
    for s in cap.series("package"):
        assert s.energy_j == pytest.approx(0.04, rel=1e-12)
        assert s.watts == pytest.approx(0.08, rel=1e-12)
    assert pkg_j == pytest.approx(0.12, rel=1e-12) and total_j == pkg_j


def test_rapl_wraparound_uses_declared_counter_range():
    text = "\n".join(line for line in (
        FIXTURES / "rapl_wraparound.log").read_text().splitlines()
        if "max_energy_uj" not in line)
    form = both(lambda pkg: cap_form(pkg.power.parse_rapl_log(text)))
    wrapped = tpower.parse_rapl_log(text).series("package")[1]
    assert wrapped.energy_j == pytest.approx(
        (30000 - 990000 + tpower.DEFAULT_RAPL_MAX_UJ) * 1e-6, rel=1e-12)
    assert form[0] == ("core", "package")


def test_powermetrics_golden_fixture_parses_exactly():
    text = (FIXTURES / "powermetrics_missing.txt").read_text()

    def case(pkg):
        cap = pkg.power.parse_powermetrics(text)
        return cap_form(cap), cap.energy_between(0.0, 1.5, "package"), \
            cap.energy_between(0.5, 1.0, "package")

    form, whole, hole = both(case)
    cap = tpower.parse_powermetrics(text)
    assert set(cap.domains) == {"big", "cpu", "gpu", "little", "package"}
    assert cap.extent == (0.0, 1.5)
    assert [(s.t0, s.t1) for s in cap.series("cpu")] == [(0.0, 0.5),
                                                         (1.0, 1.5)]
    assert whole == pytest.approx(1.55) and hole == 0.0


# ====================================================== capture semantics
@pytest.mark.parametrize("domains,want", [
    ((("package", 2.0), ("big", 1.0), ("little", 1.0)), 2.0),
    ((("cpu", 3.0), ("big", 1.0), ("little", 1.0)), 3.0),
    ((("big", 2.0), ("little", 0.5)), 2.5),
    ((("dram", 4.0),), 4.0),
    ((("dram", 1.0), ("gpu", 1.0)), ("raised", "ValueError")),
])
def test_capture_default_domain_resolution_order(domains, want):
    def case(pkg):
        cap = pkg.power.PowerCapture(
            pkg.power.PowerSample(0.0, 1.0, e, d) for d, e in domains)
        return (outcome(cap.total_energy), outcome(cap.total_energy, "gpu"),
                outcome(cap.avg_watts))

    assert both(case)[0] == want


def test_capture_energy_between_pro_rata_and_rebase():
    def case(pkg):
        S = pkg.power.PowerSample
        cap = pkg.power.PowerCapture([S(10.0, 11.0, 1.0), S(11.0, 12.0, 3.0)])
        based = cap.rebase()
        return (cap.energy_between(10.25, 10.75),
                cap.energy_between(10.5, 11.5),
                cap.energy_between(12.0, 13.0), cap_form(based),
                based.energy_between(0.5, 1.5), based.total_energy())

    got = both(case)
    assert got[:3] == (pytest.approx(0.5), pytest.approx(2.0), 0.0)
    assert got[4] == pytest.approx(2.0) and got[5] == 4.0


@pytest.mark.parametrize("bad", ["overlap", "non_increasing"])
def test_malformed_captures_raise_like_reference(bad):
    def case(pkg):
        if bad == "overlap":
            S = pkg.power.PowerSample
            return pkg.power.PowerCapture([S(0.0, 1.0, 1.0),
                                           S(0.5, 1.5, 1.0)])
        return pkg.power.parse_rapl_log(
            "0.0 package 100\n0.0 package 200\n")

    assert outcome(case, PORT) == outcome(case, REF) == ("raised",
                                                         "ValueError")
    with pytest.raises(ValueError, match="overlapping" if bad == "overlap"
                       else "non-increasing"):
        case(PORT)


# ============================================ synthesize -> parse -> refit
def _power(pkg):
    return pkg.energy.PowerModel("unit", pkg.energy.CoreTypePower(0.35, 4.25),
                                 pkg.energy.CoreTypePower(0.06, 0.84))


def _schedule(pkg):
    W = pkg.power.UtilizationWindow
    return [W(1.0, u_big=0.8, u_little=0.1, n_big=4, n_little=2),
            W(1.0, u_big=0.1, u_little=0.8, n_big=2, n_little=4),
            W(1.0, u_big=0.5, u_little=0.5, n_big=3, n_little=3),
            W(1.0, u_big=0.9, u_little=0.0, n_big=4, n_little=1),
            W(1.0, u_big=0.0, u_little=0.9, n_big=1, n_little=4)]


@pytest.mark.parametrize("start", [0, "wrap"])
def test_rapl_synthesis_round_trip_is_exact_across_wraparound(start):
    def case(pkg):
        first = pkg.power.DEFAULT_RAPL_MAX_UJ - 1_000 if start == "wrap" \
            else 0
        text = pkg.power.synthesize_rapl_log(_power(pkg), _schedule(pkg),
                                             sample_dt=0.2, start_uj=first)
        cap = pkg.power.parse_rapl_log(text)
        truth = sum(w.watts(_power(pkg)) * w.dt_s for w in _schedule(pkg))
        return text, cap_form(cap), cap.total_energy(), truth

    text, _, total, truth = both(case)
    assert total == pytest.approx(truth, rel=1e-9)


def test_powermetrics_synthesis_dropped_rails_leave_gaps():
    def case(pkg):
        full = pkg.power.synthesize_powermetrics(_power(pkg), _schedule(pkg),
                                                 sample_dt=1.0)
        holey = pkg.power.synthesize_powermetrics(
            _power(pkg), _schedule(pkg), sample_dt=1.0,
            drop_fields={2: ["Package"], 4: ["Package"]})
        return (full, holey, cap_form(pkg.power.parse_powermetrics(full)),
                cap_form(pkg.power.parse_powermetrics(holey)))

    _, _, full, holey = both(case)
    n_pkg = full[0].index("package")
    assert len(holey[1][n_pkg]) == len(full[1][n_pkg]) - 2


def test_ingestion_refit_recovers_per_type_watts_within_5pct():
    def case(pkg):
        cap = pkg.power.parse_rapl_log(pkg.power.synthesize_rapl_log(
            _power(pkg), _schedule(pkg), sample_dt=0.25))
        windows = pkg.power.windows_from_schedule(_schedule(pkg), cap)
        samples = pkg.control.samples_from_capture(windows)
        return windows, samples, pkg.control.fit_power_model(samples,
                                                             name="refit")

    _, _, fitted = both(case)
    truth = _power(PORT)
    for v in (tcore.BIG, tcore.LITTLE):
        assert fitted.busy_watts(v) == pytest.approx(truth.busy_watts(v),
                                                     rel=0.05)
        assert fitted.idle_watts(v) == pytest.approx(truth.idle_watts(v),
                                                     rel=0.05)


# ================================================== trace/capture alignment
def _info(pkg, pad=False):
    info = {"alpha": {"ctype": pkg.core.BIG, "freq": 1.0, "cores": 2},
            "beta": {"ctype": pkg.core.LITTLE, "freq": 1.0, "cores": 1}}
    if pad:
        info["pad"] = {"ctype": pkg.core.LITTLE, "freq": 1.0, "cores": 1}
    return info


def _span(name, cat, ts_us, dur_us, tid=1, args=None):
    e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
         "ts": ts_us, "dur": dur_us}
    if args:
        e["args"] = args
    return e


@pytest.mark.parametrize("crowded", [False, True])
def test_capture_windows_from_trace_aligns_and_clamps(crowded):
    if crowded:
        events = [_span("w", "window", 0.0, 1e6, args={"index": 0}),
                  _span("beta", "frame", 0.0, 0.7e6, tid=1),
                  _span("beta", "frame", 0.0, 0.7e6, tid=2)]
    else:
        events = [_span("w", "window", 0.0, 1e6, args={"index": 0}),
                  _span("alpha", "frame", 0.0, 0.4e6, tid=1),
                  _span("alpha", "frame", 0.0, 0.4e6, tid=2),
                  _span("beta", "frame", 0.8e6, 0.4e6, tid=3),
                  _span("ignored", "frame", 0.0, 1e6, tid=4)]

    def case(pkg):
        cap = pkg.power.PowerCapture([pkg.power.PowerSample(0.0, 1.0, 2.0)])
        return pkg.power.capture_windows_from_trace(events, cap, _info(pkg))

    (win,) = both(case)
    assert (win.t0, win.t1) == (0.0, 1.0)
    if crowded:
        assert win.busy_s[(tcore.LITTLE, 1.0)] == pytest.approx(
            win.alloc_s[tcore.LITTLE])
    else:
        assert win.alloc_s == {tcore.BIG: 2.0, tcore.LITTLE: 1.0}
        assert win.busy_s[(tcore.BIG, 1.0)] == pytest.approx(0.8)


# ======================================================= energy attribution
def test_attribution_closure_busy_weighted():
    events = [_span("alpha", "frame", 0.0, 0.5e6, tid=1),
              _span("beta", "frame", 0.0, 0.25e6, tid=2)]

    def case(pkg):
        cap = pkg.power.PowerCapture([pkg.power.PowerSample(0.0, 1.0, 3.0)])
        return pkg.obs.attribute_energy(events, cap)

    attr = both(case)
    assert attr.measured_j == pytest.approx(1.5)
    assert attr.unattributed_j == pytest.approx(1.5)
    by_name = {s.name: s.attributed_j for s in attr.stages}
    assert by_name == {"alpha": pytest.approx(1.0),
                       "beta": pytest.approx(0.5)}


def test_attribution_with_model_reconciles_prediction():
    busy = {"alpha": 0.6, "beta": 0.9}
    events = [_span("alpha", "frame", 0.0, busy["alpha"] / 2 * 1e6, tid=1),
              _span("alpha", "frame", 0.0, busy["alpha"] / 2 * 1e6, tid=2),
              _span("beta", "frame", 0.0, busy["beta"] * 1e6, tid=3),
              _span("pad", "frame", 0.0, 1e6, tid=4)]

    def case(pkg):
        power, big, little = _power(pkg), pkg.core.BIG, pkg.core.LITTLE
        predicted = {
            "alpha": busy["alpha"] * power.busy_watts(big)
            + (2.0 - busy["alpha"]) * power.idle_watts(big),
            "beta": busy["beta"] * power.busy_watts(little)
            + (1.0 - busy["beta"]) * power.idle_watts(little),
            "pad": power.busy_watts(little)}
        cap = pkg.power.PowerCapture([pkg.power.PowerSample(
            0.0, 1.0, sum(predicted.values()))])
        return pkg.obs.attribute_energy(events, cap,
                                        stage_info=_info(pkg, pad=True),
                                        power=power), predicted

    attr, predicted = both(case)
    assert attr.prediction_error == pytest.approx(0.0, abs=1e-9)
    for s in attr.stages:
        assert s.attributed_j == pytest.approx(predicted[s.name])


def test_attribution_reports_energy_outside_trace_extent():
    events = [_span("alpha", "frame", 0.0, 1e6, tid=1)]

    def case(pkg):
        cap = pkg.power.PowerCapture([pkg.power.PowerSample(0.0, 4.0, 8.0)])
        return pkg.obs.attribute_energy(events, cap)

    attr = both(case)
    assert attr.measured_j == pytest.approx(2.0)
    assert attr.unattributed_j == pytest.approx(6.0)
