"""SLO-governed serving in the port against the reference: the admission
planner (``repro_torch.serve.slo``) on a grid of needs and caps,
``ServeEngine`` with a planner under both paces on the stablelm-3b and
gemma3-1b smoke models in fp32 (the reference's weights carried by
``convert.params_from_jax``), and ``run_serve_scenario`` with the constants
of ``examples/serve_pipeline.py``: the governed and the max-performance arm
equal the reference's field by field and meet the example's acceptance."""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402

from _torch_parity import canon, outcome  # noqa: E402

import repro.configs.dvbs2 as jdvbs2  # noqa: E402
import repro.control as jcontrol  # noqa: E402
import repro.energy as jenergy  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.serve as jserve  # noqa: E402
from repro.core import make_chain as jmake_chain  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
import repro_torch.configs.dvbs2 as tdvbs2  # noqa: E402
import repro_torch.control as tcontrol  # noqa: E402
import repro_torch.energy as tenergy  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import make_chain  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

REF = types.SimpleNamespace(serve=jserve, control=jcontrol, energy=jenergy,
                            dvbs2=jdvbs2, obs=jobs, make_chain=jmake_chain)
PORT = types.SimpleNamespace(serve=tserve, control=tcontrol, energy=tenergy,
                             dvbs2=tdvbs2, obs=tobs, make_chain=make_chain)

# the constants of examples/serve_pipeline.py
TIME_SCALE = 2e-6
N_WINDOWS = 10
SAFETY = 1.5
INFLATION_AT = ((6, 1.3),)


# ----------------------------------------------------------------- planner
def _frontiers(pkg):
    """The mac serving frontier, and DVFS / nominal frontiers of seeded
    random chains."""
    e = pkg.energy
    out = [pkg.dvbs2.serving_preset("mac")["frontier"]]
    for seed, ladder in ((3, (1.0,)), (7, (0.5, 0.75, 1.0)), (11, (0.6, 1.0))):
        chain = pkg.make_chain(np.random.default_rng(seed), 4, 0.5)
        power = e.PowerModel("slo", e.DEFAULT_POWER.big,
                             e.DEFAULT_POWER.little, freq_levels=ladder)
        out.append(e.dvfs_frontier(chain, 2, 2, power) if len(ladder) > 1
                   else e.pareto_frontier(chain, 2, 2, power))
    return out


@pytest.mark.parametrize("index", range(4))
@pytest.mark.parametrize("time_scale", [1e-4, TIME_SCALE])
def test_admission_planner_matches_reference(index, time_scale):
    fronts = {"ref": _frontiers(REF)[index], "port": _frontiers(PORT)[index]}
    assert canon(fronts["port"]) == canon(fronts["ref"])
    front = fronts["ref"]
    watts = [pt.energy / pt.period for pt in front]
    caps = [w * f for w in watts for f in (0.999, 1.0, 1.001)] + [
        min(watts) * 0.5, max(watts) * 2.0]
    needs = [pt.period * time_scale * f for pt in front
             for f in (0.5, 0.999, 1.0, 1.001, 1.7)] + [math.inf, 0.0, -1.0]
    picked = 0
    for cap in caps:
        planners = {
            key: pkg.serve.AdmissionPlanner(frontier=fronts[key],
                                            time_scale=time_scale,
                                            cap_w=cap, safety=1.5)
            for key, pkg in (("ref", REF), ("port", PORT))}
        for need in needs:
            got = outcome(planners["port"].select, need)
            assert got == outcome(planners["ref"].select, need)
            picked += got is not None
            assert outcome(planners["port"].plan_admission, [need]) == \
                outcome(planners["ref"].plan_admission, [need])
        for group in (needs[:3], needs[-4:-1], []):
            assert outcome(planners["port"].plan_admission, group) == \
                outcome(planners["ref"].plan_admission, group)
        assert canon(planners["port"].max_perf()) == \
            canon(planners["ref"].max_perf())
    assert picked > 0
    assert tserve.step_need_s(3.0, 1.0, 4, 1.5) == \
        jserve.step_need_s(3.0, 1.0, 4, 1.5)


def test_admission_planner_rejects_what_the_reference_rejects():
    front = tdvbs2.serving_preset("mac")["frontier"]
    for kw in ({"frontier": []}, {"time_scale": 0.0}, {"safety": 0.5}):
        args = dict(frontier=front, time_scale=1e-4, cap_w=30.0) | kw
        with pytest.raises(ValueError):
            tserve.AdmissionPlanner(**args)


# ------------------------------------------------------------------ models
@pytest.fixture(scope="module", params=["stablelm-3b", "gemma3-1b"])
def models(request):
    """(jax model, jax params, port model, port params), fp32 smoke."""
    jm = JaxModel(jax_smoke(request.param))
    jp = jm.init(0)
    cfg = get_smoke_config(request.param)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, Model(cfg), tp


def _engine_run(pkg, model, params, pace):
    """Seven requests with deadlines from loose to impossible, arriving
    over the run, through a 2-slot engine with an admission planner over
    the mac serving frontier."""
    s = pkg.serve
    preset = pkg.dvbs2.serving_preset("mac")
    planner = s.AdmissionPlanner(frontier=preset["frontier"],
                                 time_scale=2e-4, cap_w=preset["cap_w"],
                                 safety=SAFETY)
    fixed = preset["frontier"][2].period * 2e-4
    engine = s.ServeEngine(model, params, batch_slots=2, max_len=64,
                           clock=s.SimClock(), planner=planner, pace=pace,
                           step_time_s=fixed if pace == "fixed" else None)
    rng = np.random.default_rng(5)
    specs = [(0.0, 40.0), (0.0, 3.5), (0.2, 0.6), (0.5, 9.0), (1.0, 2.6),
             (1.5, 30.0), (2.0, 5.0)]
    reqs = []
    for i, (t, slack) in enumerate(specs):
        prompt = rng.integers(1, 256, 2 + i % 3).tolist()
        reqs.append(s.Request(rid=i, prompt=prompt, max_new_tokens=3 + i % 2,
                              deadline_s=t + slack, arrival_s=t))
    pending = list(reqs)
    for _ in range(500):
        while pending and pending[0].arrival_s <= engine.now() + 1e-12:
            engine.submit(pending.pop(0))
        if not engine.queue and not any(engine.slots):
            if not pending:
                break
            engine.clock.advance(pending[0].arrival_s - engine.now())
            continue
        engine.step()
    return reqs, engine


@pytest.mark.parametrize("pace", ["planner", "fixed"])
def test_engine_with_planner_matches_reference(models, pace):
    jm, jp, tm, tp = models
    ours, engine = _engine_run(PORT, tm, tp, pace)
    ref, jengine = _engine_run(REF, jm, jp, pace)
    assert canon(ours) == canon(ref)
    assert (canon(engine.plan_point), engine.plan_feasible,
            engine.clock.now(), engine.last_step_s) == \
        (canon(jengine.plan_point), jengine.plan_feasible,
         jengine.clock.now(), jengine.last_step_s)
    assert all(r.done for r in ours)
    assert any(r.rejected for r in ours) and not all(r.rejected for r in ours)
    for r in ours:
        if not r.rejected:
            assert not r.missed and r.finished_s <= r.deadline_s + 1e-9
            assert len(r.out) == r.max_new_tokens


# ---------------------------------------------------------------- scenario
def _scenario(pkg, model, params, governed):
    """One arm of examples/serve_pipeline.py's scenario."""
    preset = pkg.dvbs2.serving_preset("mac")
    c, s = pkg.control, pkg.serve
    gov = c.Governor(preset["chain"], preset["b"], preset["l"],
                     preset["power"], preset["budget"],
                     slo_period=preset["slo_period"], upshift_margin=0.02)
    planner = s.AdmissionPlanner(frontier=gov.frontier(),
                                 time_scale=TIME_SCALE,
                                 cap_w=preset["cap_w"], safety=SAFETY)
    engine = s.ServeEngine(model, params, batch_slots=4, max_len=64,
                           clock=s.SimClock(), planner=planner, pace="fixed",
                           metrics=pkg.obs.MetricsRegistry())
    arrivals = c.bursty_arrivals(N_WINDOWS, base_rate=1, burst_rate=4,
                                 burst_windows=(3, 4), latency_slo_s=0.5)
    return arrivals, c.run_serve_scenario(
        gov, engine, arrivals, time_scale=TIME_SCALE, n_windows=N_WINDOWS,
        window_dt=1.0, inflation_at=INFLATION_AT, governed=governed,
        metrics=engine.metrics)


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma3-1b"])
def test_serve_scenario_matches_reference_and_meets_acceptance(arch):
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(0)
    cfg = get_smoke_config(arch)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    res = {}
    for governed in (True, False):
        arrivals, ours = _scenario(PORT, tm, tp, governed)
        jarrivals, ref = _scenario(REF, jm, jp, governed)
        assert canon(arrivals) == canon(jarrivals)
        assert canon(ours) == canon(ref)
        assert ours.joules_per_token == ref.joules_per_token
        assert ours.describe() == ref.describe()
        res[governed] = ours
    gov, maxp = res[True], res[False]
    # the acceptance of examples/serve_pipeline.py
    assert gov.deadline_misses == 0 and maxp.deadline_misses == 0
    assert gov.completed == len(arrivals)
    assert any(e.trigger == "slo" for e in gov.replans)
    assert gov.joules_per_token < maxp.joules_per_token
    for r in gov.requests:
        assert len(r.out) == 8 and all(0 <= t < cfg.vocab for t in r.out)
