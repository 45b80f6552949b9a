"""The port's serving engine against the JAX reference's on the CPU, for the
dense, ssm and hybrid smoke configs: the same requests give the same tokens
in fp32, mid-run admission is exact, a reused slot starts clean, and
deadline handling and observability match."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402

from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.obs import MetricsRegistry, Tracer  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro.serve import SimClock as JaxClock  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.obs import Tracer as PortTracer  # noqa: E402
from repro_torch.serve import Request, ServeEngine, SimClock, step_need_s  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402

# dense, the Mamba2 stack, and the zamba2 hybrid (whose lane reset must wipe
# the SSM conv/state leaves as well as the shared attention's K/V)
ARCHS = ["stablelm-3b", "phi3-medium-14b", "mamba2-1.3b", "zamba2-7b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(jax model, jax params, port model, port params) for one arch."""
    jm = JaxModel(jax_smoke(request.param))
    jp = jm.init(0)
    cfg = get_smoke_config(request.param)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, Model(cfg), tp


def _serve(engine_cls, req_cls, model, params, specs, slots, **kw):
    engine = engine_cls(model, params, batch_slots=slots, max_len=64, **kw)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    return engine, reqs


def _solo(model, params, prompt, n_new):
    return _serve(ServeEngine, Request, model, params, [(prompt, n_new)],
                  1)[1][0].out


def test_engine_matches_reference_engine(models):
    """Five requests through two slots (so three are admitted mid-run into
    freed slots): the port's tokens equal the reference engine's."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, 256, n).tolist(), m)
             for n, m in ((3, 5), (6, 2), (2, 7), (4, 4), (5, 3))]
    _, ours = _serve(ServeEngine, Request, tm, tp, specs, 2)
    _, ref = _serve(JaxEngine, JaxRequest, jm, jp, specs, 2)
    assert [r.out for r in ours] == [r.out for r in ref]
    assert all(r.done and len(r.out) == n for r, (_, n) in zip(ours, specs))


@pytest.mark.parametrize("offset", [1, 3, 6])
def test_mid_run_admission_byte_identical(models, offset):
    """A request admitted while another is mid-decode produces exactly the
    tokens it would produce served alone (and the reference's)."""
    jm, jp, tm, tp = models
    long = Request(rid=0, prompt=[5, 9, 2, 4], max_new_tokens=12)
    late = Request(rid=1, prompt=[7, 1, 3], max_new_tokens=5)
    engine = ServeEngine(tm, tp, batch_slots=2, max_len=64)
    engine.submit(long)
    for _ in range(offset):          # the long request runs alone first...
        engine.step()
    engine.submit(late)              # ...then the late one joins mid-run
    engine.run_until_idle()
    assert long.out == _solo(tm, tp, long.prompt, long.max_new_tokens)
    assert late.out == _solo(tm, tp, late.prompt, late.max_new_tokens)
    _, (jlate,) = _serve(JaxEngine, JaxRequest, jm, jp, [(late.prompt, 5)], 1)
    assert late.out == jlate.out


def test_slot_reuse_resets_lane(models):
    """A slot freed by a finished request and re-used by a later one does
    not leak stale cache state into the newcomer's tokens."""
    _, _, tm, tp = models
    engine, (a, b) = _serve(ServeEngine, Request, tm, tp,
                            [([5, 9], 3), ([7, 1, 3], 4)], 1)
    assert a.done and b.done
    assert b.out == _solo(tm, tp, b.prompt, b.max_new_tokens)
    assert engine.cache["pos"].tolist() == [3 + 4 - 1]


def test_planner_raises():
    """``ServeEngine(planner=...)`` admits and paces as the reference
    engine does (the same rejections, admission and finish times, tokens
    and plan point on the sim clock), and an unknown ``pace`` raises the
    reference's ValueError."""
    from repro.configs.dvbs2 import serving_preset as jax_preset
    from repro.serve import AdmissionPlanner as JaxPlanner
    from repro_torch.configs.dvbs2 import serving_preset
    from repro_torch.serve import AdmissionPlanner

    jm = JaxModel(jax_smoke("stablelm-3b"))
    jp = jm.init(0)
    cfg = get_smoke_config("stablelm-3b")
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    with pytest.raises(ValueError, match="pace"):
        ServeEngine(tm, tp, pace="bogus")

    def run(engine_cls, req_cls, clock_cls, planner_cls, preset, model,
            params):
        planner = planner_cls(frontier=preset["frontier"], time_scale=2e-4,
                              cap_w=preset["cap_w"], safety=1.5)
        engine = engine_cls(model, params, batch_slots=2, max_len=64,
                            clock=clock_cls(), planner=planner)
        reqs = [req_cls(rid=i, prompt=[1 + i, 2 + i], max_new_tokens=3,
                        deadline_s=d, arrival_s=0.0)
                for i, d in enumerate((30.0, 2.0, 6.0, 0.5, 60.0))]
        for r in reqs:
            engine.submit(r)
        engine.run_until_idle()
        return [(r.out, r.rejected, r.missed, r.admitted_s, r.finished_s)
                for r in reqs], (engine.plan_point.period,
                                 engine.plan_point.energy,
                                 engine.plan_feasible, engine.clock.now())

    got = run(ServeEngine, Request, SimClock, AdmissionPlanner,
              serving_preset("mac"), tm, tp)
    want = run(JaxEngine, JaxRequest, JaxClock, JaxPlanner,
               jax_preset("mac"), jm, jp)
    assert got == want
    outcomes = got[0]
    assert any(o[1] for o in outcomes) and not all(o[1] for o in outcomes)
    assert not any(o[2] for o in outcomes)


def test_deadlines_on_sim_clock_match_reference(models):
    """Without a planner both engines reject a queued request that can no
    longer meet its deadline at the fixed step time, on the deterministic
    clock, and admit the others."""
    jm, jp, tm, tp = models

    def run(engine_cls, req_cls, clock_cls, model, params):
        engine = engine_cls(model, params, batch_slots=1, max_len=64,
                            clock=clock_cls(), step_time_s=0.5)
        reqs = [req_cls(rid=0, prompt=[1, 2], max_new_tokens=3,
                        deadline_s=2.5),
                req_cls(rid=1, prompt=[3], max_new_tokens=2, deadline_s=1.0),
                req_cls(rid=2, prompt=[4, 5], max_new_tokens=2,
                        deadline_s=100.0)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_idle()
        return engine, [(r.out, r.done, r.rejected, r.missed, r.finished_s)
                        for r in reqs]

    ours, got = run(ServeEngine, Request, SimClock, tm, tp)
    _, want = run(JaxEngine, JaxRequest, JaxClock, jm, jp)
    assert got == want
    assert [g[2] for g in got] == [False, True, False]
    assert not any(g[3] for g in got)
    assert [g[4] for g in got] == [2.0, None, 3.5]
    assert ours.clock.now() == pytest.approx(0.5 * (4 + 3))
    assert step_need_s(3.0, 1.0, 4) == 0.5
    assert ours.min_step_need_s() == float("inf")


def test_engine_emits_trace_and_metrics():
    tm = Model(get_smoke_config("stablelm-3b"))
    tp = tm.init(0, device="cpu")
    tracer, metrics = Tracer(), MetricsRegistry()
    _serve(ServeEngine, Request, tm, tp, [([1, 2], 3), ([2, 3], 3)], 2,
           tracer=tracer, metrics=metrics)
    events = tracer.drain()
    steps = [e for e in events if e.name == "serve/step"]
    assert steps and all(e.ph == "X" and e.cat == "serve" for e in steps)
    assert steps[0].args["active"] == 2
    assert any(e.name == "serve/active_slots" for e in events)
    assert metrics.counter("serve/tokens") == 6
    assert metrics.counter("serve/requests_done") == 2
    hist = metrics.snapshot()["histograms"]["serve/step_s"]
    assert hist["count"] == len(steps) and hist["p99"] > 0


# five requests through two slots: three are admitted mid-run
PHASE_SPECS = [([1, 2, 3], 4), ([4, 5], 3), ([6, 7, 8, 9], 2), ([3], 5),
               ([2, 2], 3)]
STEP_PHASES = ("serve/admit", "serve/feed", "serve/replay", "serve/wait",
               "serve/emit")


@pytest.fixture(scope="module")
def smoke_lm():
    tm = Model(get_smoke_config("stablelm-3b"))
    return tm, tm.init(0, device="cpu")


def _inside(inner, outer):
    return outer.ts <= inner.ts and \
        inner.ts + inner.dur <= outer.ts + outer.dur


def test_step_phases_nest_in_and_tile_the_step(smoke_lm):
    """Each ``serve/step`` holds one span of each phase, in order, and
    they tile it; every ``serve/lane_reset`` lies inside a
    ``serve/admit`` that admitted, one per admission."""
    tracer = PortTracer()
    _serve(ServeEngine, Request, *smoke_lm, PHASE_SPECS, 2, tracer=tracer)
    spans = [e for e in tracer.drain() if e.ph == "X"]
    steps = [e for e in spans if e.name == "serve/step"]
    assert len(steps) > 10
    for step in steps:
        kids = [e for e in spans if e.cat == "serve" and e is not step
                and _inside(e, step) and e.name in STEP_PHASES]
        assert [e.name for e in kids] == list(STEP_PHASES)
        for a, b in zip(kids, kids[1:]):
            assert a.ts + a.dur == pytest.approx(b.ts, abs=1e-9)
        assert sum(e.dur for e in kids) == pytest.approx(step.dur, rel=0.05)
        assert kids[0].ts == step.ts
    admits = [e for e in spans if e.name == "serve/admit"]
    resets = [e for e in spans if e.name == "serve/lane_reset"]
    assert len(resets) == len(PHASE_SPECS) \
        == sum(e.args["admitted"] for e in admits)
    for r in resets:
        (admit,) = [a for a in admits if _inside(r, a)]
        assert admit.args["admitted"] >= 1
    assert sorted(r.args["rid"] for r in resets) == list(range(5))
    assert {r.args["slot"] for r in resets} == {0, 1}


def test_requests_stamp_first_token_and_record_their_phases(smoke_lm):
    """Every finished request has ``admitted_s <= first_token_s <=
    finished_s``; its ``serve/queued``, ``serve/prompt`` and
    ``serve/decode`` spans share its ``rid`` and follow one another from
    its arrival to its finish."""
    tracer = PortTracer()
    _, reqs = _serve(ServeEngine, Request, *smoke_lm, PHASE_SPECS, 2,
                     tracer=tracer)
    spans = [e for e in tracer.drain() if e.cat == "request"]
    for r in reqs:
        assert r.done
        assert r.admitted_s <= r.first_token_s <= r.finished_s
        mine = sorted((e for e in spans if e.args["rid"] == r.rid),
                      key=lambda e: e.ts)
        assert [e.name for e in mine] == ["serve/queued", "serve/prompt",
                                          "serve/decode"]
        queued, prompt, decode = mine
        assert queued.ts == r.arrival_s
        assert queued.ts + queued.dur == pytest.approx(r.admitted_s) \
            == prompt.ts
        assert prompt.ts + prompt.dur == pytest.approx(r.first_token_s) \
            == decode.ts
        assert decode.ts + decode.dur == pytest.approx(r.finished_s)


def test_request_spans_only_on_the_wall_clock(smoke_lm):
    """Under a :class:`SimClock` the first-token stamp is on the engine
    clock and no request span is recorded (the tracer's clock is the
    wall clock); the step's phases still are."""
    tracer = PortTracer()
    _, reqs = _serve(ServeEngine, Request, *smoke_lm, PHASE_SPECS, 2,
                     tracer=tracer, clock=SimClock(), step_time_s=0.5)
    for r in reqs:
        assert r.admitted_s <= r.first_token_s <= r.finished_s
        assert (r.first_token_s / 0.5).is_integer()
    events = tracer.drain()
    assert not any(e.cat == "request" for e in events)
    assert any(e.name == "serve/wait" for e in events)


def test_untraced_engine_serves_the_same_and_records_nothing(smoke_lm,
                                                            monkeypatch):
    """With no tracer, or a disabled one, the engine serves the same
    tokens as with an enabled one, stamps the same request fields, records
    nothing, and reads the clock no more often than without spans."""
    reads = []
    clock = engine_mod.time.perf_counter

    def counted():
        reads.append(1)
        return clock()

    runs = {}
    for name, tracer in (("none", None), ("off", PortTracer(enabled=False)),
                         ("on", PortTracer())):
        reads.clear()
        monkeypatch.setattr(engine_mod.time, "perf_counter", counted)
        engine, reqs = _serve(ServeEngine, Request, *smoke_lm, PHASE_SPECS,
                              2, tracer=tracer)
        monkeypatch.setattr(engine_mod.time, "perf_counter", clock)
        runs[name] = ([r.out for r in reqs], len(reads),
                      tracer.drain() if tracer is not None else [])
        assert all(r.first_token_s is not None for r in reqs)
    assert runs["none"][0] == runs["off"][0] == runs["on"][0]
    assert runs["off"][2] == [] and runs["on"][2]
    assert runs["none"][1] == runs["off"][1] < runs["on"][1]


def _sched_perf_specs():
    """``benchmarks/sched_perf.py``'s serve arm: 16 requests of 2-4 prompt
    tokens and 4-16 new tokens, drawn from seed 11 in its order."""
    rng = np.random.default_rng(11)
    return [([1] * int(rng.integers(2, 5)), int(rng.integers(4, 17)))
            for _ in range(16)]


def _steps_and_tokens(engine_cls, req_cls, model, params, admit_mode):
    engine = engine_cls(model, params, batch_slots=4, max_len=64,
                        admit_mode=admit_mode)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(_sched_perf_specs())]
    for r in reqs:
        engine.submit(r)
    steps = 0
    while engine.queue or any(s is not None for s in engine.slots):
        engine.step()
        steps += 1
    return steps, [r.out for r in reqs]


@pytest.mark.parametrize("admit_mode", ["continuous", "step0"])
def test_admit_mode_matches_reference(models, admit_mode):
    """Both admission modes on ``sched_perf``'s 16 requests through 4
    slots: the port's step count and every request's tokens equal the
    reference engine's."""
    jm, jp, tm, tp = models
    got = _steps_and_tokens(ServeEngine, Request, tm, tp, admit_mode)
    want = _steps_and_tokens(JaxEngine, JaxRequest, jm, jp, admit_mode)
    assert got == want
    assert all(len(out) == n for out, (_, n) in zip(got[1],
                                                    _sched_perf_specs()))


def test_continuous_admission_needs_no_more_steps():
    """``sched_perf``'s check: refilling freed slots every step drains the
    queue in fewer steps than refilling only when every slot is empty,
    with the same tokens (each request's are its solo run's); an unknown
    mode raises the reference's ValueError, and ``admit_mode`` is the 9th
    positional parameter in both packages."""
    import inspect

    tm = Model(get_smoke_config("stablelm-3b"))
    tp = tm.init(0, device="cpu")
    cont, cont_out = _steps_and_tokens(ServeEngine, Request, tm, tp,
                                       "continuous")
    step0, step0_out = _steps_and_tokens(ServeEngine, Request, tm, tp,
                                         "step0")
    assert cont < step0 and cont_out == step0_out
    with pytest.raises(ValueError, match="admit_mode"):
        ServeEngine(tm, tp, admit_mode="bogus")
    assert list(inspect.signature(ServeEngine).parameters) == \
        list(inspect.signature(JaxEngine).parameters)
    engine = ServeEngine(tm, tp, 4, 64, None, None, None, None, "step0")
    assert engine.admit_mode == "step0" and engine.pace == "planner"


def test_min_step_need_s_include_queued_matches_reference():
    """On the sim clock with one slot: the admitted request's deadline and
    the queued ones' give the reference's values with and without
    ``include_queued``; a queued deadline tighter than the admitted one
    sets the minimum only when queued deadlines are included."""
    jm = JaxModel(jax_smoke("stablelm-3b"))
    jp = jm.init(0)
    cfg = get_smoke_config("stablelm-3b")
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")

    def run(engine_cls, req_cls, clock_cls, model, params):
        engine = engine_cls(model, params, batch_slots=1, max_len=64,
                            clock=clock_cls(), step_time_s=0.25)
        for i, (d, n) in enumerate(((40.0, 6), (9.0, 3), (None, 2),
                                    (30.0, 5))):
            engine.submit(req_cls(rid=i, prompt=[3, 1 + i],
                                  max_new_tokens=n, deadline_s=d))
        out = [(engine.min_step_need_s(), engine.min_step_need_s(False))]
        for _ in range(3):
            engine.step()
            out.append((engine.min_step_need_s(),
                        engine.min_step_need_s(include_queued=False)))
        return out

    got = run(ServeEngine, Request, SimClock, tm, tp)
    want = run(JaxEngine, JaxRequest, JaxClock, jm, jp)
    assert got == want
    assert got[0] == (step_need_s(9.0, 0.0, 4), float("inf"))
    assert got[1][0] < got[1][1] == step_need_s(40.0, 0.25, 6)
