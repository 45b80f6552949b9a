"""The port's pipeline planner and streaming runtime
(``repro_torch.pipeline``) against ``repro.pipeline``.

Planner: every model config, every strategy, the reference's systems and
power caps, and the H100 class on phi3-medium-14b's prefill chain; plans,
stage tables, periods, chains and energy reports equal the reference's
with ``==`` (``_torch_parity.canon``). Runtime: the reference's cases of
``tests/test_pipeline.py`` and ``tests/test_control.py`` (order,
replication, work stealing, the plan-vs-measured period, queue wait,
exactly-once live handoff on both executors, drops across a rebuild,
stop, rebuild, the event schema, builder arity, timeouts), with the
reference's bounds, on the port's runtime; and the process executor's
guard against forking a process that initialised CUDA."""
import dataclasses
import itertools
import threading
import time

import pytest

from _hyp import given, settings, st
from _torch_parity import canon, outcome

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import repro.pipeline as J  # noqa: E402
from repro.core.variants import VariantRegistry as JVariantRegistry  # noqa: E402
from repro.models.config import get_config as jget  # noqa: E402
from repro_torch import pipeline as T  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BIG, LITTLE, STRATEGIES, TaskChain, herad)
from repro_torch.core.variants import VariantRegistry  # noqa: E402
from repro_torch.models.config import get_config, list_archs  # noqa: E402
from repro_torch.pipeline import (  # noqa: E402
    H100_CLASS,
    HeterogeneousSystem,
    StageSpec,
    StreamingPipelineRuntime,
    plan_pipeline,
)
from repro_torch.pipeline import runtime as truntime  # noqa: E402


# ================================================================ planner
def _plan_both(arch, b, l, **kw):
    """(port, reference) outcomes of one plan_pipeline call: the plan,
    its stage table and energy report, or the name of what it raised."""
    out = []
    systems = kw.pop("systems", None) or (
        T.HeterogeneousSystem.default(b, l),
        J.HeterogeneousSystem.default(b, l))
    for pkg, get, reg, system in ((T, get_config, VariantRegistry,
                                   systems[0]),
                                  (J, jget, JVariantRegistry, systems[1])):
        args = dict(kw)
        if args.get("variants") == "layers":
            registry = reg()
            for i in range(get(arch).n_layers):
                registry.register(f"layer{i}", "chunked", big=1.3,
                                  little=0.82)
            args["variants"] = registry

        def plan():
            p = pkg.plan_pipeline(get(arch), system=system, **args)
            return p, p.stage_table(), p.energy_report(system), \
                p.throughput_tokens_per_s(), p.energy_proxy_watts(system)

        out.append(outcome(plan))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_plans_like_reference(arch):
    ours, ref = _plan_both(arch, 8, 8, tokens_per_step=32, mode="decode")
    assert ours == ref
    assert ours[0][0] == "PipelinePlan"


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_every_strategy_plans_like_reference(strategy):
    kw = dict(tokens_per_step=32, mode="decode", strategy=strategy)
    if strategy == "variant_herad":
        kw["variants"] = "layers"
    ours, ref = _plan_both("stablelm-3b", 4, 4, **kw)
    assert ours == ref and ours[0][0] == "PipelinePlan"
    if strategy in ("freqherad", "variant_herad"):
        plan = plan_pipeline(get_config("stablelm-3b"),
                             system=HeterogeneousSystem.default(4, 4),
                             tokens_per_step=32, strategy=strategy,
                             variants=None)
        assert plan.freq_solution is not None
        assert {"freq", "variant"} <= set(plan.stage_table()[0])


@pytest.mark.parametrize("arch,b,l,tokens,mode", [
    ("gemma3-12b", 6, 8, 64, "decode"),
    ("stablelm-3b", 2, 14, 16, "decode"),
    ("stablelm-3b", 4, 12, 32, "decode"),
    ("stablelm-3b", 4, 6, 32, "decode"),
    ("phi3-medium-14b", 2, 2, 2048, "prefill"),
    ("mamba2-1.3b", 3, 1, 128, "train"),
    ("stablelm-3b", 0, 0, 32, "decode"),
])
def test_systems_plan_like_reference(arch, b, l, tokens, mode):
    ours, ref = _plan_both(arch, b, l, tokens_per_step=tokens, mode=mode)
    assert ours == ref
    if b + l == 0:
        assert ours == ("raised", "ValueError")
        return
    plan = plan_pipeline(get_config(arch),
                         system=HeterogeneousSystem.default(b, l),
                         tokens_per_step=tokens, mode=mode)
    sol = plan.solution
    assert sol.covers(plan.chain)
    assert sol.cores_used(BIG) <= b and sol.cores_used(LITTLE) <= l
    assert plan.period_us == sol.period(plan.chain)
    for st in sol.stages:  # ingest/emit are never replicated
        if not plan.chain.is_rep(st.start, st.end):
            assert st.cores == 1


@pytest.mark.parametrize("strategy", ["herad", "freqherad", "variant_herad"])
def test_power_cap_plans_like_reference(strategy):
    """The cap entry point: the fastest frontier plan under half the free
    plan's draw, a sequence of caps off one passed-in frontier, and the
    infeasible cap's raise."""
    cfg, jcfg = get_config("stablelm-3b"), jget("stablelm-3b")
    system, jsystem = (HeterogeneousSystem.default(4, 4),
                       J.HeterogeneousSystem.default(4, 4))
    free = plan_pipeline(cfg, system=system, tokens_per_step=32)
    cap = free.energy_report(system).avg_watts * 0.5
    kw = dict(tokens_per_step=32, strategy=strategy)
    if strategy == "variant_herad":
        kw["variants"] = "layers"
    for c in (cap, cap * 1.5, 1e-6):
        ours, ref = _plan_both("stablelm-3b", 4, 4, power_cap_w=c, **kw)
        assert ours == ref
    capped = plan_pipeline(cfg, system=system, tokens_per_step=32,
                           power_cap_w=cap)
    assert capped.energy_report(system).avg_watts <= cap + 1e-9
    assert capped.period_us >= free.period_us - 1e-9
    with pytest.raises(ValueError, match="fits under"):
        plan_pipeline(cfg, system=system, tokens_per_step=32,
                      power_cap_w=1e-6)
    # frontier pass-through: the same plans without a re-sweep
    from repro.energy.model import PowerModel as JPowerModel
    from repro.energy.pareto import pareto_frontier as jfrontier
    from repro_torch.energy.model import PowerModel
    from repro_torch.energy.pareto import pareto_frontier

    front = pareto_frontier(capped.chain, 4, 4,
                            PowerModel.from_device_classes(system))
    jfront = jfrontier(J.model_chain(jcfg, tokens_per_step=32,
                                     mode="decode", system=jsystem)[0], 4, 4,
                       JPowerModel.from_device_classes(jsystem))
    assert canon(front) == canon(jfront)
    for c in (cap, cap * 1.5):
        assert canon(plan_pipeline(cfg, system=system, tokens_per_step=32,
                                   power_cap_w=c, frontier=front)) == \
            canon(J.plan_pipeline(jcfg, system=jsystem, tokens_per_step=32,
                                  power_cap_w=c, frontier=jfront))


@pytest.mark.parametrize("b,l,stages", [(1, 0, [(0, 43, 1)]),
                                        (2, 2, None)])
def test_h100_class_plans_like_reference(b, l, stages):
    """phi3-medium-14b's prefill chain of 2048 tokens with both classes
    the H100 (datasheet rates): one stage of all 44 tasks on one card;
    on 2 + 2 the reference's three stages, the middle one replicated."""
    cls = dataclasses.astuple(H100_CLASS)
    jcls = J.planner.DeviceClass(*cls)
    assert canon(jcls) == canon(H100_CLASS)
    systems = (HeterogeneousSystem(dataclasses.replace(H100_CLASS, count=b),
                                   dataclasses.replace(H100_CLASS, count=l)),
               J.HeterogeneousSystem(dataclasses.replace(jcls, count=b),
                                     dataclasses.replace(jcls, count=l)))
    ours, ref = _plan_both("phi3-medium-14b", b, l, tokens_per_step=2048,
                           mode="prefill", systems=systems)
    assert ours == ref and ours[0][0] == "PipelinePlan"
    plan = plan_pipeline(get_config("phi3-medium-14b"), system=systems[0],
                         tokens_per_step=2048, mode="prefill")
    got = [(s.start, s.end, s.cores) for s in plan.solution.stages]
    assert len(plan.chain.names) == 44
    if stages is not None:
        assert got == stages
    else:
        assert len(got) == 3 and got[1][2] == 2
        assert plan.chain.names[got[1][0]].startswith("layer")
        assert plan.period_us < plan.chain.stage_sum(0, 43, "B")


@pytest.mark.parametrize("mode", ["prefill", "decode", "train"])
def test_h100_chain_like_reference(mode):
    """The H100 class's chain weights for phi3-medium-14b in every mode."""
    system = HeterogeneousSystem(dataclasses.replace(H100_CLASS, count=1),
                                 dataclasses.replace(H100_CLASS, count=0))
    jcls = J.planner.DeviceClass(*dataclasses.astuple(H100_CLASS))
    jsystem = J.HeterogeneousSystem(dataclasses.replace(jcls, count=1),
                                    dataclasses.replace(jcls, count=0))
    assert canon(T.model_chain(get_config("phi3-medium-14b"),
                               tokens_per_step=2048, mode=mode,
                               system=system)) == \
        canon(J.model_chain(jget("phi3-medium-14b"), tokens_per_step=2048,
                            mode=mode, system=jsystem))


def test_planner_prefers_little_on_ties():
    plan = plan_pipeline(get_config("stablelm-3b"),
                         system=HeterogeneousSystem.default(2, 14),
                         tokens_per_step=16, mode="decode")
    assert plan.solution.cores_used(LITTLE) >= plan.solution.cores_used(BIG)


def test_elastic_replan_after_device_loss():
    cfg = get_config("stablelm-3b")
    before = plan_pipeline(cfg, system=HeterogeneousSystem.default(4, 12),
                           tokens_per_step=32, mode="decode")
    after = plan_pipeline(cfg, system=HeterogeneousSystem.default(4, 6),
                          tokens_per_step=32, mode="decode")
    assert after.solution.cores_used(LITTLE) <= 6
    assert after.period_us >= before.period_us - 1e-9


# ================================================================ runtime
def _toy_plan(b: int, l: int):
    """A tiny real plan (two replicable tasks) for rebuild tests."""
    ch = TaskChain([2.0, 2.0], [4.0, 4.0], [True, True])

    class P:
        solution = herad(ch, b, l)
        chain = ch

    assert not P.solution.is_empty()
    return P


def small_chain() -> TaskChain:
    return TaskChain(w_big=[10.0, 40.0, 40.0, 10.0],
                     w_little=[25.0, 100.0, 100.0, 25.0],
                     replicable=[False, True, True, False])


class _Plan:
    chain = small_chain()

    def __init__(self, sol):
        self.solution = sol


def test_runtime_preserves_order_and_applies_stages():
    stages = [StageSpec("double", lambda x: x * 2, replicas=2),
              StageSpec("inc", lambda x: x + 1, replicas=1)]
    rt = StreamingPipelineRuntime(stages).start()
    res = rt.run(list(range(40)))
    rt.stop()
    assert res["outputs"] == [x * 2 + 1 for x in range(40)]


def test_runtime_replication_speeds_up_bottleneck():
    def slow(x):
        time.sleep(0.004)
        return x

    r1 = StreamingPipelineRuntime([StageSpec("s", slow, replicas=1)]).start()
    p1 = r1.run(list(range(30)), warmup=5)["period_s"]
    r1.stop()
    r3 = StreamingPipelineRuntime([StageSpec("s", slow, replicas=3)]).start()
    p3 = r3.run(list(range(30)), warmup=5)["period_s"]
    r3.stop()
    assert p3 < p1 / 1.7


def test_runtime_work_stealing_absorbs_straggler():
    stages = [StageSpec("s", lambda x: (time.sleep(0.003), x)[1], replicas=3,
                        delays=(0.0, 0.0, 0.03))]
    rt = StreamingPipelineRuntime(stages).start()
    res = rt.run(list(range(60)), warmup=6)
    rt.stop()
    counts = {k[1]: v for k, v in res["replica_counts"].items()}
    assert counts[2] < counts[0] / 2
    assert sum(counts.values()) == 60


def test_plan_runtime_integration_matches_predicted_period():
    w_big = [2.0, 6.0, 6.0, 2.0]   # ms
    ch = TaskChain(w_big, [4.0, 12.0, 12.0, 4.0], [False, True, True, False])
    sol = herad(ch, 3, 2)

    class FakePlan:
        solution = sol
        chain = ch

    def builder(s, e):
        def fn(x):
            time.sleep(sum(w_big[i] for i in range(s, e + 1)) / 1e3)
            return x
        return fn

    rt = StreamingPipelineRuntime.from_plan(FakePlan, builder).start()
    res = rt.run(list(range(40)), warmup=8)
    rt.stop()
    assert res["period_s"] * 1e3 == pytest.approx(sol.period(ch), rel=0.5)


def test_runtime_reports_queue_wait_for_bottleneck_stage():
    stages = [StageSpec("fast_in", lambda x: x),
              StageSpec("slow_mid", lambda x: (time.sleep(0.004), x)[1]),
              StageSpec("fast_out", lambda x: x)]
    rt = StreamingPipelineRuntime(stages).start()
    res = rt.run(list(range(40)), warmup=5)
    rt.stop()
    waits, busy = res["queue_wait_s"], res["busy_s"]
    assert set(waits) == set(busy)
    assert all(w >= 0.0 for w in waits.values())
    mid, out = waits[("slow_mid", 0)], waits[("fast_out", 0)]
    assert mid > 10 * max(out, 1e-9)
    assert mid > 0.05


def test_runtime_energy_metering_from_plan_power():
    """``from_plan(power=)`` meters busy time at busy watts and the rest
    of the window at idle watts, as ``measured_energy_j`` says."""
    from repro_torch.energy import CoreTypePower, PowerModel

    power = PowerModel("t", CoreTypePower(0.5, 4.5), CoreTypePower(0.1, 0.9))
    plan = _toy_plan(1, 1)
    rt = StreamingPipelineRuntime.from_plan(
        plan, lambda s, e: (lambda x: (time.sleep(0.002), x)[1]),
        power=power).start()
    res = rt.run(list(range(10)))
    rt.stop()
    assert res["energy_j"] == rt.measured_energy_j(res["total_s"],
                                                   res["busy_s"])
    assert res["avg_power_w"] == res["energy_j"] / res["total_s"]
    assert [s.busy_watts for s in rt.stages] == [
        power.busy_watts(st.ctype) for st in plan.solution.stages]


def _handoff_roundtrip(executor: str, rebuild_gaps_ms, n_frames: int = 60):
    plan_a, plan_b = _toy_plan(2, 0), _toy_plan(1, 1)

    def builder(s, e):
        def fn(x):
            time.sleep(0.001)
            return x * 3 + 1
        return fn

    rt = StreamingPipelineRuntime.from_plan(
        plan_a, builder, queue_depth=4, executor=executor).start()
    box = {}

    def go():
        box["res"] = rt.run(list(range(n_frames)), timeout_s=60.0)

    th = threading.Thread(target=go)
    th.start()
    plans = itertools.cycle([plan_b, plan_a])
    for gap in rebuild_gaps_ms:
        time.sleep(gap / 1000.0)
        rt.rebuild(next(plans))
    th.join(120.0)
    rt.stop()
    res = box["res"]
    assert res["frames_dropped"] == 0
    assert res["seq_ids"] == sorted(res["seq_ids"])
    assert len(set(res["seq_ids"])) == n_frames
    want = list(range(n_frames))
    for _ in range(len(plan_a.solution.stages)):
        want = [x * 3 + 1 for x in want]
    assert res["outputs"] == want


@pytest.mark.parametrize("executor", ["thread", "process"])
@pytest.mark.parametrize("gaps", [[5, 12, 7], [1], [30, 2]])
def test_live_handoff_exactly_once(executor, gaps):
    _handoff_roundtrip(executor, gaps, n_frames=60 if len(gaps) == 3 else 40)


@settings(deadline=None, max_examples=6)
@given(
    executor=st.sampled_from(["thread", "process"]),
    gaps=st.lists(st.integers(1, 30), min_size=1, max_size=3),
)
def test_live_handoff_exactly_once_property(executor, gaps):
    """Randomized rebuild instants: the fence/handoff protocol preserves
    sink ordering and exactly-once delivery on both worker backends."""
    _handoff_roundtrip(executor, gaps, n_frames=40)


def test_timeout_drops_counted_exactly_once_across_rebuild():
    plan = _toy_plan(2, 0)
    gate = threading.Event()

    def builder(s, e):
        def fn(x):
            gate.wait(10.0)
            return x
        return fn

    rt = StreamingPipelineRuntime.from_plan(plan, builder,
                                            queue_depth=8).start()
    res1 = rt.run(list(range(6)), timeout_s=0.3)
    assert res1["frames_dropped"] == 6
    assert res1["outputs"] == []
    rt.rebuild(_toy_plan(1, 1))
    gate.set()
    res2 = rt.run(list(range(4)), timeout_s=30.0)
    rt.stop()
    assert res2["outputs"] == list(range(4))
    assert res2["frames_dropped"] == 0
    assert res2["seq_ids"] == [6, 7, 8, 9]


def test_process_executor_runs_and_traces():
    """The process executor moves numpy frames through the shm rings,
    meters busy time in the shared counters, and ships each worker's
    trace ring back to the session tracer on stop."""
    import numpy as np

    from repro_torch.obs import Tracer, analyze_trace, to_chrome_events

    tracer = Tracer()
    rt = StreamingPipelineRuntime(
        [StageSpec("a", lambda x: x + 1, replicas=2),
         StageSpec("b", lambda x: (time.sleep(0.001), x * 2)[1])],
        executor="process", tracer=tracer).start()
    frames = [np.full(4, i, dtype=np.float64) for i in range(12)]
    res = rt.run(frames, timeout_s=60.0)
    rt.stop()
    assert res["frames_dropped"] == 0
    for i, out in enumerate(res["outputs"]):
        np.testing.assert_array_equal(out, np.full(4, (i + 1) * 2.0))
    assert sum(c for (s, _), c in res["replica_frames"].items()
               if s == "a") == 12
    assert res["busy_s"][("b", 0)] >= 12 * 0.001
    report = analyze_trace(to_chrome_events(tracer.drain()))
    assert {s.name: s.frames for s in report.stages} == {"a": 12, "b": 12}


def test_runtime_stop_terminates_all_stages_quickly():
    rt = StreamingPipelineRuntime([
        StageSpec("a", lambda x: x + 1, replicas=2),
        StageSpec("b", lambda x: x * 2, replicas=3),
        StageSpec("c", lambda x: x - 1),
    ]).start()
    rt.run(list(range(20)))
    threads = list(rt._threads)
    t0 = time.perf_counter()
    rt.stop()
    assert time.perf_counter() - t0 < 1.0
    assert all(not t.is_alive() for t in threads)


def test_runtime_rebuild_preserves_sequence_ids():
    ch = small_chain()
    events = []
    rt = StreamingPipelineRuntime.from_plan(
        _Plan(herad(ch, 3, 2)), lambda s, e: (lambda x: (x[0] + 1, x[1])),
        on_event=lambda name, payload: events.append(name))
    rt.start()
    frames = [(0, i) for i in range(12)]
    r1 = rt.run(frames)
    n_stages1 = len(rt.stages)
    rt.rebuild(_Plan(herad(ch, 1, 1)))
    r2 = rt.run(frames)
    rt.stop()
    assert r1["outputs"] == [(n_stages1, i) for i in range(12)]
    assert r2["outputs"] == [(len(rt.stages), i) for i in range(12)]
    assert r1["seq_ids"] == list(range(12))
    assert r2["seq_ids"] == list(range(12, 24))
    assert "rebuild" in events and events.count("start") == 1


def test_runtime_on_event_payload_schema():
    ch = small_chain()
    events = []
    rt = StreamingPipelineRuntime.from_plan(
        _Plan(herad(ch, 3, 2)), lambda s, e: (lambda x: x),
        on_event=lambda name, payload: events.append((name, payload)))
    rt.start()
    rt.run(list(range(4)))
    rt.rebuild(_Plan(herad(ch, 1, 1)))
    rt.rebuild(_Plan(herad(ch, 2, 1)), mode="drain")
    rt.stop()
    names = [n for n, _ in events]
    assert names == ["start", "rebuild", "stop", "rebuild", "start", "stop"]
    for _, payload in events:
        assert isinstance(payload["t"], float)
        assert isinstance(payload["plan_seq"], int)
    ts = [p["t"] for _, p in events]
    assert ts == sorted(ts)
    assert [p["plan_seq"] for _, p in events] == [0, 1, 1, 2, 2, 2]
    for name, payload in events:
        if name in ("start", "rebuild"):
            assert payload["stages"] and all(
                isinstance(s, str) for s in payload["stages"])
        if name == "rebuild":
            assert payload["mode"] in ("handoff", "drain")
            assert isinstance(payload["fence"], int)


def test_runtime_rebuild_requires_builder():
    rt = StreamingPipelineRuntime([StageSpec("s", lambda x: x)])
    with pytest.raises(ValueError, match="stage_fn_builder"):
        rt.rebuild(object())
    with pytest.raises(ValueError, match="unknown executor"):
        StreamingPipelineRuntime([], executor="gpu")


def test_stage_builder_arity_dispatch():
    ch = small_chain()

    class Plan:
        chain = ch
        solution = herad(ch, 3, 2)

    calls = []

    def kw_builder(start, end, **opts):
        calls.append(("kw", start, end))
        return lambda x: x

    def kwonly_builder(start, end, *, scale=1.0):
        calls.append(("kwonly", start, end))
        return lambda x: x

    def star_builder(*args):
        calls.append(("star", len(args)))
        return lambda x: x

    for builder in (kw_builder, kwonly_builder, star_builder):
        StreamingPipelineRuntime.from_plan(Plan, builder)
    assert {c[0] for c in calls} == {"kw", "kwonly", "star"}
    assert all(c == ("star", 3) for c in calls if c[0] == "star")


def test_specs_from_plan_like_reference():
    """StageSpecs of a DVFS plan with a power model, and with enforced
    frequencies, equal the reference's field for field (the fns aside)."""
    from repro.energy.model import DEFAULT_DVFS_POWER as JDVFS
    from repro.energy.pareto import freqherad as jfreqherad
    from repro.core import TaskChain as JTaskChain
    from repro_torch.energy.model import DEFAULT_DVFS_POWER
    from repro_torch.energy.pareto import freqherad

    ch = small_chain()
    jch = JTaskChain(ch.w["B"], ch.w["L"], list(ch.replicable))

    def specs(mod, fsol, chain, power, enforce):
        class P:
            pass
        P.chain, P.freq_solution = chain, fsol
        P.solution = fsol.to_solution()
        return [dataclasses.replace(s, fn=None) for s in
                mod.StreamingPipelineRuntime._specs_from_plan(
                    P, lambda s, e: (lambda x: x), power, enforce)]

    for enforce in (False, True):
        ours = specs(T, freqherad(ch, 4, 4, power=DEFAULT_DVFS_POWER), ch,
                     DEFAULT_DVFS_POWER, enforce)
        ref = specs(J, jfreqherad(jch, 4, 4, power=JDVFS), jch, JDVFS,
                    enforce)
        assert canon(ours) == canon(ref)
        assert any(s.freq < 1.0 for s in ours) == enforce


def test_run_timeout_reports_dropped_frames():
    rt = StreamingPipelineRuntime([
        StageSpec("stuck", lambda x: (time.sleep(60.0), x)[1]),
    ]).start()
    t0 = time.perf_counter()
    stats = rt.run(list(range(3)), timeout_s=0.2)
    assert time.perf_counter() - t0 < 5.0
    assert stats["frames_dropped"] == 3
    assert stats["outputs"] == []
    rt._threads = []  # workers are wedged in sleep; don't join them


def test_run_flushes_stale_sink_items():
    rt = StreamingPipelineRuntime([StageSpec("ok", lambda x: x)]).start()
    rt._queues[-1].put(truntime._Sentinel())
    rt._queues[-1].put((999, "stale"))
    stats = rt.run(list(range(5)), timeout_s=10.0)
    rt.stop()
    assert stats["frames_dropped"] == 0
    assert stats["outputs"] == list(range(5))


def test_process_executor_refuses_to_fork_after_cuda_init(monkeypatch):
    """A runtime built before CUDA was initialised raises when it would
    fork its workers after, and a rebuild does too; the thread executor
    is unaffected."""
    rt = StreamingPipelineRuntime([StageSpec("s", lambda x: x)],
                                  executor="process")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="executor='thread'"):
        rt.start()
    assert not rt._started and rt._threads == []
    with pytest.raises(RuntimeError, match="forks"):
        StreamingPipelineRuntime.from_plan(_toy_plan(1, 1),
                                           lambda s, e: (lambda x: x),
                                           executor="process")
    th = StreamingPipelineRuntime([StageSpec("s", lambda x: x + 1)]).start()
    assert th.run([1, 2])["outputs"] == [2, 3]
    th.stop()
