"""The port's executor running the port's model: a HeRAD plan of a smoke
LM's layer chain on 2 big + 2 little, materialized through
``repro_torch.pipeline.stages.model_stage_builder`` and streamed through
``StreamingPipelineRuntime``, must give, frame for frame, the greedy
tokens of the reference's monolithic forward (the reference's
``tests/test_system.py::test_scheduled_pipeline_runs_model_stages`` at its
sizes), with the reference's parameters loaded by ``params_from_jax``.
The same holds under a variant plan whose stage runs the two-pass
attention (on CPU tensors each kernel wrapper runs its plain version) and
for the planner's own chain (ingest and emit included)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import herad as jherad  # noqa: E402
from repro.core import TaskChain as JTaskChain  # noqa: E402
from repro.models import embedloss as jemb  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import TaskChain, herad  # noqa: E402
from repro_torch.core.variants import VariantRegistry, VariantSpec  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.pipeline import (  # noqa: E402
    HeterogeneousSystem, StreamingPipelineRuntime, plan_pipeline)
from repro_torch.pipeline.stages import model_stage_builder  # noqa: E402

ARCH = "stablelm-3b"


@pytest.fixture(scope="module")
def setup():
    """Reference model and params, the port's model and the same params,
    the reference's chain and 3 frames of 12 tokens."""
    jcfg = jax_smoke(ARCH)
    jm = JaxModel(jcfg)
    jp = jm.init(0)
    cfg = get_smoke_config(ARCH)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(1)
    frames = [np.asarray(rng.integers(0, cfg.vocab, (1, 12)), np.int32)
              for _ in range(3)]
    want = []
    for frame in frames:
        x = jm.forward(jp, {"tokens": jnp.asarray(frame)})
        want.append(np.asarray(jemb.greedy(x[:, -1], jp["embed"],
                                           valid_vocab=jcfg.vocab)))
    return cfg, tm, tp, frames, want


def _chain(cls, n_layers):
    names = ["embed"] + [f"layer{i}" for i in range(n_layers)] + ["head"]
    w = [1.0] + [3.0] * n_layers + [2.0]
    return cls(w, [x * 2 for x in w], [True] * (n_layers + 2), names)


class _Plan:
    def __init__(self, solution, chain, freq_solution=None):
        self.solution = solution
        self.chain = chain
        self.freq_solution = freq_solution


def _run(plan, builder, frames):
    rt = StreamingPipelineRuntime.from_plan(plan, builder).start()
    try:
        return rt.run(frames, timeout_s=120.0), rt.stages
    finally:
        rt.stop()


def test_scheduled_pipeline_runs_model_stages(setup):
    cfg, tm, tp, frames, want = setup
    chain = _chain(TaskChain, cfg.n_layers)
    sol = herad(chain, 2, 2)
    assert sol.covers(chain)
    # the port's schedule is the reference's
    jsol = jherad(_chain(JTaskChain, cfg.n_layers), 2, 2)
    assert [(s.start, s.end, s.cores, s.ctype) for s in sol.stages] == \
        [(s.start, s.end, s.cores, s.ctype) for s in jsol.stages]
    assert len(sol.stages) > 1
    builder = model_stage_builder(tm, tp, chain.names, device="cpu")
    res, _ = _run(_Plan(sol, chain), builder, frames)
    assert res["frames_dropped"] == 0
    assert res["seq_ids"] == [0, 1, 2]
    for (tok, hidden), ref in zip(res["outputs"], want):
        assert isinstance(tok, torch.Tensor) and tok.dtype == torch.int32
        assert np.array_equal(tok.numpy(), ref) and hidden.shape == (1, 64)


def test_variant_plan_runs_chunked_stage(setup, monkeypatch):
    """A plan whose middle stage carries the ``chunked`` variant: that
    stage's layers run the two-pass attention (its wrapper is called, and
    on CPU tensors runs the plain version), the others the flash
    wrapper's, and the tokens are still the reference's."""
    cfg, tm, tp, frames, want = setup
    chain = _chain(TaskChain, cfg.n_layers)
    reg = VariantRegistry()
    for i in range(cfg.n_layers):
        registry.register_family(reg, f"layer{i}", "flash_attention",
                                 {"chunked": (2.0, 0.5)})
    spec = reg.spec_for(chain)
    # the registry's callables are kernels, not stage builders: the
    # runtime would call them as builders, so the plan carries only the
    # multipliers and the stage builder reads the stage's variant
    plan_spec = VariantSpec(spec.names, spec.task_names, spec.mult)
    from repro_torch.energy import POWER_APPLE_M1_ULTRA
    from repro_torch.energy.pareto import variant_herad

    fsol = variant_herad(chain, 2, 2, power=POWER_APPLE_M1_ULTRA,
                         variants=plan_spec)
    variants = [st.variant for st in fsol.stages]
    assert "chunked" in variants
    calls = {"flash": 0, "chunked": 0}

    def counted(kind, real):
        def wrapper(*a, **k):
            calls[kind] += 1
            return real(*a, **k)
        return wrapper

    monkeypatch.setattr(fa_ops, "flash_attention_cuda",
                        counted("flash", fa_ops.flash_attention_cuda))
    monkeypatch.setattr(fa_ops, "chunked_attention_cuda",
                        counted("chunked", fa_ops.chunked_attention_cuda))
    builder = model_stage_builder(tm, tp, chain.names, device="cpu")
    res, stages = _run(_Plan(fsol.to_solution(), chain, fsol), builder,
                       frames)
    assert [s.variant for s in stages] == variants
    chunked_layers = sum(
        sum(1 for t in range(st.start, st.end + 1)
            if chain.names[t].startswith("layer"))
        for st in fsol.stages if st.variant == "chunked")
    assert 0 < chunked_layers < cfg.n_layers
    assert calls == {"chunked": chunked_layers * len(frames),
                     "flash": (cfg.n_layers - chunked_layers) * len(frames)}
    for (tok, _), ref in zip(res["outputs"], want):
        assert np.array_equal(tok.numpy(), ref)


def test_planned_model_chain_with_ingest_and_emit(setup):
    """``plan_pipeline``'s own chain (ingest, embed, layers, head, emit)
    through the builder: numpy tokens in, numpy tokens out with the last
    hidden state beside them, equal to the port's own forward's."""
    cfg, tm, tp, frames, want = setup
    plan = plan_pipeline(cfg, system=HeterogeneousSystem.default(2, 2),
                         tokens_per_step=12, mode="prefill")
    assert plan.chain.names[0] == "ingest" and plan.chain.names[-1] == "emit"
    builder = model_stage_builder(tm, tp, plan.chain.names, device="cpu")
    res, _ = _run(plan, builder, frames)
    for (tok, hidden), ref, frame in zip(res["outputs"], want, frames):
        assert isinstance(tok, np.ndarray) and np.array_equal(tok, ref)
        full = tm.forward(tp, {"tokens": torch.as_tensor(frame)})
        assert torch.equal(hidden, full[:, -1].float())


def test_builder_rejects_what_the_chain_cannot_carry():
    """Families whose layers are not one attention block each, a task the
    chain does not name, and a stage variant no implementation answers
    to all raise."""
    for arch in ("whisper-small", "zamba2-7b", "mamba2-1.3b"):
        with pytest.raises(NotImplementedError, match="attention-block"):
            model_stage_builder(Model(get_smoke_config(arch)), {}, [],
                                device="cpu")
    m = Model(get_smoke_config(ARCH))
    build = model_stage_builder(m, m.init(0, device="cpu"),
                                ["nope", "embed"], device="cpu")
    with pytest.raises(ValueError, match="unknown chain task"):
        build(0, 0)
    with pytest.raises(KeyError):
        build(1, 1, types.SimpleNamespace(variant="sequential"))
