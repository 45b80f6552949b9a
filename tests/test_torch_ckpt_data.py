"""The port's checkpoints and synthetic data against the JAX reference on
the CPU: the reference's roundtrip (bf16 and int8 leaves), retention and
bitwise resume; ``SyntheticLM.batch`` ``==`` ``repro``'s and the
prefetcher's order; a checkpoint written by either package restored by the
other with every leaf equal; and the reference's fault-tolerance story
(train, checkpoint asynchronously, lose devices, re-plan with the port's
planner, restore, train on)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.ckpt import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.train import OptConfig as JaxOptConfig  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train.step import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import LITTLE  # noqa: E402
from repro_torch.data import Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.pipeline import HeterogeneousSystem, plan_pipeline  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptConfig, TrainConfig, init_train_state, make_train_step)
from repro_torch.train.optimizer import tree_leaves  # noqa: E402


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_ckpt_roundtrip(tmp_path):
    state = {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "b": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
        "nested": {"q": torch.arange(6, dtype=torch.int8),
                   "s": torch.tensor(2.0)},
    }
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(3, state, metadata={"foo": 1}, blocking=True)
    target = {"a": torch.zeros(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16),
              "nested": {"q": torch.zeros(6, dtype=torch.int8),
                         "s": torch.tensor(0.0)}}
    restored, meta = mgr.restore(3, target)
    assert meta == {"foo": 1}
    for (ka, a), (kb, b) in zip(_flat(state), _flat(restored)):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)
    assert (tmp_path / "step_3" / "nested__q.npy").exists()
    with pytest.raises(ValueError, match="nested/q"):
        mgr.restore(3, {**target, "nested": {
            "q": torch.zeros(6, dtype=torch.int32), "s": target["nested"]["s"]}})


def test_ckpt_snapshot_is_taken_at_save(tmp_path):
    """``save`` copies every leaf to the host before it returns: changing
    the tensors afterwards changes nothing on disk."""
    x = torch.zeros(1000)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": x})
    x.fill_(7.0)
    mgr.wait()
    restored, _ = mgr.restore(1, {"x": torch.empty(1000)})
    assert float(restored["x"].abs().max()) == 0.0


def test_ckpt_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor(s)}, blocking=True)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_resume_is_bitwise_deterministic(tmp_path):
    cfg = get_smoke_config("stablelm-3b")
    model = Model(cfg)
    tcfg = TrainConfig(opt=OptConfig(name="adamw8", lr=1e-3, warmup=2))
    data = SyntheticLM(cfg.vocab, seq_len=16, global_batch=4, seed=11)
    step = make_train_step(model, tcfg)

    def run(state, start, n):
        for i in range(start, start + n):
            state, m = step(state, _tensors(data.batch(i)))
        return state, float(m["loss"])

    state = init_train_state(model, 0, tcfg, device="cpu")
    mid, _ = run(state, 0, 5)
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, mid, blocking=True)
    full, loss_a = run(mid, 5, 5)

    fresh = init_train_state(model, 1, tcfg, device="cpu")
    restored, _ = mgr.restore(5, fresh)
    for a, b in zip(tree_leaves(mid), tree_leaves(restored)):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else ((a, b),)):
            assert torch.equal(x, y)
    resumed, loss_b = run(restored, 5, 5)
    assert loss_a == loss_b
    for a, b in zip(tree_leaves(full["params"]),
                    tree_leaves(resumed["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("step", [0, 7, 123])
def test_synthetic_batches_equal_reference(step):
    for kw in ({}, {"host_index": 1, "host_count": 2},
               {"extra_fields": {"patches": ((3, 8), np.float32)}}):
        ours = SyntheticLM(vocab=256, seq_len=24, global_batch=8, seed=9,
                           **kw).batch(step)
        ref = JaxSyntheticLM(vocab=256, seq_len=24, global_batch=8, seed=9,
                             **kw).batch(step)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype
            assert np.array_equal(ours[k], ref[k]), k


def test_synthetic_determinism_and_host_sharding():
    src = SyntheticLM(vocab=128, seq_len=16, global_batch=8, seed=9)
    b1 = src.batch(7)
    assert np.array_equal(b1["tokens"], src.batch(7)["tokens"])
    assert not np.array_equal(src.batch(8)["tokens"], b1["tokens"])
    assert b1["labels"].shape == b1["tokens"].shape
    h0 = SyntheticLM(128, 16, 8, seed=9, host_index=0, host_count=2).batch(7)
    assert h0["tokens"].shape[0] == 4
    assert (src.perm[b1["tokens"]] == b1["labels"]).mean() > 0.7


def test_prefetcher_orders_batches():
    src = SyntheticLM(vocab=64, seq_len=8, global_batch=2, seed=1)
    pf = Prefetcher(src, start_step=3)
    got = [pf.next() for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    for s, batch in got:
        assert np.array_equal(batch["tokens"], src.batch(s)["tokens"])
    assert not pf._thread.is_alive()


# ------------------------------------------------- across the packages
@pytest.fixture(scope="module", params=["adamw", "adamw8"])
def jax_state(request):
    """The reference's train state of stablelm-3b's smoke config with bf16
    parameters (uint16 on disk), after one update so that the moments are
    not zero; and the port's matching target."""
    import dataclasses
    name = request.param
    jm = JaxModel(dataclasses.replace(jax_smoke("stablelm-3b"),
                                      param_dtype="bfloat16"))
    tcfg = JaxTrainConfig(opt=JaxOptConfig(name=name, lr=1e-3, warmup=1))
    data = JaxSyntheticLM(jm.cfg.vocab, seq_len=16, global_batch=2, seed=4)
    state = jax_init_train_state(jm, 0, tcfg)
    state, _ = jax.jit(jax_make_train_step(jm, tcfg))(
        state, {k: jnp.asarray(v) for k, v in data.batch(0).items()})
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              param_dtype="bfloat16")
    target = init_train_state(Model(cfg), 1, TrainConfig(
        opt=OptConfig(name=name)), device="cpu")
    return state, target


def test_reference_checkpoint_restores_into_port(tmp_path, jax_state):
    state, target = jax_state
    JaxCheckpointManager(tmp_path).save(4, state, metadata={"by": "repro"},
                                        blocking=True)
    restored, meta = CheckpointManager(tmp_path).restore(4, target)
    assert meta == {"by": "repro"}
    ref = list(_flat(jax.tree.map(np.asarray, state)))
    ours = list(_flat(restored))
    assert [k for k, _ in ref] == [k for k, _ in ours]
    for (k, a), (_, b) in zip(ref, ours):
        assert b.device.type == "cpu"
        if b.dtype == torch.bfloat16:
            b = b.view(torch.int16)
            a = a.view(np.int16)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy()), k


def test_port_checkpoint_restores_into_reference(tmp_path, jax_state):
    state, target = jax_state
    # the port's state holding the reference's values
    ported, _ = _roundtrip_into(tmp_path / "a", state, target)
    CheckpointManager(tmp_path / "b").save(6, ported, blocking=True)
    restored, _ = JaxCheckpointManager(tmp_path / "b").restore(
        6, jax.eval_shape(lambda: state))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))
    assert sorted(p.name for p in (tmp_path / "a" / "step_4").iterdir()) == \
        sorted(p.name for p in (tmp_path / "b" / "step_6").iterdir())


def _roundtrip_into(path, state, target):
    JaxCheckpointManager(path).save(4, state, blocking=True)
    return CheckpointManager(path).restore(4, target)


def test_train_failure_replan_resume(tmp_path):
    """The reference's fault-tolerance story on the port: train, checkpoint
    asynchronously, 'lose' devices, re-plan the serving pipeline with the
    port's scheduler for the degraded system, restore the weights and keep
    going. From the reference's initial parameters (``params_from_jax``),
    on which the port's losses follow the reference's."""
    cfg = get_smoke_config("gemma3-1b")
    model = Model(cfg)
    tcfg = TrainConfig(opt=OptConfig(name="adamw8", lr=5e-4, warmup=3))
    data = SyntheticLM(cfg.vocab, seq_len=16, global_batch=4, seed=2)
    state = init_train_state(model, 0, tcfg, device="cpu")
    state["params"] = params_from_jax(
        jax.tree.map(np.asarray, JaxModel(jax_smoke("gemma3-1b")).init(0)),
        cfg, device="cpu")
    step = make_train_step(model, tcfg)
    mgr = CheckpointManager(tmp_path, keep=2)

    losses = []
    for i in range(8):
        state, m = step(state, _tensors(data.batch(i)))
        losses.append(float(m["loss"]))
        if i % 4 == 3:
            mgr.save(i, state)  # async write
    mgr.wait()
    assert losses[-1] < losses[0]
    assert mgr.latest_step() == 7

    plan_a = plan_pipeline(cfg, system=HeterogeneousSystem.default(4, 4),
                           tokens_per_step=8, mode="decode")
    plan_b = plan_pipeline(cfg, system=HeterogeneousSystem.default(4, 2),
                           tokens_per_step=8, mode="decode")
    assert plan_b.solution.cores_used(LITTLE) <= 2
    assert plan_b.period_us >= plan_a.period_us - 1e-9

    target = init_train_state(model, 1, tcfg, device="cpu")
    restored, _ = mgr.restore(7, target)
    _, m2 = step(restored, _tensors(data.batch(8)))
    assert float(m2["loss"]) < losses[0]
