"""The port's training path against the JAX reference on the CPU: the
int8 block quantiser, the learning-rate schedule and clipping, one AdamW
update of each optimizer, ``Model.loss`` and its gradients on the smoke
config of every family (remat on and off), 25 training steps of
stablelm-3b's smoke config, and microbatched accumulation. The
reference's parameters are loaded with ``params_from_jax`` and both
packages see the same ``SyntheticLM`` batches."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _hyp import given, settings, st  # noqa: E402

from repro.data import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.train import OptConfig as JaxOptConfig  # noqa: E402
from repro.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.step import init_train_state as jax_init_train_state  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptConfig, TrainConfig, init_train_state, make_train_step)
from repro_torch.train import optimizer as topt  # noqa: E402

# one smoke config per family, with the batch fields it takes
FAMILIES = {"dense": "stablelm-3b", "windowed": "gemma3-1b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-7b",
            "moe": "arctic-480b", "vlm": "internvl2-26b",
            "encdec": "whisper-small"}
B, S = 2, 24                 # S > gemma3-1b smoke's window of 16
LOSS_TOL = 1e-5              # relative, the loss
GRAD_TOL = 1e-4              # relative to the leaf's largest |gradient|
STEPS = 25


def _np(t):
    return t.detach().float().numpy()


def _to_torch(tree):
    """A (numpy) state tree of the reference as the port's tensors."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _batch(cfg, rng, b=B, s=S):
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1            # ignored positions
    if cfg.kind == "vlm":
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.kind in ("encdec", "audio"):
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return batch


# ------------------------------------------------------------- quantiser
def _check_quantize(seed, n):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(3, n)) * 10.0 ** rng.integers(-4, 4)).astype(
        np.float32)
    jq, js = jopt.quantize(jnp.asarray(x))
    tq, ts = topt.quantize(torch.from_numpy(x))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    back = topt.dequantize(tq, ts, n)
    assert np.array_equal(np.asarray(jopt.dequantize(jq, js, n)),
                          back.numpy())
    # symmetric int8: error bounded by scale / 2 = max|block| / 254
    assert float(np.abs(back.numpy() - x).max()) <= \
        float(np.abs(x).max()) / 127.0 + 1e-12


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 300))
def test_quantize_matches_reference_property(seed, n):
    """The reference's hypothesis grid: int8 values and scales ``==``."""
    _check_quantize(seed, n)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 127), (2, 128), (3, 129),
                                    (4, 255), (5, 256), (6, 300),
                                    (2**31 - 1, 77)])
def test_quantize_matches_reference(seed, n):
    """The same grid at fixed points, one block, ragged tails, and more
    than two blocks: int8 values and scales ``==``."""
    _check_quantize(seed, n)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5]])
    q, s = topt.quantize(x)
    assert float(s[0, 0]) == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


# ------------------------------------------------------- schedule, update
def test_lr_schedule_and_clipping():
    """The reference's ``test_lr_schedule_and_clipping``, and the schedule
    at every step against ``repro``'s."""
    cfg = OptConfig(lr=1.0, warmup=10, total_steps=100, grad_clip=1.0,
                    name="adamw")
    assert float(topt.lr_at(cfg, 0)) == pytest.approx(0.0)
    assert float(topt.lr_at(cfg, 10)) == pytest.approx(1.0, abs=0.01)
    assert float(topt.lr_at(cfg, 100)) == pytest.approx(0.0, abs=1e-6)
    jcfg = JaxOptConfig(**dataclasses.asdict(cfg))
    for s in range(0, 120, 7):
        # the two packages' fp32 cos differ by an ulp (~6e-8 of lr)
        assert float(topt.lr_at(cfg, torch.tensor(s, dtype=torch.int32))) \
            == pytest.approx(float(jopt.lr_at(jcfg, jnp.asarray(s))),
                             rel=1e-6, abs=1e-7)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    _, _, metrics = topt.apply_updates(params, grads,
                                       topt.init_opt_state(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(400.0)


@pytest.mark.parametrize("name", ["adamw", "adamw8"])
def test_apply_updates_matches_reference(name):
    """One update of each optimizer from a state with nonzero moments (two
    steps of the reference), on leaves with ragged and multi-block last
    axes: parameters within 1e-6, moments and step as the reference's."""
    rng = np.random.default_rng(7)
    shapes = {"a": (3, 200), "b": {"c": (130,), "d": (2, 5, 64)}}
    cfg = OptConfig(name=name, lr=1e-2, warmup=1, total_steps=10)
    jcfg = JaxOptConfig(**dataclasses.asdict(cfg))

    def draw(shape_tree, scale=1.0):
        return jax.tree.map(lambda s: (rng.standard_normal(s) * scale)
                            .astype(np.float32), shape_tree,
                            is_leaf=lambda x: isinstance(x, tuple))

    params = draw(shapes)
    jstate = jopt.init_opt_state(jax.tree.map(jnp.asarray, params), jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    for _ in range(2):
        jparams, jstate, _ = jopt.apply_updates(
            jparams, jax.tree.map(jnp.asarray, draw(shapes, 3.0)), jstate,
            jcfg)
    grads = draw(shapes, 3.0)
    jp, js, jm = jopt.apply_updates(jparams, jax.tree.map(jnp.asarray, grads),
                                    jstate, jcfg)
    tp, ts, tm = topt.apply_updates(
        _to_torch(jax.tree.map(np.asarray, jparams)), _to_torch(grads),
        _to_torch(jax.tree.map(np.asarray, jstate)), cfg)
    for a, b in zip(jax.tree.leaves(jp), topt.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    jl = jax.tree.leaves(js)
    tl = [t for _, t in _flat(ts)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_allclose(b.numpy().astype(np.float64),
                                   np.asarray(a).astype(np.float64),
                                   rtol=1e-6, atol=1 if b.dtype ==
                                   torch.int8 else 1e-12)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-6)


def test_chunked_update_of_large_leaves_changes_no_number(monkeypatch):
    """A leaf over ``SLICE_NUMEL`` elements is updated a dim-0 slice at a
    time: the result equals the whole-leaf update exactly."""
    rng = np.random.default_rng(3)
    p = {"w": torch.from_numpy(rng.standard_normal((6, 3, 130))
                               .astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((6, 3, 130))
                               .astype(np.float32))}
    for name in ("adamw", "adamw8"):
        cfg = OptConfig(name=name, lr=1e-2, warmup=1)
        whole = topt.apply_updates(p, g, topt.init_opt_state(p, cfg), cfg)
        monkeypatch.setattr(topt, "SLICE_NUMEL", 100)
        sliced = topt.apply_updates(p, g, topt.init_opt_state(p, cfg), cfg)
        monkeypatch.undo()
        for (ka, a), (kb, b) in zip(_flat(whole[:2]), _flat(sliced[:2])):
            assert ka == kb and torch.equal(a, b), ka


def test_layer_helpers_match_reference():
    from repro.models import layers as jl
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    for tied, w in ((True, table), (False, table.T.copy())):
        ours = layers.lm_logits(torch.from_numpy(x), torch.from_numpy(w),
                                tied)
        ref = jl.lm_logits(jnp.asarray(x), jnp.asarray(w), tied)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
    logits = torch.from_numpy(x @ table.T)
    for m in (None, mask):
        ours = layers.cross_entropy(
            logits, torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        ref = jl.cross_entropy(jnp.asarray(logits.numpy()),
                               jnp.asarray(labels),
                               None if m is None else jnp.asarray(m))
        assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    gen = torch.Generator().manual_seed(0)
    w = layers.init_dense(gen, (256, 64), dtype=torch.bfloat16)
    assert w.shape == (256, 64) and w.dtype == torch.bfloat16
    assert float(w.float().std()) == pytest.approx(1 / 16, rel=0.05)


# ------------------------------------------------------ loss and gradients
@pytest.fixture(scope="module", params=list(FAMILIES),
                ids=list(FAMILIES))
def family(request):
    """(port model, port params, reference loss, reference gradients as
    a tree of numpy arrays, the batch) of one family's smoke config."""
    cfg = get_smoke_config(FAMILIES[request.param])
    jm = JaxModel(jax_smoke(cfg.name.removesuffix("-smoke")))
    jp = jm.init(0)
    batch = _batch(cfg, np.random.default_rng(11))
    jloss, jgrad = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return (Model(cfg), params, float(jloss),
            jax.tree.map(np.asarray, jgrad), batch)


def _flat(tree, prefix=""):
    """(path, leaf) of nested dicts and tuples, in ``jax.tree`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_loss_and_grads_match_reference(family, remat):
    """``Model.loss`` and ``torch.autograd.grad`` of it against
    ``jax.value_and_grad`` of the reference's: the loss within 1e-5, every
    leaf's gradient within 1e-4 of the leaf's largest, with per-layer
    remat on and off."""
    model, params, jloss, jgrad, batch = family
    model = Model(dataclasses.replace(model.cfg, remat=remat))
    live = topt.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = model.loss(live, {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    assert float(loss.detach()) == pytest.approx(jloss, rel=LOSS_TOL)
    grads = torch.autograd.grad(loss, topt.tree_leaves(live))
    ref = list(_flat(jgrad))
    assert len(ref) == len(grads)
    for (name, r), g in zip(ref, grads):
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(_np(g) - r).max()) / scale
        assert err < GRAD_TOL, (name, err)


def test_training_path_unbinds_and_remats(family, monkeypatch):
    """The training forward runs each layer once under checkpoint (remat)
    and indexes no stacked leaf per layer; a forward under ``no_grad``
    runs neither."""
    from repro_torch.models import transformer
    model, params, _, _, batch = family
    calls = []
    real = transformer.checkpoint

    def counted(fn, *args, **kw):
        calls.append(fn.__name__)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", counted)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    live = topt.tree_map(lambda p: p.detach().requires_grad_(), params)
    model.loss(live, tb)
    cfg = model.cfg
    n_attn = model.n_super if cfg.kind == "hybrid" else 0
    assert calls.count("_layer") == cfg.n_layers + n_attn
    assert calls.count("_enc_layer") == cfg.n_enc_layers
    calls.clear()
    with torch.no_grad():
        model.loss(live, tb)
    assert not calls


# ------------------------------------------------------------- training
def _jax_run(opt, steps, n_mb=1, lr=3e-3, seq=32, batch=8, seed=3,
             total=None, force=None):
    """The reference's ``_train`` of ``tests/test_train.py``; returns the
    losses and the states before each step."""
    jm = JaxModel(jax_smoke("stablelm-3b"))
    tcfg = JaxTrainConfig(
        n_microbatches=n_mb,
        opt=JaxOptConfig(name=opt, lr=lr, warmup=5,
                         total_steps=total or steps * 4, weight_decay=0.0))
    data = JaxSyntheticLM(jm.cfg.vocab, seq_len=seq, global_batch=batch,
                          seed=seed)
    state = jax_init_train_state(jm, 0, tcfg)
    step = jax.jit(jax_make_train_step(jm, tcfg))
    losses, states = [], []
    for i in range(steps):
        states.append(jax.tree.map(np.asarray, state))
        state, m = step(state, {k: jnp.asarray(v)
                                for k, v in data.batch(i).items()})
        losses.append(float(m["loss"]))
    return losses, states


def _port(opt, steps, n_mb=1, lr=3e-3, seq=32, batch=8, seed=3):
    cfg = get_smoke_config("stablelm-3b")
    model = Model(cfg)
    tcfg = TrainConfig(n_microbatches=n_mb,
                       opt=OptConfig(name=opt, lr=lr, warmup=5,
                                     total_steps=steps * 4,
                                     weight_decay=0.0))
    data = SyntheticLM(cfg.vocab, seq_len=seq, global_batch=batch, seed=seed)
    return cfg, make_train_step(model, tcfg), data, tcfg


def _state_from_jax(jstate, cfg):
    return {"params": params_from_jax(jstate["params"], cfg, device="cpu"),
            "opt": _to_torch(jstate["opt"])}


@pytest.fixture(scope="module", params=["adamw", "adamw8"])
def reference_run(request):
    opt = request.param
    losses, states = _jax_run(opt, STEPS)
    return opt, losses, states


def test_training_matches_reference_step_by_step(reference_run):
    """Each of the 25 steps from the reference's state before it: the
    port's loss within 1e-5 of ``repro``'s at every step, for both
    optimizers. (Run freely, the int8 moments turn the packages' ~1e-6
    gradient differences into rounding flips of one quantum, and adamw8's
    trajectories drift apart by ~3e-5 at step 25; adamw's stay within
    1e-6: ``test_training_runs_free_like_reference``.)"""
    opt, losses, states = reference_run
    cfg, step, data, _ = _port(opt, STEPS)
    for i in range(STEPS):
        _, m = step(_state_from_jax(states[i], cfg),
                    {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        assert float(m["loss"]) == pytest.approx(losses[i], rel=LOSS_TOL), i


def test_training_runs_free_like_reference(reference_run):
    """The port trained from the reference's initial parameters, 25 steps:
    the reference's own bounds (a decrease of 0.4 nats; adamw8 within 0.25
    of adamw), and for adamw the losses within 1e-5 of ``repro``'s at
    every step."""
    opt, losses, states = reference_run
    cfg, step, data, _ = _port(opt, STEPS)
    state = _state_from_jax(states[0], cfg)
    ours = []
    for i in range(STEPS):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in data.batch(i).items()})
        ours.append(float(m["loss"]))
    assert ours[-1] < ours[0] - 0.4, ours
    if opt == "adamw":
        np.testing.assert_allclose(ours, losses, rtol=LOSS_TOL)
    else:
        fp32, _ = _jax_run("adamw", STEPS)
        assert abs(ours[-1] - fp32[-1]) < 0.25


def test_microbatches_equal_full_batch():
    """``n_microbatches=4`` equals one full-batch step (1e-5), as the
    reference's test holds its own."""
    outs = {}
    for n_mb in (1, 4):
        cfg, step, data, tcfg = _port("adamw", 1, n_mb=n_mb, lr=1e-3,
                                      seq=16, seed=5)
        state = init_train_state(Model(cfg), 0, tcfg, device="cpu")
        new, m = step(state, {k: torch.from_numpy(v)
                              for k, v in data.batch(0).items()})
        outs[n_mb] = (float(m["loss"]), topt.tree_leaves(new["params"])[0])
    assert outs[1][0] == pytest.approx(outs[4][0], rel=1e-5)
    assert float((outs[1][1] - outs[4][1]).abs().max()) < 1e-5


# ------------------------------------------------------- the serving path
# Model.forward's aten ops under no_grad on stablelm-3b's smoke config
# (B 2, S 9, fp32), recorded on the tree before the training path came in
# ("aten." and ".default" dropped): the embedding, RoPE's table, each
# layer, the final norm. The one op that changed is the lookup,
# ``index.Tensor`` (``table[tokens]``) -> ``embedding`` (``F.embedding``,
# the same rows); the layers still index each stacked leaf (``select``),
# with no unbind and no checkpoint.
PARENT_PRE = """
index.Tensor arange arange div.Tensor pow.Scalar reciprocal mul.Tensor
_to_copy unsqueeze mul.Tensor sin cos
""".split()
PARENT_LAYER = """
select.int select.int select.int select.int select.int select.int select.int
select.int select.int pow.Tensor_Scalar mean.dim add.Tensor rsqrt mul.Tensor
add.Tensor mul.Tensor view mm _unsafe_view view view mm _unsafe_view view
view mm _unsafe_view view slice.Tensor slice.Tensor unsqueeze unsqueeze
unsqueeze unsqueeze mul.Tensor mul.Tensor sub.Tensor mul.Tensor mul.Tensor
add.Tensor cat slice.Tensor slice.Tensor unsqueeze unsqueeze unsqueeze
unsqueeze mul.Tensor mul.Tensor sub.Tensor mul.Tensor mul.Tensor add.Tensor
cat transpose.int transpose.int transpose.int unsqueeze expand clone view
unsqueeze expand clone view unsqueeze permute unsqueeze permute permute
clone _unsafe_view permute view bmm view permute view div.Tensor arange
unsqueeze arange unsqueeze ones le.Tensor bitwise_and_.Tensor bitwise_not
masked_fill.Scalar _softmax unsqueeze permute unsqueeze permute permute view
permute view bmm view permute view arange unsqueeze arange unsqueeze ones
le.Tensor bitwise_and_.Tensor any.dim bitwise_not unsqueeze
masked_fill.Scalar transpose.int clone _unsafe_view view mm _unsafe_view
add.Tensor pow.Tensor_Scalar mean.dim add.Tensor rsqrt mul.Tensor add.Tensor
mul.Tensor view mm _unsafe_view silu view mm _unsafe_view mul.Tensor view mm
_unsafe_view add.Tensor
""".split()
PARENT_POST = """
pow.Tensor_Scalar mean.dim add.Tensor rsqrt mul.Tensor add.Tensor mul.Tensor
""".split()


def test_no_grad_forward_issues_the_serving_ops():
    """``Model.forward`` under ``torch.no_grad()`` issues the ops it issued
    before the training path (per-layer remat, ``unbind``) came in, but
    for the embedding lookup; and the same ops with parameters that
    require a gradient, since grad mode is off."""
    from test_torch_decode_capture import OpLog

    cfg = get_smoke_config("stablelm-3b")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 9)).astype(np.int32))
    want = ["embedding"] + PARENT_PRE[1:] + PARENT_LAYER * cfg.n_layers \
        + PARENT_POST
    for tree in (params, topt.tree_map(lambda p: p.requires_grad_(),
                                       params)):
        with torch.no_grad(), OpLog() as log:
            model.forward(tree, {"tokens": tokens})
        got = [op[0].removeprefix("aten.").removesuffix(".default")
               for op in log.ops]
        assert got == want
