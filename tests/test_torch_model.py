"""The port's dense transformer against the JAX reference on the CPU: the
reference's parameters (``Model(cfg).init(0)``) loaded with
``params_from_jax``, the same numpy-made tokens through both, fp32 smoke
configs. Hidden states at 1e-5, greedy tokens identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import embedloss as jemb  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import embedloss  # noqa: E402
from repro_torch.models.config import (  # noqa: E402
    ModelConfig, SSMConfig, get_smoke_config, list_archs)
from repro_torch.models.transformer import Model  # noqa: E402

ARCHS = ["phi3-medium-14b", "stablelm-3b"]
B, S = 2, 17
TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model, port params, tokens (B, S))."""
    arch = request.param
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(0)
    cfg = get_smoke_config(arch)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jm, jp, tm, tp, tokens


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


def test_registry_and_config_copy():
    assert list_archs() == ARCHS
    for arch in ARCHS:
        for ours, ref in ((get_smoke_config(arch), jax_smoke(arch)),):
            diff = {f.name for f in dataclasses.fields(ours)
                    if getattr(ours, f.name) != getattr(ref, f.name)}
            assert diff == {"attn_impl"}, diff       # 'kernel' vs 'xla_flash'
            assert ours.attn_impl == "kernel"
            assert ours.param_count() == ref.param_count()


def test_forward_matches_jax(pair):
    jm, jp, tm, tp, tokens = pair
    ref = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    out = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (B, S, tm.cfg.d_model)
    assert _err(out, ref) < TOL
    # every prefill attention path gives the same hidden states
    for impl in ("naive", "xla_flash"):
        alt = Model(dataclasses.replace(tm.cfg, attn_impl=impl))
        assert _err(alt.forward(tp, {"tokens": torch.from_numpy(tokens)}),
                    ref) < TOL, impl


def test_prefill_matches_jax(pair):
    jm, jp, tm, tp, tokens = pair
    jcache, jlast = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 32)
    cache, last = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, 32)
    assert set(cache) == set(jcache) == {"pos", "k", "v"}
    assert cache["pos"].dtype == torch.int32
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        assert _err(cache[key], jcache[key]) < TOL
    assert _err(last, jlast) < TOL


def test_decode_matches_forward_and_jax(pair):
    """Streaming tokens through decode_step reproduces the greedy token of
    the full forward at every position, and the reference's decode tokens
    (the reference's test_decode_matches_forward, held across both)."""
    jm, jp, tm, tp, tokens = pair
    cfg = tm.cfg
    x = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    fwd = torch.stack([embedloss.greedy(x[:, t], tp["embed"], cfg.vocab)
                       for t in range(S)], dim=1).numpy()
    cache = tm.init_cache(B, 32, device="cpu")
    jcache = jm.init_cache(B, 32)
    step = jax.jit(jm.decode_step)
    dec, jdec = [], []
    for t in range(S):
        nxt, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]))
        jnxt, jcache = step(jp, jcache, jnp.asarray(tokens[:, t]))
        dec.append(nxt.numpy())
        jdec.append(np.asarray(jnxt))
    dec, jdec = np.stack(dec, 1), np.stack(jdec, 1)
    assert (dec == fwd).all() and (dec == jdec).all()
    assert cache["pos"].tolist() == [S] * B
    assert _err(cache["k"], jcache["k"]) < TOL
    jfwd = np.stack([np.asarray(jemb.greedy(
        jm.forward(jp, {"tokens": jnp.asarray(tokens)})[:, t], jp["embed"],
        valid_vocab=cfg.vocab)) for t in range(S)], 1)
    assert (fwd == jfwd).all()


def test_prefill_then_decode_equals_prefill_as_decode(pair):
    _, _, tm, tp, tokens = pair
    s0 = 9
    cache, last = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :s0])},
                             32)
    tok = embedloss.greedy(last, tp["embed"], tm.cfg.vocab)
    after = [tok]
    for t in range(s0, S):
        nxt, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]))
        after.append(nxt)
    stream = tm.init_cache(B, 32, device="cpu")
    streamed = []
    for t in range(S):
        nxt, stream = tm.decode_step(tp, stream,
                                     torch.from_numpy(tokens[:, t]))
        if t >= s0 - 1:
            streamed.append(nxt)
    assert torch.equal(torch.stack(after), torch.stack(streamed))
    assert torch.equal(cache["pos"], stream["pos"])
    assert float((cache["k"] - stream["k"]).abs().max()) < TOL


def test_reset_cache_lane_matches_jax(pair):
    jm, jp, tm, tp, tokens = pair
    jcache, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 32)
    cache, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, 32)
    same = tm.reset_cache_lane(cache, 1)
    jcache = jm.reset_cache_lane(jcache, jnp.int32(1))
    assert same is cache                      # updated in place
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL
    assert cache["pos"].tolist() == [S, 0]
    assert float(cache["k"][:, 1].abs().max()) == 0.0
    assert tm.cache_axes() == jm.cache_axes()


def test_param_count_and_layout_match_init(pair):
    jm, _, tm, _, _ = pair
    cfg = tm.cfg
    params = tm.init(0, device="cpu")
    shapes = jax.tree.map(lambda s: tuple(s.shape), jm.abstract_params())
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    actual = sum(t.numel() for t in jax.tree.leaves(params))
    assert actual == cfg.param_count()[0] + (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    again = tm.init(0, device="cpu")
    other = tm.init(1, device="cpu")
    assert torch.equal(params["layers"]["wq"], again["layers"]["wq"])
    assert not torch.equal(params["layers"]["wq"], other["layers"]["wq"])
    assert float(params["layers"]["ln_attn"].abs().max()) == 0.0


def test_bf16_config_runs_in_bf16():
    cfg = dataclasses.replace(get_smoke_config("phi3-medium-14b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    assert params["layers"]["wq"].dtype == torch.bfloat16
    tokens = torch.arange(12).reshape(2, 6)
    cache, last = model.prefill(params, {"tokens": tokens}, 8)
    assert last.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
    nxt, cache = model.decode_step(params, cache, tokens[:, 0])
    assert nxt.dtype == torch.int32 and cache["pos"].tolist() == [7, 7]


@pytest.mark.parametrize("kw", [dict(kind="ssm", ssm=SSMConfig()),
                                dict(kind="dense", window=8),
                                dict(kind="moe")])
def test_unported_families_raise(kw):
    cfg = ModelConfig(name="x", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab=128, **kw)
    with pytest.raises(NotImplementedError, match="Queue A"):
        Model(cfg)


def test_params_from_jax_rejects_a_wrong_tree(pair):
    jm, jp, tm, _, _ = pair
    tree = jax.tree.map(np.asarray, jp)
    del tree["layers"]["wq"]
    with pytest.raises(ValueError):
        params_from_jax(tree, tm.cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"] = tree["embed"][:-1]
    with pytest.raises(ValueError):
        params_from_jax(tree, tm.cfg, device="cpu")


def test_params_from_jax_bf16_is_exact():
    jm = JaxModel(dataclasses.replace(jax_smoke("stablelm-3b"),
                                      param_dtype="bfloat16"))
    jp = jm.init(0)
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              param_dtype="bfloat16")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert _err(tp["layers"]["w_up"], jp["layers"]["w_up"]) == 0.0
