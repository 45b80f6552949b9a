"""The port's model families (dense; ssm and hybrid) against the JAX
reference on the CPU: the reference's parameters (``Model(cfg).init(0)``)
loaded with ``params_from_jax``, the same numpy-made tokens through both,
fp32 smoke configs. Hidden states and cache leaves at 1e-5, greedy tokens
identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import embedloss as jemb  # noqa: E402
from repro.models.config import get_config as jax_config  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import embedloss  # noqa: E402
from repro_torch.models.config import (  # noqa: E402
    ModelConfig, get_config, get_smoke_config, list_archs)
from repro_torch.models.transformer import Model  # noqa: E402

ARCHS = ["phi3-medium-14b", "stablelm-3b"]
SSM_ARCHS = ["mamba2-1.3b", "zamba2-7b"]
# the sliding-window dense family (tests/test_torch_windowed.py)
WINDOWED_ARCHS = ["gemma3-1b", "gemma3-12b"]
# the moe and vlm families (tests/test_torch_moe_model.py)
MOE_VLM_ARCHS = ["arctic-480b", "internvl2-26b", "kimi-k2-1t-a32b"]
# the encoder-decoder family (tests/test_torch_whisper.py)
ENCDEC_ARCHS = ["whisper-small"]
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


# the port's own fields, beyond the reference's (Zyphra's hybrid layout and
# the layer pattern given as data, models/config.py), at these defaults in
# every architecture both packages have; and the architectures only the
# port has (tests/test_torch_zamba2.py, tests/test_torch_granite.py)
PORT_ONLY = {"hybrid_layer_ids": (), "n_mem_blocks": 1, "attn_in": 0,
             "adapter_rank": 0, "layer_types": (), "rope": True,
             "softmax_scale": 0.0, "embedding_multiplier": 1.0,
             "residual_multiplier": 1.0, "logits_scaling": 1.0}
SSM_PORT_ONLY = {"n_groups": 1, "conv_bias": False}
MOE_PORT_ONLY = {"dropless": False}
PORT_ARCHS = ["granite-4.0-h-small", "zamba2-7b-instruct"]


def _value(v):
    """A config field compared across the packages (their SSMConfig and
    MoEConfig dataclasses are distinct types; the port's own SSM and MoE
    fields are left out)."""
    if not dataclasses.is_dataclass(v):
        return v
    return {k: x for k, x in dataclasses.asdict(v).items()
            if k not in SSM_PORT_ONLY and k not in MOE_PORT_ONLY}


def test_registry_and_config_copy():
    ported = ARCHS + SSM_ARCHS + WINDOWED_ARCHS + MOE_VLM_ARCHS + ENCDEC_ARCHS
    assert list_archs() == sorted(ported + PORT_ARCHS)
    for arch in ported:
        for ours, ref in ((get_smoke_config(arch), jax_smoke(arch)),
                          (get_config(arch), jax_config(arch))):
            ref_fields = {f.name for f in dataclasses.fields(ref)}
            assert ref_fields <= {f.name for f in dataclasses.fields(ours)}
            assert {k: getattr(ours, k) for k in PORT_ONLY} == PORT_ONLY
            if ours.ssm is not None:
                assert {k: getattr(ours.ssm, k) for k in SSM_PORT_ONLY} \
                    == SSM_PORT_ONLY
            if ours.moe is not None:
                assert {k: getattr(ours.moe, k) for k in MOE_PORT_ONLY} \
                    == MOE_PORT_ONLY
            diff = {f.name for f in dataclasses.fields(ours)
                    if f.name not in PORT_ONLY and (
                        f.name not in ref_fields
                        or _value(getattr(ours, f.name))
                        != _value(getattr(ref, f.name)))}
            # 'kernel' vs 'xla_flash', and the port's own ssd_impl
            assert diff == {"attn_impl", "ssd_impl"}, diff
            assert ours.attn_impl == "kernel" and ours.ssd_impl == "kernel"
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


@pytest.mark.parametrize("kw", [dict(kind="encdec", n_enc_layers=1),
                                dict(kind="audio", n_enc_layers=1)])
def test_unported_families_raise(kw):
    """The encoder-decoder families run dense only: a window on them (which
    no reference config has) raises."""
    cfg = ModelConfig(name="x", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=2, d_ff=64, vocab=128, window=16, **kw)
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


# ------------------------------------------------------- ssm and hybrid
@pytest.fixture(scope="module", params=SSM_ARCHS)
def ssm_pair(request):
    """(jax model, jax params, port model, port params, tokens (B, S)) for
    the Mamba2 stack and the zamba2 hybrid."""
    arch = request.param
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(0)
    cfg = get_smoke_config(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jm, jp, Model(cfg), tp, tokens


def test_ssm_forward_matches_jax(ssm_pair):
    """The SSD kernel's path (on the CPU its plain version) and the blocked
    plain scan give the reference's hidden states; the hybrid's shared
    attention through every prefill attention path too."""
    jm, jp, tm, tp, tokens = ssm_pair
    ref = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    out = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (B, S, tm.cfg.d_model)
    assert _err(out, ref) < TOL
    alts = [dict(ssd_impl="blocked")]
    if tm.cfg.kind == "hybrid":
        alts += [dict(attn_impl=impl) for impl in ("chunked", "xla_flash",
                                                   "naive")]
    for kw in alts:
        alt = Model(dataclasses.replace(tm.cfg, **kw))
        assert _err(alt.forward(tp, {"tokens": torch.from_numpy(tokens)}),
                    ref) < TOL, kw


def test_ssm_prefill_matches_jax(ssm_pair):
    """Every cache leaf (conv inputs, SSM states, the shared attention's
    K/V) and the last hidden state equal the reference prefill's."""
    jm, jp, tm, tp, tokens = ssm_pair
    jcache, jlast = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 32)
    cache, last = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, 32)
    assert set(cache) == set(jcache)
    want = {"pos", "conv", "state"} | ({"conv_tail", "state_tail",
                                        "k_shared", "v_shared"}
                                       if tm.cfg.kind == "hybrid" else set())
    assert set(cache) == want
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for key in want - {"pos"}:
        assert cache[key].shape == jcache[key].shape, key
        assert cache[key].dtype == getattr(torch, str(jcache[key].dtype))
        assert _err(cache[key], jcache[key]) < TOL, key
    assert _err(last, jlast) < TOL
    assert tm.cache_axes() == jm.cache_axes()


def test_ssm_decode_matches_forward_and_jax(ssm_pair):
    """Prompt tokens streamed through decode_step reproduce the full
    forward's greedy token at every position and the reference's decode
    tokens; a prefill continued by decode gives the same tokens."""
    jm, jp, tm, tp, tokens = ssm_pair
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
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL, key

    s0 = 9
    pre, last = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :s0])},
                           32)
    after = [embedloss.greedy(last, tp["embed"], cfg.vocab).numpy()]
    for t in range(s0, S):
        nxt, pre = tm.decode_step(tp, pre, torch.from_numpy(tokens[:, t]))
        after.append(nxt.numpy())
    assert (np.stack(after, 1) == dec[:, s0 - 1:]).all()


def test_ssm_reset_cache_lane_matches_jax(ssm_pair):
    """Slot reset wipes every leaf of the lane, SSM state included."""
    jm, jp, tm, tp, tokens = ssm_pair
    jcache, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, 32)
    cache, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, 32)
    assert tm.reset_cache_lane(cache, 1) is cache
    jcache = jm.reset_cache_lane(jcache, jnp.int32(1))
    axes = tm.cache_axes()
    for key, val in cache.items():
        assert _err(val, jcache[key]) < TOL, key
        lane = val.select(axes[key].index("batch"), 1)
        assert float(lane.abs().max()) == 0.0, key
    assert float(cache["state"].abs().max()) > 0.0


def test_ssm_param_count_and_layout_match_init(ssm_pair):
    jm, _, tm, _, _ = ssm_pair
    cfg = tm.cfg
    params = tm.init(0, device="cpu")
    shapes = jax.tree.map(lambda s: tuple(s.shape), jm.abstract_params())
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    actual = sum(t.numel() for t in jax.tree.leaves(params))
    assert actual == cfg.param_count()[0] + (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    group = "layers" if cfg.kind == "ssm" else "mamba"
    again, other = tm.init(0, device="cpu"), tm.init(1, device="cpu")
    assert torch.equal(params[group]["in_proj"], again[group]["in_proj"])
    assert not torch.equal(params[group]["in_proj"], other[group]["in_proj"])
    # the reference's constants, and every layer its own draw
    jp = jm.init(0)
    for name in ("dt_bias", "A_log", "D", "ssm_norm"):
        assert _err(params[group][name], jp[group][name]) < 1e-6, name
    w = params[group]["in_proj"].reshape(-1, *params[group]["in_proj"]
                                         .shape[-2:])
    assert not torch.equal(w[0], w[1])


def test_params_from_jax_walks_nested_groups():
    """The hybrid's nested groups are checked leaf by leaf."""
    jm = JaxModel(jax_smoke("zamba2-7b"))
    cfg = get_smoke_config("zamba2-7b")
    tree = jax.tree.map(np.asarray, jm.init(0))
    tp = params_from_jax(tree, cfg, device="cpu")
    assert set(tp) == {"embed", "ln_final", "mamba", "tail", "shared_attn"}
    assert _err(tp["shared_attn"]["wq"], tree["shared_attn"]["wq"]) == 0.0
    for group, leaf in (("tail", "A_log"), ("shared_attn", "w_up"),
                        ("mamba", "conv_w")):
        bad = jax.tree.map(np.asarray, jm.init(0))
        del bad[group][leaf]
        with pytest.raises(ValueError, match=group):
            params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, jm.init(0))
    bad["mamba"]["in_proj"] = bad["mamba"]["in_proj"][:1]
    with pytest.raises(ValueError, match="mamba/in_proj"):
        params_from_jax(bad, cfg, device="cpu")


def test_bf16_hybrid_runs_in_bf16():
    cfg = dataclasses.replace(get_smoke_config("zamba2-7b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    assert params["mamba"]["in_proj"].dtype == torch.bfloat16
    tokens = torch.arange(12).reshape(2, 6)
    cache, last = model.prefill(params, {"tokens": tokens}, 8)
    assert last.dtype == torch.bfloat16
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["state"].dtype == torch.float32
    nxt, cache = model.decode_step(params, cache, tokens[:, 0])
    assert nxt.dtype == torch.int32 and cache["pos"].tolist() == [7, 7]


def test_unknown_ssd_impl_raises():
    cfg = dataclasses.replace(get_smoke_config("mamba2-1.3b"),
                              ssd_impl="pallas")
    with pytest.raises(ValueError, match="ssd_impl"):
        Model(cfg)
