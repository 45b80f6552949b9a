"""The port's moe family (arctic-480b, kimi-k2-1t smoke configs) and vlm
family (internvl2-26b smoke, with patch embeddings) against the JAX
reference on the CPU: the reference's parameters loaded with
``params_from_jax``, the same numpy-made tokens and patches through both,
fp32, capacity as configured (drops included) unless named.

Tolerances:
  hidden states, cache leaves             1e-5 (fp32)
  greedy tokens, served tokens            identical
  expert leaves' std at init              5 % of 1/sqrt(fan-in)
  kernel wrappers' CPU paths vs Pallas    2e-5 fp32 / 2e-2 bf16 (interpret)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.chunked import chunked_attention_tpu  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa: E402
from repro.models import embedloss as jemb  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.models import embedloss  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

MOE_ARCHS = ["arctic-480b", "kimi-k2-1t-a32b"]
ARCHS = MOE_ARCHS + ["internvl2-26b"]
B, S = 2, 17
TOL = 1e-5


def _batch(cfg, seed):
    """numpy tokens (B, S) and, for vlm, patches (B, n_patches, D) at the
    embedding table's scale."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.kind == "vlm":
        out["patches"] = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
                          / np.sqrt(cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _ample(cfg):
    """The config with capacity factor E: nothing drops, so a token's
    output does not depend on how many tokens share its forward."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax model, jax params, port model, port params, numpy batch)."""
    arch = request.param
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(0)
    cfg = get_smoke_config(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, Model(cfg), tp, _batch(cfg, 0)


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


def _greedy_all(model, params, x):
    return torch.stack([embedloss.greedy(x[:, t], params["embed"],
                                         model.cfg.vocab)
                        for t in range(x.shape[1])], dim=1).numpy()


def test_forward_matches_jax(pair):
    """Hidden states at 1e-5 on every prefill attention path; a vlm's
    patches really replace the first positions."""
    jm, jp, tm, tp, batch = pair
    ref = jm.forward(jp, _jax_batch(batch))
    out = tm.forward(tp, _torch_batch(batch))
    assert out.shape == (B, S, tm.cfg.d_model)
    assert _err(out, ref) < TOL
    for impl in ("chunked", "xla_flash", "naive"):
        alt = Model(dataclasses.replace(tm.cfg, attn_impl=impl))
        assert _err(alt.forward(tp, _torch_batch(batch)), ref) < TOL, impl
    if tm.cfg.kind == "vlm":
        text = tm.forward(tp, {"tokens": torch.from_numpy(batch["tokens"])})
        assert float((text - out).abs().max()) > 1e-2
        assert _err(text, jm.forward(jp, {"tokens": jnp.asarray(
            batch["tokens"])})) < TOL


def test_prefill_matches_jax(pair):
    jm, jp, tm, tp, batch = pair
    jcache, jlast = jm.prefill(jp, _jax_batch(batch), 32)
    cache, last = tm.prefill(tp, _torch_batch(batch), 32)
    assert set(cache) == set(jcache) == {"pos", "k", "v"}
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for key in ("k", "v"):
        assert cache[key].shape == jcache[key].shape
        assert _err(cache[key], jcache[key]) < TOL
    assert _err(last, jlast) < TOL
    assert tm.cache_axes() == jm.cache_axes()


def test_decode_matches_forward(pair):
    """With capacity factor E (as the reference's test_decode_matches_forward
    runs arctic), tokens streamed through decode_step give the full
    forward's greedy token at every position."""
    _, jp, tm, _, batch = pair
    model = Model(_ample(tm.cfg))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), model.cfg,
                         device="cpu")
    tokens = torch.from_numpy(batch["tokens"])
    fwd = _greedy_all(model, tp, model.forward(tp, {"tokens": tokens}))
    cache = model.init_cache(B, 32, device="cpu")
    dec = []
    for t in range(S):
        nxt, cache = model.decode_step(tp, cache, tokens[:, t])
        dec.append(nxt.numpy())
    assert (np.stack(dec, 1) == fwd).all()


def test_decode_matches_jax(pair):
    """At the configured capacity (a decode step's tokens may drop), the
    decode tokens and cache equal the reference's token for token; so do
    the tokens of a prefill (with its patches) continued by decode."""
    jm, jp, tm, tp, batch = pair
    tokens = batch["tokens"]
    cache = tm.init_cache(B, 32, device="cpu")
    jcache = jm.init_cache(B, 32)
    step = jax.jit(jm.decode_step)
    dec, jdec = [], []
    for t in range(S):
        nxt, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]))
        jnxt, jcache = step(jp, jcache, jnp.asarray(tokens[:, t]))
        dec.append(nxt.numpy())
        jdec.append(np.asarray(jnxt))
    assert (np.stack(dec, 1) == np.stack(jdec, 1)).all()
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL, key

    s0 = 11
    head = {k: (v[:, :s0] if k == "tokens" else v) for k, v in batch.items()}
    pre, last = tm.prefill(tp, _torch_batch(head), 32)
    jpre, jlast = jm.prefill(jp, _jax_batch(head), 32)
    tok = embedloss.greedy(last, tp["embed"], tm.cfg.vocab)
    jtok = jemb.greedy(jlast, jp["embed"], valid_vocab=tm.cfg.vocab)
    ours, ref = [tok.numpy()], [np.asarray(jtok)]
    for t in range(s0, S):
        tok, pre = tm.decode_step(tp, pre, torch.from_numpy(tokens[:, t]))
        jtok, jpre = step(jp, jpre, jnp.asarray(tokens[:, t]))
        ours.append(tok.numpy())
        ref.append(np.asarray(jtok))
    assert (np.stack(ours, 1) == np.stack(ref, 1)).all()
    assert _err(pre["k"], jpre["k"]) < TOL


def test_reset_cache_lane_matches_jax(pair):
    jm, jp, tm, tp, batch = pair
    jcache, _ = jm.prefill(jp, _jax_batch(batch), 32)
    cache, _ = tm.prefill(tp, _torch_batch(batch), 32)
    assert tm.reset_cache_lane(cache, 1) is cache
    jcache = jm.reset_cache_lane(jcache, jnp.int32(1))
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL, key
    assert cache["pos"].tolist() == [S, 0]
    assert float(cache["k"][:, 1].abs().max()) == 0.0
    assert float(cache["k"][:, 0].abs().max()) > 0.0


def test_param_count_and_layout_match_init(pair):
    jm, _, tm, _, _ = pair
    cfg = tm.cfg
    params = tm.init(0, device="cpu")
    shapes = jax.tree.map(lambda s: tuple(s.shape), jm.abstract_params())
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert list(params["layers"]) == list(tm.param_shapes()["layers"])
    actual = sum(t.numel() for t in jax.tree.leaves(params))
    assert actual == cfg.param_count()[0] + (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    if cfg.kind == "moe":
        want = {"router", "moe_gate", "moe_up", "moe_down"}
        if cfg.moe.dense_residual:
            want |= {"w_gate", "w_up", "w_down"}
        assert want <= set(params["layers"])
        assert ("w_gate" in params["layers"]) == cfg.moe.dense_residual


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_draws_experts_at_the_reference_fan_in(arch, monkeypatch):
    """Expert leaves (L, E, d, f) have std 1/sqrt(d) (``moe_down`` (L, E,
    f, d): 1/sqrt(f)), the reference's ``in_axis=ns + 1``, not 1/sqrt(E);
    and no fp32 draw is larger than one (layer, expert) slice."""
    cfg = get_smoke_config(arch)
    m = cfg.moe
    draws = []
    randn = torch.randn

    def recording(*args, **kw):
        out = randn(*args, **kw)
        draws.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", recording)
    params = Model(cfg).init(0, device="cpu")
    monkeypatch.undo()
    layers = params["layers"]
    for name, fan_in in (("moe_gate", cfg.d_model), ("moe_up", cfg.d_model),
                         ("moe_down", m.d_ff_expert)):
        std = float(layers[name].std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (name, std)
        assert abs(std * np.sqrt(m.n_experts) - 1.0) > 0.3, (name, std)
    assert float(layers["router"].std()) * np.sqrt(cfg.d_model) \
        == pytest.approx(1.0, abs=0.05)
    per_layer = cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
    assert max(draws) <= max(per_layer, cfg.padded_vocab * cfg.d_model)
    slice_ = cfg.d_model * m.d_ff_expert
    assert draws.count(slice_) >= 3 * cfg.n_layers * m.n_experts
    a, b = layers["moe_gate"][0, 0], layers["moe_gate"][0, 1]
    assert not torch.equal(a, b)


def test_params_from_jax_walks_the_moe_leaves():
    """arctic's expert leaves and dense residual load exactly; a missing
    or misshapen moe leaf raises naming it."""
    jm = JaxModel(jax_smoke("arctic-480b"))
    cfg = get_smoke_config("arctic-480b")
    tree = jax.tree.map(np.asarray, jm.init(0))
    tp = params_from_jax(tree, cfg, device="cpu")
    for leaf in ("router", "moe_gate", "moe_up", "moe_down", "w_gate",
                 "w_up", "w_down"):
        assert _err(tp["layers"][leaf], tree["layers"][leaf]) == 0.0, leaf
    for leaf in ("moe_down", "w_up", "router"):
        bad = jax.tree.map(np.asarray, jm.init(0))
        del bad["layers"][leaf]
        with pytest.raises(ValueError, match="layers"):
            params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, jm.init(0))
    bad["layers"]["moe_gate"] = bad["layers"]["moe_gate"][:, :-1]
    with pytest.raises(ValueError, match="layers/moe_gate"):
        params_from_jax(bad, cfg, device="cpu")
    # kimi has no dense residual: arctic's leaves do not load into it
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(tree, get_smoke_config("kimi-k2-1t-a32b"),
                        device="cpu")


def test_bf16_moe_runs_in_bf16():
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    assert params["layers"]["moe_gate"].dtype == torch.bfloat16
    tokens = torch.arange(12).reshape(2, 6)
    cache, last = model.prefill(params, {"tokens": tokens}, 8)
    assert last.dtype == torch.bfloat16 and cache["k"].dtype == torch.bfloat16
    assert bool(torch.isfinite(last).all())
    nxt, cache = model.decode_step(params, cache, tokens[:, 0])
    assert nxt.dtype == torch.int32 and cache["pos"].tolist() == [7, 7]


@pytest.mark.parametrize("kind,window", [("moe", 16), ("vlm", 16),
                                         ("audio", 16)])
def test_windowed_moe_vlm_and_audio_raise(kind, window):
    cfg = dataclasses.replace(get_smoke_config(
        "arctic-480b" if kind == "moe" else "internvl2-26b"), kind=kind,
        window=window)
    with pytest.raises(NotImplementedError, match="Queue A"):
        Model(cfg)


# -------------------------------------------------------------- serving
def _serve(engine_cls, req_cls, model, params, specs, slots):
    engine = engine_cls(model, params, batch_slots=slots, max_len=64)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    return reqs


@pytest.mark.parametrize("cf", [1.25, 8.0], ids=["drops", "ample"])
def test_engine_matches_reference_engine(cf):
    """arctic smoke: five requests through two slots (three admitted
    mid-run into freed slots) give the reference engine's tokens, at the
    configured capacity (C = 1 per step: two lanes on one expert drop the
    second) and at ample capacity."""
    jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=cf)) for c in (jax_smoke("arctic-480b"),
                                              get_smoke_config("arctic-480b")))
    jm = JaxModel(jcfg)
    jp = jm.init(0)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, 256, n).tolist(), m)
             for n, m in ((3, 5), (6, 2), (2, 7), (4, 4), (5, 3))]
    ours = _serve(ServeEngine, Request, tm, tp, specs, 2)
    ref = _serve(JaxEngine, JaxRequest, jm, jp, specs, 2)
    assert [r.out for r in ours] == [r.out for r in ref]
    assert all(r.done and len(r.out) == n for r, (_, n) in zip(ours, specs))


# ------------------------------------------------------- kernel wrappers
GQA7_CASE = (1, 14, 2, 256, 256, 128)     # b, hq, hkv, sq, skv, d: group 7


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("two_pass", [False, True], ids=["flash", "two_pass"])
def test_kernel_wrappers_gqa_group_7_match_pallas_interpret(two_pass, dtype,
                                                            tol):
    """arctic's GQA group (56 q heads over 8 kv heads: 7) through both
    kernel wrappers' CPU paths, causal, against the reference's Pallas
    kernels in interpret mode; nothing is launched."""
    b, hq, hkv, sq, skv, d = GQA7_CASE
    rng = np.random.default_rng(7)
    arrs = [rng.normal(size=(b, h, s, d)).astype(np.float32)
            for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in arrs)
    key, wrapper, pallas = (("chunked_attention",
                             chunked.chunked_attention_cuda,
                             chunked_attention_tpu) if two_pass else
                            ("flash_attention", fa.flash_attention_cuda,
                             flash_attention_tpu))
    before = build.launches[key]
    out = wrapper(q, k, v, causal=True)
    ref = pallas(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    assert build.launches[key] == before
    assert out.shape == (b, hq, sq, d) and out.dtype == q.dtype
    assert _err(out, ref) < tol
