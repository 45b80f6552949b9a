"""The port's encoder-decoder family (whisper-small) against the JAX
reference on the CPU: the reference's parameters loaded with
``params_from_jax``, the same numpy-made tokens and frames through both,
fp32. Two configs: whisper-small's smoke config (head dim 16, 30 encoder
frames) and a mid-width one (head dim 64, the full model's, over 150
frames: a ragged non-causal key length for the kernel wrappers' CPU
paths).

Tolerances:
  encoder output, cross K/V, hidden states, cache leaves   2e-5 (fp32)
  greedy tokens, served tokens                             identical
  sinusoidal positions (fp32 and bf16)                     bit for bit
  cross-attention leaves' std at init                      5 % of 1/sqrt(d)
  kernel wrappers' CPU paths vs Pallas (interpret)         2e-5 fp32 / 2e-2
                                                           bf16
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
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.models import embedloss, transformer  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "whisper-small"
# the mid-width config: whisper-small's head dim 64 over 150 frames
MID = dict(name="whisper-small-mid", d_model=256, n_heads=4, n_kv_heads=4,
           head_dim=64, d_ff=512, enc_len=150)
B, S = 2, 17
TOL = 2e-5
CACHE_LEN = 32


def _configs(which):
    """(reference config, port config) of ``which``: smoke or mid."""
    ref, ours = jax_smoke(ARCH), get_smoke_config(ARCH)
    if which == "mid":
        ref, ours = (dataclasses.replace(c, **MID) for c in (ref, ours))
    return ref, ours


def _batch(cfg, seed=0):
    """numpy tokens (B, S) and frames (B, enc_len, D) ~ N(0, 1), as the
    reference's tests make them."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "frames": rng.normal(size=(B, cfg.enc_len, cfg.d_model))
            .astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=["smoke", "mid"])
def pair(request):
    """(jax model, jax params, port model, port params, numpy batch)."""
    jcfg, cfg = _configs(request.param)
    jm = JaxModel(jcfg)
    jp = jm.init(0)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jm, jp, Model(cfg), tp, _batch(cfg)


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("n,d", [(30, 64), (150, 256), (1500, 768)])
def test_sinusoid_matches_jax(n, d):
    """The encoder's positions equal the reference's bit for bit in fp32
    and, cast, in bf16 (the compute dtype they are added in)."""
    ours = transformer._sinusoid(n, d)
    ref = np.asarray(jtransformer._sinusoid(n, d))
    assert ours.dtype == torch.float32 and ours.shape == (n, d)
    assert np.array_equal(ours.numpy(), ref)
    bf16 = np.asarray(jtransformer._sinusoid(n, d).astype(jnp.bfloat16),
                      np.float32)
    assert np.array_equal(ours.to(torch.bfloat16).float().numpy(), bf16)


def test_encode_and_cross_kv_match_jax(pair):
    jm, jp, tm, tp, batch = pair
    frames = batch["frames"]
    enc = tm.encode(tp, torch.from_numpy(frames))
    jenc = jm.encode(jp, jnp.asarray(frames))
    assert enc.shape == (B, tm.cfg.enc_len, tm.cfg.d_model)
    assert _err(enc, jenc) < TOL
    kc, vc = tm.cross_kv(tp, enc)
    jkc, jvc = jm.cross_kv(jp, jenc)
    assert kc.shape == jkc.shape and vc.shape == jvc.shape
    assert _err(kc, jkc) < TOL and _err(vc, jvc) < TOL


def test_encoder_positions_are_computed_once(monkeypatch):
    """The host's float64 table is built once per (frames, device, dtype)
    and model, and reused by every later encode."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    calls = []
    sinusoid = transformer._sinusoid
    monkeypatch.setattr(transformer, "_sinusoid",
                        lambda n, d: calls.append(n) or sinusoid(n, d))
    frames = torch.from_numpy(_batch(cfg)["frames"])
    first = model.encode(params, frames)
    assert torch.equal(model.encode(params, frames), first)
    model.encode(params, frames[:, :7])
    assert calls == [cfg.enc_len, 7]


def test_forward_matches_jax(pair):
    """Hidden states at 2e-5 on every prefill attention path; the frames
    reach the decoder."""
    jm, jp, tm, tp, batch = pair
    ref = jm.forward(jp, _jax_batch(batch))
    out = tm.forward(tp, _torch_batch(batch))
    assert out.shape == (B, S, tm.cfg.d_model)
    assert _err(out, ref) < TOL
    for impl in ("chunked", "xla_flash", "naive"):
        alt = Model(dataclasses.replace(tm.cfg, attn_impl=impl))
        assert _err(alt.forward(tp, _torch_batch(batch)), ref) < TOL, impl
    other = dict(batch, frames=_batch(tm.cfg, 1)["frames"])
    assert float((tm.forward(tp, _torch_batch(other)) - out).abs().max()) \
        > 1e-2


def test_prefill_matches_jax(pair):
    """Every cache leaf, the cross K/V (all enc_len rows) included."""
    jm, jp, tm, tp, batch = pair
    jcache, jlast = jm.prefill(jp, _jax_batch(batch), CACHE_LEN)
    cache, last = tm.prefill(tp, _torch_batch(batch), CACHE_LEN)
    assert list(cache) == list(jcache) == ["pos", "k_self", "v_self",
                                           "k_cross", "v_cross"]
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for key in cache:
        assert cache[key].shape == jcache[key].shape, key
        assert _err(cache[key], jcache[key]) < TOL, key
    assert float(cache["k_cross"].abs().min(dim=2).values.max()) > 0.0
    assert _err(last, jlast) < TOL
    assert tm.cache_axes() == jm.cache_axes()


def test_init_cache_with_frames_matches_jax(pair):
    """``init_cache(params=, batch=)`` fills the cross K/V from the
    encoder, as the reference's, and they equal the prefill's."""
    jm, jp, tm, tp, batch = pair
    cache = tm.init_cache(B, CACHE_LEN, device="cpu", params=tp,
                          batch=_torch_batch(batch))
    jcache = jm.init_cache(B, CACHE_LEN, params=jp, batch=_jax_batch(batch))
    assert list(cache) == list(jcache)
    for key in cache:
        assert cache[key].shape == jcache[key].shape, key
        assert _err(cache[key], jcache[key]) < TOL, key
    pre, _ = tm.prefill(tp, _torch_batch(batch), CACHE_LEN)
    for key in ("k_cross", "v_cross"):
        assert float((cache[key] - pre[key]).abs().max()) < TOL, key
    zero = tm.init_cache(B, CACHE_LEN, device="cpu")
    assert float(zero["k_cross"].abs().max()) == 0.0


def test_decode_matches_forward(pair):
    """The reference's test_decode_matches_forward: tokens streamed
    through decode_step from ``init_cache(params=, batch=)`` give the full
    forward's greedy token at each of 17 positions."""
    _, _, tm, tp, batch = pair
    tb = _torch_batch(batch)
    x = tm.forward(tp, tb)
    fwd = torch.stack([embedloss.greedy(x[:, t], tp["embed"], tm.cfg.vocab)
                       for t in range(S)], dim=1)
    cache = tm.init_cache(B, CACHE_LEN, device="cpu", params=tp, batch=tb)
    dec = []
    for t in range(S):
        nxt, cache = tm.decode_step(tp, cache, tb["tokens"][:, t])
        dec.append(nxt)
    assert torch.equal(torch.stack(dec, dim=1), fwd)
    assert cache["pos"].tolist() == [S, S]


def test_decode_matches_jax(pair):
    """Decode tokens and every cache leaf equal the reference's step for
    step; so do the tokens of a prefill continued by decode."""
    jm, jp, tm, tp, batch = pair
    tb, jb = _torch_batch(batch), _jax_batch(batch)
    cache = tm.init_cache(B, CACHE_LEN, device="cpu", params=tp, batch=tb)
    jcache = jm.init_cache(B, CACHE_LEN, params=jp, batch=jb)
    step = jax.jit(jm.decode_step)
    dec, jdec = [], []
    for t in range(S):
        nxt, cache = tm.decode_step(tp, cache, tb["tokens"][:, t])
        jnxt, jcache = step(jp, jcache, jb["tokens"][:, t])
        dec.append(nxt.numpy())
        jdec.append(np.asarray(jnxt))
    assert (np.stack(dec, 1) == np.stack(jdec, 1)).all()
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL, key

    s0 = 11
    head = dict(batch, tokens=batch["tokens"][:, :s0])
    pre, last = tm.prefill(tp, _torch_batch(head), CACHE_LEN)
    jpre, jlast = jm.prefill(jp, _jax_batch(head), CACHE_LEN)
    tok = embedloss.greedy(last, tp["embed"], tm.cfg.vocab)
    jtok = jemb.greedy(jlast, jp["embed"], valid_vocab=tm.cfg.vocab)
    ours, ref = [tok.numpy()], [np.asarray(jtok)]
    for t in range(s0, S):
        tok, pre = tm.decode_step(tp, pre, tb["tokens"][:, t])
        jtok, jpre = step(jp, jpre, jb["tokens"][:, t])
        ours.append(tok.numpy())
        ref.append(np.asarray(jtok))
    assert (np.stack(ours, 1) == np.stack(ref, 1)).all()
    for key in pre:
        assert _err(pre[key], jpre[key]) < TOL, key


def test_reset_cache_lane_matches_jax(pair):
    """A reset lane is wiped in every leaf, the cross K/V included, as the
    reference's; the other lane keeps its rows."""
    jm, jp, tm, tp, batch = pair
    jcache, _ = jm.prefill(jp, _jax_batch(batch), CACHE_LEN)
    cache, _ = tm.prefill(tp, _torch_batch(batch), CACHE_LEN)
    assert tm.reset_cache_lane(cache, 1) is cache
    jcache = jm.reset_cache_lane(jcache, jnp.int32(1))
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL, key
    assert cache["pos"].tolist() == [S, 0]
    for key in ("k_self", "v_self", "k_cross", "v_cross"):
        assert float(cache[key][:, 1].abs().max()) == 0.0, key
        assert float(cache[key][:, 0].abs().max()) > 0.0, key


def _serve(engine_cls, req_cls, model, params, specs, slots):
    engine = engine_cls(model, params, batch_slots=slots, max_len=64)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    return reqs


def test_engine_matches_reference_engine():
    """Five requests through two slots (three admitted mid-run into freed
    slots) give the reference engine's tokens. Neither engine is given
    frames: both decode over zero cross K/V (the reference's engine)."""
    jm = JaxModel(jax_smoke(ARCH))
    jp = jm.init(0)
    cfg = get_smoke_config(ARCH)
    tm = Model(cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, cfg.vocab, n).tolist(), m)
             for n, m in ((3, 5), (6, 2), (2, 7), (4, 4), (5, 3))]
    ours = _serve(ServeEngine, Request, tm, tp, specs, 2)
    ref = _serve(JaxEngine, JaxRequest, jm, jp, specs, 2)
    assert [r.out for r in ours] == [r.out for r in ref]
    assert all(r.done and len(r.out) == n for r, (_, n) in zip(ours, specs))


@pytest.mark.parametrize("which", ["smoke", "mid"])
def test_init_layout_zero_norms_and_cross_fan_in(which):
    """The port's own init: the reference's leaf names, order and shapes;
    every norm scale zero, the cross-attention's ``cln_attn`` and the
    encoder's ``ln_enc_final`` included (the reference's ``norm``); the
    cross-attention weights drawn at fan-in d (``cwo``: Hq * hd)."""
    jcfg, cfg = _configs(which)
    jm, tm = JaxModel(jcfg), Model(cfg)
    params = tm.init(0, device="cpu")
    ref = jm.init(0)
    assert jax.tree.map(lambda t: tuple(t.shape), params) \
        == jax.tree.map(lambda a: tuple(a.shape), ref)
    assert list(params) == list(ref)
    for group in ("enc", "dec"):
        assert list(params[group]) == list(ref[group]), group
    actual = sum(t.numel() for t in jax.tree.leaves(params))
    assert actual == cfg.param_count()[0] + (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    dec = params["dec"]
    for name in ("ln_attn", "cln_attn", "ln_mlp"):
        assert float(dec[name].abs().max()) == 0.0, name
    assert float(params["ln_enc_final"].abs().max()) == 0.0
    for name, fan_in in (("cwq", cfg.d_model), ("cwk", cfg.d_model),
                         ("cwv", cfg.d_model),
                         ("cwo", cfg.n_heads * cfg.hd)):
        std = float(dec[name].std())
        assert abs(std * np.sqrt(fan_in) - 1.0) < 0.05, (name, std)
    assert not torch.equal(dec["cwq"], dec["wq"])


def test_params_from_jax_walks_enc_and_dec():
    """The encoder, the decoder's cross-attention and ``ln_enc_final``
    load exactly; a missing or misshapen leaf raises naming it."""
    jm = JaxModel(jax_smoke(ARCH))
    cfg = get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jm.init(0))
    tp = params_from_jax(tree, cfg, device="cpu")
    for group, leaf in (("enc", "wq"), ("dec", "cwk"), ("dec", "cln_attn"),
                        ("dec", "w_down")):
        assert _err(tp[group][leaf], tree[group][leaf]) == 0.0, leaf
    assert _err(tp["ln_enc_final"], tree["ln_enc_final"]) == 0.0
    bad = jax.tree.map(np.asarray, jm.init(0))
    del bad["dec"]["cwv"]
    with pytest.raises(ValueError, match="dec"):
        params_from_jax(bad, cfg, device="cpu")
    bad = jax.tree.map(np.asarray, jm.init(0))
    bad["enc"]["wo"] = bad["enc"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="enc/wo"):
        params_from_jax(bad, cfg, device="cpu")


def test_bf16_whisper_runs_in_bf16():
    cfg = dataclasses.replace(get_smoke_config(ARCH), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    assert params["dec"]["cwq"].dtype == torch.bfloat16
    batch = _torch_batch(_batch(cfg))
    cache, last = model.prefill(params, batch, CACHE_LEN)
    assert last.dtype == torch.bfloat16
    assert all(cache[k].dtype == torch.bfloat16 for k in cache if k != "pos")
    assert bool(torch.isfinite(last).all())
    nxt, cache = model.decode_step(params, cache, batch["tokens"][:, 0])
    assert nxt.dtype == torch.int32 and cache["pos"].tolist() == [S + 1] * B


# ------------------------------------------------------- kernel wrappers
# b, hq, hkv, sq, skv, d: cross-attention's shape cut down, non-causal with
# a ragged key length (150 = 2 * 64 + 22)
RAGGED_CASE = (1, 4, 4, 40, 150, 64)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("two_pass", [False, True], ids=["flash", "two_pass"])
def test_kernel_wrappers_noncausal_ragged_match_pallas_interpret(
        two_pass, dtype, tol):
    """Both kernel wrappers' CPU paths, non-causal over a ragged key
    length, against the reference's Pallas kernels in interpret mode;
    nothing is launched."""
    b, hq, hkv, sq, skv, d = RAGGED_CASE
    rng = np.random.default_rng(20)
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
    out = wrapper(q, k, v, causal=False)
    ref = pallas(jq, jk, jv, causal=False, bq=64, bk=64, interpret=True)
    assert build.launches[key] == before
    assert out.shape == (b, hq, sq, d) and out.dtype == q.dtype
    assert _err(out, ref) < tol
