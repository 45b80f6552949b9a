"""IBM's Granite 4.0-H (``granite-4.0-h-small``) in the port: the layer
pattern given as data, the dropless MoE with its shared expert, attention
without positional encoding, the multipliers, the mixed cache. On the CPU
at the smoke size (one whole period: attention at layer 2 among four
Mamba2 layers, 8 experts top-3, fp32). The port's logits are held here
against the plain reference of the published equations
(``bench/reference/granite.py``, loaded from its file: it imports torch
alone); decoding through the cache against that reference, and the
reference against transformers' model, are in
``bench/tests/test_bench_granite.py``.

Tolerances: the port against the plain reference computes the same fp32
function in another order of operations (the blocked SSD scan against the
masked decay over the whole sequence, the batched experts against one
expert at a time), which differ at the level of fp32 rounding grown
through 5 layers: 1e-4 relative on logits. Decoding through the cache against the full forward computes
the same fp32 function in another order of sums (the SSD's step update
against its blocked scan): 1e-5 relative. The dropless layer against the
per-expert oracle sums the same products in another order: 1e-5.

On the card (``-m chip``, skipped without CUDA; ``python -m pytest
tests/test_torch_granite.py -m chip``): the decode update kernel at one
Granite Mamba2 layer (32 lanes, 128 heads x 64, d_state 128, one group)
against the plain ops, the flash kernel at head dim 128 with the softmax
scale 1/128 on unrotated q and k against its plain version, and the smoke
config's captured decode against its eager one.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.pointwise import kernel as pw  # noqa: E402
from repro_torch.models import embedloss, moe, transformer  # noqa: E402
from repro_torch.models.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "granite-4.0-h-small"
B, S = 2, 19
REF_REL = 1e-4       # the port vs the plain reference, logits
CACHE_REL = 1e-5     # decode through the cache vs the full forward
MOE_REL = 1e-5       # the dropless layer vs the per-expert oracle


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(seed=3, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S)).astype(np.int64))
    return cfg, model, params, tokens


def test_published_widths():
    """Every published width, counted from the leaf shapes alone (no
    tensor is made): 32,207,337,984 parameters, the analytic count too,
    8.8 billion of them active a token."""
    cfg = get_config(ARCH)
    assert cfg.patterned and cfg.n_layers == 40 and cfg.d_model == 4096
    assert [i for i, t in enumerate(cfg.layer_types) if t == "attention"] \
        == [5, 15, 25, 35]
    assert cfg.layer_types.count("mamba") == 36
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (32, 8, 128)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.dense_residual,
            m.dropless) == (72, 10, 768, True, True)
    assert cfg.d_ff == 1536 and cfg.vocab == cfg.padded_vocab == 100352
    s = cfg.ssm
    assert (s.n_heads(4096), s.head_dim, s.d_state, s.n_groups, s.conv_bias) \
        == (128, 64, 128, 1, True)
    assert not cfg.rope and cfg.attn_scale == 1 / 128
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.norm_eps) == (12.0, 0.22, 16.0, 1e-5)
    shapes = Model(cfg).param_shapes()

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return math.prod(t)

    total, active = cfg.param_count()
    assert count(shapes) == total == 32_207_337_984
    assert active == 8_803_121_664
    assert shapes["ssm"]["in_proj"] == (36, 4096, 8192 + 8448 + 128)
    assert shapes["attn"]["wk"] == (4, 4096, 1024)
    assert shapes["ffn"]["moe_gate"] == (40, 72, 4096, 768)
    assert shapes["ffn"]["w_down"] == (40, 1536, 4096)


def test_smoke_config_keeps_a_whole_period():
    cfg, full = get_smoke_config(ARCH), get_config(ARCH)
    assert cfg.patterned and "attention" in cfg.layer_types
    assert cfg.layer_types[0] == "mamba" and cfg.layer_types[-1] == "mamba"
    for field in ("rope", "embedding_multiplier", "residual_multiplier",
                  "logits_scaling"):
        assert getattr(cfg, field) == getattr(full, field), field
    assert cfg.moe.dropless and cfg.moe.dense_residual
    assert cfg.moe.n_experts >= 8 and cfg.moe.top_k > 1


def test_other_configs_keep_their_defaults():
    """The new fields leave every other configuration as it was: RoPE on,
    no multiplier, capacity that may drop, the attention's default scale
    (Zyphra's derived one)."""
    from repro_torch.models.config import list_archs

    for arch in list_archs():
        if arch == ARCH:
            continue
        cfg = get_config(arch)
        assert not cfg.layer_types and cfg.rope and not cfg.softmax_scale
        assert (cfg.embedding_multiplier, cfg.residual_multiplier,
                cfg.logits_scaling) == (1.0, 1.0, 1.0)
        assert cfg.moe is None or not cfg.moe.dropless
        assert cfg.attn_scale == ((cfg.hd / 2) ** -0.5 if cfg.zyphra
                                  else None)


def test_pattern_is_checked():
    cfg = get_smoke_config(ARCH)
    for bad in ({"layer_types": cfg.layer_types[:-1]},
                {"layer_types": cfg.layer_types[:-1] + ("mlp",)},
                {"moe": None}):
        with pytest.raises(ValueError, match="layer_types"):
            Model(dataclasses.replace(cfg, **bad))


def test_prefill_then_decode_matches_forward(smoke, monkeypatch):
    """Prefill 7 positions, then decode the rest one token a step through
    the cache: each step's last hidden state equals the full forward's at
    that position, its greedy token too, and the cache afterwards equals a
    prefill of the whole sequence (K/V, conv and SSM state)."""
    cfg, model, params, tokens = smoke
    seen = []
    greedy = embedloss.greedy

    def record(x, table, **kw):
        seen.append(x.clone())
        return greedy(x, table, **kw)

    with torch.no_grad():
        full = model.forward(params, {"tokens": tokens})
        cache, last = model.prefill(params, {"tokens": tokens[:, :7]},
                                    cache_len=32)
        assert _rel(last, full[:, 6]) < CACHE_REL
        monkeypatch.setattr(transformer.embedloss, "greedy", record)
        for t in range(7, S):
            nxt, cache = model.decode_step(params, cache,
                                           tokens[:, t].to(torch.int32))
            assert _rel(seen[-1], full[:, t]) < CACHE_REL
            assert torch.equal(nxt, greedy(full[:, t], params["embed"],
                                           valid_vocab=cfg.vocab))
        monkeypatch.undo()
        whole, _ = model.prefill(params, {"tokens": tokens}, cache_len=32)
    assert set(cache) == {"pos", "conv", "state", "k", "v"}
    for key in cache:
        assert _rel(cache[key].float(), whole[key].float()) < CACHE_REL, key


def _reference():
    """``bench/reference/granite.py``'s ``Reference``, loaded from its file."""
    path = Path(__file__).resolve().parents[1] / "bench" / "reference" \
        / "granite.py"
    spec = importlib.util.spec_from_file_location("granite_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Reference


def _reference_dims(cfg) -> dict:
    """What the reference reads of a configuration file's ``as_run``, from
    the port's config: its effective softmax scale included."""
    return {"kind": cfg.kind, "vocab": cfg.vocab, "norm_eps": cfg.norm_eps,
            "layer_types": list(cfg.layer_types), "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd,
            "softmax_scale": cfg.attn_scale,
            "embedding_multiplier": cfg.embedding_multiplier,
            "residual_multiplier": cfg.residual_multiplier,
            "logits_scaling": cfg.logits_scaling,
            "ssm": dataclasses.asdict(cfg.ssm),
            "moe": dataclasses.asdict(cfg.moe)}


def test_prefill_logits_match_plain_reference(smoke):
    """The port's logits at every position of the forward, and at the last
    position of a prefill, equal the plain reference's in fp32. Each
    published constant matters at this size: the reference with the
    softmax scale, the residual or the embedding multiplier of another
    model departs from the port by far more than the tolerance."""
    cfg, model, params, tokens = smoke
    Reference = _reference()
    dims = _reference_dims(cfg)
    with torch.no_grad():
        got = model.logits(params, model.forward(params, {"tokens": tokens}))
        _, last = model.prefill(params, {"tokens": tokens}, cache_len=32)
        last = model.logits(params, last)
    ref = Reference(dims, params)
    want = ref.logits(ref.hidden(tokens))
    assert _rel(got, want) < REF_REL
    assert _rel(last, want[:, -1]) < REF_REL
    for key, other in (("softmax_scale", cfg.hd ** -0.5),
                       ("residual_multiplier", 1.0),
                       ("embedding_multiplier", 1.0)):
        off = Reference({**dims, key: other}, params)
        assert _rel(got, off.logits(off.hidden(tokens))) > 100 * REF_REL, key


def test_mixed_cache_layout_and_lane_reset(smoke):
    """One conv and fp32 SSM state a Mamba2 layer, one K/V an attention
    layer; ``reset_cache_lane`` zeroes exactly one lane of every kind and
    leaves the other lane as it was."""
    cfg, model, params, tokens = smoke
    with torch.no_grad():
        cache, _ = model.prefill(params, {"tokens": tokens[:, :5]},
                                 cache_len=16)
    s = cfg.ssm
    n_attn = cfg.layer_types.count("attention")
    n_ssm = cfg.n_layers - n_attn
    assert cache["k"].shape == (n_attn, B, 16, cfg.n_kv_heads, cfg.hd)
    assert cache["state"].shape == (n_ssm, B, s.n_heads(cfg.d_model),
                                    s.head_dim, s.d_state)
    assert cache["state"].dtype == torch.float32
    assert cache["conv"].shape == (n_ssm, B, s.conv_width - 1,
                                   2 * cfg.d_model + 2 * s.d_state)
    other = {k: (v[0] if k == "pos" else v[:, 0]).clone()
             for k, v in cache.items()}
    model.reset_cache_lane(cache, 1)
    for key, leaf in cache.items():
        lane = leaf[1] if key == "pos" else leaf[:, 1]
        kept = leaf[0] if key == "pos" else leaf[:, 0]
        assert not lane.any(), key
        assert kept.any() and torch.equal(kept, other[key]), key


def _layer_moe(cfg, params, i=0):
    f = {k: v[i] for k, v in params["ffn"].items()}
    return f, {"router": f["router"], "w_gate": f["moe_gate"],
               "w_up": f["moe_up"], "w_down": f["moe_down"]}


@pytest.mark.parametrize("t", [4, moe.DROPLESS_STATIC_T + 37],
                         ids=["decode", "prefill"])
def test_no_assignment_dropped_with_a_biased_router(smoke, t):
    """The router biased so that every token's first choice is expert 0:
    the dropless layer equals the per-expert oracle, at decode's token
    count (C = T, static) and above ``DROPLESS_STATIC_T`` (C read from the
    counts); the same layer with the default capacity drops and misses."""
    cfg, model, params, _ = smoke
    _, p = _layer_moe(cfg, params)
    router = p["router"].clone()
    router[:, 0] += 10.0 * router.abs().max()
    p = {**p, "router": router}
    x = torch.randn(t, cfg.d_model, generator=torch.Generator().manual_seed(5))
    x = x.abs() + 0.1            # every token's logit for expert 0 the largest
    _, experts = moe.route(x, router, cfg.moe.top_k)
    assert bool((experts[:, 0] == 0).all())
    want = moe.moe_dense_oracle(x, p, cfg.moe)
    got = moe.moe_local(x, p, cfg.moe)
    assert _rel(got, want) < MOE_REL
    capped = dataclasses.replace(cfg.moe, dropless=False)
    assert moe._capacity(t, capped) < t
    assert _rel(moe.moe_local(x, p, capped), want) > 1e-2


def test_ffn_is_the_experts_plus_the_shared_expert(smoke):
    """A layer's FFN adds r (MoE(h) + SwiGLU_shared(h)) to x, h the normed
    input, r the residual multiplier: the oracle's experts plus the shared
    expert, computed here from the leaves."""
    cfg, model, params, _ = smoke
    f, p = _layer_moe(cfg, params, i=1)
    x = torch.randn(1, 6, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got = model._ffn(f, x)
    h = transformer.rms_norm(x, f["ln_mlp"], cfg.norm_eps)
    shared = (F.silu(h @ f["w_gate"]) * (h @ f["w_up"])) @ f["w_down"]
    experts = moe.moe_dense_oracle(h[0], p, cfg.moe)[None]
    want = x + cfg.residual_multiplier * (experts + shared)
    assert _rel(got, want) < MOE_REL


def _rope_refused(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("RoPE applied to a NoPE attention")
    monkeypatch.setattr(transformer, "apply_rope", refuse)
    monkeypatch.setattr(transformer, "rope_table", refuse)
    monkeypatch.setattr(pw, "rope_qk_cuda", refuse)


def test_nope_applies_no_rope_in_prefill_or_decode(smoke, monkeypatch):
    """No RoPE in the sequence forward, the prefill or the decode step;
    the same model with RoPE on computes something else, so the check
    above would see it."""
    cfg, model, params, tokens = smoke
    with torch.no_grad():
        want = model.forward(params, {"tokens": tokens})
        _rope_refused(monkeypatch)
        assert torch.equal(model.forward(params, {"tokens": tokens}), want)
        cache, _ = model.prefill(params, {"tokens": tokens[:, :5]},
                                 cache_len=16)
        for t in range(5, 8):
            model.decode_step(params, cache, tokens[:, t].to(torch.int32))
        monkeypatch.undo()
        roped = Model(dataclasses.replace(cfg, rope=True))
        assert _rel(roped.forward(params, {"tokens": tokens}), want) > 1e-3


def test_nope_fused_route_runs_no_rope_kernel(smoke, monkeypatch):
    """With the fused route taken (forced on the CPU, the wrappers then
    run the plain ops), a NoPE attention block takes its norm and the
    residual-add norm and never the RoPE kernel; every layer's FFN takes
    the residual-add norm and the shared expert's gate; the hidden states
    are the plain path's."""
    cfg, model, params, tokens = smoke
    with torch.no_grad():
        plain = model.forward(params, {"tokens": tokens})
    calls = dict.fromkeys(("rms_norm_cuda", "add_rms_norm_cuda",
                           "swiglu_gate_cuda"), 0)
    for name in calls:
        fn = getattr(pw, name)

        def counted(*args, _name=name, _fn=fn):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(pw, name, counted)
    monkeypatch.setattr(pw, "takes", lambda x: True)
    _rope_refused(monkeypatch)
    with torch.no_grad():
        fused = model.forward(params, {"tokens": tokens})
    assert torch.equal(fused, plain)
    n_attn = cfg.layer_types.count("attention")
    assert calls == {"rms_norm_cuda": n_attn, "add_rms_norm_cuda":
                     cfg.n_layers, "swiglu_gate_cuda": cfg.n_layers}


def test_multipliers(smoke):
    """The embedding is multiplied by ``embedding_multiplier``, the loss
    scores ``Model.logits`` (the head's logits divided by
    ``logits_scaling``), and with every multiplier at 1 the model is
    another function."""
    cfg, model, params, tokens = smoke
    with torch.no_grad():
        x = model._embed(params, tokens)
        assert torch.equal(x, params["embed"][tokens] * 12.0)
        h = model.forward(params, {"tokens": tokens})
        labels = torch.roll(tokens, -1, 1)
        loss = model.loss(params, {"tokens": tokens, "labels": labels})
        logits = model.logits(params, h)
        want = F.cross_entropy(logits.reshape(-1, cfg.vocab),
                               labels.reshape(-1))
        assert float(loss) == pytest.approx(float(want), rel=1e-5)
        assert torch.equal(logits, (h @ params["embed"].T)[..., :cfg.vocab]
                           / 16.0)
        plain = Model(dataclasses.replace(
            cfg, embedding_multiplier=1.0, residual_multiplier=1.0))
        assert _rel(plain.forward(params, {"tokens": tokens}), h) > 1e-2


def test_serve_engine_matches_forward_per_request(smoke):
    """Five requests through two slots, three admitted into lanes freed
    and reset mid-run: each request's tokens are the greedy continuation
    of its own prompt by the full forward, position by position."""
    cfg, model, params, _ = smoke
    rng = np.random.default_rng(5)
    specs = [(rng.integers(0, cfg.vocab, n).tolist(), m)
             for n, m in ((4, 5), (7, 3), (2, 6), (5, 4), (3, 3))]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(specs)]
    engine = ServeEngine(model, params, batch_slots=2, max_len=32)
    for r in reqs[:3]:
        engine.submit(r)
    for _ in range(4):
        engine.step()
    for r in reqs[3:]:
        engine.submit(r)
    engine.run_until_idle()
    for r in reqs:
        assert r.done and len(r.out) == r.max_new_tokens
        seq = torch.tensor([r.prompt + r.out[:-1]])
        with torch.no_grad():
            h = model.forward(params, {"tokens": seq})[0, len(r.prompt) - 1:]
        want = model.logits(params, h).argmax(-1)
        assert r.out == want.tolist(), r.rid


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    """The CUDA device; skips the test where this host has none (decided
    when the test runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# one Mamba2 layer of the cell's step: 32 lanes, 128 heads x 64, d_state
# 128, one group; the attention layers' prefill shape, 32 / 8 heads x 128
UPDATE_SHAPE = (32, 128, 64, 128)
ATTN_SHAPE = (2, 32, 8, 2048, 128)
Y_REL = 1e-5         # y's sum over N in another order than the plain GEMV
ATTN_ABS = 2e-2      # bf16 output against the fp32 plain version


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_decode_update_at_granite_layer_on_card(card, dtype):
    """The decode update kernel at one Granite Mamba2 layer (d_state 128,
    one group, x/B/C as column views of one projection): the state bit
    for bit against the plain ops, y within 1e-5, one launch."""
    from repro_torch.kernels.ssd_scan import decode as sd
    from repro_torch.kernels.ssd_scan.ref import ssd_decode_step

    b, h, p, n = UPDATE_SHAPE
    gen = torch.Generator(device=card).manual_seed(21)
    xbc = F.silu(torch.randn(b, 1, h * p + 2 * n, generator=gen,
                             device=card)).to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))[:, 0]
    bm, cm = xbc[:, 0, h * p:h * p + n], xbc[:, 0, h * p + n:]
    dt = F.softplus(torch.randn(b, 1, h, generator=gen, device=card)
                    + 1.0)[:, 0]
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=card)
    state = torch.randn(b, h, p, n, generator=gen, device=card)
    want_y, want_s = ssd_decode_step(state, x, dt, a, bm, cm)
    before = build.launches["ssd_decode"]
    y = sd.ssd_decode_update(state, x, dt, a, bm, cm)
    assert build.launches["ssd_decode"] == before + 1
    assert torch.equal(state, want_s)
    assert _rel(y.float(), want_y.float()) < Y_REL


@pytest.mark.chip
def test_flash_at_head_dim_128_with_granite_scale_on_card(card):
    """The flash kernel at the attention layers' shape, head dim 128, GQA
    4, causal, with the softmax scale 1/128 on q and k as projected (no
    RoPE), q, k, v views of (B, S, H, D) projections: within 2e-2 of the
    plain version in fp32; the default scale gives another answer."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_kernel_ref

    b, hq, hkv, s, d = ATTN_SHAPE
    gen = torch.Generator(device=card).manual_seed(22)
    q = torch.randn(b, s, hq, d, generator=gen, device=card).to(
        torch.bfloat16).transpose(1, 2)
    kv = torch.randn(b, s, 2, hkv, d, generator=gen, device=card).to(
        torch.bfloat16)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    before = build.launches["flash_attention"]
    out = kernel.flash_attention_cuda(q, k, v, causal=True, scale=1 / 128)
    assert build.launches["flash_attention"] == before + 1
    want = attention_kernel_ref(q.float(), k.float(), v.float(), causal=True,
                                scale=1 / 128)
    err = float((out.float() - want).abs().max())
    assert out.shape == (b, hq, s, d) and err < ATTN_ABS, err
    default = attention_kernel_ref(q.float(), k.float(), v.float(),
                                   causal=True)
    assert float((default - want).abs().max()) > 10 * ATTN_ABS


@pytest.mark.chip
def test_captured_decode_matches_eager_on_card(card):
    """The smoke config in fp32 on the card: the engine's captured step
    (one CUDA graph, the dropless MoE and NoPE attention inside it) gives
    the eager step's tokens, request by request."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(seed=4, device=card)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 3, 6)]
    outs = []
    for eager in (False, True):
        engine = ServeEngine(model, params, batch_slots=2, max_len=32)
        if eager:
            engine._step = model.decode_step
        reqs = [Request(rid=i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        engine.run_until_idle()
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
