"""Zyphra's Zamba2 (``zamba2-7b-instruct``) in the port against a plain
fp32 reference of the published equations (``tests/_zamba2_ref.py``: plain
torch, the SSD as its step recurrence), on the CPU at the smoke size (two
shared blocks, three unevenly spaced applications, two B/C groups, head
dim 2 d / heads, rank-8 adapters, conv bias), fp32.

Tolerances: the port and the reference compute the same fp32 function in
another order of operations (the port's blocked SSD against one position
at a time, fused projections, einsum orders), which differ at the level of
fp32 rounding grown through 8 layers: 1e-4 relative on logits. Decoding
through the cache against the full forward, and the reference against
transformers' model, differ in the order of sums only: 1e-5.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import _zamba2_ref as ref  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential  # noqa: E402
from repro_torch.models import embedloss, ssm, transformer  # noqa: E402
from repro_torch.models.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

ARCH = "zamba2-7b-instruct"
B, S = 2, 19
LOGIT_REL = 1e-4     # port vs reference: blocked vs step-recurrent SSD
CACHE_REL = 1e-5     # decode through the cache vs the full forward
HF_REL = 1e-5        # the reference vs transformers' Zamba2


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


def test_smoke_config_keeps_every_kind_of_part():
    cfg, full = get_smoke_config(ARCH), get_config(ARCH)
    for c in (cfg, full):
        ids = c.hybrid_layer_ids
        assert c.zyphra and c.n_mem_blocks == 2 and c.ssm.n_groups == 2
        assert c.ssm.conv_bias and c.adapter_rank > 0
        assert c.hd == 2 * c.d_model // c.n_heads
        assert c.attn_width == 2 * c.d_model == c.n_heads * c.hd
        assert len(set(np.diff(ids))) > 1       # unevenly spaced
    assert len(cfg.hybrid_layer_ids) >= 2


def test_published_width_parameter_count():
    """The published config's parameters, counted from the leaf shapes
    alone (no tensor is made): 7,356,749,648, the analytic count too."""
    cfg = get_config(ARCH)
    shapes = Model(cfg).param_shapes()

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return math.prod(t)

    assert count(shapes) == cfg.param_count()[0] == 7_356_749_648
    assert shapes["layers"]["in_proj"] == (81, 3584, 7168 + 7424 + 112)
    assert shapes["layers"]["conv_b"] == (81, 7424)
    assert shapes["blocks"]["wq"] == (2, 7168, 7168)
    assert shapes["blocks"]["wo"] == (2, 7168, 3584)
    assert shapes["hybrid"]["adapter"] == (13, 3584, 128)
    assert shapes["hybrid"]["w_link"] == (13, 3584, 3584)
    meta = Model(cfg).abstract_params()
    assert meta["blocks"]["ln_attn"].shape == (2, 7168)


def test_forward_logits_match_reference(smoke):
    cfg, model, params, tokens = smoke
    with torch.no_grad():
        h = model.forward(params, {"tokens": tokens})
    want = ref.hidden(params, tokens, cfg)
    assert _rel(ref.logits(params, h, cfg),
                ref.logits(params, want, cfg)) < LOGIT_REL


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
    assert set(cache) == {"pos", "conv", "state", "k_shared", "v_shared"}
    for key in cache:
        assert _rel(cache[key].float(), whole[key].float()) < CACHE_REL, key


def test_cache_layout_and_lane_reset(smoke):
    cfg, model, params, tokens = smoke
    with torch.no_grad():
        cache, _ = model.prefill(params, {"tokens": tokens[:, :5]},
                                 cache_len=16)
    s = cfg.ssm
    n_apps = len(cfg.hybrid_layer_ids)
    assert cache["k_shared"].shape == (n_apps, B, 16, cfg.n_kv_heads, cfg.hd)
    assert cache["state"].shape == (cfg.n_layers, B, s.n_heads(cfg.d_model),
                                    s.head_dim, s.d_state)
    assert cache["state"].dtype == torch.float32
    assert cache["conv"].shape == (cfg.n_layers, B, s.conv_width - 1,
                                   2 * cfg.d_model + 2 * s.n_groups
                                   * s.d_state)
    model.reset_cache_lane(cache, 1)
    for key, leaf in cache.items():
        lane = leaf[1] if key == "pos" else leaf[:, 1]
        other = leaf[0] if key == "pos" else leaf[:, 0]
        assert not lane.any(), key
        assert other.any(), key


def test_serve_engine_matches_reference_per_request(smoke):
    """Six requests through two slots, four of them admitted into lanes
    freed and reset mid-run, two submitted while others decode: each
    request's tokens are the reference's greedy continuation of its own
    prompt, position by position."""
    cfg, model, params, _ = smoke
    rng = np.random.default_rng(5)
    specs = [(rng.integers(0, cfg.vocab, n).tolist(), m)
             for n, m in ((4, 5), (7, 3), (2, 6), (5, 4), (3, 3), (6, 2))]
    reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(specs)]
    engine = ServeEngine(model, params, batch_slots=2, max_len=32)
    for r in reqs[:4]:
        engine.submit(r)
    for _ in range(5):
        engine.step()
    for r in reqs[4:]:
        engine.submit(r)
    engine.run_until_idle()
    for r in reqs:
        assert r.done and len(r.out) == r.max_new_tokens
        seq = torch.tensor([r.prompt + r.out[:-1]])
        h = ref.hidden(params, seq, cfg)[0, len(r.prompt) - 1:]
        want = ref.logits(params, h, cfg).argmax(-1)
        assert r.out == want.tolist(), r.rid


def _groups_case(seed=0, b=2, l=37, h=8, p=16, g=2, n=8):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, l, h, p, generator=gen)
    dt = torch.rand(b, l, h, generator=gen) * 0.5 + 0.01
    a = -torch.rand(h, generator=gen) - 0.5
    bm = torch.randn(b, l, g, n, generator=gen)
    cm = torch.randn(b, l, g, n, generator=gen)
    s0 = torch.randn(b, h, p, n, generator=gen) * 0.1
    return x, dt, a, bm, cm, s0


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_grouped_ssd_matches_step_recurrence(chunk):
    """The port's blocked scan (``ssd_ref``), its sequential version and
    the kernel's wrapper (on the CPU its plain version) with two B/C groups
    against the reference's step recurrence; the decode update likewise,
    one step from a state."""
    x, dt, a, bm, cm, s0 = _groups_case()
    want_y, want_s = ref.ssd_steps(x, dt, a, bm, cm)
    y, s = ssm.ssd_ref(x, dt, a, bm, cm, chunk=chunk)
    assert _rel(y, want_y) < 1e-5 and _rel(s, want_s) < 1e-5
    y, s = ssd_ref_sequential(x, dt, a, bm, cm)
    assert _rel(y, want_y) < 1e-5 and _rel(s, want_s) < 1e-5
    y, s = sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk)
    assert _rel(y, want_y) < 1e-5 and _rel(s, want_s) < 1e-5
    # one more position from the final state
    y1, s1 = ssm.ssd_decode_step(s, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    ys, ss = ref.ssd_steps(torch.cat([x, x[:, :1]], 1),
                           torch.cat([dt, dt[:, :1]], 1), a,
                           torch.cat([bm, bm[:, :1]], 1),
                           torch.cat([cm, cm[:, :1]], 1))
    assert _rel(y1, ys[:, -1]) < 1e-5 and _rel(s1, ss) < 1e-5


def test_grouped_ssd_continues_a_state():
    x, dt, a, bm, cm, s0 = _groups_case(seed=1)
    y, s = ssm.ssd_ref(x, dt, a, bm, cm, chunk=16, init_state=s0)
    ys, ss = ssd_ref_sequential(x, dt, a, bm, cm, init_state=s0)
    assert _rel(y, ys) < 1e-5 and _rel(s, ss) < 1e-5
    # the groups matter: the same B/C for every head gives another answer
    y1, _ = ssm.ssd_ref(x, dt, a, bm[:, :, :1].expand_as(bm),
                        cm[:, :, :1].expand_as(cm), chunk=16, init_state=s0)
    assert _rel(y1, y) > 1e-2


def test_kernel_check_takes_groups():
    x, dt, a, bm, cm, _ = _groups_case()
    sk.check_args(x, dt, a, bm, cm, 16)
    with pytest.raises(ValueError):
        sk.check_args(x, dt, a, bm[:, :, :1].expand(2, 37, 3, 8).contiguous(),
                      cm[:, :, :1].expand(2, 37, 3, 8).contiguous(), 16)


# ------------------------------------------------ transformers' Zamba2
def _hf_model(cfg, params):
    """transformers' ``Zamba2ForCausalLM`` at ``cfg``'s sizes holding
    ``params`` (norm scales as 1 + w), for sequences of up to 64
    positions."""
    tf = pytest.importorskip("transformers")
    from transformers.models.zamba2 import modeling_zamba2 as mz

    s = cfg.ssm
    types = ["hybrid" if i in cfg.hybrid_layer_ids else "mamba"
             for i in range(cfg.n_layers)]
    hc = tf.Zamba2Config(
        vocab_size=cfg.vocab, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, layers_block_type=types,
        mamba_d_state=s.d_state, mamba_d_conv=s.conv_width,
        mamba_expand=s.expand, mamba_ngroups=s.n_groups,
        n_mamba_heads=s.n_heads(cfg.d_model), use_conv_bias=s.conv_bias,
        # one chunk over the whole sequence: transformers' plain-torch
        # chunked SSD (the path its CPU model runs; the published model runs
        # mamba_ssm's kernels) departs from the recurrence from its second
        # chunk on, by ~0.1 relative in the logits at the smoke size, with
        # one group or two, while within one chunk it agrees to ~5e-6
        chunk_size=64, intermediate_size=cfg.d_ff, hidden_act="gelu",
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        num_mem_blocks=cfg.n_mem_blocks, use_shared_attention_adapter=False,
        adapter_rank=cfg.adapter_rank, use_mem_rope=True,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps,
        max_position_embeddings=64, tie_word_embeddings=True,
        # the published 0.001 floors dt in the plain path only (its fused
        # kernels take no floor): 0 leaves every dt as the port computes it
        time_step_min=1e-9, time_step_floor=1e-9,
        attn_implementation="eager", pad_token_id=0)
    hf = mz.Zamba2ForCausalLM(hc).eval()
    one = {k: v for k, v in params.items()}

    def lin(module, w):
        module.weight.data.copy_(w.T)

    def norm(module, w):
        module.weight.data.copy_(1.0 + w)

    m = hf.model
    m.embed_tokens.weight.data.copy_(one["embed"][:cfg.vocab])
    norm(m.final_layernorm, one["ln_final"])
    app = {lid: j for j, lid in enumerate(cfg.hybrid_layer_ids)}
    for i, layer in enumerate(m.layers):
        p = {k: v[i] for k, v in one["layers"].items()}
        dec = layer.mamba_decoder if i in app else layer
        mix = dec.mamba
        norm(dec.input_layernorm, p["ln_ssm"])
        lin(mix.in_proj, p["in_proj"])
        mix.conv1d.weight.data.copy_(p["conv_w"].T[:, None, :])
        mix.conv1d.bias.data.copy_(p["conv_b"])
        mix.dt_bias.data.copy_(p["dt_bias"])
        mix.A_log.data.copy_(p["A_log"])
        mix.D.data.copy_(p["D"])
        norm(mix.norm, p["ssm_norm"])
        lin(mix.out_proj, p["out_proj"])
        if i not in app:
            continue
        j = app[i]
        blk = {k: v[j % cfg.n_mem_blocks] for k, v in one["blocks"].items()}
        ap = {k: v[j] for k, v in one["hybrid"].items()}
        st = layer.shared_transformer
        assert st.block_id == j % cfg.n_mem_blocks
        norm(st.input_layernorm, blk["ln_attn"])
        for name in ("q", "k", "v", "o"):
            lin(getattr(st.self_attn, f"{name}_proj"), blk[f"w{name}"])
        norm(st.pre_ff_layernorm, blk["ln_mlp"])
        ff = st.feed_forward
        lin(ff.gate_up_proj, torch.cat([blk["w_gate"], blk["w_up"]], 1))
        lin(ff.down_proj, blk["w_down"])
        lin(ff.gate_up_proj_adapter_list[j][0], ap["adapter"])
        lin(ff.gate_up_proj_adapter_list[j][1],
            torch.cat([ap["adapter_gate"], ap["adapter_up"]], 1))
        lin(layer.linear, ap["w_link"])
    return hf


def test_reference_matches_transformers_zamba2(smoke):
    """The plain reference against transformers' ``Zamba2ForCausalLM`` (its
    plain-torch path on the CPU) at the smoke sizes with the same weights:
    logits within 1e-5 relative."""
    cfg, model, params, tokens = smoke
    hf = _hf_model(cfg, params)
    with torch.no_grad():
        out = hf(input_ids=tokens, use_cache=False).logits
    want = ref.logits(params, ref.hidden(params, tokens, cfg), cfg)
    assert _rel(want, out.float()) < HF_REL


def test_port_matches_transformers_zamba2(smoke):
    """The port's forward against transformers' model, the same weights."""
    cfg, model, params, tokens = smoke
    hf = _hf_model(cfg, params)
    with torch.no_grad():
        out = hf(input_ids=tokens, use_cache=False).logits
        h = model.forward(params, {"tokens": tokens})
    assert _rel(ref.logits(params, h, cfg), out.float()) < LOGIT_REL


def test_zamba2_variant_is_not_zyphra():
    """The JAX package's variant keeps its own layout: one shared block
    every 6 layers over the 3584-wide stream, one group, no conv bias."""
    v = get_config("zamba2-7b")
    assert not v.zyphra and v.shared_attn_every == 6 and v.hd == 112
    assert v.ssm.n_groups == 1 and not v.ssm.conv_bias
    assert v.attn_scale is None
    z = get_config(ARCH)
    assert z.attn_scale == pytest.approx(112 ** -0.5)
    assert dataclasses.replace(z, hybrid_layer_ids=()).attn_scale is None


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    """The CUDA device; skips the test where this host has none (decided
    when the test runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the published prefill shapes: the SSD of one Mamba2 layer over 2 x 2048
# tokens (112 heads of 64, 2 groups of d_state 64, chunk 256), and the
# shared blocks' attention (32 heads of 224, causal)
SSD_SHAPE = (2, 2048, 112, 64, 2, 64, 256)
ATTN_SHAPE = (2, 32, 2048, 224)
# the kernels against their plain versions over the same inputs: fp32 at
# the CUDA cores' rounding; bf16 relative to the largest output, as
# chip_smoke.py's limits (SSD_Y_REL_TOL, SSD_STATE_REL_TOL, TOL)
SSD_REL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-3)}
ATTN_ABS = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _max_rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.chip
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_grouped_ssd_kernel_on_card(card, dtype):
    """The SSD kernel with two B/C groups at the published shape, against
    its plain version (the sequential recurrence, fp32) over the same
    inputs, from a given state; B and C read as column views of one
    projection, as ``mamba_block`` hands them. A control that gives every
    head group 0's B and C must miss by far."""
    b, l, h, p, g, n, chunk = SSD_SHAPE
    gen = torch.Generator(device=card).manual_seed(11)
    xbc = torch.randn(b, l, h * p + 2 * g * n, generator=gen, device=card)
    xbc = (xbc * 0.5).to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    bm = xbc[..., h * p:h * p + g * n].unflatten(-1, (g, n))
    cm = xbc[..., h * p + g * n:].unflatten(-1, (g, n))
    dt = torch.rand(b, l, h, generator=gen, device=card) * 0.1 + 1e-3
    a = -torch.rand(h, generator=gen, device=card) * 8 - 1
    s0 = torch.randn(b, h, p, n, generator=gen, device=card) * 0.1
    before = build.launches["ssd_scan"]
    y, s = sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk, init_state=s0)
    assert build.launches["ssd_scan"] == before + 1
    yr, sr = ssd_ref_sequential(x, dt, a, bm, cm, init_state=s0)
    y_tol, s_tol = SSD_REL[dtype]
    assert _max_rel(y, yr) < y_tol and _max_rel(s, sr) < s_tol
    one = bm[:, :, :1].expand_as(bm), cm[:, :, :1].expand_as(cm)
    y1, _ = sk.ssd_cuda(x, dt, a, *one, chunk=chunk, init_state=s0)
    assert _max_rel(y1, yr) > 10 * y_tol


@pytest.mark.chip
@pytest.mark.parametrize("two_pass", [False, True], ids=["flash", "chunked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_attention_kernels_at_head_dim_224_on_card(card, two_pass, dtype):
    """Both attention kernels at head dim 224 with the shared block's
    softmax scale (224 / 2)^-1/2, causal, at the published shape: q, k, v
    as views of (B, S, H, D) projections, against the plain version; the
    default scale gives another answer."""
    from repro_torch.kernels.flash_attention import chunked, kernel
    from repro_torch.kernels.flash_attention.ref import attention_kernel_ref

    b, hh, s, d = ATTN_SHAPE
    gen = torch.Generator(device=card).manual_seed(12)
    qkv = torch.randn(b, s, 3, hh, d, generator=gen, device=card).to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    fn = chunked.chunked_attention_cuda if two_pass \
        else kernel.flash_attention_cuda
    scale = (d / 2) ** -0.5
    out = fn(q, k, v, causal=True, scale=scale)
    want = attention_kernel_ref(q, k, v, causal=True, scale=scale)
    err = float((out.float() - want.float()).abs().max())
    assert out.shape == (b, hh, s, d) and err < ATTN_ABS[dtype], err
    default = attention_kernel_ref(q, k, v, causal=True)
    assert float((default.float() - want.float()).abs().max()) \
        > 10 * ATTN_ABS[dtype]
