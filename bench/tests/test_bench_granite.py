"""The Granite serving cell (``granite-4.0-h-small.serve-chat``) driven on
the CPU at the program's smoke size of Granite 4.0-H (one whole period of
the pattern: attention at layer 2 among four Mamba2 layers, a dropless MoE
of 8 experts top-3 with its shared expert in every layer), its chip look
skipped: the sound run is correct, and each way of breaking the timed
path underneath makes ``correct`` false. Besides: the Granite reference
against the program's forward and against its decoding through the cache,
against transformers' ``GraniteMoeHybridForCausalLM``, its fp8 control,
serve_granite's check of the configuration, and the step's operation and
byte counts against hand counts at the published widths.

Tolerances: the port and the reference compute the same fp32 function in
another order of operations (the port's blocked SSD against the masked
decay over the whole sequence, the batched experts against one expert at
a time, fused projections), which differ at the level of fp32 rounding
grown through 5 layers: 1e-4 relative on logits. The reference against
transformers' model computes the same sums in nearly the same order:
1e-5.
"""
import dataclasses

import numpy as np
import pytest
import smoke
import test_bench_cells as cells

import torch

from bench import harness, weights, work_granite
from bench.drivers import serve_granite
from bench.reference.granite import Reference, ssd

torch.set_num_threads(2)

CELL = "granite-4.0-h-small.serve-chat"
CONFIG = harness.load_json(harness.BENCH / "configs"
                           / "granite-4.0-h-small.json")
LOGIT_REL = 1e-4         # port vs reference: another order of fp32 sums
HF_REL = 1e-5            # the reference vs transformers' Granite
# the driver's draws at the smoke width: the published std gives a product
# over d = 4096 the gain 0.02 x 64 = 1.28; over the smoke config's d = 64
# the same gain takes 0.02 x sqrt(4096 / 64) (at 0.02 every branch adds
# next to nothing, and greedy decoding repeats the input token whatever
# the layers compute)
SMOKE_INIT_STD = CONFIG["initializer_range"] * (4096 / 64) ** 0.5


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def as_run(cfg) -> dict:
    """A configuration file's ``as_run`` of a program config with a layer
    pattern: ``smoke.as_run``'s sizes and the pattern's own."""
    dims = smoke.as_run(cfg)
    dims.update(ssm=dataclasses.asdict(cfg.ssm),
                moe=dataclasses.asdict(cfg.moe),
                layer_types=list(cfg.layer_types), rope=cfg.rope,
                softmax_scale=cfg.softmax_scale,
                embedding_multiplier=cfg.embedding_multiplier,
                residual_multiplier=cfg.residual_multiplier,
                logits_scaling=cfg.logits_scaling)
    return dims


def shrink(cell: harness.Cell, dtype: str = "float32") -> harness.Cell:
    """``cell`` at Granite's smoke size on the CPU: every size of the smoke
    config as the program's override and in ``as_run``, and the serving
    smoke mix."""
    from repro_torch.models.config import get_smoke_config

    config = dict(cell.config)
    small = get_smoke_config(config["program_arch"])
    over = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)
            if f.name not in ("name", "param_dtype", "compute_dtype")}
    config.update(program_overrides=over, dtype=dtype, as_run=as_run(small),
                  initializer_range=SMOKE_INIT_STD)
    mix = {**cell.mix, **smoke.SMOKE_MIX["serve"]}
    cell = dataclasses.replace(cell, config=config, mix=mix, device="cpu")
    cell.limits = cells.SERVE_LIMITS
    return cell


def granite_cell(seed=7, seconds=1.0):
    return shrink(harness.load_cell(harness.load_spec(), CELL, seed, seconds,
                                    False))


def smoke_weights(cell, seed=11):
    """The program's model of ``cell`` and the benchmark's weights for it,
    with the driver's published constants."""
    from repro_torch.models.transformer import STACK_DIMS, Model

    model = Model(serve_granite.check_granite(cell))
    params = weights.make(model.param_shapes(), STACK_DIMS, seed, "cpu",
                          torch.float32)
    serve_granite.published_init(params, cell)
    return model, params


def conv_and_state_unwritten(run):
    """The step writes its K/V and positions but leaves every Mamba2
    layer's conv and SSM state as it found them."""
    def after(nxt, cache, saved):
        for k in ("conv", "state"):
            cache[k].copy_(saved[k])
    cells.wrap_step(run, after)


def assignments_dropped(run):
    """The step's MoE layers keep a fixed capacity (the other configs'
    default) instead of taking every assignment."""
    cfg = run.model.cfg
    run.model.cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dropless=False))


def rope_applied(run):
    """The step's attention encodes positions with RoPE."""
    run.model.cfg = dataclasses.replace(run.model.cfg, rope=True)


def test_cell_files_and_driver():
    cell = harness.load_cell(harness.load_spec(), CELL, 1, 30.0, False)
    assert cell.mix["driver"] == "serve_granite"
    assert cell.config["reduced"] == [] and cell.chips == 1
    assert cell.limits["served_tokens_checked"]["min"] >= 100
    mix = cell.mix
    assert (mix["batch_slots"], mix["max_len"]) == (32, 896)
    assert mix["arrivals"]["kind"] == "poisson"
    assert mix["prompt"]["max"] + mix["output"]["max"] <= mix["max_len"]
    assert (mix["prompt"]["median"], mix["output"]["median"]) == (128, 96)
    knee = mix["knee"]
    assert mix["arrivals"]["rate_per_s"] == pytest.approx(
        knee["share_of_knee"] * knee["steady_poisson_knee_per_s"])


def test_config_quotes_the_catalog_row():
    """The published keys, as the catalog's row gives them, and the
    program's sizes as run."""
    dims = CONFIG["as_run"]
    assert CONFIG["num_hidden_layers"] == dims["n_layers"] == 40
    assert CONFIG["hidden_size"] == dims["d_model"] == 4096
    assert CONFIG["layer_types"] == dims["layer_types"]
    assert [i for i, t in enumerate(dims["layer_types"])
            if t == "attention"] == [5, 15, 25, 35]
    assert CONFIG["num_local_experts"] == dims["moe"]["n_experts"] == 72
    assert CONFIG["num_experts_per_tok"] == dims["moe"]["top_k"] == 10
    assert CONFIG["intermediate_size"] == dims["moe"]["d_ff_expert"] == 768
    assert CONFIG["shared_intermediate_size"] == dims["d_ff"] == 1536
    assert CONFIG["attention_multiplier"] == dims["softmax_scale"]
    assert CONFIG["embedding_multiplier"] == dims["embedding_multiplier"]
    assert CONFIG["residual_multiplier"] == dims["residual_multiplier"]
    assert CONFIG["logits_scaling"] == dims["logits_scaling"]
    assert CONFIG["position_embedding_type"] == "nope" and not dims["rope"]
    assert CONFIG["mamba_d_state"] == dims["ssm"]["d_state"] == 128
    assert CONFIG["mamba_n_heads"] == 2 * 4096 // dims["ssm"]["head_dim"]
    assert CONFIG["hidden_size"] // CONFIG["num_attention_heads"] \
        == dims["head_dim"]
    assert dims["moe"]["dropless"] and dims["moe"]["dense_residual"]


def test_program_config_matches_as_run():
    cell = harness.load_cell(harness.load_spec(), CELL, 1, 30.0, False)
    cfg = serve_granite.check_granite(cell)
    assert cfg.patterned and cfg.vocab == 100352 and not cfg.rope


@pytest.mark.parametrize("field, value", [
    ("layer_types", ["mamba"] * 40), ("rope", True),
    ("residual_multiplier", 1.0),
    ("moe", {**CONFIG["as_run"]["moe"], "dropless": False})],
    ids=["layer_types", "rope", "residual_multiplier", "moe"])
def test_driver_refuses_other_pattern_fields(field, value):
    cell = harness.load_cell(harness.load_spec(), CELL, 1, 30.0, False)
    config = dict(cell.config)
    config["as_run"] = {**cell.dims, field: value}
    with pytest.raises(ValueError, match=field):
        serve_granite.check_granite(dataclasses.replace(cell, config=config))


def test_published_init_is_the_same_on_every_call():
    """Every weight drawn again at the published std from the seed, the
    same on every call; the embedding at that std over the multiplier; the
    norms as made, the conv's bias 0, the SSM constants as published."""
    cell = granite_cell()
    _, params = smoke_weights(cell)
    first = {g: {k: v.clone() for k, v in params[g].items()}
             for g in ("ssm", "attn", "ffn")}
    serve_granite.published_init(params, cell)
    assert all(torch.equal(params[g][k], v) for g, leaves in first.items()
               for k, v in leaves.items())
    std = SMOKE_INIT_STD
    for leaf in (params["ffn"]["moe_down"], params["ffn"]["router"],
                 params["ssm"]["in_proj"], params["attn"]["wq"]):
        assert float(leaf.std()) == pytest.approx(std, rel=0.1)
    assert float(params["embed"].std()) == pytest.approx(std / 12, rel=0.1)
    ssm = params["ssm"]
    assert not ssm["conv_b"].any() and not params["ffn"]["ln_mlp"].any()
    h = ssm["A_log"].shape[1]
    assert torch.allclose(ssm["A_log"][0].exp(), torch.arange(1.0, h + 1))
    assert bool((ssm["D"] == 1).all() and (ssm["dt_bias"] == 1).all())


def test_sound_run_is_correct():
    ok, values = cells.correct(granite_cell())
    assert ok, values
    assert values["served_tokens_checked"] >= 10


@pytest.mark.parametrize("fault", [cells.token_altered, cells.state_unchanged,
                                   cells.half_batch, conv_and_state_unwritten,
                                   assignments_dropped, rope_applied],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(fault):
    ok, values = cells.correct(granite_cell(), fault)
    assert not ok, values


def test_metrics_read_the_run():
    run, rec, values, checks = smoke.run_cell(granite_cell())
    record = {**rec, "dims": run.cell.dims, "peaks": {
        "bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}}
    mfu = harness.load_module("metrics", "mfu.granite-serve").read(record)
    assert 0 < mfu < 100
    share = harness.load_module("metrics", "moe_route_share.granite-serve")
    update = harness.load_module("metrics",
                                 "ssd_update_roofline.granite-serve")
    assert share.read(record) is None and update.read(record) is None
    trace = {"kernels": {
        "nvjet_tst_64x8": {"seconds": 3.0, "launches": 9},
        "void at::native::sbtopk::gatherTopK<float, unsigned int, 2>": {
            "seconds": 0.5, "launches": 9},
        "void at::native::searchsorted_cuda_kernel<long>": {
            "seconds": 0.5, "launches": 9},
        "void ssd_decode_update<16, float>(float*, float*)": {
            "seconds": 1.0, "launches": 9},
        "Memcpy DtoD (Device -> Device)": {"seconds": 5.0, "launches": 1}}}
    assert share.read({**record, "trace": trace}) == 20.0
    assert update.read({**record, "trace": trace}) > 0


def test_reference_matches_program_forward():
    """The Granite reference against the program's forward at the smoke
    size, fp32, on the benchmark's weights with the driver's constants:
    the same logits; the fp8 control departs from both."""
    cell = granite_cell()
    model, params = smoke_weights(cell)
    tokens = torch.randint(0, cell.dims["vocab"], (2, 37),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens.int()})
    ref = Reference(cell.dims, params)
    want = ref.hidden(tokens)
    rel = _rel(model.logits(params, got), ref.logits(want))
    assert rel < LOGIT_REL, rel
    low = Reference(cell.dims, params, fp8=True).hidden(tokens)
    assert _rel(low, want) > 100 * _rel(got, want)


def test_decode_through_the_cache_matches_reference():
    """Prefill 6 positions, then decode the rest one token a step through
    the cache: each step's logits equal the reference's full forward at
    that position, and so does each greedy token."""
    from repro_torch.models import embedloss, transformer

    cell = granite_cell()
    model, params = smoke_weights(cell)
    b, s = 2, 23
    tokens = torch.randint(0, cell.dims["vocab"], (b, s),
                           generator=torch.Generator().manual_seed(1))
    ref = Reference(cell.dims, params)
    want = ref.logits(ref.hidden(tokens))
    seen = []
    greedy = embedloss.greedy

    def record(x, table, **kw):
        seen.append(x.clone())
        return greedy(x, table, **kw)

    with torch.no_grad():
        cache, last = model.prefill(params, {"tokens": tokens[:, :6]},
                                    cache_len=32)
        assert _rel(model.logits(params, last), want[:, 5]) < LOGIT_REL
        transformer.embedloss.greedy = record
        try:
            for t in range(6, s):
                nxt, cache = model.decode_step(params, cache,
                                               tokens[:, t].to(torch.int32))
                got = model.logits(params, seen[-1])
                assert _rel(got, want[:, t]) < LOGIT_REL, t
                assert nxt.tolist() == want[:, t].argmax(-1).tolist()
        finally:
            transformer.embedloss.greedy = greedy


def test_masked_decay_ssd_in_head_blocks_matches_steps(monkeypatch):
    """The reference's quadratic SSD, in blocks of heads that do not
    divide the heads, against its step recurrence, one group."""
    from bench.reference import granite

    monkeypatch.setattr(granite, "HEAD_BLOCK", 3)
    gen = torch.Generator().manual_seed(3)
    b, l, h, p, g, n = 2, 23, 8, 4, 1, 5
    x = torch.randn(b, l, h, p, generator=gen)
    dt = torch.rand(b, l, h, generator=gen) + 0.1
    a = -torch.rand(h, generator=gen) - 0.2
    bm = torch.randn(b, l, g, n, generator=gen)
    cm = torch.randn(b, l, g, n, generator=gen)
    s = torch.zeros(b, h, p, n)
    want = []
    for t in range(l):
        bt = bm[:, t].expand(b, h, n)
        ct = cm[:, t].expand(b, h, n)
        s = s * torch.exp(dt[:, t] * a)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * bt[:, :, None]
        want.append(torch.einsum("bhpn,bhn->bhp", s, ct))
    y = ssd(x, dt, a, bm, cm)
    assert _rel(y, torch.stack(want, 1)) < 1e-5


# ------------------------------------------- transformers' Granite 4.0-H
def _hf_model(cfg, params):
    """transformers' ``GraniteMoeHybridForCausalLM`` at ``cfg``'s sizes
    holding ``params`` (norm scales as 1 + w), for sequences of up to 64
    positions, on its plain-torch path."""
    tf = pytest.importorskip("transformers")
    from transformers.models.granitemoehybrid import (
        modeling_granitemoehybrid as mg)

    s, m = cfg.ssm, cfg.moe
    hc = tf.GraniteMoeHybridConfig(
        vocab_size=cfg.vocab, hidden_size=cfg.d_model,
        num_hidden_layers=cfg.n_layers, layer_types=list(cfg.layer_types),
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        intermediate_size=m.d_ff_expert, shared_intermediate_size=cfg.d_ff,
        num_local_experts=m.n_experts, num_experts_per_tok=m.top_k,
        mamba_n_heads=s.n_heads(cfg.d_model), mamba_d_head=s.head_dim,
        mamba_d_state=s.d_state, mamba_d_conv=s.conv_width,
        mamba_expand=s.expand, mamba_n_groups=s.n_groups,
        mamba_conv_bias=s.conv_bias, mamba_proj_bias=False,
        # one chunk over the whole sequence: transformers' plain chunked SSD
        # is read against the masked decay within one chunk
        mamba_chunk_size=64, position_embedding_type="nope",
        attention_multiplier=cfg.softmax_scale,
        embedding_multiplier=cfg.embedding_multiplier,
        residual_multiplier=cfg.residual_multiplier,
        logits_scaling=cfg.logits_scaling, rms_norm_eps=cfg.norm_eps,
        hidden_act="silu", attention_bias=False, tie_word_embeddings=True,
        max_position_embeddings=64, attn_implementation="eager",
        pad_token_id=0)
    hf = mg.GraniteMoeHybridForCausalLM(hc).eval()

    def lin(module, w):
        module.weight.data.copy_(w.T)

    def norm(module, w):
        module.weight.data.copy_(1.0 + w)

    mm = hf.model
    mm.embed_tokens.weight.data.copy_(params["embed"][:cfg.vocab])
    norm(mm.norm, params["ln_final"])
    seen = {"attention": 0, "mamba": 0}
    for i, layer in enumerate(mm.layers):
        kind = cfg.layer_types[i]
        j = seen[kind]
        seen[kind] += 1
        f = {k: v[i] for k, v in params["ffn"].items()}
        if kind == "attention":
            p = {k: v[j] for k, v in params["attn"].items()}
            norm(layer.input_layernorm, p["ln_attn"])
            for name in ("q", "k", "v", "o"):
                lin(getattr(layer.self_attn, f"{name}_proj"), p[f"w{name}"])
        else:
            p = {k: v[j] for k, v in params["ssm"].items()}
            mix = layer.mamba
            norm(layer.input_layernorm, p["ln_ssm"])
            lin(mix.in_proj, p["in_proj"])
            mix.conv1d.weight.data.copy_(p["conv_w"].T[:, None, :])
            mix.conv1d.bias.data.copy_(p["conv_b"])
            mix.dt_bias.data.copy_(p["dt_bias"])
            mix.A_log.data.copy_(p["A_log"])
            mix.D.data.copy_(p["D"])
            norm(mix.norm, p["ssm_norm"])
            lin(mix.out_proj, p["out_proj"])
        norm(layer.post_attention_layernorm, f["ln_mlp"])
        moe = layer.block_sparse_moe
        lin(moe.router.layer, f["router"])
        moe.input_linear.weight.data.copy_(torch.cat(
            [f["moe_gate"].transpose(1, 2), f["moe_up"].transpose(1, 2)], 1))
        moe.output_linear.weight.data.copy_(f["moe_down"].transpose(1, 2))
        lin(layer.shared_mlp.input_linear,
            torch.cat([f["w_gate"], f["w_up"]], 1))
        lin(layer.shared_mlp.output_linear, f["w_down"])
    return hf


def test_reference_matches_transformers_granite():
    """The plain reference against transformers' Granite 4.0-H (its
    plain-torch path on the CPU) at the smoke size with the same weights:
    logits within 1e-5 relative; so does the port's forward within its
    tolerance against the reference."""
    cell = granite_cell()
    model, params = smoke_weights(cell)
    cfg = model.cfg
    hf = _hf_model(cfg, params)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 29)))
    ref = Reference(cell.dims, params)
    with torch.no_grad():
        out = hf(input_ids=tokens, use_cache=False).logits.float()
        got = model.logits(params, model.forward(params, {"tokens": tokens}))
    want = ref.logits(ref.hidden(tokens))
    assert _rel(want, out) < HF_REL
    assert _rel(got, out) < LOGIT_REL


def test_step_work_counts_at_the_published_widths():
    dims = CONFIG["as_run"]
    d, e, f, sh = 4096, 72, 768, 1536
    mamba = d * (8192 + 8448 + 128) + 8192 * d
    attn = d * (32 + 16) * 128 + 32 * 128 * d
    ffn = d * e + e * 3 * d * f + 3 * d * sh
    assert work_granite.layer_counts(dims) == (36, 4)
    assert work_granite.attn_params(dims) == attn
    assert work_granite.ffn_params(dims) == ffn
    assert work_granite.weight_bytes(dims) == 2 * 32_207_337_984
    # the experts, 54.4 GB of the 64.4 GB of weights
    assert 40 * e * 3 * d * f * 2 == pytest.approx(54.4e9, rel=1e-3)
    ssm = 36 * 128 * 64 * 128 * 4           # 151 MB a lane
    conv = 36 * 3 * 8448 * 2                 # 1.8 MB a lane
    assert work_granite.state_bytes(dims) == ssm + conv
    kv_row = 2 * 8 * 128 * 2
    flops, nbytes = work_granite.decode_step_work(dims, 32, 32 * 300)
    assert nbytes == 2 * 32_207_337_984 + 2 * 32 * (ssm + conv) \
        + 4 * (32 * 300 + 32) * kv_row
    assert nbytes / 3.35e12 == pytest.approx(22.1e-3, rel=0.01)
    per_lane = 36 * mamba + 4 * attn + 40 * (d * e + 10 * 3 * d * f
                                             + 3 * d * sh) + 100352 * d
    assert flops == 32 * (2 * per_lane + 36 * 5 * 128 * 64 * 128) \
        + 4 * 4 * 32 * 128 * 32 * 300
