"""The sequence forward's fused pointwise kernels (``kernels/pointwise``).

On the CPU: each wrapper runs the plain ops on CPU tensors; the argument
checks; and the model's dispatch, shown with the kernels' device test
(``pw.takes``) forced true so that CPU tensors reach the wrappers: a
sequence forward at S > 1 calls them and computes what the plain path
computes, while ``decode_step`` and a forward that autograd records call
none. On the card (``-m chip``, skipped without CUDA): each kernel against
the plain ops at the chain's shape and at ragged and odd shapes (RoPE,
SwiGLU and the residual sum bit for bit, the norms within one bf16 ulp),
and a 40-layer phi3-medium-14b forward against the plain path.

Run on the card: ``python -m pytest tests/test_torch_pointwise.py -m chip``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.pointwise import kernel as pw  # noqa: E402
from repro_torch.models import embedloss  # noqa: E402
from repro_torch.models.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.models.layers import apply_rope, rms_norm, rope_table  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402

WRAPPERS = ("rms_norm_cuda", "add_rms_norm_cuda", "rope_qk_cuda",
            "swiglu_gate_cuda")
# their keys in ``build.launches``
KEYS = tuple(w[:-len("_cuda")] for w in WRAPPERS)
# one smoke config of each family whose blocks run attention (both hybrid
# layouts: the JAX package's zamba2 variant and Zyphra's)
ARCHS = ("stablelm-3b", "gemma3-1b", "zamba2-7b", "arctic-480b",
         "internvl2-26b", "whisper-small", "zamba2-7b-instruct")
B, S = 2, 9


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------- the CPU
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_wrappers_run_the_plain_ops_on_cpu_tensors(dtype):
    g = _gen()
    x = torch.randn(B, S, 64, generator=g).to(dtype)
    y = torch.randn(B, S, 64, generator=g).to(dtype)
    scale = torch.randn(64, generator=g).to(dtype)
    q = torch.randn(B, S, 4, 32, generator=g).to(dtype)
    k = torch.randn(B, S, 2, 32, generator=g).to(dtype)
    before = build.launches.copy()
    assert torch.equal(pw.rms_norm_cuda(x, scale, 1e-6),
                       rms_norm(x, scale, 1e-6))
    s, h = pw.add_rms_norm_cuda(x, y, scale, 1e-6)
    assert torch.equal(s, x + y)
    assert torch.equal(h, rms_norm(x + y, scale, 1e-6))
    for table in (rope_table(torch.arange(S), 32, 1e4),
                  rope_table(torch.arange(S)[None].expand(B, S) + 3, 32,
                             1e4)):
        rq, rk = pw.rope_qk_cuda(q, k, *table)
        assert torch.equal(rq, apply_rope(q, *table))
        assert torch.equal(rk, apply_rope(k, *table))
    assert torch.equal(pw.swiglu_gate_cuda(x, y), F.silu(x) * y)
    assert build.launches == before


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


# (check, arguments, what the message names); each is refused
REFUSED = {
    "norm_width_not_8": (pw.check_norm_args, lambda: (_bf16(2, 12),
                                                      _bf16(12)), "multiple"),
    "norm_fp32": (pw.check_norm_args, lambda: (torch.zeros(2, 16),
                                               _bf16(16)), "bf16"),
    "norm_scale_shape": (pw.check_norm_args, lambda: (_bf16(2, 16),
                                                      _bf16(8)), "scale"),
    "norm_scale_int": (pw.check_norm_args, lambda: (
        _bf16(2, 16), torch.zeros(16, dtype=torch.int32)), "scale dtype"),
    "norm_too_wide": (pw.check_norm_args, lambda: (
        _bf16(1, pw.MAX_D + 8), _bf16(pw.MAX_D + 8)), "multiple"),
    "norm_strided": (pw.check_norm_args, lambda: (_bf16(16, 4).T,
                                                  _bf16(16)), "contiguous"),
    "add_norm_shapes": (pw.check_norm_args, lambda: (
        _bf16(2, 16), _bf16(16), _bf16(3, 16)), "differ"),
    "rope_head_dim_24": (pw.check_rope_args, lambda: (
        _bf16(1, 4, 2, 24), _bf16(1, 4, 1, 24), torch.zeros(4, 12),
        torch.zeros(4, 12)), "head dim"),
    "rope_fp32": (pw.check_rope_args, lambda: (
        torch.zeros(1, 4, 2, 32), torch.zeros(1, 4, 1, 32),
        torch.zeros(4, 16), torch.zeros(4, 16)), "bf16"),
    "rope_bf16_tables": (pw.check_rope_args, lambda: (
        _bf16(1, 4, 2, 32), _bf16(1, 4, 1, 32), _bf16(4, 16),
        _bf16(4, 16)), "float32"),
    "rope_table_shape": (pw.check_rope_args, lambda: (
        _bf16(1, 4, 2, 32), _bf16(1, 4, 1, 32), torch.zeros(5, 16),
        torch.zeros(5, 16)), "tables"),
    "rope_positions": (pw.check_rope_args, lambda: (
        _bf16(1, 4, 2, 32), _bf16(1, 3, 1, 32), torch.zeros(4, 16),
        torch.zeros(4, 16)), "want"),
    "rope_unaligned_heads": (pw.check_rope_args, lambda: (
        _bf16(1, 4, 2, 40)[..., 4:36], _bf16(1, 4, 1, 32),
        torch.zeros(4, 16), torch.zeros(4, 16)), "aligned"),
    "swiglu_shapes": (pw.check_swiglu_args, lambda: (_bf16(2, 16),
                                                     _bf16(2, 8)), "shape"),
    "swiglu_size_not_8": (pw.check_swiglu_args, lambda: (_bf16(3, 3),
                                                         _bf16(3, 3)),
                          "multiple"),
    "swiglu_fp32": (pw.check_swiglu_args, lambda: (torch.zeros(8),
                                                   torch.zeros(8)), "bf16"),
}


@pytest.mark.parametrize("case", list(REFUSED), ids=list(REFUSED))
def test_argument_checks_refuse_what_the_kernels_do_not_take(case):
    check, args, match = REFUSED[case]
    with pytest.raises(ValueError, match=match):
        check(*args())


def test_argument_checks_take_the_chains_layouts():
    """The shapes the chain hands the kernels, at a few positions: rows of
    5,120 with a bf16 or an fp32 scale, q and k as views of their
    projections with shared or per-lane tables, the gate's (B, S, F)."""
    x = _bf16(1, 4, 5120)
    for scale in (_bf16(5120), torch.zeros(5120)):
        pw.check_norm_args(x, scale)
        pw.check_norm_args(x, scale, _bf16(1, 4, 5120))
    for hd in (64, 80, 112, 128, 256):
        q = _bf16(2, 4, 40 * hd).view(2, 4, 40, hd)
        k = _bf16(2, 4, 10 * hd).view(2, 4, 10, hd)
        for shape in ((4, hd // 2), (2, 4, hd // 2)):
            pw.check_rope_args(q, k, torch.zeros(shape), torch.zeros(shape))
    pw.check_swiglu_args(_bf16(1, 4, 17920), _bf16(1, 4, 17920))


def _model(arch):
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    return model, model.init(0, device="cpu")


def _batch(model, s=S):
    cfg = model.cfg
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, s)).astype(np.int32))}
    if cfg.enc_len:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_len, cfg.d_model)).astype(np.float32))
    return batch


def _count_calls(monkeypatch):
    """Forces the fused route on CPU tensors and counts each wrapper's
    calls (the wrappers then run the plain ops)."""
    calls = dict.fromkeys(WRAPPERS, 0)
    monkeypatch.setattr(pw, "takes", lambda x: True)
    for name in WRAPPERS:
        def counted(*args, _name=name, _fn=getattr(pw, name)):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(pw, name, counted)
    return calls


def _refuse_calls(monkeypatch):
    monkeypatch.setattr(pw, "takes", lambda x: True)
    for name in WRAPPERS:
        def refuse(*args, _name=name):
            raise AssertionError(f"{_name} called")
        monkeypatch.setattr(pw, name, refuse)


@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_forward_takes_the_fused_wrappers(arch, monkeypatch):
    """At S > 1 outside autograd every attention block takes the fused
    norm and RoPE, and every dense SwiGLU the fused gate, and the forward
    computes exactly what the plain path computes."""
    model, params = _model(arch)
    batch = _batch(model)
    with torch.no_grad():
        plain = model.forward(params, batch)
        calls = _count_calls(monkeypatch)
        fused = model.forward(params, batch)
    assert torch.equal(fused, plain)
    assert calls["rope_qk_cuda"] >= 1 and calls["rms_norm_cuda"] >= 1
    if arch == "stablelm-3b":
        n = model.cfg.n_layers
        assert calls == dict.fromkeys(WRAPPERS, n)
    if arch == "zamba2-7b-instruct":
        # Zyphra's shared block, applied 3 times: its two norms (the
        # concatenated input's and the MLP's) and RoPE, never the
        # residual-add norm (it has no residual) or SwiGLU's gate (GeGLU)
        n = len(model.cfg.hybrid_layer_ids)
        assert calls == {"rms_norm_cuda": 2 * n, "add_rms_norm_cuda": 0,
                         "rope_qk_cuda": n, "swiglu_gate_cuda": 0}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_calls_no_fused_wrapper(arch, monkeypatch):
    """The decode step's (B, 1, D) calls keep the plain ops."""
    model, params = _model(arch)
    cache = model.init_cache(B, 16, device="cpu")
    _refuse_calls(monkeypatch)
    tokens = torch.zeros(B, dtype=torch.int32)
    for _ in range(2):
        model.decode_step(params, cache, tokens)


def test_training_forward_calls_no_fused_wrapper(monkeypatch):
    """A forward that autograd records keeps the plain ops, remat on and
    off, and its gradients flow."""
    model, params = _model("stablelm-3b")
    for leaf in [params["embed"], *params["layers"].values()]:
        leaf.requires_grad_()
    batch = _batch(model)
    batch["labels"] = batch["tokens"]
    _refuse_calls(monkeypatch)
    for remat in (False, True):
        m = Model(dataclasses.replace(model.cfg, remat=remat))
        m.loss(params, batch).backward()
    assert params["layers"]["wq"].grad is not None


def test_chain_stage_takes_the_fused_wrappers(monkeypatch):
    """The chain's stage runs each layer task through the fused path and
    emits what the plain path emits."""
    from repro_torch.pipeline.stages import model_stage_builder

    model, params = _model("stablelm-3b")
    names = ["ingest", "embed", *(f"layer{i}" for i in
                                  range(model.cfg.n_layers)), "head", "emit"]
    tokens = _batch(model)["tokens"][:1].numpy()
    with torch.no_grad():
        fn = model_stage_builder(model, params, names, device="cpu")(
            0, len(names) - 1)
        plain = fn(tokens)
        calls = _count_calls(monkeypatch)
        fused = fn(tokens)
    assert calls == dict.fromkeys(WRAPPERS, model.cfg.n_layers)
    assert np.array_equal(fused[0], plain[0])
    assert torch.equal(fused[1], plain[1])


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    """The CUDA device; skips the test where this host has none (decided
    when the test runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ulps(a, b):
    """The distance of two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


# (rows shape, width): the chain's frame, and ragged and odd shapes of the
# port's configs (whisper 768, stablelm 2560, zamba2 3584, gemma3-12b 3840,
# arctic 7168) up to the widest row the kernel holds
NORM_SHAPES = [((1, 2048), 5120), ((3, 37), 5120), ((1, 1), 5120),
               ((2, 37), 768), ((5, 13), 2560), ((2, 37), 3584),
               ((1, 129), 3840), ((2, 37), 7168), ((3, 5), 8),
               ((2, 3), pw.MAX_D)]


@pytest.mark.chip
@pytest.mark.parametrize("shape", NORM_SHAPES,
                         ids=[f"{r}x{d}" for r, d in NORM_SHAPES])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_scale", "fp32_scale"])
def test_norm_kernels_on_card(card, shape, scale_dtype):
    (b, s), d = shape
    g = torch.Generator(device=card).manual_seed(b * s + d)
    x = (torch.randn(b, s, d, generator=g, device=card) * 3).bfloat16()
    y = torch.randn(b, s, d, generator=g, device=card).bfloat16()
    scale = (torch.randn(d, generator=g, device=card) * 0.1).to(scale_dtype)
    h = pw.rms_norm_cuda(x, scale, 1e-6)
    assert int(_ulps(h, rms_norm(x, scale, 1e-6)).max()) <= 1
    total, h = pw.add_rms_norm_cuda(x, y, scale, 1e-6)
    assert torch.equal(total, x + y)
    assert int(_ulps(h, rms_norm(x + y, scale, 1e-6)).max()) <= 1
    torch.cuda.synchronize()


# (batch, positions, q heads, kv heads): the chain's, and ragged ones
ROPE_SHAPES = [(1, 2048, 40, 10), (2, 37, 4, 2), (3, 5, 7, 1)]


@pytest.mark.chip
@pytest.mark.parametrize("hd", [64, 80, 112, 128, 256])
@pytest.mark.parametrize("shape", ROPE_SHAPES,
                         ids=["x".join(map(str, s)) for s in ROPE_SHAPES])
@pytest.mark.parametrize("per_lane", [False, True],
                         ids=["shared_table", "per_lane_table"])
def test_rope_kernel_on_card(card, hd, shape, per_lane):
    b, s, hq, hkv = shape
    g = torch.Generator(device=card).manual_seed(hd + s)
    q = (torch.randn(b, s, hq * hd, generator=g, device=card) * 4
         ).bfloat16().view(b, s, hq, hd)
    k = (torch.randn(b, s, hkv * hd, generator=g, device=card) * 4
         ).bfloat16().view(b, s, hkv, hd)
    pos = torch.arange(s, device=card)
    if per_lane:
        pos = pos[None] + 100 * torch.arange(b, device=card)[:, None]
    sin, cos = rope_table(pos, hd, 1e4)
    want_q, want_k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    got_q, got_k = pw.rope_qk_cuda(q, k, sin, cos)
    assert got_q.data_ptr() == q.data_ptr()
    assert torch.equal(got_q, want_q) and torch.equal(got_k, want_k)


SWIGLU_SHAPES = [(1, 2048, 17920), (3, 37, 136), (1, 1, 8), (2, 5, 4104)]


@pytest.mark.chip
@pytest.mark.parametrize("shape", SWIGLU_SHAPES,
                         ids=["x".join(map(str, s)) for s in SWIGLU_SHAPES])
def test_swiglu_gate_kernel_on_card(card, shape):
    g = torch.Generator(device=card).manual_seed(shape[-1])
    gate = (torch.randn(*shape, generator=g, device=card) * 6).bfloat16()
    up = torch.randn(*shape, generator=g, device=card).bfloat16()
    want = F.silu(gate) * up
    assert torch.equal(pw.swiglu_gate_cuda(gate, up), want)


def _sum_reordered_norm(x, scale, eps=1e-6):
    """``rms_norm`` with its fp32 sum of squares taken in another order
    (over the reversed row): the only way the fused norm departs from the
    plain one."""
    x32 = x.float()
    var = x32.flip(-1).square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


@pytest.mark.chip
def test_phi3_forward_matches_the_plain_path_on_card(card, monkeypatch):
    """A 40-layer phi3-medium-14b forward over 2,048 tokens, bf16, random
    weights: one launch of each kernel a layer, the plain path's greedy
    token, and a last hidden state no farther from the plain path's than
    the plain path with only its norms' sum order changed (the control).

    A relative gap of 1e-3 over 40 layers is out of reach for any norm
    that is not bit-identical: the random-weight network grows a one-ulp
    difference in a norm to ~1.7 % by the last layer, the control as much
    as the fused path (0.0169 / 0.0185 against 0.0170 / 0.0167 on two
    token draws, NVIDIA H100 80GB HBM3)."""
    from repro_torch.models import transformer

    cfg = get_config("phi3-medium-14b")
    model = Model(cfg)
    params = model.init(0, device=card)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, 2048)).astype(np.int32)).to(card)}
    before = build.launches.copy()
    last = {}
    with torch.no_grad():
        last["fused"] = model.forward(params, batch)[:, -1]
        counts = {k: build.launches[k] - before[k] for k in KEYS}
        monkeypatch.setattr(pw, "takes", lambda x: False)
        last["plain"] = model.forward(params, batch)[:, -1]
        monkeypatch.setattr(transformer, "rms_norm", _sum_reordered_norm)
        last["control"] = model.forward(params, batch)[:, -1]
        tok = {k: embedloss.greedy(h, params["embed"], valid_vocab=cfg.vocab)
               for k, h in last.items()}
    assert counts == dict.fromkeys(KEYS, cfg.n_layers)
    plain = last["plain"].float()

    def gap(k):
        return float((last[k].float() - plain).norm() / plain.norm())

    assert gap("fused") <= 1.5 * gap("control"), (gap("fused"),
                                                   gap("control"))
    assert 0 < gap("control") < 0.05
    assert torch.equal(tok["fused"], tok["plain"])
    del params
    torch.cuda.empty_cache()


# launches of (rms_norm, add_rms_norm, rope_qk, swiglu_gate) in one
# sequence forward of each family's smoke config: one of each per
# attention block (gemma3-1b's 8 windowed and global layers, zamba2-7b's
# shared block applied twice, arctic's dense residual beside its
# experts); whisper's 2 encoder layers take two plain norms and a gate,
# its 2 decoder layers a norm before self-attention, cross-attention and
# the MLP, RoPE once and a gate, and no fused add; Zyphra's shared block,
# applied 3 times, two norms and RoPE only
SMOKE_LAUNCHES = {"stablelm-3b": (2, 2, 2, 2), "gemma3-1b": (8, 8, 8, 8),
                  "zamba2-7b": (2, 2, 2, 2), "arctic-480b": (2, 2, 2, 2),
                  "internvl2-26b": (2, 2, 2, 2),
                  "whisper-small": (10, 0, 2, 4),
                  "zamba2-7b-instruct": (6, 0, 3, 0)}


@pytest.mark.chip
@pytest.mark.parametrize("arch", ARCHS)
def test_family_forward_takes_the_kernels_on_card(card, arch, monkeypatch):
    """Each family's smoke config in bf16 on the card, 2 x 37 positions
    (internvl2's first positions spliced from patches, whisper's decoder
    over 30 encoded frames): the forward through the real route passes
    the kernels' argument checks on the family's own layouts, launches
    each kernel as often as ``SMOKE_LAUNCHES`` says, and its hidden states
    lie no farther from the plain path's than one bf16 ulp, relative, or
    1.5 x the control's (the plain path with its norms' sum order
    changed). Attention and the SSD run their plain versions: the smoke
    configs' head dim of 16 is below what the attention kernels take."""
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16",
                              compute_dtype="bfloat16", attn_impl="xla_flash",
                              ssd_impl="blocked")
    model = Model(cfg)
    params = model.init(0, device=card)
    batch = _batch(model, s=37)
    if cfg.n_patches:
        batch["patches"] = torch.from_numpy(np.random.default_rng(1)
                                            .standard_normal((B, cfg.n_patches,
                                                              cfg.d_model))
                                            .astype(np.float32))
    batch = {k: v.to(card) for k, v in batch.items()}
    before = build.launches.copy()
    out = {}
    with torch.no_grad():
        out["fused"] = model.forward(params, batch).float()
        counts = tuple(build.launches[k] - before[k] for k in KEYS)
        monkeypatch.setattr(pw, "takes", lambda x: False)
        out["plain"] = model.forward(params, batch).float()
        monkeypatch.setattr(transformer, "rms_norm", _sum_reordered_norm)
        out["control"] = model.forward(params, batch).float()
    assert counts == SMOKE_LAUNCHES[arch]
    assert all(bool(torch.isfinite(h).all()) for h in out.values())

    def gap(k):
        return float((out[k] - out["plain"]).norm() / out["plain"].norm())

    assert gap("fused") <= max(1.5 * gap("control"), 2 ** -8), (
        gap("fused"), gap("control"))
