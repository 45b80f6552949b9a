"""Capture safety of the port's decode step, on the CPU.

The serving engine replays ``Model.decode_step`` as one CUDA graph on the
card (``repro_torch.serve.graph.CapturedStep``). A graph records the
kernels of one step and replays them with their arguments as captured, so
the step may not read a device value on the host (``.item()``,
``nonzero``), may not build a tensor from host data inside the step (a
host-to-device copy that capture rejects, or a value baked in at capture),
and must launch the same ops on the same shapes at every step, whatever
the lanes' positions. No CUDA graph runs here: a ``TorchDispatchMode``
records every aten op of ``decode_step`` on the smoke config of each
family, in fp32 (the path of the card's fp32 witnesses) and in bf16 with
the card's fused fp32-output products (``aten::mm.dtype`` /
``aten::bmm.dtype``, which the CPU lacks, computed here as widened
products), and the tests hold the property a graph needs. The new greedy
and decode-attention code is held against the code it replaced with
``==`` in fp32 on the CPU, and its bf16 products against widened ones.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.models import attention, embedloss, layers  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.graph import CapturedStep  # noqa: E402

# one smoke config per family: dense, windowed dense (window 16), ssm,
# hybrid, moe, vlm, encoder-decoder, and the hybrid's layer pattern given
# as data (Mamba2 and NoPE attention layers, each with a dropless MoE)
FAMILIES = {"dense": "stablelm-3b", "windowed": "gemma3-1b",
            "ssm": "mamba2-1.3b", "hybrid": "zamba2-7b",
            "moe": "arctic-480b", "vlm": "internvl2-26b",
            "encdec": "whisper-small", "pattern": "granite-4.0-h-small"}
DTYPES = ["float32", "bfloat16"]
B, CACHE = 2, 24
# ops that read a device value on the host, or build a tensor from host
# data, or whose output size depends on the data
FORBIDDEN = {"_local_scalar_dense", "item", "nonzero", "tolist",
             "scalar_tensor", "lift_fresh", "lift_fresh_copy",
             "masked_select", "_unique2", "unique_dim", "unique_consecutive",
             "repeat_interleave"}
FUSED = {"aten.mm.dtype": torch.mm, "aten.bmm.dtype": torch.bmm}


def _sig(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _sig(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return x
    return type(x).__name__    # a profiler range's handle, one per call


class OpLog(TorchDispatchMode):
    """Every aten op as (name, signature of its arguments: tensors by shape
    and dtype, every other argument by value). The fused fp32-output
    products, which have no CPU kernel, run as products of operands
    widened to ``wide``."""

    def __init__(self, wide=torch.float32):
        super().__init__()
        self.ops = []
        self.wide = wide

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops.append((str(func), _sig(args), _sig(kwargs)))
        if str(func) in FUSED:
            a, b, _ = args
            return FUSED[str(func)](a.to(self.wide), b.to(self.wide))
        return func(*args, **kwargs)

    def bad(self):
        return [op for op in self.ops
                if op[0].split(".")[1] in FORBIDDEN
                or (op[0].startswith("aten._to_copy")
                    and "device" in dict(op[2]))]


def _bf16_fused(*ts):
    return all(t.dtype == torch.bfloat16 for t in ts)


@pytest.fixture(params=[(f, d) for f in FAMILIES for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def family(request, monkeypatch):
    """(model, params) of one family's smoke config on the CPU, in fp32 or
    in bf16 taking the card's fused products."""
    name, dtype = request.param
    cfg = dataclasses.replace(get_smoke_config(FAMILIES[name]),
                              param_dtype=dtype, compute_dtype=dtype)
    if dtype == "bfloat16":
        monkeypatch.setattr(layers, "fused_f32", _bf16_fused)
        monkeypatch.setattr(attention, "fused_f32", _bf16_fused)
    model = Model(cfg)
    return model, model.init(0, device="cpu")


def _step(model, params, cache, rng):
    tokens = torch.from_numpy(
        rng.integers(0, model.cfg.vocab, B).astype(np.int32))
    with OpLog() as log:
        nxt, _ = model.decode_step(params, cache, tokens)
    assert nxt.shape == (B,) and nxt.dtype == torch.int32
    return log


def test_decode_step_builds_no_tensor_from_host_data(family):
    """One step at per-lane positions 5 and 2: no op reads a device value
    on the host or makes a tensor from host data."""
    model, params = family
    cache = model.init_cache(B, CACHE, device="cpu")
    cache["pos"].copy_(torch.tensor([5, 2], dtype=torch.int32))
    log = _step(model, params, cache, np.random.default_rng(0))
    assert log.ops and not log.bad(), log.bad()


def test_decode_step_op_sequence_is_static(family):
    """The same ops on the same shapes and arguments at every step: the
    first (lanes at positions 0 and 0), one at 1 and 1, one right after
    lane 1 was reset (3 and 0), and one past the rolling buffers' wrap
    (window 16 on gemma3-1b; 19 and 16), so that one captured step stands
    for all of them."""
    model, params = family
    rng = np.random.default_rng(1)
    cache = model.init_cache(B, CACHE, device="cpu")
    first = _step(model, params, cache, rng).ops
    seen = {}
    for i in range(1, 20):
        if i == 3:
            model.reset_cache_lane(cache, torch.tensor([1]))
            seen["after a lane reset"] = _step(model, params, cache, rng).ops
            continue
        ops = _step(model, params, cache, rng).ops
        if i == 1:
            seen["at a later position"] = ops
    seen["past the window's wrap"] = ops
    assert cache["pos"].tolist() == [20, 17]
    if model.cfg.window:
        assert cache["pos"].min().item() > model.cfg.window
    for when, ops in seen.items():
        assert ops == first, when


# the cache axes of the one config with no reference to hold them against,
# written out
KV_AXES = (None, "batch", "kv_seq", None, None)
WRITTEN_AXES = {"zamba2-7b-instruct": {
    "pos": ("batch",), "conv": (None, "batch", None, "ff"),
    "state": (None, "batch", "q_heads", None, None),
    "k_shared": KV_AXES, "v_shared": KV_AXES}}


@pytest.mark.parametrize("arch", list(FAMILIES.values()) + list(WRITTEN_AXES))
def test_lane_reset_by_index_tensor_is_a_device_op(arch):
    """``reset_cache_lane`` with a (1,) index tensor (the engine's on CUDA)
    makes no tensor from host data, wipes every leaf's lane to what
    ``init_cache`` makes, and leaves the other lane as it was; the cache
    axes are the written-out ones where a config has them."""
    model = Model(get_smoke_config(arch))
    params = model.init(0, device="cpu")
    cache = model.init_cache(B, CACHE, device="cpu")
    rng = np.random.default_rng(2)
    for _ in range(3):
        _step(model, params, cache, rng)
    for leaf in cache.values():   # every lane nonzero, cross K/V included
        leaf.add_(1)
    before = {k: v.clone() for k, v in cache.items()}
    lanes = torch.arange(B)[:, None]
    with OpLog() as log:
        model.reset_cache_lane(cache, lanes[0])
    assert not log.bad(), log.bad()
    assert {op[0] for op in log.ops} <= {"aten.index_fill_.int_Scalar",
                                         "aten.select.int"}
    fresh = model.init_cache(B, CACHE, device="cpu")
    axes = model.cache_axes()
    assert axes == WRITTEN_AXES.get(arch, axes)
    for key, leaf in cache.items():
        ax = axes[key].index("batch")
        assert torch.equal(leaf.select(ax, 0), fresh[key].select(ax, 0)), key
        assert torch.equal(leaf.select(ax, 1), before[key].select(ax, 1)), key


def test_cpu_engine_steps_eagerly_and_a_graph_needs_cuda():
    """On the CPU the engine's step and lane reset are the model's own
    methods, run eagerly; a captured step over a CPU cache raises (there
    is no eager fallback) and keeps no graph to replay."""
    model = Model(get_smoke_config("stablelm-3b"))
    params = model.init(0, device="cpu")
    engine = ServeEngine(model, params, batch_slots=B, max_len=CACHE)
    assert engine._step == model.decode_step
    assert engine._reset_lane == model.reset_cache_lane
    step = CapturedStep(model)
    with pytest.raises(ValueError, match="CUDA"):
        step(params, engine.cache, torch.zeros(B, dtype=torch.int32))
    assert step.graph is None


# ------------------------------------------------- new code against the old
def _old_greedy(x, table, valid_vocab=None):
    v = table.shape[0]
    valid = valid_vocab or v
    logits = x.float() @ table.float().T
    logits[:, valid:] = -torch.inf
    return logits.argmax(dim=-1).to(torch.int32)


def _old_decode_attention_local(q, k_cache, v_cache, *, pos, window=0,
                                kv_offset=0):
    b, hq, d = q.shape
    skv, n_kv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, n_kv, hq // n_kv, d).float()
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    kv_pos = kv_offset + torch.arange(skv, device=q.device)
    pos_b = torch.as_tensor(pos, device=q.device).expand(b)
    msk = kv_pos[None, :] <= pos_b[:, None]
    if window > 0:
        msk &= kv_pos[None, :] > pos_b[:, None] - window
    msk = msk[:, None, None, :]
    s = torch.where(msk, s, attention._NEG)
    m = s.amax(dim=-1)
    p = torch.where(msk, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def _qkv(rng, b, hq, hkv, s, d, dtype=torch.float32):
    def make(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    return make(b, hq, d), make(b, s, hkv, d), make(b, s, hkv, d)


@pytest.mark.parametrize("valid", [None, 50])
def test_greedy_equals_the_widened_product_in_fp32(valid):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((64, 32)).astype(
        np.float32))
    assert torch.equal(embedloss.greedy(x, table, valid_vocab=valid),
                       _old_greedy(x, table, valid_vocab=valid))


@pytest.mark.parametrize("pos,window", [
    ("lanes", 0), ("lanes", 5), (11, 0), (6, 4)],
    ids=["per-lane", "per-lane-window", "int", "int-window"])
def test_decode_attention_equals_the_old_code_in_fp32(pos, window):
    """fp32 on the CPU: (o, m, l) equal the replaced code's bit for bit,
    with per-lane tensor positions and with an int position (a cross
    layer's), with and without a window, at GQA group 3."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 6, 2, 12, 16)
    if pos == "lanes":
        pos = torch.tensor([11, 0, 7], dtype=torch.int32)
    new = attention.decode_attention_local(q, k, v, pos=pos, window=window)
    old = _old_decode_attention_local(q, k, v, pos=pos, window=window)
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def test_split3_bf16_is_exact():
    """Softmax weights over 30 decades as three bf16 terms: hi + mid + lo
    equals the fp32 weight exactly, so the p·V products are of bf16
    values."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy((10.0 ** rng.uniform(-30, 0, (4, 3, 2, 257))
                          ).astype(np.float32))
    parts = attention.split3_bf16(p)
    assert parts.dtype == torch.bfloat16 and parts.shape == (4, 3, 3, 2, 257)
    back = parts[:, 0].float() + parts[:, 1].float() + parts[:, 2].float()
    assert torch.equal(back, p)


@pytest.mark.parametrize("hq,hkv", [(6, 2), (4, 4), (7, 1)],
                         ids=["gqa3", "mha", "mqa7"])
def test_blockdiag_products_equal_the_widened_einsums(hq, hkv, monkeypatch):
    """The card's bf16 products of decode attention, each lane's queries
    laid block-diagonally against its cache rows as they lie, their
    fused products computed here in float64 from the bf16 operands: the
    scores and p·V equal the widened einsums in float64 to the last bits
    (only the order of the sums differs)."""
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng, 3, hq, hkv, 20, 16, torch.bfloat16)
    p = torch.softmax(torch.from_numpy(rng.standard_normal(
        (3, hkv, hq // hkv, 20)).astype(np.float32)) * 4, dim=-1)
    monkeypatch.setattr(layers, "fused_f32", _bf16_fused)
    with OpLog(torch.float64):
        scores = attention.scores_blockdiag(q, k)
        o = attention.pv_blockdiag(p, v)
    ref = torch.einsum("bhgd,bkhd->bhgk",
                       q.reshape(3, hkv, hq // hkv, 16).double(), k.double())
    torch.testing.assert_close(scores, ref, rtol=1e-12, atol=1e-12)
    ref = torch.einsum("bhgk,bkhd->bhgd", p.double(), v.double())
    torch.testing.assert_close(o, ref, rtol=1e-12, atol=1e-12)


def test_fused_decode_attention_matches_the_widened_path(monkeypatch):
    """The whole bf16 decode attention on the fused path (forced on the
    CPU, its fp32-output products widened here) against the widened
    einsums on the same bf16 inputs: fp32 sums in another order, 1e-5."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 2, 8, 2, 33, 32, torch.bfloat16)
    pos = torch.tensor([32, 9], dtype=torch.int32)
    want = _old_decode_attention_local(q, k, v, pos=pos, window=12)
    monkeypatch.setattr(layers, "fused_f32", _bf16_fused)
    monkeypatch.setattr(attention, "fused_f32", _bf16_fused)
    with OpLog() as log:
        got = attention.decode_attention_local(q, k, v, pos=pos, window=12)
    assert [op[0] for op in log.ops].count("aten.bmm.dtype") == 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
