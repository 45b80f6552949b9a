"""Gradients through the kernel wrappers, on the CPU.

Each wrapper (flash, two-pass, SSD scan) goes through its
``torch.autograd.Function`` whenever an input requires a gradient. Its
backward, run here with the kernel's plain forward injected as the CPU
wrappers do, is held against autograd of the plain version
(``attention_kernel_ref``, ``ssd_ref_sequential``) in fp32: causal,
window, non-causal over a ragged key length, GQA, head dim 80, rows that
see no key, and the SSD scan with and without an initial state. Then the
CUDA branch of each wrapper runs on the CPU over a faked extension that
writes the plain result into the wrapper's output: every input that
requires a gradient receives one through that branch, which the wrappers
before the Functions did not give (their output had no ``grad_fn``)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro_torch.kernels import autograd, build  # noqa: E402
from repro_torch.kernels.flash_attention import chunked as ca  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_kernel_bwd_ref, attention_kernel_ref)
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential  # noqa: E402

# b, hq, hkv, sq, skv, d, causal, window
ATTN_CASES = {
    "causal": (2, 4, 4, 40, 40, 16, True, 0),
    "window": (1, 4, 2, 70, 70, 32, True, 16),
    "noncausal-ragged": (2, 4, 4, 24, 45, 16, False, 0),
    "gqa4": (1, 8, 2, 33, 33, 16, True, 0),
    "d80": (1, 2, 2, 37, 37, 80, True, 0),
    "no-key-rows": (1, 2, 1, 64, 16, 32, True, 8),
}
# a head dim the CUDA kernels take, GQA group 4: the faked CUDA branch
FAKE_CASE = (1, 8, 2, 33, 33, 32, True, 0)
# b, l, h, p, n, chunk: zamba2's head layout (head dim 16, 16 states) at a
# ragged length
SSD_CASE = (2, 37, 4, 16, 16, 16)
TOL = 1e-4      # max |difference| over max |reference|, fp32
WRAPPERS = {"flash": fa.flash_attention_cuda,
            "chunked": ca.chunked_attention_cuda}


def _attn_inputs(case, seed=0):
    b, hq, hkv, sq, skv, d, _, _ = case
    rng = np.random.default_rng(seed)

    def make(s, h):
        x = rng.standard_normal((b, s, h, d)).astype(np.float32)
        return torch.from_numpy(x).transpose(1, 2).requires_grad_()

    q, k, v = make(sq, hq), make(skv, hkv), make(skv, hkv)
    do = torch.from_numpy(rng.standard_normal((b, hq, sq, d))
                          .astype(np.float32))
    return q, k, v, do


def _rel(got, ref):
    got, ref = got.detach(), ref.detach()
    return float((got - ref).abs().max()) / max(float(ref.abs().max()),
                                                1e-30)


def _ref_grads(case, q, k, v, do):
    causal, window = case[6], case[7]
    o = attention_kernel_ref(q, k, v, causal=causal, window=window)
    return torch.autograd.grad(o, (q, k, v), do)


@pytest.mark.parametrize("case", list(ATTN_CASES), ids=list(ATTN_CASES))
@pytest.mark.parametrize("wrapper", list(WRAPPERS), ids=list(WRAPPERS))
def test_attention_function_matches_autograd(wrapper, case):
    c = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(c)
    o = WRAPPERS[wrapper](q, k, v, causal=c[6], window=c[7])
    assert type(o.grad_fn).__name__ == "AttentionFunctionBackward"
    got = torch.autograd.grad(o, (q, k, v), do)
    for name, g, r in zip("qkv", got, _ref_grads(c, q, k, v, do)):
        assert g.shape == r.shape and _rel(g, r) < TOL, (name, _rel(g, r))


def test_attention_bwd_ref_tiles_and_empty_rows():
    """The backward blocked over query tiles of any size gives the same
    gradients, and a row that sees no key gets a zero dq."""
    c = ATTN_CASES["no-key-rows"]
    q, k, v, do = _attn_inputs(c, seed=1)
    with torch.no_grad():
        o = attention_kernel_ref(q, k, v, causal=c[6], window=c[7])
    ref = _ref_grads(c, q, k, v, do)
    for tile in (1, 7, 16, 512):
        got = attention_kernel_bwd_ref(q, k, v, o, do, causal=c[6],
                                       window=c[7], q_tile=tile)
        for g, r in zip(got, ref):
            assert _rel(g, r) < TOL
    # keys 0..15, window 8: from row 23 on no key is visible
    dq = got[0]
    assert bool((dq[:, :, 23:] == 0).all())


def _ssd_inputs(seed, init):
    b, l, h, p, n, _ = SSD_CASE
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0, pos=False):
        x = rng.standard_normal(shape) * scale
        x = np.abs(x) if pos else x
        return torch.from_numpy(x.astype(np.float32)).requires_grad_()

    x = t(b, l, h, p)
    dt = t(b, l, h, scale=0.1, pos=True)
    a = (-t(h, pos=True)).detach().requires_grad_()
    bmat, cmat = t(b, l, n), t(b, l, n)
    s0 = t(b, h, p, n) if init else None
    return x, dt, a, bmat, cmat, s0


@pytest.mark.parametrize("init", [False, True], ids=["zero", "init-state"])
def test_ssd_function_matches_autograd(init):
    x, dt, a, bmat, cmat, s0 = _ssd_inputs(0, init)
    y, state = sk.ssd_cuda(x, dt, a, bmat, cmat, chunk=SSD_CASE[5],
                           init_state=s0)
    assert type(y.grad_fn).__name__ == "SSDFunctionBackward"
    rng = np.random.default_rng(5)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    ds = torch.from_numpy(rng.standard_normal(state.shape)
                          .astype(np.float32))
    inputs = [x, dt, a, bmat, cmat] + ([s0] if init else [])
    got = torch.autograd.grad((y, state), inputs, (dy, ds))
    y2, s2 = ssd_ref_sequential(x, dt, a, bmat, cmat, s0)
    ref = torch.autograd.grad((y2, s2), inputs, (dy, ds))
    for name, g, r in zip(["x", "dt", "a", "B", "C", "init"], got, ref):
        assert _rel(g, r) < TOL, (name, _rel(g, r))


def test_no_function_without_grad():
    """Under ``no_grad``, or with no input that requires a gradient, the
    wrappers call their forward directly."""
    c = ATTN_CASES["causal"]
    q, k, v, _ = _attn_inputs(c)
    with torch.no_grad():
        assert fa.flash_attention_cuda(q, k, v).grad_fn is None
    assert fa.flash_attention_cuda(q.detach(), k.detach(),
                                   v.detach()).grad_fn is None
    assert not autograd.needs_grad(q.detach(), None)


# ------------------------------------------------- the faked CUDA branch
@pytest.fixture
def fake_extension(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors: ``all_cpu`` says no,
    ``check_cuda`` passes, and the extension writes the plain result into
    the output the wrapper allocated. Counts the launches it takes."""
    calls = []

    # autograd does not see inside an extension: the writes record nothing
    @torch.no_grad()
    def attention(q, k, v, out, causal, window, scale, q_offset):
        calls.append("attention")
        out.copy_(attention_kernel_ref(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset))

    @torch.no_grad()
    def ssd(x, dt, a, bmat, cmat, y, state, init, keys, cstate, prev, q):
        calls.append("ssd")
        yy, ss = ssd_ref_sequential(x, dt, a, bmat, cmat,
                                    init if init.numel() else None)
        y.copy_(yy)
        state.copy_(ss)

    ext = types.SimpleNamespace(flash_attention_fwd=attention,
                                chunked_attention_fwd=attention,
                                ssd_scan_fwd=ssd)
    monkeypatch.setattr(build, "all_cpu", lambda *ts: False)
    monkeypatch.setattr(build, "check_cuda", lambda name, *ts: None)
    monkeypatch.setattr(build, "extension", lambda verbose=False: ext)
    return calls


@pytest.mark.parametrize("wrapper", list(WRAPPERS), ids=list(WRAPPERS))
def test_cuda_branch_gives_attention_gradients(fake_extension, wrapper):
    c = FAKE_CASE
    q, k, v, do = _attn_inputs(c)
    key = f"{wrapper}_attention"
    before = build.launches[key]
    o = WRAPPERS[wrapper](q, k, v, causal=c[6], window=c[7])
    assert build.launches[key] == before + 1 \
        and fake_extension == ["attention"]
    got = torch.autograd.grad(o, (q, k, v), do)
    assert build.launches[key] == before + 1  # the backward launches nothing
    for name, g, r in zip("qkv", got, _ref_grads(c, q, k, v, do)):
        assert _rel(g, r) < TOL, name
    # the control, the wrappers before the Functions: the branch's output
    # is detached from q, k and v
    raw = fa._flash_fwd if wrapper == "flash" else ca._chunked_fwd
    assert raw(q, k, v, c[6], c[7]).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_cuda_branch_gives_ssd_gradients(fake_extension, dtype):
    x, dt, a, bmat, cmat, s0 = _ssd_inputs(2, True)
    if dtype == torch.bfloat16:
        x, bmat, cmat = (t.detach().to(dtype).requires_grad_()
                         for t in (x, bmat, cmat))
    before = build.launches["ssd_scan"]
    y, state = sk.ssd_cuda(x, dt, a, bmat, cmat, chunk=SSD_CASE[5],
                           init_state=s0)
    assert build.launches["ssd_scan"] == before + 1 \
        and fake_extension == ["ssd"]
    inputs = (x, dt, a, bmat, cmat, s0)
    got = torch.autograd.grad((y.float().sum() + state.sum()), inputs)
    for name, g, t in zip(["x", "dt", "a", "B", "C", "init"], got, inputs):
        assert g is not None and g.shape == t.shape, name
        assert bool(torch.isfinite(g.float()).all()) and \
            float(g.float().abs().max()) > 0, name
    assert build.launches["ssd_scan"] == before + 1
    assert sk._ssd_fwd(x, dt, a, bmat, cmat, SSD_CASE[5],
                       s0)[0].grad_fn is None


def test_ssd_gradients_stay_finite_where_a_chunk_decays_past_fp32():
    """dt * A of -3 a step over a chunk of 32: the chunk's decay spans
    e^93, past fp32's e^88.7, above the diagonal. The backward's recomputed
    ``ssd_ref`` keeps that exponent at -inf, so every gradient is finite
    and equals autograd of the sequential recurrence; selecting the
    overflowed decay away after the product (the reference's form) gives
    NaN."""
    x, dt, a, bmat, cmat, s0 = _ssd_inputs(4, True)
    dt = torch.full_like(dt, 0.25).requires_grad_()
    a = torch.full_like(a, -12.0).requires_grad_()
    inputs = (x, dt, a, bmat, cmat, s0)
    y, state = sk.ssd_cuda(x, dt, a, bmat, cmat, chunk=32, init_state=s0)
    got = torch.autograd.grad(y.sum() + state.sum(), inputs)
    y2, s2 = ssd_ref_sequential(x, dt, a, bmat, cmat, s0)
    ref = torch.autograd.grad(y2.sum() + s2.sum(), inputs)
    for name, g, r in zip(["x", "dt", "a", "B", "C", "init"], got, ref):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, r) < TOL, (name, _rel(g, r))
    # the reference's form of the decay, for contrast
    seg = torch.zeros(4, 4, requires_grad=True)
    causal = torch.ones(4, 4, dtype=torch.bool).tril()
    wide = seg + torch.triu(torch.full((4, 4), 200.0), 1)
    m = torch.where(causal, torch.exp(wide) * 1.0, 0.0)
    assert bool(torch.isnan(torch.autograd.grad(
        (m * torch.exp(wide)).sum(), seg)[0]).any())
