"""Mamba2's decode update kernel (``kernels/ssd_scan/decode.py``) and its
route through ``models/ssm.py`` ``mamba_block``.

On the CPU: the wrapper runs the plain version and writes the given state
in place, equal to ``ssd_decode_step`` bit for bit, grouped and not, at
the smoke shapes and at d_state 128; the argument checks; the route
predicate ``decode_route`` on what it observes (a stand-in reports a CUDA
device, since this host has none); and ``Model.decode_step`` with the
route forced through the wrapper gives the plain route's tokens and cache,
bit for bit, without copying the state back. On the card (``-m chip``,
skipped without CUDA): the kernel against the plain ops at
zamba2-7b-instruct's, zamba2-7b's, mamba2-1.3b's and the smoke shapes (the state bit
for bit, y within 1e-5 relative L2), in place, and a captured decode of
the zamba2-7b-instruct smoke config against the plain route.

Run on the card: ``python -m pytest tests/test_torch_ssd_decode.py -m
chip``.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd_scan import decode as sd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.config import get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402

# (lanes, heads, head dim, state dim, groups): the smoke configs' (P 16,
# N 16; zamba2-7b-instruct's two groups), and d_state 128 (mamba2-1.3b's)
CPU_CASES = [(3, 8, 16, 16, 1), (3, 8, 16, 16, 2), (2, 4, 64, 128, 1),
             (2, 4, 64, 128, 2)]
ARCH = "zamba2-7b-instruct"
Y_REL = 1e-5        # y's sum over N in another order than the plain GEMV


def _ids(cases):
    return [f"B{b}_H{h}_P{p}_N{n}_G{g}" for b, h, p, n, g in cases]


def inputs(b, h, p, n, g, device="cpu", dtype=torch.float32, seed=0):
    """A decode update's inputs as ``mamba_block`` hands them: x, B and C
    column views of one (B, 1, H P + 2 G N) projection at position 0, dt
    (B, H) a view of (B, 1, H), the published A and dt ranges; the state
    (B, H, P, N) fp32."""
    gen = torch.Generator(device=device).manual_seed(seed)
    xbc = F.silu(torch.randn(b, 1, h * p + 2 * g * n, generator=gen,
                             device=device)).to(dtype)
    x = xbc[..., :h * p].unflatten(-1, (h, p))[:, 0]
    bm = xbc[..., h * p:h * p + g * n]
    cm = xbc[..., h * p + g * n:]
    if g > 1:
        bm, cm = bm.unflatten(-1, (g, n)), cm.unflatten(-1, (g, n))
    bm, cm = bm[:, 0], cm[:, 0]
    bias = torch.log(torch.expm1(torch.linspace(1e-3, 0.1, h,
                                                device=device)))
    dt = F.softplus(torch.randn(b, 1, h, generator=gen, device=device)
                    + bias)[:, 0]
    a = -torch.arange(1, h + 1, dtype=torch.float32, device=device)
    state = torch.randn(b, h, p, n, generator=gen, device=device)
    return state, x, dt, a, bm, cm


def _rel(a, b):
    return float((a - b).norm() / b.norm())


# ------------------------------------------------------------- the CPU
@pytest.mark.parametrize("case", CPU_CASES, ids=_ids(CPU_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_wrapper_on_cpu_updates_the_state_in_place(case, dtype):
    state, *args = inputs(*case, dtype=dtype)
    want_y, want_s = ssd_decode_step(state, *args)
    ptr, before = state.data_ptr(), build.launches["ssd_decode"]
    y = sd.ssd_decode_update(state, *args)
    assert state.data_ptr() == ptr
    assert build.launches["ssd_decode"] == before
    assert torch.equal(state, want_s) and torch.equal(y, want_y)
    assert y.dtype == torch.float32 and y.shape == case[:3]


def test_argument_checks_take_the_models_layouts():
    for case in CPU_CASES:
        for dtype in sd.DTYPES:
            sd.check_args(*inputs(*case, dtype=dtype))


def _bad(name):
    """One argument list the kernel refuses, built from a good one."""
    state, x, dt, a, bm, cm = inputs(2, 4, 16, 16, 2)
    if name == "fp16_x":
        x, bm, cm = x.half(), bm.half(), cm.half()
    elif name == "x_and_b_dtypes_differ":
        x = x.bfloat16()
    elif name == "bf16_state":
        state = state.bfloat16()
    elif name == "bf16_dt":
        dt = dt.bfloat16()
    elif name == "two_devices":
        state = state.to("meta")
    elif name == "state_shape":
        state = state[:, :, :8].contiguous()
    elif name == "x_shape":
        x = x[:1]
    elif name == "groups_do_not_divide":
        bm, cm = torch.randn(2, 3, 16), torch.randn(2, 3, 16)
    elif name == "b_and_c_differ":
        cm = cm[:, :1]
    elif name == "a_rank":
        a = a[None]
    elif name == "no_template_n":
        state, x, dt, a, bm, cm = inputs(2, 4, 16, 32, 1)
    elif name == "n_8":
        state, x, dt, a, bm, cm = inputs(2, 4, 16, 8, 1)
    elif name == "non_contiguous_state":
        state = state.transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "strided_last_dim":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif name == "empty":
        state, x, dt, a, bm, cm = (t[:0] if t is not a else t for t in
                                   (state, x, dt, a, bm, cm))
    return state, x, dt, a, bm, cm


BAD = ("fp16_x", "x_and_b_dtypes_differ", "bf16_state", "bf16_dt",
       "two_devices", "state_shape", "x_shape", "groups_do_not_divide",
       "b_and_c_differ", "a_rank", "no_template_n", "n_8",
       "non_contiguous_state", "strided_last_dim", "empty")


@pytest.mark.parametrize("name", BAD)
def test_argument_checks_refuse_what_the_kernel_does_not_take(name):
    with pytest.raises(ValueError):
        sd.check_args(*_bad(name))


class _OnCuda:
    """A stand-in for a CUDA tensor on this host: what ``decode_route``
    observes of ``t`` (dtype, shape, layout, alignment, autograd), on a
    CUDA device."""
    is_cuda = True
    device = torch.device("cuda")

    def __init__(self, t):
        self.t = t

    def __getattr__(self, name):
        return getattr(self.t, name)


ROUTE = {
    "cuda_fp32_state": (True, {}),
    "cuda_bf16_inputs": (True, {"dtype": torch.bfloat16}),
    "n_128": (True, {"n": 128}),
    "cpu": (False, {"cpu": True}),
    "bf16_state": (False, {"state_dtype": torch.bfloat16}),
    "fp16_x": (False, {"dtype": torch.float16}),
    "non_contiguous_state": (False, {"strided": True}),
    "n_32": (False, {"n": 32}),
    "strided_x": (False, {"strided_x": True}),
    "groups_do_not_divide": (False, {"g": 3}),
    "inputs_on_two_devices": (False, {"split": True}),
    "autograd_records": (False, {"grad": True}),
    "dtensor": (False, {"dtensor": True}),
}


@pytest.mark.parametrize("name", list(ROUTE))
def test_decode_route(name, monkeypatch):
    want, o = ROUTE[name]
    state, x, dt, a, bm, cm = inputs(2, 6 if o.get("g") else 4, 16,
                                     o.get("n", 16), o.get("g", 2),
                                     dtype=o.get("dtype", torch.float32))
    if o.get("g"):                  # three groups' B and C over 4 heads
        state, x, dt, a = state[:, :4], x[:, :4], dt[:, :4], a[:4]
    state = state.to(o.get("state_dtype", torch.float32))
    if o.get("strided"):
        state = state.transpose(2, 3).contiguous().transpose(2, 3)
    if o.get("strided_x"):
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    if o.get("grad"):
        a = a.clone().requires_grad_()
    if o.get("dtensor"):
        monkeypatch.setattr(rules, "is_dtensor", lambda t: t is state)
    if not o.get("cpu"):
        state, x, dt, a, bm = map(_OnCuda, (state, x, dt, a, bm))
        cm = cm if o.get("split") else _OnCuda(cm)
    with torch.enable_grad():
        assert ssm.decode_route(state, x, dt, a, bm, cm) is want
    with torch.no_grad():   # the same inputs outside autograd
        assert ssm.decode_route(state, x, dt, a, bm, cm) is (
            want or name == "autograd_records")


def _prefill(model, params, lanes=3, prompt=5, cache_len=32):
    """A seeded prompt prefilled: (its last tokens (lanes,), the cache)."""
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, model.cfg.vocab, (lanes, prompt),
                           generator=gen)
    cache, _ = model.prefill(params, {"tokens": tokens}, cache_len)
    return tokens[:, -1].to(torch.int32), cache


def _steps(model, params, nxt, cache, steps):
    out = []
    for _ in range(steps):
        nxt, cache = model.decode_step(params, cache, nxt)
        out.append(nxt)
    return torch.stack(out, 1), cache


def test_decode_step_through_the_wrapper_matches_the_plain_route(
        monkeypatch):
    """``decode_step`` with the route forced through the wrapper (on the
    CPU its plain version, in place) gives the plain route's tokens and
    cache bit for bit, and copies no state back into the cache: the
    wrapper's own write-back is the only copy into a state view."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(seed=3, device="cpu")
    steps = 6
    with torch.no_grad():
        want_tokens, want_cache = _steps(model, params,
                                         *_prefill(model, params), steps)
        nxt, cache = _prefill(model, params)
        calls, copies = [], []
        wrapper, copy = sd.ssd_decode_update, torch.Tensor.copy_

        def counted(state, *args):
            calls.append(state.data_ptr())
            return wrapper(state, *args)

        def watched(dst, src, *a, **k):
            copies.append(dst.data_ptr())
            return copy(dst, src, *a, **k)

        monkeypatch.setattr(sd, "takes", lambda *args: True)
        monkeypatch.setattr(sd, "ssd_decode_update", counted)
        monkeypatch.setattr(torch.Tensor, "copy_", watched)
        tokens, cache = _steps(model, params, nxt, cache, steps)
        monkeypatch.setattr(torch.Tensor, "copy_", copy)
    assert torch.equal(tokens, want_tokens)
    assert all(torch.equal(cache[k], want_cache[k]) for k in want_cache)
    states = {cache["state"][i].data_ptr() for i in range(cfg.n_layers)}
    assert len(calls) == cfg.n_layers * steps and set(calls) == states
    assert sum(p in states for p in copies) == len(calls)


@pytest.mark.parametrize("kernel_route", [True, False],
                         ids=["kernel_route", "plain_route"])
def test_mamba_block_decode_leaves_the_state_in_place(kernel_route,
                                                      monkeypatch):
    """A decode step of ``mamba_block`` (L = 1 with a state) writes its new
    state into the given one and returns that tensor, on the kernel's
    route (forced; on the CPU the wrapper's plain version) and on the
    plain route alike, equal bit for bit to the plain route's on a copy."""
    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(seed=3, device="cpu")
    _, cache = _prefill(model, params)
    p, (conv, state) = next((p, views[:2]) for kind, p, views, *_ in
                            model._layers(params, cache) if kind == "mamba")
    x = torch.randn(conv.shape[0], 1, cfg.d_model,
                    generator=torch.Generator().manual_seed(5))
    x = x.to(params["embed"].dtype)
    with torch.no_grad():
        monkeypatch.setattr(sd, "takes", lambda *args: False)
        want_out, (_, want_s) = ssm.mamba_block(
            p, x, cfg.ssm, conv_cache=conv.clone(), ssd_state=state.clone(),
            eps=cfg.norm_eps)
        monkeypatch.setattr(sd, "takes", lambda *args: kernel_route)
        before, ptr = state.clone(), state.data_ptr()
        out, (_, got) = ssm.mamba_block(p, x, cfg.ssm, conv_cache=conv,
                                        ssd_state=state, eps=cfg.norm_eps)
    assert got is state and state.data_ptr() == ptr
    assert not torch.equal(state, before)
    assert torch.equal(state, want_s) and torch.equal(out, want_out)


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    """The CUDA device; skips the test where this host has none (decided
    when the test runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# zamba2-7b-instruct's layer at the cell's 96 lanes, zamba2-7b's (one
# group), mamba2-1.3b's (64 heads, d_state 128), and the smoke shapes,
# grouped and not
CARD_CASES = [(96, 112, 64, 64, 2), (4, 112, 64, 64, 1), (8, 64, 64, 128, 1),
              (3, 8, 16, 16, 1), (3, 8, 16, 16, 2), (5, 6, 64, 64, 3)]


@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES, ids=_ids(CARD_CASES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_kernel_against_the_plain_ops_on_card(card, case, dtype):
    """The state bit for bit, y within ``Y_REL``; in place: the state keeps
    its storage, and no input is written."""
    state, *args = inputs(*case, device=card, dtype=dtype, seed=sum(case))
    want_y, want_s = ssd_decode_step(state, *args)
    saved = [t.clone() for t in args]
    ptr, before = state.data_ptr(), build.launches["ssd_decode"]
    y = sd.ssd_decode_update(state, *args)
    torch.cuda.synchronize()
    assert build.launches["ssd_decode"] == before + 1
    assert state.data_ptr() == ptr
    assert torch.equal(state, want_s)
    assert _rel(y, want_y) <= Y_REL
    assert all(torch.equal(t, s) for t, s in zip(args, saved))


@pytest.mark.chip
def test_captured_decode_matches_the_plain_route_on_card(card, monkeypatch):
    """16 steps of the zamba2-7b-instruct smoke config through the captured
    step give the plain route's tokens and states; the kernel launches once
    a layer in each step the Python code runs (16 eager steps; the
    capture's warm-up steps and the capture itself), and never on the plain
    route."""
    from repro_torch.serve.graph import WARMUP_STEPS, CapturedStep

    cfg = get_smoke_config(ARCH)
    model = Model(cfg)
    params = model.init(seed=3, device=card)
    gen = torch.Generator(device=card).manual_seed(4)
    prompt = torch.randint(0, cfg.vocab, (3, 5), generator=gen, device=card)

    def run(step):
        cache, _ = model.prefill(params, {"tokens": prompt}, 32)
        nxt, out = prompt[:, -1].to(torch.int32), []
        for _ in range(16):
            nxt, cache = step(params, cache, nxt)
            out.append(nxt.clone())
        return torch.stack(out, 1), cache

    launches = build.launches
    with torch.no_grad():
        before = launches["ssd_decode"]
        eager, eager_cache = run(model.decode_step)
        assert launches["ssd_decode"] - before == cfg.n_layers * 16
        before = launches["ssd_decode"]
        captured, cache = run(CapturedStep(model))
        assert launches["ssd_decode"] - before == \
            cfg.n_layers * (WARMUP_STEPS + 1)
        with monkeypatch.context() as m:
            m.setattr(sd, "takes", lambda *args: False)
            before = launches["ssd_decode"]
            plain, plain_cache = run(model.decode_step)
            assert launches["ssd_decode"] == before
    torch.cuda.synchronize()
    assert torch.equal(eager, plain) and torch.equal(captured, plain)
    for c in (eager_cache, cache):
        assert _rel(c["state"], plain_cache["state"]) < Y_REL
