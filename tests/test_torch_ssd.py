"""The port's SSD functions and the SSD kernel's wrapper against the JAX
reference on the CPU: the sequential recurrence, the blocked scan (with and
without an initial state), the kernel's wrapper continuing an initial
state, the decode step, the causal conv, the Mamba2 block (plain scan and
the kernel's wrapper, whose CPU path is its plain version, from zero and
from a given state), the kernel registry, and a plain-torch emulation of
the bf16 tensor-core body's arithmetic. Inputs are made with numpy from a
seed and fed to both. The CUDA kernel itself runs only on a GPU
(``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.kernels import registry as jregistry  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_tpu  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref_sequential as jseq  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import SSMConfig as JSSMConfig  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_attention.chunked import chunked_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.attention import flash_attention_xla  # noqa: E402
from repro_torch.models.config import SSMConfig  # noqa: E402

# the reference's grid (tests/test_kernels.py::test_ssd_kernel):
# b, l, h, p, n, chunk
SSD_CASES = [
    (2, 64, 4, 16, 8, 16),
    (1, 100, 2, 32, 16, 32),
    (2, 37, 3, 8, 8, 64),
    (1, 128, 1, 64, 32, 128),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 5e-2)}
# a mid width, zamba2's head and state dims and chunk, held against the
# full-width limits of chip_smoke.py (relative max-norm: y, state)
MID_CASE = (1, 512, 8, 64, 64, 256)
MID_Y_REL, MID_STATE_REL = 1e-2, 1e-3


def _inputs(seed, b, l, h, p, n):
    """numpy x (B, L, H, P), dt (B, L, H), a (H,), B/C (B, L, N), with the
    reference test's distributions."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.3, size=(b, l, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32))


def _both(arrs, tdt, jdt):
    """x, B, C in the dtype under test; dt and a stay float32."""
    x, dt, a, bm, cm = arrs
    t = [torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
         torch.from_numpy(a), torch.from_numpy(bm).to(tdt),
         torch.from_numpy(cm).to(tdt)]
    j = [jnp.asarray(x, jdt), jnp.asarray(dt), jnp.asarray(a),
         jnp.asarray(bm, jdt), jnp.asarray(cm, jdt)]
    return t, j


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_sequential_matches_jax(case, dtype):
    """The plain version of the kernel on the reference's four cases, the
    same (x, B, C in the dtype) inputs through both: y in x's dtype, the
    state in fp32."""
    b, l, h, p, n, _ = case
    tdt, jdt, tol = DTYPES[dtype]
    t, j = _both(_inputs(0, b, l, h, p, n), tdt, jdt)
    y, s = ssd_ref_sequential(*t)
    yr, sr = jseq(*j)
    assert y.shape == (b, l, h, p) and y.dtype == tdt
    assert s.shape == (b, h, p, n) and s.dtype == torch.float32
    assert _err(y, yr) < tol
    assert _err(s, sr) < tol


@pytest.mark.parametrize("case", [SSD_CASES[1], SSD_CASES[2]])
def test_kernel_wrapper_on_cpu_matches_pallas_interpret(case):
    """On CPU tensors ``ssd_cuda`` runs its plain version and computes what
    the Pallas kernel computes in interpret mode, on the two cases whose L
    is no multiple of the chunk, and launches nothing."""
    b, l, h, p, n, chunk = case
    t, j = _both(_inputs(1, b, l, h, p, n), torch.float32, jnp.float32)
    before = sk.launches
    y, s = sk.ssd_cuda(*t, chunk=chunk)
    yr, sr = ssd_tpu(*j, chunk=chunk, interpret=True)
    assert sk.launches == before
    assert _err(y, yr) < 1e-4 and _err(s, sr) < 1e-4


@pytest.mark.parametrize("case", SSD_CASES)
def test_public_ssd_matches_reference_ops(case):
    """``ssd_scan.ops.ssd``, the public entry from zero state, against the
    reference's ``ops.ssd`` (Pallas in interpret mode) on the reference's
    four cases: the port's wrapper, whose CPU path is the plain version."""
    from repro.kernels.ssd_scan import ops as jops
    from repro_torch.kernels.ssd_scan import ops

    b, l, h, p, n, chunk = case
    t, j = _both(_inputs(2, b, l, h, p, n), torch.float32, jnp.float32)
    y, s = ops.ssd(*t, chunk=chunk)
    yr, sr = jops.ssd(*j, chunk=chunk, interpret=True)
    assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)
    assert _err(y, yr) < 1e-4 and _err(s, sr) < 1e-4


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_ref_blocked_matches_jax(case, with_state):
    """The blocked plain scan, from zero and from a given state, and
    against the sequential recurrence."""
    b, l, h, p, n, chunk = case
    arrs = _inputs(2, b, l, h, p, n)
    t, j = _both(arrs, torch.float32, jnp.float32)
    s0 = np.random.default_rng(3).normal(size=(b, h, p, n)).astype(
        np.float32) if with_state else None
    y, s = ssm.ssd_ref(*t, chunk=chunk, init_state=None if s0 is None
                       else torch.from_numpy(s0))
    yr, sr = jssm.ssd_ref(*j, chunk=chunk, init_state=None if s0 is None
                          else jnp.asarray(s0))
    assert y.shape == (b, l, h, p) and y.dtype == torch.float32
    assert _err(y, yr) < 1e-4 and _err(s, sr) < 1e-4
    if s0 is None:
        ys, ss = ssd_ref_sequential(*t)
        assert float((y - ys).abs().max()) < 1e-4
        assert float((s - ss).abs().max()) < 1e-4


def test_ssd_decode_step_matches_jax():
    b, h, p, n = 3, 4, 8, 16
    rng = np.random.default_rng(4)
    st = rng.normal(size=(b, h, p, n)).astype(np.float32)
    x = rng.normal(size=(b, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, n)).astype(np.float32)
    cm = rng.normal(size=(b, n)).astype(np.float32)
    args = (st, x, dt, a, bm, cm)
    y, s = ssm.ssd_decode_step(*map(torch.from_numpy, args))
    yr, sr = jssm.ssd_decode_step(*map(jnp.asarray, args))
    assert _err(y, yr) < 1e-5 and _err(s, sr) < 1e-5


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_jax(with_cache):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    cache = rng.normal(size=(2, 3, 12)).astype(np.float32) \
        if with_cache else None
    y, c = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           None if cache is None else torch.from_numpy(cache))
    yr, cr = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if cache is None else jnp.asarray(cache))
    assert _err(y, yr) < 1e-5 and _err(c, cr) < 1e-5
    assert c.shape == (2, 3, 12)


@pytest.fixture(scope="module")
def block():
    """(port SSMConfig, reference SSMConfig, params as numpy, x (B, L, D))
    for one Mamba2 block at a small width; the reference's leaf
    constants for dt_bias / A_log / D."""
    d, s = 32, dict(d_state=8, head_dim=8, expand=2, conv_width=4, chunk=16)
    cfg, jcfg = SSMConfig(**s), JSSMConfig(**s)
    di, n, h = cfg.d_inner(d), cfg.d_state, cfg.n_heads(d)
    rng = np.random.default_rng(6)

    def dense(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    params = {"in_proj": dense(d, 2 * di + 2 * n + h),
              "conv_w": dense(4, di + 2 * n),
              "dt_bias": np.log(np.expm1(np.linspace(0.001, 0.1, h))
                                ).astype(np.float32),
              "A_log": np.log(np.linspace(1.0, 16.0, h)).astype(np.float32),
              "D": np.ones(h, np.float32),
              "ssm_norm": (0.1 * rng.normal(size=di)).astype(np.float32),
              "out_proj": dense(di, d)}
    x = rng.normal(size=(2, 37, d)).astype(np.float32)
    return cfg, jcfg, params, x


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_matches_jax(block, use_kernel):
    """The block with the plain blocked scan and with the kernel's wrapper
    (on CPU tensors its plain version) against the reference's block;
    both give the same output and cache material."""
    cfg, jcfg, params, x = block
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, (conv, st) = ssm.mamba_block(tp, torch.from_numpy(x), cfg,
                                      use_kernel=use_kernel)
    ref, (jconv, jst) = jssm.mamba_block(jp, jnp.asarray(x), jcfg)
    assert out.shape == x.shape
    assert _err(out, ref) < 1e-5
    assert _err(conv, jconv) < 1e-6 and _err(st, jst) < 1e-5


def test_mamba_block_decode_continues_prefill(block):
    """A prefill of L-1 tokens then one decode step (conv cache + SSM
    state) gives the full block's last output, in both packages."""
    cfg, jcfg, params, x = block
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    full, _ = ssm.mamba_block(tp, torch.from_numpy(x), cfg, use_kernel=True)
    _, (conv, st) = ssm.mamba_block(tp, torch.from_numpy(x[:, :-1]), cfg,
                                    use_kernel=True)
    last, _ = ssm.mamba_block(tp, torch.from_numpy(x[:, -1:]), cfg,
                              conv_cache=conv, ssd_state=st, use_kernel=True)
    _, (jconv, jst) = jssm.mamba_block(jp, jnp.asarray(x[:, :-1]), jcfg)
    jlast, _ = jssm.mamba_block(jp, jnp.asarray(x[:, -1:]), jcfg,
                                conv_cache=jconv, ssd_state=jst)
    assert float((last[:, 0] - full[:, -1]).abs().max()) < 1e-5
    assert _err(last, jlast) < 1e-5


def test_mamba_block_kernel_with_state_raises(block):
    """The kernel path continues a given state with L > 1 (it raised
    before the kernel took an initial state): the port's block with the
    kernel's wrapper (on CPU tensors its plain version) equals the
    reference's plain block from the same N(0, 1) state, output and
    carried state, and differs from a zero start."""
    cfg, jcfg, params, x = block
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    h = cfg.n_heads(x.shape[-1])
    st = np.random.default_rng(7).normal(
        size=(x.shape[0], h, cfg.head_dim, cfg.d_state)).astype(np.float32)
    out, (_, new_st) = ssm.mamba_block(tp, torch.from_numpy(x), cfg,
                                       ssd_state=torch.from_numpy(st),
                                       use_kernel=True)
    ref, (_, jst) = jssm.mamba_block(jp, jnp.asarray(x), jcfg,
                                     ssd_state=jnp.asarray(st),
                                     use_kernel=False)
    assert _err(out, ref) < 1e-5 and _err(new_st, jst) < 1e-5
    zero, _ = ssm.mamba_block(tp, torch.from_numpy(x), cfg, use_kernel=True)
    assert float((out - zero).abs().max()) > 1e-3


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_wrapper_with_state_matches_jax(case):
    """The kernel's wrapper (on CPU tensors the sequential recurrence)
    continuing an N(0, 1) initial state computes what the reference's
    blocked scan computes from it; it launches nothing."""
    b, l, h, p, n, chunk = case
    t, j = _both(_inputs(8, b, l, h, p, n), torch.float32, jnp.float32)
    s0 = np.random.default_rng(9).normal(size=(b, h, p, n)).astype(
        np.float32)
    before = sk.launches
    y, s = sk.ssd_cuda(*t, chunk=chunk, init_state=torch.from_numpy(s0))
    yr, sr = jssm.ssd_ref(*j, chunk=chunk, init_state=jnp.asarray(s0))
    assert sk.launches == before
    assert y.shape == (b, l, h, p) and s.shape == (b, h, p, n)
    assert _err(y, yr) < 1e-4 and _err(s, sr) < 1e-4


def test_kernel_registry_catalog():
    """The port's catalog has the reference's families and variant names
    in the reference's order, the port's callables, the reference's
    KeyErrors, and a register_family that registers the reference's variant
    names and multipliers with the port's callables."""
    for family in ("flash_attention", "ssd_scan"):
        names = registry.variant_names(family)
        assert names == jregistry.variant_names(family)
        assert len(names) >= 3 and names[0] == "base"
        for name in names:
            assert callable(registry.implementation(family, name))
    impl = registry.implementation
    assert impl("flash_attention", "base") is flash_attention_cuda
    assert impl("flash_attention", "chunked") is chunked_attention_cuda
    assert impl("flash_attention", "xla") is flash_attention_xla
    assert impl("ssd_scan", "base") is sk.ssd_cuda
    assert impl("ssd_scan", "blocked") is ssm.ssd_ref
    assert impl("ssd_scan", "sequential") is ssd_ref_sequential
    with pytest.raises(KeyError):
        registry.variant_names("conv")
    with pytest.raises(KeyError):
        registry.implementation("flash_attention", "nope")
    from repro.core.variants import VariantRegistry as JaxRegistry
    from repro_torch.core.variants import VariantRegistry
    mult = {"chunked": (1.3, 0.82), "xla": (1.1, 0.9)}
    ours, ref = VariantRegistry(), JaxRegistry()
    got = registry.register_family(ours, "Attn.apply", "flash_attention",
                                   mult)
    want = jregistry.register_family(ref, "Attn.apply", "flash_attention",
                                     mult)
    assert [(v.task, v.name, v.mult_big, v.mult_little) for v in got] == \
        [(v.task, v.name, v.mult_big, v.mult_little) for v in want]
    assert [v.fn for v in got] == [chunked_attention_cuda, flash_attention_xla]
    assert ours.names == ref.names == ("base", "chunked", "xla")
    with pytest.raises(ValueError, match="base"):
        registry.register_family(ours, "Attn.apply", "flash_attention",
                                 {"base": (1.0, 1.0)})
    with pytest.raises(KeyError):
        registry.register_family(ours, "Attn.apply", "ssd_scan",
                                 {"chunked": (1.0, 1.0)})


def test_kernel_check_args():
    """What the kernel takes, checked on meta tensors (no device needed):
    mamba_block's strided column views pass; a head dim past 64, a state
    dim no multiple of 4, a float16 x or a bf16 dt are refused."""
    b, l, h, p, n = 2, 40, 3, 16, 8
    xbc = torch.empty(b, l, h * p + 2 * n, device="meta")
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.empty(b, l, h, device="meta")
    a = torch.empty(h, device="meta")
    sk.check_args(x, dt, a, bm, cm, 16)
    with pytest.raises(ValueError, match="head dim"):
        sk.check_args(torch.empty(b, l, h, 96, device="meta"), dt, a, bm,
                      cm, 16)
    bad = torch.empty(b, l, 6, device="meta")
    with pytest.raises(ValueError, match="state dim"):
        sk.check_args(x, dt, a, bad, bad, 16)
    with pytest.raises(ValueError, match="dtypes"):
        sk.check_args(x.half(), dt, a, bm.half(), cm.half(), 16)
    with pytest.raises(ValueError, match="float32"):
        sk.check_args(x, dt.bfloat16(), a, bm, cm, 16)
    with pytest.raises(ValueError, match="chunk"):
        sk.check_args(x, dt, a, bm, cm, 0)
    sk.check_args(x, dt, a, bm, cm, 16,
                  torch.empty(b, h, p, n, device="meta"))
    with pytest.raises(ValueError, match="initial state"):
        sk.check_args(x, dt, a, bm, cm, 16,
                      torch.empty(b, h, n, p, device="meta"))
    with pytest.raises(ValueError, match="initial state"):
        sk.check_args(x, dt, a, bm, cm, 16,
                      torch.empty(b, h, p, n, device="meta").bfloat16())



def _split(v, parts=2):
    """v as the tensor cores see it in the bf16 body: the sum of its
    ``parts`` bf16 parts, hi = bf16(v), lo = bf16(v - hi), ...; the kernel
    takes two."""
    out = torch.zeros_like(v)
    for _ in range(parts):
        out = out + (v - out).bfloat16().float()
    return out


def _tc_emulation(x, dt, a, bm, cm, chunk, init_state=None, parts=2):
    """What the bf16 tensor-core body (``ssd_scan.cu``, namespace tc)
    computes, rounding where it rounds, chunk by chunk: seg = cumsum(dt a)
    in fp32; every fp32 operand of a product taken as its two-part bf16
    split hi + lo (``_split``): w * B with w = e^{seg_last - seg} dt in the
    chunk's own state x^T (w * B); the state before the chunk (the scan
    over chunks runs in fp32) and M = (C B^T) e^{seg_i - seg_j} dt_j (j <= i,
    else 0) in y = M x + e^{seg} (C . S_prev^T); fp32 accumulate; y rounded
    to x's dtype, the final state fp32. x, B, C bf16 (B, L, H, P) /
    (B, L, N). ``parts=1`` rounds each operand to bf16 once instead."""
    b, l, h, p = x.shape
    xf, bf, cf = x.float(), bm.float(), cm.float()
    y = torch.empty(b, l, h, p)
    state = (torch.zeros(b, h, p, bm.shape[-1]) if init_state is None
             else init_state.float().clone())
    for c0 in range(0, l, chunk):
        rows = slice(c0, min(c0 + chunk, l))
        xc, bc, cc, dtc = xf[:, rows], bf[:, rows], cf[:, rows], dt[:, rows]
        seg = torch.cumsum(dtc * a, dim=1)                    # (b, q, h)
        w = torch.exp(seg[:, -1:] - seg) * dtc
        own = torch.einsum("bqhp,bqhn->bhpn", xc,
                           _split(w[..., None] * bc[:, :, None, :], parts))
        q = seg.shape[1]
        causal = torch.ones(q, q, dtype=torch.bool).tril()[None, :, :, None]
        diff = seg[:, :, None, :] - seg[:, None, :, :]        # (b, i, j, h)
        g = torch.einsum("bin,bjn->bij", cc, bc)[..., None]
        m = torch.where(causal, g * torch.exp(torch.where(causal, diff, 0.0))
                        * dtc[:, None], 0.0)
        y[:, rows] = torch.einsum("bijh,bjhp->bihp", _split(m, parts), xc) \
            + torch.einsum("bin,bhpn->bihp", cc, _split(state, parts)) \
            * torch.exp(seg)[..., None]
        state = state * torch.exp(seg[:, -1])[..., None, None] + own
    return y.to(x.dtype), state


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_tc_emulation_matches_jax_bf16(case, with_state):
    """The emulated bf16 body on the reference's four cases at the bf16
    tolerance: from zero against the Pallas kernel (interpret mode) and
    the sequential recurrence; from an N(0, 1) initial state, which
    neither takes, against the reference's blocked scan continuing it,
    its y rounded to x's dtype as the Pallas kernel returns it."""
    b, l, h, p, n, chunk = case
    t, j = _both(_inputs(11, b, l, h, p, n), torch.bfloat16, jnp.bfloat16)
    s0 = np.random.default_rng(12).normal(size=(b, h, p, n)).astype(
        np.float32) if with_state else None
    y, s = _tc_emulation(*t, chunk, None if s0 is None
                         else torch.from_numpy(s0))
    assert y.shape == (b, l, h, p) and y.dtype == torch.bfloat16
    refs = ([ssd_tpu(*j, chunk=chunk, interpret=True), jseq(*j)]
            if s0 is None else
            [jssm.ssd_ref(*j, chunk=chunk, init_state=jnp.asarray(s0))])
    if s0 is not None:
        refs = [(refs[0][0].astype(jnp.bfloat16), refs[0][1])]
    for yr, sr in refs:
        assert _err(y, yr) < 5e-2 and _err(s, sr) < 5e-2


def test_tc_emulation_mid_width_relative():
    """The emulated bf16 body at a mid width with zamba2's P, N and chunk,
    against the sequential recurrence on the same bf16 inputs, within the
    full-width limits the card's gate holds the kernel to (relative
    max-norm: y 1e-2, the state 1e-3)."""
    b, l, h, p, n, chunk = MID_CASE
    t, j = _both(_inputs(13, b, l, h, p, n), torch.bfloat16, jnp.bfloat16)
    y, s = _tc_emulation(*t, chunk)
    yr, sr = (np.asarray(r, np.float32) for r in jseq(*j))
    assert _err(y, yr) / np.abs(yr).max() < MID_Y_REL
    assert _err(s, sr) / np.abs(sr).max() < MID_STATE_REL


def test_tc_emulation_one_bf16_part_misses_state_limit():
    """Why the bf16 body splits each fp32 operand of its products into two
    bf16 parts: rounded to bf16 once, the emulated state at the mid width
    is further from the sequential recurrence than the full-width limit
    (1e-3 relative) that two parts meet with room to spare."""
    b, l, h, p, n, chunk = MID_CASE
    t, j = _both(_inputs(13, b, l, h, p, n), torch.bfloat16, jnp.bfloat16)
    sr = np.asarray(jseq(*j)[1], np.float32)
    one = _err(_tc_emulation(*t, chunk, parts=1)[1], sr) / np.abs(sr).max()
    two = _err(_tc_emulation(*t, chunk)[1], sr) / np.abs(sr).max()
    assert one > MID_STATE_REL > 100 * two
