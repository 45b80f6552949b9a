"""The port's attention paths (plain versions of the CUDA kernel, the
chunked plain-torch flash attention, decode attention) against the JAX
reference on the CPU, the kernel wrappers' CPU paths on rows that see no
key, and a plain-torch emulation of the bf16 tensor-core bodies'
arithmetic against the reference's. Inputs are made
with numpy from a seed and fed to both. The kernel itself runs only on a
GPU: the ``-m chip`` cases at the end hold its bf16 body against the
plain version there (they need no JAX), as ``chip_smoke.py`` does."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

try:
    import jax.numpy as jnp  # noqa: E402

    from repro.kernels.flash_attention.chunked import chunked_attention_tpu  # noqa: E402
    from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa: E402
    from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
    from repro.models import attention as jattn  # noqa: E402
except ImportError:  # a machine with a card and no JAX runs the -m chip cases only
    jnp = None
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import chunked  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_kernel_ref, attention_ref)
from repro_torch.models import attention as tattn  # noqa: E402

# the reference's grid (tests/test_kernels.py)
FLASH_CASES = [
    # b, hq, hkv, sq, skv, d, causal, window, bq, bk
    (2, 4, 2, 128, 128, 64, True, 0, 32, 32),
    (1, 4, 4, 96, 96, 32, True, 0, 32, 32),
    (1, 6, 2, 100, 100, 32, True, 0, 32, 32),      # ragged / padded
    (2, 8, 2, 64, 192, 64, False, 0, 32, 64),      # cross attention
    (1, 4, 1, 256, 256, 32, True, 48, 64, 32),     # sliding window
    (1, 2, 2, 64, 64, 128, True, 0, 64, 64),
]
DTYPES = {"float32": (torch.float32, "float32", 2e-5),
          "bfloat16": (torch.bfloat16, "bfloat16", 2e-2)}


def _qkv(seed, b, hq, hkv, sq, skv, d):
    """numpy q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _both(arrs, tdt, jdt):
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_attention_ref_matches_jax(case, dtype):
    b, hq, hkv, sq, skv, d, causal, window, _, _ = case
    tdt, jdt, tol = DTYPES[dtype]
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, b, hq, hkv, sq, skv, d), tdt, jdt)
    out = attention_ref(q, k, v, causal=causal, window=window)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    assert out.shape == (b, hq, sq, d) and out.dtype == tdt
    assert _err(out, ref) < tol


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_xla_matches_jax(case, dtype):
    """The chunked plain-torch path, with the case's kv block as the chunk
    (so ragged tails are exercised), against the reference's."""
    b, hq, hkv, sq, skv, d, causal, window, _, bk = case
    tdt, jdt, tol = DTYPES[dtype]
    arrs = [a.transpose(0, 2, 1, 3) for a in _qkv(2, b, hq, hkv, sq, skv, d)]
    (q, k, v), (jq, jk, jv) = _both(arrs, tdt, jdt)
    out = tattn.flash_attention_xla(q, k, v, causal=causal, window=window,
                                    kv_chunk=bk)
    ref = jattn.flash_attention_xla(jq, jk, jv, causal=causal,
                                    window=window, kv_chunk=bk)
    assert out.shape == (b, sq, hq, d)
    assert _err(out, ref) < tol


def test_flash_attention_xla_offsets_and_kv_len():
    """q/kv offsets and a valid-length cut, as context parallelism and
    decode caches use them."""
    b, hq, hkv, sq, skv, d = 1, 4, 2, 40, 100, 32
    arrs = [a.transpose(0, 2, 1, 3) for a in _qkv(3, b, hq, hkv, sq, skv, d)]
    (q, k, v), (jq, jk, jv) = _both(arrs, torch.float32, jnp.float32)
    kw = dict(causal=True, window=24, q_offset=50, kv_offset=3, kv_chunk=32,
              kv_len=70)
    out = tattn.flash_attention_xla(q, k, v, **kw)
    ref = jattn.flash_attention_xla(jq, jk, jv, **kw)
    assert _err(out, ref) < 2e-5
    naive = tattn.naive_attention(q, k, v, causal=True, window=24,
                                  q_offset=50, kv_offset=3)
    jnaive = jattn.naive_attention(jq, jk, jv, causal=True, window=24,
                                   q_offset=50, kv_offset=3)
    assert _err(naive, jnaive) < 2e-5


@pytest.mark.parametrize("case", [FLASH_CASES[2], FLASH_CASES[4]])
def test_kernel_wrapper_on_cpu_matches_pallas_interpret(case):
    """On CPU tensors the kernel's wrapper runs its plain version; it
    computes what the Pallas kernel computes (interpret mode), on the
    ragged and the sliding-window case, and launches nothing."""
    b, hq, hkv, sq, skv, d, causal, window, bq, bk = case
    (q, k, v), (jq, jk, jv) = _both(_qkv(4, b, hq, hkv, sq, skv, d),
                                    torch.float32, jnp.float32)
    before = build.launches["flash_attention"]
    out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                              bq=bq, bk=bk, interpret=True)
    assert build.launches["flash_attention"] == before
    assert _err(out, ref) < 2e-5


# non-causal with a window of 8 over 16 keys: query rows 23 to 63 see no
# key (b, hq, hkv, sq, skv, d, causal, window)
NO_KEY_CASE = (1, 2, 1, 64, 16, 32, False, 8)
NO_KEY_ROWS = slice(23, None)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("two_pass", [False, True], ids=["flash", "two_pass"])
def test_kernel_wrapper_rows_without_keys_are_zero(two_pass, dtype):
    """On rows that see no key the wrappers' CPU paths give 0, as the
    Pallas kernels (interpret mode) and the CUDA bodies do, and agree with
    the Pallas kernel of their variant everywhere else; ``attention_ref``
    keeps the reference's mean of V there."""
    b, hq, hkv, sq, skv, d, causal, window = NO_KEY_CASE
    tdt, jdt, _ = DTYPES[dtype]
    (q, k, v), (jq, jk, jv) = _both(_qkv(10, b, hq, hkv, sq, skv, d), tdt,
                                    jdt)
    wrapper = (chunked.chunked_attention_cuda if two_pass
               else fa.flash_attention_cuda)
    pallas = chunked_attention_tpu if two_pass else flash_attention_tpu
    out = wrapper(q, k, v, causal=causal, window=window)
    ref = pallas(jq, jk, jv, causal=causal, window=window, interpret=True)
    assert out.shape == (b, hq, sq, d) and out.dtype == tdt
    assert _err(out, ref) < (2e-5 if dtype == "float32" else 2e-2)
    assert bool((out[:, :, NO_KEY_ROWS] == 0).all())
    assert float(out[:, :, :NO_KEY_ROWS.start].abs().max()) > 0.1
    mean_v = attention_ref(q, k, v, causal=causal, window=window)
    assert _err(mean_v, jax_ref(jq, jk, jv, causal=causal,
                                window=window)) < DTYPES[dtype][2]
    assert float(mean_v[:, :, NO_KEY_ROWS].float().abs().max()) > 0.1


def test_ops_layout_and_attn_impl_dispatch():
    """ops.flash_attention takes (B, S, H, D); every ``attn_impl`` gives
    the same attention; an unknown one raises."""
    b, hq, hkv, s, d = 2, 4, 2, 48, 32
    q, k, v = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
               for a in _qkv(5, b, hq, hkv, s, s, d))
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2)).transpose(1, 2)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.shape == (b, s, hq, d)
    assert float((out - ref).abs().max()) < 2e-5
    for impl in tattn.IMPLS:
        o = tattn.context_attention(q, k, v, causal=True, impl=impl)
        assert float((o - ref).abs().max()) < 2e-5, impl
    # a causal window: the plain path slices the keys, the kernels mask
    wref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), window=7).transpose(1, 2)
    for impl in tattn.IMPLS:
        o = tattn.context_attention(q, k, v, causal=True, window=7,
                                    impl=impl)
        assert float((o - wref).abs().max()) < 2e-5, impl
    with pytest.raises(ValueError):
        tattn.context_attention(q, k, v, impl="pallas")


# the reference grid's sliding-window case, whole (its slice would cover
# every key) and in query chunks of 64, each reading a 112-key slice; and a
# query offset into a longer key sequence (context parallelism's shard)
WINDOW_CASES = [
    # b, hq, hkv, sq, skv, d, window, q_offset, q_chunk
    (1, 4, 1, 256, 256, 32, 48, 0, 0),
    (1, 4, 1, 256, 256, 32, 48, 0, 64),
    (2, 4, 2, 100, 100, 16, 16, 0, 24),
    (1, 4, 2, 64, 200, 32, 40, 136, 32),
]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_attention_xla_matches_jax(case):
    """The per-query-chunk KV slicing of the plain windowed path, with its
    fallthrough to ``flash_attention_xla`` when a slice would cover every
    key, against the reference's ``window_attention_xla``."""
    b, hq, hkv, sq, skv, d, window, q_offset, q_chunk = case
    arrs = [a.transpose(0, 2, 1, 3) for a in _qkv(11, b, hq, hkv, sq, skv, d)]
    (q, k, v), (jq, jk, jv) = _both(arrs, torch.float32, jnp.float32)
    kw = dict(window=window, q_offset=q_offset, q_chunk=q_chunk)
    out = tattn.window_attention_xla(q, k, v, **kw)
    ref = jattn.window_attention_xla(jq, jk, jv, **kw)
    assert out.shape == (b, sq, hq, d)
    assert _err(out, ref) < 2e-5
    if not q_offset:
        full = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                             causal=True, window=window)
        assert float((out - full.transpose(1, 2)).abs().max()) < 2e-5


@pytest.mark.parametrize("impl", ["naive", "xla_flash", "kernel"])
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 48, 0), (False, 0, 0), (True, 48, 16),
    (False, 32, 0)])
def test_attend_matches_jax(impl, causal, window, q_offset):
    """``attend`` on each path against the reference's plain ``attend``
    (its ``pallas`` is the port's ``kernel``, the plain version on the
    CPU); the kernel takes a query offset, as the reference's does not."""
    b, hq, hkv, s, d = 1, 4, 2, 160, 32
    arrs = [a.transpose(0, 2, 1, 3) for a in _qkv(12, b, hq, hkv, s, s, d)]
    (q, k, v), (jq, jk, jv) = _both(arrs, torch.float32, jnp.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ref = jattn.attend(jq, jk, jv, impl="xla_flash", **kw)
    out = tattn.attend(q, k, v, impl=impl, **kw)
    assert _err(out, ref) < 2e-5
    assert _err(out, jattn.attend(jq, jk, jv, impl="naive", **kw)) < 2e-5


@pytest.mark.parametrize("per_lane", [False, True])
def test_decode_attention_matches_jax(per_lane):
    """Single-token attention over a cache, with a scalar position or one
    position per lane, and a window."""
    rng = np.random.default_rng(6)
    b, hq, hkv, s, d = 3, 4, 2, 24, 16
    q = rng.normal(size=(b, hq, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    pos = np.array([3, 17, 23], np.int32) if per_lane else 11
    for window in (0, 5):
        o, m, l = tattn.decode_attention_local(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            pos=torch.from_numpy(pos) if per_lane else pos, window=window)
        jo, jm, jl = jattn.decode_attention_local(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            pos=jnp.asarray(pos), window=window)
        for t, j in ((o, jo), (m, jm), (l, jl)):
            assert _err(t, j) < 2e-5
        od = tattn.decode_attention(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            pos=torch.from_numpy(pos) if per_lane else pos, window=window)
        jod = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), pos=jnp.asarray(pos),
                                     window=window)
        assert od.shape == (b, hq, d) and _err(od, jod) < 2e-5


# the bf16 bodies' tiling: blocks of BQ query rows as warpgroups of WG
# rows; the two-pass body's kv tiles have TC_BK rows
# (attention_common.cuh, namespace attn::tc), the flash body's
# flash_kv_rows(d) (flash_attention.cu kv_rows)
TC_BQ, TC_WG, TC_BK = 128, 64, 64
# a zamba2-like head dim beside the reference grid; its q rows end inside
# the second block's first warpgroup
D112_CASE = (1, 4, 2, 160, 160, 112, True, 0, 32, 32)
# gemma3's head dim (one m64n256k16 for P.v), on the same rows
D256_CASE = (1, 4, 2, 160, 160, 256, True, 0, 32, 32)
# the flash body's 128-row kv tiles at D = 128: three query tiles, the last
# ragged, over three kv tiles, and a window that cuts a tile's far edge
D128_CASES = [(1, 2, 1, 300, 300, 128, True, 0, 32, 32),
              (1, 2, 2, 300, 300, 128, True, 150, 32, 32)]


def flash_kv_rows(d: int) -> int:
    """Kv rows of a ring stage of the flash body at head dim ``d``."""
    return 128 if d <= 128 else 64


def _tc_emulation(q, k, v, *, causal, window, two_pass):
    """What the bf16 tensor-core bodies compute, rounding where they round:
    bf16 q/k/v, fp32 scores; each block's kv tiles between its loop bounds
    (the two-pass body per warpgroup, skipping tiles none of its rows
    sees; the flash body for both warpgroups, its 128-row tiles at
    D <= 128); masked scores -inf; P rounded to bf16 before P.v and summed
    as rounded into l; fp32 o; o / max(l, 1e-30) rounded to bf16. The
    two-pass body takes the scores in the log2 domain (s * scale_log2) and
    a first pass for the max; the flash body keeps the raw scores, tracks
    their online max m with the rescale 2^((m_old - m_new) scale_log2),
    and takes P = 2^(s scale_log2 - m scale_log2) in one fused multiply-add
    (emulated in float64, rounded once). q (B, Hq, Sq, D), k/v
    (B, Hkv, Skv, D) bf16."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    group = hq // k.shape[1]
    bk = TC_BK if two_pass else flash_kv_rows(d)
    qf = q.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    out = torch.zeros(b, hq, sq, d)

    def reach(q0, rows):
        hi = min(skv, q0 + rows) if causal else skv
        return (max(0, q0 - window + 1) if window > 0 else 0), hi

    for q0 in range(0, sq, TC_BQ):
        lo, hi = reach(q0, TC_BQ)
        tiles = range(lo // bk * bk, hi, bk)
        for r0 in range(q0, min(q0 + TC_BQ, sq), TC_WG):
            wlo, whi = reach(r0, TC_WG)
            seen = ([k0 for k0 in tiles if k0 < whi and k0 + bk > wlo]
                    if two_pass else list(tiles))
            rows = torch.arange(r0, min(r0 + TC_WG, sq))

            def scores(k0):
                cols = torch.arange(k0, min(k0 + bk, skv))
                s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, rows],
                                 kf[:, :, cols])
                if two_pass:
                    s = s * scale_log2
                ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
                if causal:
                    ok &= cols[None] <= rows[:, None]
                if window > 0:
                    ok &= cols[None] > rows[:, None] - window
                return s.masked_fill(~ok, -math.inf), cols

            m = torch.full((b, hq, len(rows), 1), -math.inf)
            l = torch.zeros(b, hq, len(rows), 1)
            o = torch.zeros(b, hq, len(rows), d)
            if two_pass:
                for k0 in seen:
                    m = torch.maximum(m, scores(k0)[0].amax(-1, True))
            for k0 in seen:
                s, cols = scores(k0)
                if two_pass:
                    base = torch.where(m == -math.inf, 0.0, m)
                    p = torch.exp2(s - base)
                else:
                    m_new = torch.maximum(m, s.amax(-1, True))
                    base = torch.where(m_new == -math.inf, 0.0, m_new)
                    corr = torch.exp2((m - base) * scale_log2)
                    m, l, o = m_new, l * corr, o * corr
                    p = torch.exp2((s.double() * scale_log2
                                    - (base * scale_log2).double()).float())
                p = p.bfloat16().float()
                l = l + p.sum(-1, keepdim=True)
                o = o + p @ vf[:, :, cols]
            out[:, :, rows] = o / l.clamp_min(1e-30)
    return out.bfloat16()


@pytest.mark.parametrize("two_pass", [False, True], ids=["flash", "two_pass"])
@pytest.mark.parametrize("case", FLASH_CASES + [D112_CASE, D256_CASE]
                         + D128_CASES)
def test_tc_emulation_matches_jax_bf16(case, two_pass):
    """The emulated bf16 kernel (flash and two-pass variants) against the
    reference's XLA flash attention and its Pallas kernel of the same
    variant in interpret mode, on the reference grid, D=112 and D=256
    cases, and D=128 cases over several of the flash body's kv tiles, at
    the bf16 tolerance: the margin the bf16 rounding of P leaves before
    the card's gates."""
    b, hq, hkv, sq, skv, d, causal, window, bq, bk = case
    arrs = _qkv(9, b, hq, hkv, sq, skv, d)
    (q, k, v), (jq, jk, jv) = _both(arrs, torch.bfloat16, jnp.bfloat16)
    out = _tc_emulation(q, k, v, causal=causal, window=window,
                        two_pass=two_pass)
    pallas = chunked_attention_tpu if two_pass else flash_attention_tpu
    ref = pallas(jq, jk, jv, causal=causal, window=window, bq=bq, bk=bk,
                 interpret=True)
    xla = jattn.flash_attention_xla(*(x.transpose(0, 2, 1, 3)
                                      for x in (jq, jk, jv)),
                                    causal=causal, window=window)
    assert out.shape == (b, hq, sq, d)
    assert _err(out, ref) < 2e-2
    assert _err(out, np.asarray(xla, np.float32).transpose(0, 2, 1, 3)) < 2e-2


@pytest.mark.parametrize("window", [0, 20], ids=["causal", "window20"])
@pytest.mark.parametrize("start", [0, 16, 32, 48])
def test_kernel_plain_version_takes_query_offset(start, window):
    """Four query slices of 16 tile a causal 64 x 64 problem: each slice at
    its offset against the whole K/V, through the kernels' plain version
    and its backward, equals the reference's ``naive_attention(q_offset=)``
    and autograd of it (fp32, 2e-5), and both wrappers give the same
    slice of the unsplit call."""
    import jax
    from repro.models.attention import naive_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_kernel_bwd_ref, attention_kernel_ref)
    b, hq, hkv, s, d = 2, 4, 2, 64, 16
    q, k, v = _qkv(21, b, hq, hkv, s, s, d)
    do = np.random.default_rng(22).normal(
        size=(b, hq, 16, d)).astype(np.float32)
    qs = q[:, :, start:start + 16]
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (qs, k, v, do))
    out = attention_kernel_ref(tq, tk, tv, causal=True, window=window,
                               q_offset=start)

    def jfn(q_, k_, v_):
        return naive_attention(q_.transpose(0, 2, 1, 3),
                               k_.transpose(0, 2, 1, 3),
                               v_.transpose(0, 2, 1, 3), causal=True,
                               window=window, q_offset=start
                               ).transpose(0, 2, 1, 3)

    ref, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (qs, k, v)))
    assert _err(out, ref) < 2e-5
    grads = attention_kernel_bwd_ref(tq, tk, tv, out, tdo, causal=True,
                                     window=window, q_offset=start)
    for g, r in zip(grads, vjp(jnp.asarray(do))):
        assert _err(g, r) < 2e-5
    # the autograd Function's backward is the same plain backward
    lq, lk, lv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    o = fa.flash_attention_cuda(lq, lk, lv, causal=True, window=window,
                                q_offset=start)
    for g, r in zip(torch.autograd.grad(o, (lq, lk, lv), tdo), grads):
        assert float((g - r).abs().max()) < 2e-5
    full = torch.from_numpy(q)
    for fn in (fa.flash_attention_cuda, chunked.chunked_attention_cuda):
        whole = fn(full, tk, tv, causal=True, window=window)
        part = fn(tq, tk, tv, causal=True, window=window, q_offset=start)
        assert float((part - whole[:, :, start:start + 16]).abs().max()) \
            < 2e-5


# ------------------------------------------------------------ the card
@pytest.fixture
def card():
    """The CUDA device; skips the test where this host has none (decided
    when the test runs, never when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_qkv(seed, b, hq, hkv, sq, skv, d, device):
    """bf16 q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) on ``device`` as
    transposed views of (B, S, H, D) tensors, the layout the model hands
    the kernel."""
    gen = torch.Generator().manual_seed(seed)

    def make(s, h):
        return torch.randn((b, s, h, d), generator=gen).to(
            torch.bfloat16).to(device).transpose(1, 2)
    return make(sq, hq), make(skv, hkv), make(skv, hkv)


# b, hq, hkv, sq, skv, d, causal, window, q_offset, scale: every head dim
# causal, under a window of 1024 and non-causal; GQA groups 1, 4 and 7;
# whisper's cross attention (224 x 1500) and its ragged 1500; a ragged
# 2047; phi3's prompt in four query slices at their offsets, and gemma3's
# windowed one; Zyphra zamba2's softmax scale (224 / 2)^-1/2
CARD_CASES = (
    [(1, 4, 2, 2048, 2048, d, True, 0, 0, None) for d in fa.HEAD_DIMS]
    + [(1, 4, 2, 2048, 2048, d, True, 1024, 0, None) for d in fa.HEAD_DIMS]
    + [(2, 4, 2, 700, 700, d, False, 0, 0, None) for d in fa.HEAD_DIMS]
    + [(1, 8, 8, 1024, 1024, 128, True, 0, 0, None),
       (1, 40, 10, 2048, 2048, 128, True, 0, 0, None),
       (1, 7, 1, 600, 600, 128, True, 0, 0, None),
       (2, 12, 12, 224, 1500, 64, False, 0, 0, None),
       (2, 12, 12, 1500, 1500, 64, False, 0, 0, None),
       (1, 8, 2, 2047, 2047, 128, True, 0, 0, None)]
    + [(1, 8, 2, 512, 2048, 128, True, 0, off, None)
       for off in (0, 512, 1024, 1536)]
    + [(1, 4, 2, 512, 2048, 256, True, 1024, off, None)
       for off in (0, 512, 1024, 1536)]
    + [(1, 8, 8, 1000, 1000, 224, True, 0, 0, (224 / 2) ** -0.5)])


@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES, ids=[
    "-".join(str(x) for x in c[:8]) + f"-off{c[8]}" + ("-scale" if c[9] else "")
    for c in CARD_CASES])
def test_flash_kernel_matches_plain_version_on_card(card, case):
    """The bf16 body against the plain version at the bf16 tolerance, in
    one launch of the kernel a call."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset, scale = case
    q, k, v = _card_qkv(sum(case[:8]), b, hq, hkv, sq, skv, d, card)
    before = build.launches["flash_attention"]
    out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, scale=scale)
    torch.cuda.synchronize()
    assert build.launches["flash_attention"] == before + 1
    ref = attention_kernel_ref(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    assert out.shape == (b, hq, sq, d) and out.dtype == torch.bfloat16
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref.float()).abs().max()) < 2e-2


@pytest.mark.chip
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_kernel_rows_without_keys_are_zero_on_card(card, d):
    """Non-causal under a window of 8 over 16 keys: the query rows from 23
    on see no key and the bf16 body gives them exactly 0; the rest match
    the plain version."""
    b, hq, hkv, sq, skv, _, causal, window = NO_KEY_CASE
    q, k, v = _card_qkv(d, b, hq, hkv, sq, skv, d, card)
    out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref = attention_kernel_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert bool((out[:, :, NO_KEY_ROWS] == 0).all())
    assert float(out[:, :, :NO_KEY_ROWS.start].abs().max()) > 0.1
    assert float((out.float() - ref.float()).abs().max()) < 2e-2
