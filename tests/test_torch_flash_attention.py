"""The port's attention paths (plain versions of the CUDA kernel, the
chunked plain-torch flash attention, decode attention) against the JAX
reference on the CPU. Inputs are made with numpy from a seed and fed to
both. The kernel itself runs only on a GPU (``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_tpu  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
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
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


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
    before = fa.launches
    out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    ref = flash_attention_tpu(jq, jk, jv, causal=causal, window=window,
                              bq=bq, bk=bk, interpret=True)
    assert fa.launches == before
    assert _err(out, ref) < 2e-5


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
    with pytest.raises(ValueError):
        tattn.context_attention(q, k, v, impl="pallas")


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
