"""The port's two-pass (chunked) attention kernel's wrapper against the JAX
reference's Pallas kernel on the CPU, the ``attn_impl="chunked"`` dispatch,
and the argument checks both attention kernels share (zamba2's head dim
112 included). Inputs are made with numpy from a seed and fed to both. The
CUDA kernels themselves run only on a GPU (``chip_smoke.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.chunked import chunked_attention_tpu  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import chunked  # noqa: E402
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


def _qkv(seed, b, hq, hkv, sq, skv, d):
    """numpy q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("case", [FLASH_CASES[3], FLASH_CASES[4]])
def test_chunked_wrapper_on_cpu_matches_pallas_interpret(case):
    """On CPU tensors the chunked kernel's wrapper runs its plain version;
    it computes what the reference's Pallas two-pass kernel computes
    (interpret mode), on the cross-attention and the sliding-window case,
    and launches nothing."""
    b, hq, hkv, sq, skv, d, causal, window, bq, bk = case
    arrs = _qkv(7, b, hq, hkv, sq, skv, d)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    before = build.launches["chunked_attention"]
    out = chunked.chunked_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    ref = chunked_attention_tpu(*(jnp.asarray(a) for a in arrs),
                                causal=causal, window=window, bq=bq, bk=bk,
                                interpret=True)
    assert build.launches["chunked_attention"] == before
    assert out.shape == (b, hq, sq, d)
    assert _err(out, ref) < 2e-5


def test_chunked_dispatch_and_layout():
    """``attn_impl="chunked"`` takes (B, S, H, D) like the flash path and
    gives the same attention; the ops wrapper matches the plain version."""
    b, hq, hkv, s, d = 2, 4, 2, 40, 32
    q, k, v = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
               for a in _qkv(8, b, hq, hkv, s, s, d))
    ref = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), window=9).transpose(1, 2)
    out = ops.chunked_attention(q, k, v, causal=True, window=9)
    assert out.shape == (b, s, hq, d)
    assert float((out - ref).abs().max()) < 2e-5
    via = tattn.context_attention(q, k, v, causal=True, window=9,
                                  impl="chunked")
    assert float((via - ref).abs().max()) < 2e-5
    assert "chunked" in tattn.IMPLS


def _meta(b, h, s, d, dtype=torch.float32):
    """A (B, H, S, D) view of a (B, S, H, D) meta tensor, as the model
    hands the kernels."""
    return torch.empty(b, s, h, d, dtype=dtype, device="meta").transpose(1, 2)


@pytest.mark.parametrize("d", [32, 64, 112, 128, 256])
def test_check_args_accepts_the_instantiated_head_dims(d):
    """Both kernels take head dims 32, 64, 112 (zamba2's shared attention),
    128 and 256 (gemma3), in fp32 and bf16, through strided views."""
    for dtype in fa.DTYPES:
        q, k = _meta(4, 32, 64, d, dtype), _meta(4, 8, 64, d, dtype)
        fa.check_args(q, k, k, 0)


def test_check_args_rejects_what_no_kernel_takes():
    q, k = _meta(1, 4, 16, 96), _meta(1, 2, 16, 96)
    with pytest.raises(ValueError, match="head dim 96"):
        fa.check_args(q, k, k, 0)
    q, k = _meta(1, 4, 16, 112), _meta(1, 3, 16, 112)
    with pytest.raises(ValueError, match="multiple"):
        fa.check_args(q, k, k, 0)
    q16 = _meta(1, 4, 16, 64, torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        fa.check_args(q16, q16, q16, 0)
    q = torch.empty(1, 4, 16, 64, device="meta")
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_args(q.transpose(2, 3).contiguous().transpose(2, 3),
                      q, q, 0)
    with pytest.raises(ValueError, match="window"):
        fa.check_args(q, q, q, -1)


def test_check_args_rejects_the_smoke_head_dim():
    """gemma3's smoke configs (head dim 16) run on the CPU only, through
    the plain version: on CUDA no kernel takes 16, so it raises and never
    falls back."""
    assert 256 in fa.HEAD_DIMS and 16 not in fa.HEAD_DIMS
    for dtype in fa.DTYPES:
        q, k = _meta(4, 4, 64, 16, dtype), _meta(4, 2, 64, 16, dtype)
        with pytest.raises(ValueError, match="head dim 16"):
            fa.check_args(q, k, k, 1024)
