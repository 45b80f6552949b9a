"""The port's layers and embedding/sampling against the JAX reference on the
CPU, in fp32 at 1e-5 (``sin``/``cos`` of large angles differ by a few ulps
between the two libraries). Inputs are made with numpy from a seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.models import embedloss as jemb  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro_torch.models import embedloss as temb  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = 1e-5
RNG = np.random.default_rng(0)


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def test_rms_norm_matches_jax():
    x, scale = _normal(2, 5, 64), 0.1 * _normal(64)
    out = tl.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    ref = jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    assert _err(out, ref) < TOL
    # the scale is zero-centred: a zero scale is the plain RMS normalisation
    zero = tl.rms_norm(torch.from_numpy(x), torch.zeros(64))
    rms = np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)
    assert float(np.abs(zero.numpy() - x / rms).max()) < TOL


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (128, 10_000.0),
                                      (64, 1_000_000.0)])
def test_rope_table_matches_jax(hd, theta):
    pos = np.array([0, 1, 7, 100, 2047, 2063], np.int32)
    sin, cos = tl.rope_table(torch.from_numpy(pos), hd, theta)
    jsin, jcos = jl.rope_table(jnp.asarray(pos), hd, theta)
    assert sin.shape == (len(pos), hd // 2)
    assert _err(sin, jsin) < TOL and _err(cos, jcos) < TOL


@pytest.mark.parametrize("per_lane", [False, True])
def test_apply_rope_matches_jax(per_lane):
    b, s, h, d = 2, 6, 3, 16
    x = _normal(b, s, h, d)
    pos = (np.array([[4], [9]], np.int32) if per_lane
           else np.arange(s, dtype=np.int32))
    if per_lane:
        x = x[:, :1]
    sin, cos = tl.rope_table(torch.from_numpy(pos), d, 10_000.0)
    jsin, jcos = jl.rope_table(jnp.asarray(pos), d, 10_000.0)
    out = tl.apply_rope(torch.from_numpy(x), sin, cos)
    ref = jl.apply_rope(jnp.asarray(x), jsin, jcos)
    assert out.shape == x.shape and _err(out, ref) < TOL


def test_swiglu_matches_jax():
    x, wg, wu, wd = (_normal(2, 5, 32), _normal(32, 48) / 6,
                     _normal(32, 48) / 6, _normal(48, 32) / 7)
    out = tl.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    ref = jl.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    assert _err(out, ref) < TOL


def test_embed_and_greedy_match_jax():
    """Embedding lookup, and greedy argmax that never picks a padding
    column even where the padding scores highest."""
    table = _normal(256, 32)
    table[200:] *= 50.0                     # padding rows dominate the logits
    tokens = RNG.integers(0, 200, (2, 7)).astype(np.int32)
    x = tl.embed_tokens(torch.from_numpy(table), torch.from_numpy(tokens),
                        torch.float32)
    xe = temb.embed_in(torch.from_numpy(table), torch.from_numpy(tokens),
                       torch.float32)
    ref = jemb.embed_in(jnp.asarray(table), jnp.asarray(tokens), jnp.float32)
    assert _err(x, ref) == 0.0 and _err(xe, ref) == 0.0
    h = _normal(5, 32)
    out = temb.greedy(torch.from_numpy(h), torch.from_numpy(table),
                      valid_vocab=200)
    jref = jemb.greedy(jnp.asarray(h), jnp.asarray(table), valid_vocab=200)
    assert out.dtype == torch.int32
    assert out.tolist() == np.asarray(jref).tolist()
    assert max(out.tolist()) < 200
