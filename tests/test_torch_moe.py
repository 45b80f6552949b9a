"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the JAX reference's local path (``repro.models.moe``) on the CPU: the same
numpy-made inputs through both, capacity drops included.

Tolerances:
  routing choices, capacities, dispatch slots  exact
  routing weights (fp32 softmax)               1e-6
  moe_local / moe_dense_oracle, fp32           1e-5
  moe_local, bf16                              2e-2 (the reference grid's
                                               bf16 limit)
  moe_local against the oracle, ample capacity 1e-5 (fp32)
"""
import numpy as np
import pytest

from _hyp import given, settings, st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import MoEConfig as JaxMoEConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import MoEConfig  # noqa: E402

# n_experts, top_k, d_ff_expert, capacity_factor: the arctic and kimi smoke
# layers at their configured capacity, and a top-1 layer at half capacity
LAYERS = [(8, 2, 96, 1.25), (16, 4, 64, 1.25), (4, 1, 8, 0.5)]
D, T = 64, 48


def _cfgs(e, k, f, cf):
    return MoEConfig(e, k, f, capacity_factor=cf), \
        JaxMoEConfig(e, k, f, capacity_factor=cf)


def _inputs(seed, t, d, e, f):
    """numpy x (T, D) and the layer's weights at the init's scales."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, e)) / np.sqrt(d),
         "w_gate": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(e, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(e, f, d)) / np.sqrt(f)}
    x = rng.normal(size=(t, d))
    return x.astype(np.float32), {k: v.astype(np.float32)
                                  for k, v in p.items()}


def _both(x, p, tdt=torch.float32, jdt=jnp.float32):
    return (torch.from_numpy(x).to(tdt),
            {k: torch.from_numpy(v).to(tdt) for k, v in p.items()},
            jnp.asarray(x, jdt), {k: jnp.asarray(v, jdt) for k, v in p.items()})


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


@pytest.mark.parametrize("e,k", [(8, 2), (16, 4), (128, 2), (384, 8)])
def test_route_matches_jax(e, k):
    rng = np.random.default_rng(e)
    x = rng.normal(size=(200, D)).astype(np.float32)
    w = (rng.normal(size=(D, e)) / np.sqrt(D)).astype(np.float32)
    weights, experts = moe.route(torch.from_numpy(x), torch.from_numpy(w), k)
    jweights, jexperts = jmoe.route(jnp.asarray(x), jnp.asarray(w), k)
    assert weights.dtype == torch.float32 and weights.shape == (200, k)
    assert np.array_equal(experts.numpy(), np.asarray(jexperts))
    assert _err(weights, jweights) < 1e-6
    np.testing.assert_allclose(weights.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("t,e,k,cf,want", [
    (8192, 128, 2, 1.25, 160),        # arctic prefill, 4 x 2048
    (8192, 384, 8, 1.25, 214),        # kimi prefill
    (4, 128, 2, 1.25, 1),             # decode at 4 slots
    (4, 384, 8, 1.25, 1),
    (34, 8, 2, 1.25, 11),
    (1, 8, 2, 0.01, 1),               # never below 1
])
def test_capacity_matches_jax(t, e, k, cf, want):
    ours, ref = _cfgs(e, k, 8, cf)
    assert moe._capacity(t, ours) == jmoe._capacity(t, ref) == want


@pytest.mark.parametrize("t,e,k", [(8192, 128, 2), (8192, 384, 8), (4, 128, 2),
                                   (37, 8, 2)])
def test_dispatch_indices_match_jax(t, e, k):
    """Slots of the reference's one-hot cumsum, exactly, on routings from
    router products of random hidden states (the full configs' prefill
    and decode shapes, and a smoke shape), drops included."""
    rng = np.random.default_rng(t + e)
    x = rng.normal(size=(t, 32)).astype(np.float32)
    w = rng.normal(size=(32, e)).astype(np.float32)
    _, experts = moe.route(torch.from_numpy(x), torch.from_numpy(w), k)
    cap = moe._capacity(t, MoEConfig(e, k, 8))
    slot = moe._dispatch_indices(experts, e, cap)
    jslot = jmoe._dispatch_indices(jnp.asarray(experts.numpy(), jnp.int32),
                                   e, cap)
    assert np.array_equal(slot.numpy(), np.asarray(jslot))
    if t == 8192:
        assert int((slot == e * cap).sum()) > 0     # some assignments drop


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 10_000), st.integers(2, 8), st.integers(1, 3),
       st.integers(4, 40))
def test_dispatch_indices_properties(seed, e, k, t):
    """tests/test_moe.py's property, and equality with the reference."""
    k = min(k, e)
    rng = np.random.default_rng(seed)
    experts = rng.integers(0, e, (t, k))
    cap = moe._capacity(t, MoEConfig(e, k, 8, capacity_factor=1.25))
    slots = moe._dispatch_indices(torch.from_numpy(experts), e, cap).numpy()
    kept = slots[slots < e * cap]
    assert len(np.unique(kept)) == len(kept)
    for (ti, ki), s in np.ndenumerate(slots):
        if s < e * cap:
            assert s // cap == experts[ti, ki]
    jslots = jmoe._dispatch_indices(jnp.asarray(experts, jnp.int32), e, cap)
    assert np.array_equal(slots, np.asarray(jslots))


@pytest.mark.parametrize("layer", LAYERS, ids=lambda c: f"e{c[0]}k{c[1]}")
def test_moe_local_with_drops_matches_jax(layer):
    """At the configured capacity some assignments drop: the same ones as
    the reference's, and the outputs agree at 1e-5 in fp32."""
    e, k, f, cf = layer
    ours, ref = _cfgs(*layer)
    x, p = _inputs(1, T, D, e, f)
    tx, tp, jx, jp = _both(x, p)
    _, experts = moe.route(tx, tp["router"], k)
    cap = moe._capacity(T, ours)
    slot = moe._dispatch_indices(experts, e, cap)
    _, jexperts = jmoe.route(jx, jp["router"], k)
    jslot = np.asarray(jmoe._dispatch_indices(jexperts, e, cap))
    dropped = slot.numpy() == e * cap
    assert dropped.any()
    assert np.array_equal(dropped, jslot == e * cap)
    out = moe.moe_local(tx, tp, ours)
    assert out.shape == (T, D) and out.dtype == torch.float32
    assert _err(out, jmoe.moe_local(jx, jp, ref)) < 1e-5


def test_moe_local_bf16_matches_jax():
    e, k, f, cf = LAYERS[0]
    ours, ref = _cfgs(e, k, f, cf)
    x, p = _inputs(2, T, D, e, f)
    tx, tp, jx, jp = _both(x, p, torch.bfloat16, jnp.bfloat16)
    out = moe.moe_local(tx, tp, ours)
    assert out.dtype == torch.bfloat16
    assert _err(out, jmoe.moe_local(jx, jp, ref)) < 2e-2


@pytest.mark.parametrize("layer", LAYERS[:2], ids=lambda c: f"e{c[0]}k{c[1]}")
def test_moe_dense_oracle_matches_jax(layer):
    e, k, f, cf = layer
    ours, ref = _cfgs(*layer)
    x, p = _inputs(3, T, D, e, f)
    tx, tp, jx, jp = _both(x, p)
    out = moe.moe_dense_oracle(tx, tp, ours)
    assert out.dtype == torch.float32
    assert _err(out, jmoe.moe_dense_oracle(jx, jp, ref)) < 1e-5


@pytest.mark.parametrize("layer", LAYERS[:2], ids=lambda c: f"e{c[0]}k{c[1]}")
def test_moe_local_matches_oracle_with_ample_capacity(layer):
    """With capacity factor E nothing drops, and the dispatch path equals
    the per-expert oracle; at the configured capacity it does not."""
    e, k, f, _ = layer
    x, p = _inputs(4, T, D, e, f)
    tx, tp, _, _ = _both(x, p)
    ample = MoEConfig(e, k, f, capacity_factor=float(e))
    oracle = moe.moe_dense_oracle(tx, tp, ample)
    assert float((moe.moe_local(tx, tp, ample) - oracle).abs().max()) < 1e-5
    tight = MoEConfig(e, k, f)
    assert float((moe.moe_local(tx, tp, tight) - oracle).abs().max()) > 1e-3


def test_moe_apply_is_local_over_batch_and_sequence():
    e, k, f, cf = LAYERS[1]
    cfg, ref = _cfgs(e, k, f, cf)
    x, p = _inputs(5, 2 * 24, D, e, f)
    tx, tp, jx, jp = _both(x, p)
    out = moe.moe_apply(tx.reshape(2, 24, D), tp, cfg)
    assert out.shape == (2, 24, D)
    assert torch.equal(out.reshape(-1, D), moe.moe_local(tx, tp, cfg))
    assert _err(out, jmoe.moe_apply(jx.reshape(2, 24, D), jp, ref)) < 1e-5
