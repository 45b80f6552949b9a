"""The port's sliding-window dense family (gemma3: superblocks of
``global_every - 1`` windowed layers and one global layer, then a tail of
windowed layers, each windowed layer decoding over a rolling cache) against
the JAX reference on the CPU: the reference's parameters loaded with
``params_from_jax``, the same numpy-made tokens through both, fp32 smoke
configs. The prompt (37) is longer than the window (16) and no multiple of
it, so the rolled cache leaves are compared leaf by leaf and decoding
crosses the roll. Hidden states and cache leaves at 1e-5, greedy tokens
identical."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.config import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import embedloss  # noqa: E402
from repro_torch.models.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model, _place  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

# gemma3-1b-smoke: 8 layers = 2 superblocks of 3 and a tail of 2;
# gemma3-12b-smoke: 7 layers = 2 superblocks of 3 and a tail of 1
ARCHS = ["gemma3-1b", "gemma3-12b"]
B, S, CACHE = 2, 37, 48
TOL = 1e-5
LEAVES = {"pos", "k_local", "v_local", "k_global", "v_global", "k_tail",
          "v_tail"}


@pytest.fixture(scope="module", params=ARCHS)
def wpair(request):
    """(jax model, jax params, port model, port params, tokens (B, S))."""
    arch = request.param
    jm = JaxModel(jax_smoke(arch))
    jp = jm.init(0)
    cfg = get_smoke_config(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return jm, jp, Model(cfg), tp, tokens


def _err(t, j) -> float:
    return float(np.abs(t.float().numpy() - np.asarray(j, np.float32)).max())


def test_structure_of_the_smoke_configs(wpair):
    jm, _, tm, _, _ = wpair
    cfg = tm.cfg
    assert cfg.window == 16 and cfg.global_every == 3 and S > cfg.window
    assert S % cfg.window != 0
    assert (tm.n_super, tm.n_tail) == (jm.n_super, jm.n_tail)
    assert (tm.n_super, tm.n_tail) == {8: (2, 2), 7: (2, 1)}[cfg.n_layers]
    windows = [(w, rolling) for kind, _, _, w, rolling
               in tm._layers(tm.init(0, device="cpu"))]
    assert windows == [(cfg.layer_window(i), cfg.layer_window(i) > 0)
                       for i in range(cfg.n_layers)]


@pytest.mark.parametrize("impl", ["kernel", "chunked", "xla_flash", "naive"])
def test_windowed_forward_matches_jax(wpair, impl):
    """Every prefill attention path (the kernels' plain versions on the
    CPU, the sliced plain path, the oracle) gives the reference's hidden
    states."""
    jm, jp, tm, tp, tokens = wpair
    ref = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    model = Model(dataclasses.replace(tm.cfg, attn_impl=impl))
    out = model.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert out.shape == (B, S, tm.cfg.d_model)
    assert _err(out, ref) < TOL


def test_windowed_prefill_matches_jax(wpair):
    """Every cache leaf, the rolling ones in their rolled order (slot
    p % 16 holds position p, 21..36), equals the reference prefill's."""
    jm, jp, tm, tp, tokens = wpair
    jcache, jlast = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CACHE)
    cache, last = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, CACHE)
    want = LEAVES if tm.n_tail else LEAVES - {"k_tail", "v_tail"}
    assert set(cache) == set(jcache) == want
    assert cache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()
    for key in want - {"pos"}:
        assert cache[key].shape == jcache[key].shape, key
        assert _err(cache[key], jcache[key]) < TOL, key
    w = tm.cfg.window
    assert cache["k_local"].shape[-3] == w
    assert cache["k_global"].shape[-3] == CACHE
    assert _err(last, jlast) < TOL
    assert tm.cache_axes() == jm.cache_axes()


@pytest.mark.parametrize("s", [5, 16, 21, 32, 37])
def test_place_keeps_the_last_window_at_slot_pos_mod_w(s):
    """``_place`` writes what the reference's ``place_rolling`` builds with
    a roll: the last w positions, position p at slot p % w (whole rows
    when s <= w), and rows from 0 into a full cache."""
    w, smax = 16, 48
    src = torch.arange(2 * s * 3, dtype=torch.float32).reshape(2, s, 3, 1)
    dst = torch.zeros(2, w, 3, 1)
    _place(dst, src, rolling=True)
    if s <= w:
        want = torch.zeros(2, w, 3, 1)
        want[:, :s] = src
    else:
        want = torch.roll(src[:, s - w:], s % w, dims=1)
    assert torch.equal(dst, want)
    pos = dst[0, :, 0, 0] / 3                 # the position held by a slot
    held = [p for p in range(max(0, s - w), s)]
    assert sorted(pos[:min(s, w)].long().tolist()) == held
    assert all(int(pos[p % w]) == p for p in held)
    full = torch.zeros(2, smax, 3, 1)
    _place(full, src, rolling=False)
    assert torch.equal(full[:, :s], src) and not full[:, s:].any()


def test_windowed_decode_matches_forward_and_jax(wpair):
    """Streaming the prompt through decode_step (the rolling slots wrap at
    positions 16 and 32) reproduces the full forward's greedy token at
    every position and the reference's decode tokens and cache."""
    jm, jp, tm, tp, tokens = wpair
    cfg = tm.cfg
    x = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    fwd = torch.stack([embedloss.greedy(x[:, t], tp["embed"], cfg.vocab)
                       for t in range(S)], dim=1).numpy()
    cache = tm.init_cache(B, CACHE, device="cpu")
    jcache = jm.init_cache(B, CACHE)
    step = jax.jit(jm.decode_step)
    dec, jdec = [], []
    for t in range(S):
        nxt, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]))
        jnxt, jcache = step(jp, jcache, jnp.asarray(tokens[:, t]))
        dec.append(nxt.numpy())
        jdec.append(np.asarray(jnxt))
    dec, jdec = np.stack(dec, 1), np.stack(jdec, 1)
    assert (dec == fwd).all() and (dec == jdec).all()
    assert cache["pos"].tolist() == [S] * B
    for key in cache:
        assert _err(cache[key], jcache[key]) < TOL, key


def test_windowed_prefill_then_decode_equals_prefill_as_decode(wpair):
    """A prefill longer than the window, continued by decode steps across
    the next roll, gives the tokens and every cache leaf of the same
    tokens streamed through decode_step from an empty cache."""
    _, _, tm, tp, tokens = wpair
    s0 = 21
    cache, last = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :s0])},
                             CACHE)
    after = [embedloss.greedy(last, tp["embed"], tm.cfg.vocab)]
    for t in range(s0, S):
        nxt, cache = tm.decode_step(tp, cache, torch.from_numpy(tokens[:, t]))
        after.append(nxt)
    stream = tm.init_cache(B, CACHE, device="cpu")
    streamed = []
    for t in range(S):
        nxt, stream = tm.decode_step(tp, stream,
                                     torch.from_numpy(tokens[:, t]))
        if t >= s0 - 1:
            streamed.append(nxt)
    assert torch.equal(torch.stack(after), torch.stack(streamed))
    for key in cache:
        assert float((cache[key].float() - stream[key].float()).abs()
                     .max()) < TOL, key


def test_windowed_reset_cache_lane_matches_jax(wpair):
    """Slot reset wipes the lane of every leaf, the rolling ones along
    their batch axis 2."""
    jm, jp, tm, tp, tokens = wpair
    jcache, _ = jm.prefill(jp, {"tokens": jnp.asarray(tokens)}, CACHE)
    cache, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)}, CACHE)
    assert tm.reset_cache_lane(cache, 1) is cache
    jcache = jm.reset_cache_lane(jcache, jnp.int32(1))
    axes = tm.cache_axes()
    assert axes["k_local"].index("batch") == 2
    for key, val in cache.items():
        assert _err(val, jcache[key]) < TOL, key
        lane = val.select(axes[key].index("batch"), 1)
        assert float(lane.abs().max()) == 0.0, key
    assert float(cache["k_local"][:, :, 0].abs().max()) > 0.0
    assert cache["pos"].tolist() == [S, 0]


def test_windowed_param_count_and_layout_match_init(wpair):
    jm, _, tm, _, _ = wpair
    cfg = tm.cfg
    params = tm.init(0, device="cpu")
    shapes = jax.tree.map(lambda s: tuple(s.shape), jm.abstract_params())
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    assert params["local"]["wq"].shape[:2] == (tm.n_super,
                                               cfg.global_every - 1)
    actual = sum(t.numel() for t in jax.tree.leaves(params))
    assert actual == cfg.param_count()[0] + (cfg.padded_vocab - cfg.vocab) \
        * cfg.d_model
    other = tm.init(1, device="cpu")
    assert not torch.equal(params["global"]["wq"], other["global"]["wq"])
    w = params["local"]["wq"].flatten(0, 1)
    assert not torch.equal(w[0], w[1])


def test_full_width_configs_construct():
    """gemma3-1b and gemma3-12b at full width: structure and parameter
    layout, nothing allocated."""
    for arch, (ns, nt, count) in {"gemma3-1b": (4, 2, None),
                                  "gemma3-12b": (8, 0, 11_765_395_200)
                                  }.items():
        cfg = get_config(arch)
        model = Model(cfg)
        assert (model.n_super, model.n_tail) == (ns, nt)
        assert cfg.hd == 256 and cfg.window == 1024
        shapes = model.param_shapes()
        assert ("tail" in shapes) == bool(nt)
        assert shapes["local"]["wq"] == (ns, 5, cfg.d_model, cfg.n_heads * 256)
        total = sum(int(np.prod(s)) for g in shapes.values()
                    for s in (g.values() if isinstance(g, dict) else [g]))
        assert total == cfg.param_count()[0] + (cfg.padded_vocab
                                                - cfg.vocab) * cfg.d_model
        if count is not None:
            assert cfg.param_count()[0] == count


def test_params_from_jax_walks_the_windowed_groups(wpair):
    jm, jp, tm, _, _ = wpair
    tree = jax.tree.map(np.asarray, jp)
    groups = {"embed", "ln_final", "local", "global"} | (
        {"tail"} if tm.n_tail else set())
    assert set(tree) == groups
    for group in groups - {"embed", "ln_final"}:
        bad = jax.tree.map(np.asarray, jp)
        del bad[group]["wk"]
        with pytest.raises(ValueError, match=group):
            params_from_jax(bad, tm.cfg, device="cpu")
    bad = jax.tree.map(np.asarray, jp)
    bad["local"]["wq"] = bad["local"]["wq"][:, :1]
    with pytest.raises(ValueError, match="local/wq"):
        params_from_jax(bad, tm.cfg, device="cpu")


def _serve(engine_cls, req_cls, model, params, specs, slots):
    engine = engine_cls(model, params, batch_slots=slots, max_len=64)
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(specs)]
    for r in reqs:
        engine.submit(r)
    engine.run_until_idle()
    return reqs


def test_windowed_engine_matches_reference_engine(wpair):
    """Five requests through two slots, three admitted mid-run into freed
    slots, prompts and outputs long enough to wrap the 16-slot rolling
    caches: the unchanged ``ServeEngine`` gives the reference engine's
    tokens, and a late request its solo tokens."""
    jm, jp, tm, tp, _ = wpair
    rng = np.random.default_rng(3)
    specs = [(rng.integers(0, 256, n).tolist(), m)
             for n, m in ((14, 9), (20, 3), (6, 15), (18, 6), (11, 8))]
    ours = _serve(ServeEngine, Request, tm, tp, specs, 2)
    ref = _serve(JaxEngine, JaxRequest, jm, jp, specs, 2)
    assert [r.out for r in ours] == [r.out for r in ref]
    assert all(r.done and len(r.out) == n for r, (_, n) in zip(ours, specs))
    assert max(len(p) + n for p, n in specs) > tm.cfg.window
    solo = _serve(ServeEngine, Request, tm, tp, specs[3:4], 1)[0]
    assert solo.out == ours[3].out


def test_bf16_windowed_runs_in_bf16():
    """The smoke config in bf16, the gemma3 phase of ``chip_smoke.py`` at
    a small size: prefill past the window, decode across the roll."""
    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, device="cpu")
    assert params["local"]["wq"].dtype == torch.bfloat16
    tokens = torch.arange(2 * 20).reshape(2, 20) % cfg.vocab
    cache, last = model.prefill(params, {"tokens": tokens}, 24)
    assert last.dtype == torch.bfloat16
    assert cache["k_local"].dtype == torch.bfloat16
    assert cache["k_local"].shape[-3] == 16
    for _ in range(3):
        nxt, cache = model.decode_step(params, cache, tokens[:, 0])
    assert nxt.dtype == torch.int32 and cache["pos"].tolist() == [23, 23]
