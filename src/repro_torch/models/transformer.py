"""The dense decoder transformer (RoPE, GQA, SwiGLU), counterpart of the
dense family of ``repro.models.transformer``.

Parameters are a dict with the reference's leaf names and its stacked
``[L, ...]`` layer layout (``params["layers"]["wq"]`` is (L, D, Hq*hd)), so
``repro_torch.convert.params_from_jax`` loads the reference's parameters
as they are. The reference's ``lax.scan`` over layers is a Python loop
over dim 0. Its donated, functional cache updates are in-place
``index_copy_`` / ``index_fill_`` on a preallocated cache here: a cache
passed to ``decode_step`` or ``reset_cache_lane`` is updated in place
and returned.
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import embedloss
from repro_torch.models.attention import context_attention, decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, rope_table, swiglu

Params = dict[str, Any]

LAYER_LEAVES = ("ln_attn", "wq", "wk", "wv", "wo",
                "ln_mlp", "w_gate", "w_up", "w_down")


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model(nn.Module):
    """The dense family (``kind="dense"``, ``window=0``). Methods take the
    parameter dict explicitly, as the reference's do, so one model object
    serves several parameter sets (the tests hold the port against the
    reference this way)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.kind != "dense" or cfg.window > 0:
            raise NotImplementedError(
                f"{cfg.name}: kind={cfg.kind!r}, window={cfg.window} is not "
                "ported yet; the port runs the dense family only (ROADMAP "
                "Queue A item 7)")
        self.cfg = cfg

    # ---------------------------------------------------------------- init
    def param_shapes(self) -> dict[str, Any]:
        """Leaf shapes of the parameter dict, in the reference's order."""
        c = self.cfg
        d, hq, hkv, hd, f, L = (c.d_model, c.n_heads, c.n_kv_heads, c.hd,
                                c.d_ff, c.n_layers)
        layers = {
            "ln_attn": (L, d), "wq": (L, d, hq * hd), "wk": (L, d, hkv * hd),
            "wv": (L, d, hkv * hd), "wo": (L, hq * hd, d), "ln_mlp": (L, d),
            "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
        }
        return {"embed": (c.padded_vocab, d), "ln_final": (d,),
                "layers": layers}

    def init(self, seed: int = 0, device=None) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on ``device``
        (default ``cuda``): dense leaves ~ N(0, 1/fan_in) drawn in fp32 and
        cast to ``param_dtype``, norm scales 0. The numbers differ from the
        reference's ``jax.random`` draws; the layout does not."""
        dev = resolve_device(device)
        dtype = _dt(self.cfg.param_dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def leaf(name, shape, fan_in_axis):
            if name.startswith("ln_"):
                return torch.zeros(shape, dtype=dtype, device=dev)
            w = torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32)
            return w.mul_(1.0 / math.sqrt(shape[fan_in_axis])).to(dtype)

        shapes = self.param_shapes()
        params: Params = {"embed": leaf("embed", shapes["embed"], 1),
                          "ln_final": leaf("ln_final", shapes["ln_final"], 0)}
        params["layers"] = {name: leaf(name, shape, 1)
                            for name, shape in shapes["layers"].items()}
        return params

    # ------------------------------------------------------ shared pieces
    def _attn_train(self, p, x, sin, cos):
        c = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, p["ln_attn"], c.norm_eps)
        q = (h @ p["wq"]).reshape(b, s, c.n_heads, c.hd)
        k = (h @ p["wk"]).reshape(b, s, c.n_kv_heads, c.hd)
        v = (h @ p["wv"]).reshape(b, s, c.n_kv_heads, c.hd)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        o = context_attention(q, k, v, causal=True, window=0,
                              impl=c.attn_impl)
        return x + o.reshape(b, s, -1) @ p["wo"], (k, v)

    def _ffn(self, p, x):
        h = rms_norm(x, p["ln_mlp"], self.cfg.norm_eps)
        return x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"])

    @staticmethod
    def _layer(params: Params, i: int) -> dict[str, torch.Tensor]:
        return {name: params["layers"][name][i] for name in LAYER_LEAVES}

    # ------------------------------------------------------------- forward
    def forward(self, params: Params, batch: dict, cache=None):
        """Full-sequence forward -> final hidden states (B, S, D).

        Given a decode ``cache`` (from :meth:`init_cache`, ``seq_len`` >= S),
        each layer writes its K/V into ``cache["k"][i, :, :S]`` and
        ``cache["v"][i, :, :S]`` in place: the counterpart of the
        reference's ``collect=True``, which returns them stacked."""
        c = self.cfg
        tokens = batch["tokens"]
        x = embedloss.embed_in(params["embed"], tokens, _dt(c.compute_dtype))
        s = x.shape[1]
        sin, cos = rope_table(torch.arange(s, device=x.device), c.hd,
                              c.rope_theta)
        for i in range(c.n_layers):
            p = self._layer(params, i)
            x, (k, v) = self._attn_train(p, x, sin, cos)
            if cache is not None:
                cache["k"][i, :, :s].copy_(k)
                cache["v"][i, :, :s].copy_(v)
            x = self._ffn(p, x)
        return rms_norm(x, params["ln_final"], c.norm_eps)

    # ================================================================ decode
    def init_cache(self, batch_size: int, seq_len: int, device=None):
        """Zeroed decode cache for a max context of ``seq_len``: per-slot
        positions ``pos`` (B,) int32 and K/V (L, B, S, Hkv, hd)."""
        c = self.cfg
        dev = resolve_device(device)
        kv = (c.n_layers, batch_size, seq_len, c.n_kv_heads, c.hd)
        cdt = _dt(c.compute_dtype)
        return {"pos": torch.zeros(batch_size, dtype=torch.int32, device=dev),
                "k": torch.zeros(kv, dtype=cdt, device=dev),
                "v": torch.zeros(kv, dtype=cdt, device=dev)}

    def cache_axes(self):
        """Logical axes of the cache leaves (where the batch axis is)."""
        kv = (None, "batch", "kv_seq", None, None)
        return {"pos": ("batch",), "k": kv, "v": kv}

    def reset_cache_lane(self, cache, slot: int):
        """Zero one batch lane of a decode cache in place (``pos[slot] = 0``
        and every leaf's ``slot`` row along its batch axis): what
        :meth:`init_cache` would have produced for that lane."""
        axes = self.cache_axes()
        for key, val in cache.items():
            idx = torch.tensor([slot], device=val.device)
            val.index_fill_(axes[key].index("batch"), idx, 0)
        return cache

    def _attn_decode(self, p, x, cache_kv, pos):
        """x (B, 1, D); cache_kv = one layer's (k, v) cache views
        (B, S, Hkv, hd), written in place at each lane's position."""
        c = self.cfg
        b = x.shape[0]
        k_cache, v_cache = cache_kv
        smax = k_cache.shape[1]
        h = rms_norm(x, p["ln_attn"], c.norm_eps)
        q = (h @ p["wq"]).reshape(b, 1, c.n_heads, c.hd)
        k = (h @ p["wk"]).reshape(b, 1, c.n_kv_heads, c.hd)
        v = (h @ p["wv"]).reshape(b, 1, c.n_kv_heads, c.hd)
        # pos is per-slot (B,): each lane rotates and writes at its own
        # position, so mid-run admissions decode exactly as if solo
        sin, cos = rope_table(pos[:, None], c.hd, c.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
        rows = torch.arange(b, device=x.device) * smax \
            + torch.clamp(pos, max=smax - 1)
        k_cache.view(b * smax, c.n_kv_heads, c.hd).index_copy_(
            0, rows, k[:, 0].to(k_cache.dtype))
        v_cache.view(b * smax, c.n_kv_heads, c.hd).index_copy_(
            0, rows, v[:, 0].to(v_cache.dtype))
        o = decode_attention(q[:, 0], k_cache, v_cache, pos=pos)
        return x + o.reshape(b, 1, -1) @ p["wo"]

    def decode_step(self, params: Params, cache, tokens: torch.Tensor):
        """tokens (B,) int32 -> (next_tokens (B,) int32, cache), the cache
        updated in place."""
        c = self.cfg
        pos = cache["pos"]
        x = embedloss.embed_in(params["embed"], tokens[:, None],
                               _dt(c.compute_dtype))
        for i in range(c.n_layers):
            p = self._layer(params, i)
            x = self._attn_decode(p, x, (cache["k"][i], cache["v"][i]), pos)
            x = self._ffn(p, x)
        x = rms_norm(x, params["ln_final"], c.norm_eps)
        nxt = embedloss.greedy(x[:, 0], params["embed"], valid_vocab=c.vocab)
        pos.add_(1)
        return nxt, cache

    # -------------------------------------------------------------- prefill
    def prefill(self, params: Params, batch: dict, cache_len: int):
        """Full-sequence forward that fills a fresh decode cache in place,
        layer by layer. Returns (cache, last_hidden (B, D))."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len, device=tokens.device)
        x = self.forward(params, batch, cache=cache)
        cache["pos"].fill_(s)
        return cache, x[:, -1]
