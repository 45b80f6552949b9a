"""The model families of the port, counterpart of
``repro.models.transformer``:

  dense  : pre-norm decoder transformer (RoPE, GQA, SwiGLU); with
           ``window > 0`` (gemma3) superblocks of ``global_every - 1``
           sliding-window layers and one global layer, then a tail of
           ``n_layers % global_every`` windowed layers, each windowed
           layer decoding over a rolling cache of ``window`` slots;
  moe    : the dense skeleton with a Mixture-of-Experts FFN in every layer
           (``models/moe.py``), plus arctic's dense SwiGLU residual;
  vlm    : the dense skeleton whose first ``n_patches`` positions are the
           batch's precomputed ``patches`` embeddings (internvl2's vision
           frontend is a stub in the reference too);
  ssm    : Mamba2 (SSD) stack;
  hybrid : the JAX package's zamba2 variant (``zamba2-7b``, not Zyphra's
           block) — Mamba2 superblocks of ``shared_attn_every`` layers,
           each followed by one *shared* attention + SwiGLU block (one set
           of weights for every application, with its residual), then a
           tail of ``n_layers % shared_attn_every`` Mamba2 layers; or,
           with ``hybrid_layer_ids`` (``zamba2-7b-instruct``), Zyphra's
           published layout: every layer Mamba2, and before each listed
           layer one of ``n_mem_blocks`` shared blocks (attention over
           concat(x, token embedding), a GeGLU MLP with the application's
           own low-rank adapter, no residual) whose output, through the
           application's own linear, is added to that Mamba2 layer's input;
           or, with ``layer_types`` (``granite-4.0-h-small``), a layer
           pattern given as data: layer i is a Mamba2 layer or a GQA
           attention block (without RoPE where ``rope`` is off, at the
           config's softmax scale), as ``layer_types[i]`` says, then its
           own FFN (``ln_mlp``, the MoE with its dense residual as the
           shared expert); each branch is multiplied by
           ``residual_multiplier`` before its residual add, the embedding
           by ``embedding_multiplier``;
  encdec / audio : whisper — a non-causal encoder over the batch's
           ``frames`` (B, enc_len, D) (the audio frontend is a stub in the
           reference too) plus sinusoidal positions, and a decoder whose
           layers are causal self-attention (RoPE), cross-attention to the
           encoder's output (no RoPE) and the MLP.

Parameters are a dict with the reference's leaf names and its stacked
layouts (``params["layers"]["wq"]`` is (L, D, Hq*hd); windowed dense has
``local`` (n_super, global_every - 1, ...), ``global`` (n_super, ...) and
``tail`` (n_tail, ...); moe's expert leaves are (L, E, ...); hybrid has
``mamba`` (n_super, per, ...), ``tail`` (n_tail, ...) and an unstacked
``shared_attn``, or in Zyphra's layout ``layers`` (L, ...), ``blocks``
(n_mem_blocks, ...) and ``hybrid`` (one adapter and linear an
application; a layer pattern ``ssm`` (Mamba2 layers, ...), ``attn``
(attention layers, ...) and ``ffn`` (L, ...)); encdec has ``enc``
(n_enc_layers, ...), ``dec`` (L, ...)
whose cross-attention leaves carry a ``c`` prefix, and ``ln_enc_final``),
so
``repro_torch.convert.params_from_jax`` loads the reference's parameters
as they are. The reference's ``lax.scan`` over
layers is a Python loop over the stack dims. Its donated, functional
cache updates are in-place ``copy_`` / ``index_copy_`` / ``index_fill_``
on a preallocated cache here: a cache passed to ``forward``,
``decode_step`` or ``reset_cache_lane`` is updated in place and returned.

A forward that autograd will differentiate (grad mode on and a parameter
leaf that requires a gradient, as ``train/step.py``'s are) takes the
training path: each stacked leaf is ``unbind``-ed once (indexing it per
layer would make its backward write a zeroed full-size stack per layer),
and with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint.checkpoint``, the counterpart of the
reference's ``jax.checkpoint`` around each scanned layer body. Serving
takes neither: its op sequence is the one its captured CUDA graph
replays.

A sequence forward (S > 1) of CUDA bf16 tensors that autograd does not
record runs each attention block's pointwise ops through the hand-written
kernels of ``kernels/pointwise``: the norms, RoPE on q and k in place, the
attention's residual add fused with the next norm, SwiGLU's gate. Zyphra's
shared block takes only the two that compute its ops, the norms and RoPE:
it has no residual add and a GELU MLP. Training, the CPU, fp32, DTensors
and the decode step run the plain ops.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.pointwise import kernel as pw
from repro_torch.models import embedloss
from repro_torch.models.attention import context_attention, decode_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, rope_table
from repro_torch.models.moe import moe_apply
from repro_torch.models.ssm import mamba_block
from repro_torch.obs.ranges import profiler_range
from repro_torch.sharding import rules, shard

Params = dict[str, Any]

KINDS = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec", "audio")
# the mixers of a hybrid's layer pattern (``ModelConfig.layer_types``)
LAYER_TYPES = ("mamba", "attention")
# the families of one stack of attention + FFN layers (``layers``)
DENSE_KINDS = ("dense", "moe", "vlm")
# the encoder-decoder families (whisper): ``enc`` and ``dec`` stacks
ENCDEC_KINDS = ("encdec", "audio")
# leaves with an expert dim after the stack dims: their fan-in is the next
# dim (d or f), and they are drawn one (layer, expert) slice at a time
EXPERT_LEAVES = ("moe_gate", "moe_up", "moe_down")
SSD_IMPLS = ("kernel", "blocked")
# stack dims of each layer group: dense/ssm "layers" (L,), windowed dense
# "local" (n_super, global_every - 1) and "global" (n_super,), hybrid
# "mamba" (n_super, per), "tail" (n_tail,), "shared_attn" unstacked, Zyphra's
# hybrid "blocks" (n_mem_blocks,) and "hybrid" (applications,), a layer
# pattern's "ssm" (Mamba2 layers,), "attn" (attention layers,) and "ffn"
# (L,), encdec "enc" (n_enc_layers,) and "dec" (L,)
STACK_DIMS = {"layers": 1, "local": 2, "global": 1, "mamba": 2, "tail": 1,
              "shared_attn": 0, "blocks": 1, "hybrid": 1, "ssm": 1,
              "attn": 1, "ffn": 1, "enc": 1, "dec": 1}
# the prefix of a decoder layer's cross-attention leaves (``cwq``, ...)
CROSS = "c"
# logical axes of each leaf without its stack dims (the reference's
# ``_Maker`` declarations); a cross-attention leaf takes its name's
LEAF_AXES = {
    "embed": ("vocab", "embed"), "ln_final": ("embed",),
    "ln_enc_final": ("embed",),
    "ln_attn": ("embed",), "wq": ("embed", "q_heads"),
    "wk": ("embed", "kv_heads"), "wv": ("embed", "kv_heads"),
    "wo": ("q_heads", "embed"),
    "ln_mlp": ("embed",), "w_gate": ("embed", "ff"), "w_up": ("embed", "ff"),
    "w_down": ("ff", "embed"),
    "router": ("embed", None),
    "moe_gate": ("experts", "embed", "expert_ff"),
    "moe_up": ("experts", "embed", "expert_ff"),
    "moe_down": ("experts", "expert_ff", "embed"),
    "ln_ssm": ("embed",), "in_proj": ("embed", "ff"), "conv_w": (None, None),
    "conv_b": (None,),
    "dt_bias": (None,), "A_log": (None,), "D": (None,), "ssm_norm": ("ff",),
    "out_proj": ("ff", "embed"),
    "adapter": ("embed", None), "adapter_gate": (None, "ff"),
    "adapter_up": (None, "ff"), "w_link": ("embed", None),
}
# logical axes of each decode-cache leaf without its stack dims, by its
# name up to the first "_" (``k_local``, ``state_tail``, ``k_cross`` ...)
_KV_AXES = ("batch", "kv_seq", None, None)
CACHE_LEAF_AXES = {"pos": ("batch",), "k": _KV_AXES, "v": _KV_AXES,
                   "conv": ("batch", None, "ff"),
                   "state": ("batch", "q_heads", None, None)}


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


class Model(nn.Module):
    """The dense (with or without a sliding window), moe, vlm, ssm, hybrid
    and encoder-decoder families. Methods take the parameter dict
    explicitly, as the reference's do, so one model object serves several
    parameter sets (the tests hold the port against the reference this
    way)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.kind not in KINDS or (
                cfg.window > 0 and cfg.kind != "dense") or (
                cfg.kind == "hybrid" and cfg.shared_attn_every <= 0
                and not cfg.hybrid_layer_ids and not cfg.layer_types):
            raise NotImplementedError(
                f"{cfg.name}: kind={cfg.kind!r}, window={cfg.window} is not "
                f"ported yet; the port runs {KINDS}, a window on dense only "
                "(ROADMAP Queue A: windowed moe/vlm/encdec, which no "
                "reference config has)")
        if cfg.layer_types and (len(cfg.layer_types) != cfg.n_layers or
                                set(cfg.layer_types) - set(LAYER_TYPES)
                                or cfg.moe is None):
            raise ValueError(f"{cfg.name}: layer_types must give one of "
                             f"{LAYER_TYPES} for each of its {cfg.n_layers} "
                             "layers, each followed by the MoE of moe")
        if cfg.ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown ssd_impl {cfg.ssd_impl!r}; expected "
                             f"one of {SSD_IMPLS}")
        self.cfg = cfg
        # the encoder's positions by (frames, device, dtype), built once:
        # the host computes the table in float64 numpy (whisper's is 1500 x
        # 768), and the reference's jit folds it to a constant
        self._enc_pos: dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------ structure
    @property
    def _period(self) -> int:
        """Layers per superblock: windowed dense ``global_every``, hybrid
        ``shared_attn_every``, 0 for the families without superblocks."""
        c = self.cfg
        if c.window > 0:
            return c.global_every
        return c.shared_attn_every if c.kind == "hybrid" else 0

    @property
    def n_super(self) -> int:
        """Superblocks: windowed dense (local layers + one global layer) or
        hybrid (Mamba2 layers + one shared attention)."""
        return self.cfg.n_layers // self._period if self._period else 0

    @property
    def n_tail(self) -> int:
        """Layers after the last superblock (windowed or Mamba2)."""
        return self.cfg.n_layers % self._period if self._period else 0

    # ---------------------------------------------------------------- init
    def _attn_shapes(self, stack: tuple, pre: str = "") -> dict[str, tuple]:
        """An attention block's leaves; ``pre`` ``CROSS`` names a decoder
        layer's cross-attention (the reference's ``_attn_leaves(cross=)``)."""
        c = self.cfg
        d, hq, hkv, hd = c.d_model, c.n_heads, c.n_kv_heads, c.hd
        a = c.attn_width
        return {pre + "ln_attn": stack + (a,),
                pre + "wq": stack + (a, hq * hd),
                pre + "wk": stack + (a, hkv * hd),
                pre + "wv": stack + (a, hkv * hd),
                pre + "wo": stack + (hq * hd, d)}

    def _mlp_shapes(self, stack: tuple) -> dict[str, tuple]:
        d, f = self.cfg.d_model, self.cfg.d_ff
        return {"ln_mlp": stack + (d,), "w_gate": stack + (d, f),
                "w_up": stack + (d, f), "w_down": stack + (f, d)}

    def _attn_mlp_shapes(self, stack: tuple) -> dict[str, tuple]:
        return {**self._attn_shapes(stack), **self._mlp_shapes(stack)}

    def _moe_shapes(self, stack: tuple) -> dict[str, tuple]:
        """A MoE layer's leaves in the reference's order (``_moe_leaves``):
        attention, ``ln_mlp``, the router, the experts' SwiGLU and, with
        ``dense_residual``, the dense SwiGLU of width ``d_ff``."""
        c = self.cfg
        d, m = c.d_model, c.moe
        e, f = m.n_experts, m.d_ff_expert
        dense = self._attn_mlp_shapes(stack)
        out = {k: dense[k] for k in ("ln_attn", "wq", "wk", "wv", "wo",
                                     "ln_mlp")}
        out.update(router=stack + (d, e), moe_gate=stack + (e, d, f),
                   moe_up=stack + (e, d, f), moe_down=stack + (e, f, d))
        if m.dense_residual:
            out.update({k: dense[k] for k in ("w_gate", "w_up", "w_down")})
        return out

    def _ffn_shapes(self, stack: tuple) -> dict[str, tuple]:
        """A layer pattern's FFN leaves: ``ln_mlp``, then the MoE's router
        and experts with, under ``dense_residual`` (the shared expert), the
        dense SwiGLU of width ``d_ff``."""
        moe = self._moe_shapes(stack)
        return {k: v for k, v in moe.items()
                if k not in ("ln_attn", "wq", "wk", "wv", "wo")}

    def _mamba_shapes(self, stack: tuple) -> dict[str, tuple]:
        c = self.cfg
        s, d = c.ssm, c.d_model
        di, h, w = s.d_inner(d), s.n_heads(d), s.conv_width
        conv = di + 2 * s.n_groups * s.d_state
        out = {"ln_ssm": stack + (d,), "in_proj": stack + (d, di + conv + h),
               "conv_w": stack + (w, conv)}
        if s.conv_bias:
            out["conv_b"] = stack + (conv,)
        out.update(dt_bias=stack + (h,), A_log=stack + (h,), D=stack + (h,),
                   ssm_norm=stack + (di,), out_proj=stack + (di, d))
        return out

    def _app_shapes(self) -> dict[str, tuple]:
        """Each application's own leaves in Zyphra's hybrid: the MLP's
        rank-r adapter (d -> r, then r -> the gate's and the up product's
        f) and the d x d linear into the next Mamba2 layer's input."""
        c = self.cfg
        n, d, r, f = len(c.hybrid_layer_ids), c.d_model, c.adapter_rank, c.d_ff
        return {"adapter": (n, d, r), "adapter_gate": (n, r, f),
                "adapter_up": (n, r, f), "w_link": (n, d, d)}

    def param_shapes(self) -> dict[str, Any]:
        """Leaf shapes of the parameter dict, in the reference's order."""
        c = self.cfg
        out: dict[str, Any] = {"embed": (c.padded_vocab, c.d_model),
                               "ln_final": (c.d_model,)}
        if c.window > 0:
            out["local"] = self._attn_mlp_shapes((self.n_super,
                                                  c.global_every - 1))
            out["global"] = self._attn_mlp_shapes((self.n_super,))
            if self.n_tail:
                out["tail"] = self._attn_mlp_shapes((self.n_tail,))
        elif c.kind == "moe":
            out["layers"] = self._moe_shapes((c.n_layers,))
        elif c.kind in DENSE_KINDS:
            out["layers"] = self._attn_mlp_shapes((c.n_layers,))
        elif c.kind == "ssm":
            out["layers"] = self._mamba_shapes((c.n_layers,))
        elif c.patterned:
            n_attn = c.layer_types.count("attention")
            out["ssm"] = self._mamba_shapes((c.n_layers - n_attn,))
            out["attn"] = self._attn_shapes((n_attn,))
            out["ffn"] = self._ffn_shapes((c.n_layers,))
        elif c.zyphra:
            out["layers"] = self._mamba_shapes((c.n_layers,))
            out["blocks"] = self._attn_mlp_shapes((c.n_mem_blocks,))
            out["hybrid"] = self._app_shapes()
        elif c.kind in ENCDEC_KINDS:
            out["enc"] = self._attn_mlp_shapes((c.n_enc_layers,))
            dec = (c.n_layers,)
            out["dec"] = {**self._attn_shapes(dec),
                          **self._attn_shapes(dec, CROSS),
                          **self._mlp_shapes(dec)}
            out["ln_enc_final"] = (c.d_model,)
        else:
            out["mamba"] = self._mamba_shapes((self.n_super,
                                               c.shared_attn_every))
            if self.n_tail:
                out["tail"] = self._mamba_shapes((self.n_tail,))
            out["shared_attn"] = self._attn_mlp_shapes(())
        return out

    def param_axes(self) -> dict[str, Any]:
        """Logical-axis names mirroring the parameter dict (no
        allocation): a stacked leaf's stack dims are None."""
        def axes(name, shape, n_stack):
            base = LEAF_AXES[name[len(CROSS):] if name.startswith(
                CROSS + "w") or name == CROSS + "ln_attn" else name]
            return (None,) * n_stack + base

        out: dict[str, Any] = {}
        for group, shapes in self.param_shapes().items():
            if isinstance(shapes, dict):
                out[group] = {name: axes(name, shape, STACK_DIMS[group])
                              for name, shape in shapes.items()}
            else:
                out[group] = axes(group, shapes, 0)
        return out

    def abstract_params(self) -> dict[str, Any]:
        """The parameter dict as meta tensors (shapes and dtypes, no
        storage): the reference's ``eval_shape`` of ``init``."""
        dtype = _dt(self.cfg.param_dtype)

        def leaf(shape):
            if isinstance(shape, dict):
                return {k: leaf(v) for k, v in shape.items()}
            return torch.empty(shape, dtype=dtype, device="meta")

        return leaf(self.param_shapes())

    def init(self, seed: int = 0, device=None) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on ``device``
        (default ``cuda``): dense leaves ~ N(0, 1/fan_in), norm scales 0
        (a cross-attention's ``cln_attn`` too, as the reference's ``norm``),
        and the reference's constants for the SSM's ``dt_bias``, ``A_log``
        and ``D``. A stacked leaf is drawn one layer at a time in fp32 and
        copied into the preallocated leaf in ``param_dtype``, so the fp32
        temporary is one layer's, not the stack's; an expert leaf (L, E, ...)
        is drawn one (layer, expert) slice at a time at the fan-in of the
        dim after E (d, or f for ``moe_down``), as the reference's
        ``in_axis=ns + 1``. The numbers differ from
        the reference's ``jax.random`` draws; the layout does not."""
        dev = resolve_device(device)
        dtype = _dt(self.cfg.param_dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def leaf(name, shape, n_stack, fan_in_axis=None):
            out = torch.empty(shape, dtype=dtype, device=dev)
            h = shape[-1]
            if name.startswith(("ln_", CROSS + "ln_")) or name == "ssm_norm":
                return out.zero_()
            if name == "D":
                return out.fill_(1.0)
            if name in ("dt_bias", "A_log"):
                lo, hi = (0.001, 0.1) if name == "dt_bias" else (1.0, 16.0)
                r = torch.linspace(lo, hi, h, dtype=torch.float32,
                                   device=dev)
                r = torch.log(torch.expm1(r)) if name == "dt_bias" \
                    else torch.log(r)
                return out.copy_(r.expand(shape))
            lead = n_stack + (name in EXPERT_LEAVES)
            std = 1.0 / math.sqrt(shape[lead if fan_in_axis is None
                                        else fan_in_axis])
            slices = out.view(-1, *shape[lead:])
            for i in range(slices.shape[0]):
                w = torch.randn(shape[lead:], generator=gen, device=dev,
                                dtype=torch.float32)
                slices[i].copy_(w.mul_(std))
            return out

        params: Params = {}
        for group, shapes in self.param_shapes().items():
            if isinstance(shapes, dict):
                params[group] = {name: leaf(name, shape, STACK_DIMS[group])
                                 for name, shape in shapes.items()}
            else:  # embed (fan-in d_model, axis 1) and ln_final
                params[group] = leaf(group, shapes, 0, fan_in_axis=-1)
        return params

    # ------------------------------------------------------ shared pieces
    def _attn_branch(self, p, x, sin, cos, window, fused):
        """Causal self-attention with RoPE (none where ``rope`` is off:
        ``sin`` and ``cos`` are then None) over the full sequence, before
        its residual add: x (B, S, D) -> (its output (B, S, D), (k, v)),
        for :meth:`_ffn` to add. With ``fused`` (:func:`fused_route`) the
        norm and RoPE take the fused kernels."""
        c = self.cfg
        b, s, _ = x.shape
        with _nope_range(c):
            h = _norm(x, p["ln_attn"], c.norm_eps, fused)
            q = _heads(rules.matmul(h, p["wq"]), s, c.n_heads)
            k = _heads(rules.matmul(h, p["wk"]), s, c.n_kv_heads)
            v = _heads(rules.matmul(h, p["wv"]), s, c.n_kv_heads)
            if c.rope and fused:
                q, k = pw.rope_qk_cuda(q, k, sin, cos)
            elif c.rope:
                q = apply_rope(q, sin, cos)
                k = apply_rope(k, sin, cos)
            o = context_attention(q, k, v, causal=True, window=window,
                                  impl=c.attn_impl, scale=c.attn_scale)
            o = rules.pin(o.reshape(b, s, -1))
            return shard(rules.matmul(o, p["wo"]), "batch", "seq",
                         None), (k, v)

    def _attn_nocausal(self, p, x, kv_from=None, fused=False):
        """Encoder self-attention, or with ``kv_from`` (the encoder's
        output, not normed again) a decoder layer's cross-attention, whose
        leaves are named with the ``CROSS`` prefix: no RoPE, no mask. With
        ``fused`` (:func:`fused_route`) its norm takes the fused kernel."""
        c = self.cfg
        b, s, _ = x.shape
        prefix = "" if kv_from is None else CROSS
        h = _norm(x, p[prefix + "ln_attn"], c.norm_eps, fused)
        src = h if kv_from is None else kv_from
        t = src.shape[1]
        q = _heads(rules.matmul(h, p[prefix + "wq"]), s, c.n_heads)
        k = _heads(rules.matmul(src, p[prefix + "wk"]), t, c.n_kv_heads)
        v = _heads(rules.matmul(src, p[prefix + "wv"]), t, c.n_kv_heads)
        o = context_attention(q, k, v, causal=False, window=0,
                              impl=c.attn_impl)
        o = rules.pin(o.reshape(b, s, -1))
        return x + shard(rules.matmul(o, p[prefix + "wo"]), "batch",
                         "seq", None), (k, v)

    def _ffn(self, p, x, y=None, fused=False):
        """The FFN block: SwiGLU, or in a MoE layer the experts (plus the
        dense SwiGLU of the same normed input with ``dense_residual``: the
        ``moe/shared`` range). With ``y`` (a mixer's output: an attention's,
        :meth:`_attn_branch`, or a layer pattern's Mamba2 layer's) the
        block's input is x + y, added in one pass with the norm when
        ``fused`` (:func:`fused_route`); its own residual add stays one
        add. A ``residual_multiplier`` other than 1 scales y and the FFN's
        output before their adds."""
        c = self.cfg
        r = c.residual_multiplier
        if y is not None and r != 1.0:
            y = y * r
        if y is None:
            h = _norm(x, p["ln_mlp"], c.norm_eps, fused)
        elif fused:
            x, h = pw.add_rms_norm_cuda(x, y, p["ln_mlp"], c.norm_eps)
        else:
            x = x + y
            h = rms_norm(x, p["ln_mlp"], c.norm_eps)
        if "router" not in p:
            y = self._dense_mlp(p, h, fused)
        else:
            y = moe_apply(h, {"router": p["router"],
                              "w_gate": p["moe_gate"], "w_up": p["moe_up"],
                              "w_down": p["moe_down"]}, c.moe)
            if c.moe.dense_residual:
                with profiler_range("moe/shared"):
                    y = y + self._dense_mlp(p, h, fused)
        if r != 1.0:
            y = y * r
        return x + shard(y, "batch", "seq", None)

    @staticmethod
    def _dense_mlp(p, h, fused=False):
        """SwiGLU, its hidden dim sharded over 'ff' under a mesh; with
        ``fused`` its gate in one kernel."""
        g = rules.matmul(h, p["w_gate"])
        if fused:
            hh = pw.swiglu_gate_cuda(g, rules.matmul(h, p["w_up"]))
        else:
            hh = F.silu(g) * rules.matmul(h, p["w_up"])
        return rules.matmul(shard(hh, "batch", "seq", "ff"), p["w_down"])

    def _zamba_mlp(self, p, app, a, fused=False):
        """The rest of Zyphra's shared block after its attention output
        ``a`` (B, S, D): RMSNorm, GeGLU (exact GELU) whose gate and up
        products gain the application's adapter, the down product, then
        the application's linear. No residual: the caller adds the result
        to the next Mamba2 layer's input. With ``fused`` the norm takes the
        fused kernel (the block has no residual add or SwiGLU for the
        others)."""
        h = _norm(a, p["ln_mlp"], self.cfg.norm_eps, fused)
        low = rules.matmul(h, app["adapter"])
        g = rules.matmul(h, p["w_gate"]) + rules.matmul(low,
                                                        app["adapter_gate"])
        u = rules.matmul(h, p["w_up"]) + rules.matmul(low, app["adapter_up"])
        m = rules.matmul(F.gelu(g) * u, p["w_down"])
        return rules.matmul(m, app["w_link"])

    def _zamba_block(self, p, x, e, sin, cos):
        """Zyphra's shared block over the full sequence (``p["block"]``, the
        application's ``p["app"]``): attention over concat(x, e) (e the
        token embeddings), then :meth:`_zamba_mlp`. Returns (what it adds
        to the Mamba2 layer's input, (k, v))."""
        with profiler_range("zamba2/shared_block"):
            fused = fused_route(x, p["block"])
            t = torch.cat([x, e], dim=-1)
            a, kv = self._attn_branch(p["block"], t, sin, cos, 0, fused)
            return self._zamba_mlp(p["block"], p["app"], a, fused), kv

    @staticmethod
    def _index(tree: Params, *idx) -> dict[str, torch.Tensor]:
        """One layer's leaves of a stacked group."""
        return {name: rules.gather_dims(leaf, range(len(idx)))[idx]
                for name, leaf in tree.items()}

    def _picker(self, params: Params, train: bool):
        """``pick(group, *idx)``: one layer's leaves of a stacked group. On
        the training path each leaf of a group is unbound once, its stack
        dims flattened, so that its backward stacks the layers' gradients
        once; otherwise ``_index``."""
        if not train:
            return lambda group, *idx: self._index(params[group], *idx)
        unbound: dict[str, dict] = {}

        def pick(group, *idx):
            n = STACK_DIMS[group]
            if group not in unbound:
                unbound[group] = {
                    name: rules.gather_dims(leaf, range(n)).flatten(
                        0, n - 1).unbind(0)
                    for name, leaf in params[group].items()}
            first = next(iter(params[group].values()))
            flat = int(np.ravel_multi_index(idx, first.shape[:n]))
            return {name: rows[flat] for name, rows in unbound[group].items()}

        return pick

    @staticmethod
    def _training(params: Params) -> bool:
        """Whether autograd will differentiate a forward over ``params``:
        grad mode on and some leaf requires a gradient."""
        def leaves(tree):
            for v in tree.values():
                yield from leaves(v) if isinstance(v, dict) else (v,)
        return torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves(params))

    def _layers(self, params: Params, cache=None, train: bool = False):
        """The layer sequence in order, as (kind, params, cache views,
        window, rolling): ``("attn", p, (k, v), window, rolling)`` for a
        dense layer, a windowed or global layer or a shared attention
        application (an attention + MLP block), where ``window`` is its
        prefill attention's window (0: full causal) and ``rolling`` whether
        its cache is a rolling buffer of the last ``window`` positions;
        ``("mamba", p, (conv, state), 0, False)`` for a Mamba2 layer;
        ``("zamba", p, (conv, state, k, v), 0, False)`` for a Mamba2 layer
        of Zyphra's hybrid that a shared block precedes (``p["block"]``
        the block's leaves, ``p["app"]`` the application's);
        ``("dec", p, (k_self, v_self, k_cross, v_cross), 0, False)`` for an
        encoder-decoder's decoder layer (self-attention, cross-attention,
        MLP). A layer pattern's layer is an ``"attn"`` or ``"mamba"`` entry
        whose ``p`` holds its FFN's leaves besides its mixer's (a Mamba2
        layer with an FFN: ``ln_mlp`` in ``p``). The cache views are None
        without a cache; ``train`` picks each layer's leaves as
        :meth:`_picker` says."""
        c = self.cfg
        pick = self._picker(params, train)

        def views(*keys_idx):
            if cache is None:
                return None
            return tuple(cache[key][idx] for key, idx in keys_idx)

        if c.window > 0:
            for si in range(self.n_super):
                for j in range(c.global_every - 1):
                    yield ("attn", pick("local", si, j),
                           views(("k_local", (si, j)), ("v_local", (si, j))),
                           c.window, True)
                yield ("attn", pick("global", si),
                       views(("k_global", si), ("v_global", si)), 0, False)
            for t in range(self.n_tail):
                yield ("attn", pick("tail", t),
                       views(("k_tail", t), ("v_tail", t)), c.window, True)
        elif c.kind in DENSE_KINDS:
            for i in range(c.n_layers):
                yield ("attn", pick("layers", i),
                       views(("k", i), ("v", i)), 0, False)
        elif c.kind == "ssm":
            for i in range(c.n_layers):
                yield ("mamba", pick("layers", i),
                       views(("conv", i), ("state", i)), 0, False)
        elif c.patterned:
            n = {"attention": 0, "mamba": 0}
            for i, t in enumerate(c.layer_types):
                j = n[t]
                n[t] += 1
                ffn = pick("ffn", i)
                if t == "attention":
                    yield ("attn", {**pick("attn", j), **ffn},
                           views(("k", j), ("v", j)), 0, False)
                else:
                    yield ("mamba", {**pick("ssm", j), **ffn},
                           views(("conv", j), ("state", j)), 0, False)
        elif c.zyphra:
            app = {lid: j for j, lid in enumerate(c.hybrid_layer_ids)}
            for i in range(c.n_layers):
                p = pick("layers", i)
                j = app.get(i)
                if j is None:
                    yield ("mamba", p, views(("conv", i), ("state", i)), 0,
                           False)
                    continue
                p = {**p, "block": pick("blocks", j % c.n_mem_blocks),
                     "app": pick("hybrid", j)}
                yield ("zamba", p, views(("conv", i), ("state", i),
                                         ("k_shared", j), ("v_shared", j)),
                       0, False)
        elif c.kind in ENCDEC_KINDS:
            for i in range(c.n_layers):
                yield ("dec", pick("dec", i),
                       views(("k_self", i), ("v_self", i), ("k_cross", i),
                             ("v_cross", i)), 0, False)
        else:
            for si in range(self.n_super):
                for j in range(c.shared_attn_every):
                    yield ("mamba", pick("mamba", si, j),
                           views(("conv", (si, j)), ("state", (si, j))),
                           0, False)
                yield ("attn", params["shared_attn"],
                       views(("k_shared", si), ("v_shared", si)), 0, False)
            for t in range(self.n_tail):
                yield ("mamba", pick("tail", t),
                       views(("conv_tail", t), ("state_tail", t)), 0, False)

    # ------------------------------------------------------------- forward
    def forward(self, params: Params, batch: dict, cache=None):
        """Full-sequence forward -> final hidden states (B, S, D).

        Given a decode ``cache`` (from :meth:`init_cache`, ``seq_len`` >= S),
        each layer writes its cache material into it in place: attention
        K/V into ``cache[k][..., :S]`` rows, or into a rolling buffer of w
        slots the last min(S, w) positions, position p at slot p % w (the
        reference's ``place_rolling``); Mamba2 conv inputs and final SSM
        states into their leaves. The counterpart of the reference's
        ``collect=True``, which returns them stacked.

        A vlm batch may carry ``patches`` (B, P, D): they replace the first
        P positions' token embeddings, in the compute dtype, before the
        layers (RoPE positions are unchanged). An encoder-decoder's batch
        carries ``frames`` (B, T, D): the encoder's output over them is
        what every decoder layer cross-attends to, and each layer's cross
        K/V fill rows 0..T-1 of its ``k_cross`` / ``v_cross`` leaves. In
        Zyphra's hybrid each application's K/V fill its ``k_shared`` /
        ``v_shared`` rows."""
        c = self.cfg
        enc = self.encode(params, batch["frames"]) \
            if c.kind in ENCDEC_KINDS else None
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        if c.kind == "vlm" and "patches" in batch:
            patches = batch["patches"].to(x.dtype)
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        x = shard(x, "batch", "seq", None)
        if c.zyphra:          # the shared blocks read the token embeddings
            enc = x
        s = x.shape[1]
        sin = cos = None
        if c.rope:
            sin, cos = rope_table(torch.arange(s, device=x.device), c.hd,
                                  c.rope_theta)
        train = self._training(params)
        remat = c.remat and train and cache is None
        for kind, p, views, window, rolling in self._layers(params, cache,
                                                            train):
            if remat:
                x = checkpoint(rules.bind_ctx(self._layer), kind, p, views,
                               window, rolling, x, sin, cos, enc,
                               use_reentrant=False)
            else:
                x = self._layer(kind, p, views, window, rolling, x, sin, cos,
                                enc)
        return rms_norm(x, params["ln_final"], c.norm_eps)

    def _layer(self, kind, p, views, window, rolling, x, sin, cos, enc):
        """One entry of :meth:`_layers` over the full sequence: x (B, S, D)
        -> x, writing its cache material into ``views`` when given. ``enc``
        is the encoder's output (encdec) or, in Zyphra's hybrid, the token
        embeddings."""
        c = self.cfg
        if kind in ("mamba", "zamba"):
            xin = x
            if kind == "zamba":
                m, kv = self._zamba_block(p, x, enc, sin, cos)
                xin = x + m
                if views is not None:
                    for dst, src in zip(views[2:], kv):
                        _place(dst, src, rolling)
            h = rms_norm(xin, p["ln_ssm"], c.norm_eps)
            y, (conv, state) = mamba_block(
                p, h, c.ssm, use_kernel=c.ssd_impl == "kernel",
                eps=c.norm_eps)
            if views is not None:
                views[0].copy_(conv)
                views[1].copy_(state)
            y = shard(y, "batch", "seq", None)
            if "ln_mlp" in p:             # a layer pattern's: its FFN follows
                return self._ffn(p, x, y, fused_route(x, p))
            return x + y
        fused = fused_route(x, p)
        y, kv = self._attn_branch(p, x, sin, cos, window, fused)
        if kind == "dec":
            x, cross = self._attn_nocausal(p, x + y, kv_from=enc,
                                           fused=fused)
            y, kv = None, kv + cross
        if views is not None:
            for dst, src in zip(views, kv):
                _place(dst, src, rolling)
        return self._ffn(p, x, y, fused)

    def loss(self, params: Params, batch: dict) -> torch.Tensor:
        """Mean next-token cross-entropy of the batch's ``labels`` (ignored
        where < 0) over the forward's hidden states, against the tied
        embedding table, its padding columns masked: the reference's
        ``Model.loss``, for every family."""
        x = self.forward(params, batch)
        if self.cfg.logits_scaling != 1.0:
            x = x / self.cfg.logits_scaling     # the logits, divided
        return embedloss.lm_loss(x, params["embed"], batch["labels"],
                                 valid_vocab=self.cfg.vocab)

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """The token embeddings (B, S, D) in the compute dtype, times
        ``embedding_multiplier`` where it is not 1."""
        c = self.cfg
        x = embedloss.embed_in(params["embed"], tokens, _dt(c.compute_dtype))
        return x * c.embedding_multiplier if c.embedding_multiplier != 1.0 \
            else x

    def logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        """Final hidden states (..., D) -> fp32 logits over the vocab (its
        padding columns left out), divided by ``logits_scaling``: what
        :meth:`loss` scores and the greedy head's argmax picks from."""
        c = self.cfg
        out = h.float() @ params["embed"][:c.vocab].float().T
        return out / c.logits_scaling if c.logits_scaling != 1.0 else out

    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """The encoder (whisper): frames (B, T, D) -> its normed output
        (B, T, D). The frames are cast to the compute dtype before the
        sinusoidal positions (themselves fp32, then the compute dtype) are
        added, as the reference does: the order of the casts decides the
        bf16 bits."""
        c = self.cfg
        cdt = _dt(c.compute_dtype)
        key = (frames.shape[1], frames.device, cdt)
        if key not in self._enc_pos:
            self._enc_pos[key] = _sinusoid(key[0], c.d_model).to(
                frames.device, cdt)
        h = shard(frames.to(cdt) + self._enc_pos[key][None], "batch", None,
                  None)
        train = self._training(params)
        pick = self._picker(params, train)
        for i in range(c.n_enc_layers):
            p = pick("enc", i)
            if c.remat and train:
                h = checkpoint(rules.bind_ctx(self._enc_layer), p, h,
                               use_reentrant=False)
            else:
                h = self._enc_layer(p, h)
        return rms_norm(h, params["ln_enc_final"], c.norm_eps)

    def _enc_layer(self, p, h):
        """One encoder layer: non-causal self-attention and the MLP."""
        fused = fused_route(h, p)
        h, _ = self._attn_nocausal(p, h, fused=fused)
        return self._ffn(p, h, fused=fused)

    def cross_kv(self, params: Params, enc_out: torch.Tensor):
        """Every decoder layer's cross-attention K and V of the encoder's
        output: two (L, B, T, Hkv, hd) tensors (the reference's one einsum
        over the layers is one product per layer here)."""
        c = self.cfg
        b, t, _ = enc_out.shape
        dec = params["dec"]

        def stack(w):
            return torch.stack([(enc_out @ w[i]).reshape(
                b, t, c.n_kv_heads, c.hd) for i in range(c.n_layers)])

        return stack(dec[CROSS + "wk"]), stack(dec[CROSS + "wv"])

    # ================================================================ decode
    def init_cache(self, batch_size: int, seq_len: int, device=None,
                   params: Params | None = None, batch: dict | None = None,
                   abstract: bool = False):
        """The decode cache of :meth:`_zero_cache`; with ``abstract`` as
        meta tensors (shapes and dtypes, no storage; no cross K/V
        computed). Under a device mesh each leaf is a DTensor laid out by
        :meth:`cache_axes` (its sequence over 'kv_seq', its batch over
        'batch')."""
        if abstract:
            return self._zero_cache(batch_size, seq_len, torch.device("meta"))
        dev = resolve_device(device)
        if not rules.is_device_mesh(rules.current_mesh()):
            return self._zero_cache(batch_size, seq_len, dev, params, batch)
        # each rank allocates its own shard of each leaf, never the whole
        axes = self.cache_axes()
        cache = {k: rules.sharded_zeros(v, axes[k], dev) for k, v in
                 self._zero_cache(batch_size, seq_len,
                                  torch.device("meta")).items()}
        if params is not None and batch is not None and "k_cross" in cache:
            kc, vc = self.cross_kv(params, self.encode(params,
                                                       batch["frames"]))
            cdt = _dt(self.cfg.compute_dtype)
            cache["k_cross"] = rules.distribute(kc.to(device=dev, dtype=cdt),
                                                axes["k_cross"])
            cache["v_cross"] = rules.distribute(vc.to(device=dev, dtype=cdt),
                                                axes["v_cross"])
        return cache

    def _zero_cache(self, batch_size: int, seq_len: int, dev: torch.device,
                    params: Params | None = None, batch: dict | None = None):
        """Zeroed decode cache for a max context of ``seq_len``: per-slot
        positions ``pos`` (B,) int32; attention K/V (n, B, S, Hkv, hd),
        windowed layers' rolling K/V of w = min(window, seq_len) slots
        (``k_local`` (n_super, global_every - 1, B, w, Hkv, hd), ``k_tail``
        (n_tail, B, w, Hkv, hd)); Mamba2 conv inputs (n, B, W-1, di+2N) and
        SSM states (n, B, H, P, N) fp32 (Zyphra's hybrid: one of each a
        layer, and K/V ``k_shared`` (applications, B, S, Hkv, hd) one a
        shared block's application; a layer pattern: one of each a Mamba2
        layer, and K/V (attention layers, B, S, Hkv, hd)); an
        encoder-decoder's self K/V ``k_self`` (L, B, S, Hkv, hd) and cross
        K/V ``k_cross`` (L, B, enc_len, Hkv, hd) — the reference's leaves
        and shapes. Given
        ``params`` and a ``batch`` with ``frames``, an encoder-decoder's
        cross K/V are those of the encoder's output over the frames, as
        the reference's; otherwise zeros."""
        c = self.cfg
        cdt = _dt(c.compute_dtype)
        b = batch_size

        def zeros(shape, dtype=cdt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def kv(n, s=seq_len):
            return (n, b, s, c.n_kv_heads, c.hd)

        cache = {"pos": zeros((b,), torch.int32)}
        if c.window > 0:
            w = min(c.window, seq_len)
            local = (self.n_super, c.global_every - 1, b, w, c.n_kv_heads,
                     c.hd)
            cache["k_local"] = zeros(local)
            cache["v_local"] = zeros(local)
            cache["k_global"] = zeros(kv(self.n_super))
            cache["v_global"] = zeros(kv(self.n_super))
            if self.n_tail:
                cache["k_tail"] = zeros(kv(self.n_tail, w))
                cache["v_tail"] = zeros(kv(self.n_tail, w))
            return cache
        if c.kind in DENSE_KINDS:
            cache["k"] = zeros(kv(c.n_layers))
            cache["v"] = zeros(kv(c.n_layers))
            return cache
        if c.kind in ENCDEC_KINDS:
            cache["k_self"] = zeros(kv(c.n_layers))
            cache["v_self"] = zeros(kv(c.n_layers))
            if params is not None and batch is not None and \
                    dev.type != "meta":
                kc, vc = self.cross_kv(params, self.encode(params,
                                                           batch["frames"]))
                cache["k_cross"] = kc.to(device=dev, dtype=cdt)
                cache["v_cross"] = vc.to(device=dev, dtype=cdt)
            else:
                cache["k_cross"] = zeros(kv(c.n_layers, c.enc_len))
                cache["v_cross"] = zeros(kv(c.n_layers, c.enc_len))
            return cache
        s = c.ssm
        conv = (b, s.conv_width - 1,
                s.d_inner(c.d_model) + 2 * s.n_groups * s.d_state)
        state = (b, s.n_heads(c.d_model), s.head_dim, s.d_state)
        if c.patterned:
            n_attn = c.layer_types.count("attention")
            cache["conv"] = zeros((c.n_layers - n_attn,) + conv)
            cache["state"] = zeros((c.n_layers - n_attn,) + state,
                                   torch.float32)
            cache["k"] = zeros(kv(n_attn))
            cache["v"] = zeros(kv(n_attn))
            return cache
        if c.kind == "ssm" or c.zyphra:
            cache["conv"] = zeros((c.n_layers,) + conv)
            cache["state"] = zeros((c.n_layers,) + state, torch.float32)
            if c.zyphra:
                cache["k_shared"] = zeros(kv(len(c.hybrid_layer_ids)))
                cache["v_shared"] = zeros(kv(len(c.hybrid_layer_ids)))
            return cache
        stack = (self.n_super, c.shared_attn_every)
        cache["conv"] = zeros(stack + conv)
        cache["state"] = zeros(stack + state, torch.float32)
        if self.n_tail:
            cache["conv_tail"] = zeros((self.n_tail,) + conv)
            cache["state_tail"] = zeros((self.n_tail,) + state,
                                        torch.float32)
        cache["k_shared"] = zeros(kv(self.n_super))
        cache["v_shared"] = zeros(kv(self.n_super))
        return cache

    def cache_axes(self):
        """Logical axes of the cache leaves (where the batch axis is),
        derived from :meth:`_zero_cache`'s leaves as :meth:`param_axes` is
        from the parameters: a leaf's stack dims are None."""
        return {name: _cache_leaf_axes(name, leaf) for name, leaf in
                self._zero_cache(1, 1, torch.device("meta")).items()}

    def reset_cache_lane(self, cache, slot):
        """Zero one batch lane of a decode cache in place (``pos[slot] = 0``
        and every leaf's ``slot`` row along its batch axis): what
        :meth:`init_cache` would have produced for that lane. Attention
        masks already hide K/V past a lane's position, but the SSM conv and
        state leaves carry history unconditionally, so every leaf is
        wiped, an encoder-decoder's cross K/V included (as the
        reference's). ``slot`` is an int, or a (1,) int64 index tensor on
        the cache's device, which spares the call its one host-to-device
        copy (the serving engine makes one per slot up front)."""
        idx = slot if isinstance(slot, torch.Tensor) else torch.tensor(
            [slot], device=cache["pos"].device)
        for key, val in cache.items():
            val.index_fill_(_cache_leaf_axes(key, val).index("batch"), idx,
                            0)
        return cache

    def _attn_decode(self, p, x, cache_kv, pos, rolling=False, cross=False,
                     residual=True):
        """x (B, 1, D); cache_kv = one layer's (k, v) cache views
        (B, S, Hkv, hd), written in place at each lane's position: slot
        ``min(pos, S - 1)``, or ``pos % S`` in a rolling buffer, which then
        holds exactly the window's last S positions and is attended whole
        (every slot is visible once ``pos >= S - 1``). The slot is computed
        on the device: no host sync, no branch on a device value.

        ``cross`` (a decoder layer's cross-attention, leaves named with the
        ``CROSS`` prefix): the cache is read only, no RoPE, and every lane
        attends to all S encoder positions (``pos = S - 1``). Without
        ``residual`` (Zyphra's shared block, whose x is the concatenated
        input; a block whose FFN adds it, :meth:`_ffn`) the attention's
        output alone is returned. Without ``rope`` in the config no
        position is encoded."""
        c = self.cfg
        b = x.shape[0]
        k_cache, v_cache = cache_kv
        smax = k_cache.shape[1]
        prefix = CROSS if cross else ""
        h = rms_norm(x, p[prefix + "ln_attn"], c.norm_eps)
        q = _heads(h @ p[prefix + "wq"], 1, c.n_heads)
        if cross:
            o = decode_attention(q[:, 0], k_cache, v_cache, pos=smax - 1)
            return x + o.reshape(b, 1, -1) @ p[prefix + "wo"]
        with _nope_range(c):
            k = _heads(h @ p["wk"], 1, c.n_kv_heads)
            v = _heads(h @ p["wv"], 1, c.n_kv_heads)
            # pos is per-slot (B,): each lane rotates and writes at its own
            # position, so mid-run admissions decode exactly as if solo
            if c.rope:
                sin, cos = rope_table(pos[:, None], c.hd, c.rope_theta)
                q = apply_rope(q, sin, cos)
                k = apply_rope(k, sin, cos)
            slot = torch.remainder(pos, smax) if rolling \
                else torch.clamp(pos, max=smax - 1)
            _write_lanes(k_cache, k[:, 0], slot)
            _write_lanes(v_cache, v[:, 0], slot)
            o = decode_attention(q[:, 0], k_cache, v_cache, pos=pos,
                                 scale=c.attn_scale)
            o = o.reshape(b, 1, -1) @ p["wo"]
        return x + o if residual else o

    def decode_step(self, params: Params, cache, tokens: torch.Tensor):
        """tokens (B,) int32 -> (next_tokens (B,) int32, cache), the cache
        updated in place."""
        c = self.cfg
        pos = cache["pos"]
        x = shard(self._embed(params, tokens[:, None]), "batch", None, None)
        e = x
        for kind, p, views, _, rolling in self._layers(params, cache):
            if kind in ("mamba", "zamba"):
                xin = x
                if kind == "zamba":
                    with profiler_range("zamba2/shared_block"):
                        a = self._attn_decode(p["block"],
                                              torch.cat([x, e], dim=-1),
                                              views[2:], pos, residual=False)
                        xin = x + self._zamba_mlp(p["block"], p["app"], a)
                h = rms_norm(xin, p["ln_ssm"], c.norm_eps)
                y, (conv, _) = mamba_block(p, h, c.ssm,
                                           conv_cache=views[0],
                                           ssd_state=views[1],
                                           eps=c.norm_eps)
                views[0].copy_(conv)       # the state is updated in place
                x = self._ffn(p, x, y) if "ln_mlp" in p else x + y
            elif kind == "dec":
                x = self._attn_decode(p, x, views[:2], pos, rolling)
                x = self._attn_decode(p, x, views[2:], pos, cross=True)
                x = self._ffn(p, x)
            else:
                x = self._ffn(p, x, self._attn_decode(p, x, views[:2], pos,
                                                      rolling,
                                                      residual=False))
        x = rms_norm(x, params["ln_final"], c.norm_eps)
        nxt = embedloss.greedy(x[:, 0], params["embed"], valid_vocab=c.vocab)
        pos.add_(1)
        return nxt, cache

    # -------------------------------------------------------------- prefill
    def prefill(self, params: Params, batch: dict, cache_len: int):
        """Full-sequence forward that fills a fresh decode cache in place,
        layer by layer (the batch as :meth:`forward` takes it, a vlm's
        ``patches`` and an encoder-decoder's ``frames`` included: its self
        and cross K/V). Returns (cache, last_hidden (B, D))."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = self.init_cache(b, cache_len, device=tokens.device)
        x = self.forward(params, batch, cache=cache)
        cache["pos"].fill_(s)
        return cache, x[:, -1]


def fused_route(x: torch.Tensor, p: dict[str, torch.Tensor]) -> bool:
    """Whether a layer's pointwise ops take the fused kernels
    (``kernels/pointwise``), decided once a layer: S > 1 (the decode
    step's (B, 1, D) calls keep the plain ops), then ``build.route`` over
    the layer's input x (B, S, D) with ``pw.takes`` (CUDA bf16) and its
    parameters ``p``. Which kernels a route takes is the block's to say: a
    dense block all four, Zyphra's shared block only the norms and RoPE
    (``Model._zamba_block``), a block without positional encoding (``rope``
    off) all but RoPE, a layer pattern's Mamba2 layer the FFN's residual
    add with its norm and the shared expert's gate."""
    return x.shape[1] > 1 and build.route(pw.takes, x, params=p.values())


def _cache_leaf_axes(name: str, leaf: torch.Tensor) -> tuple:
    """A decode-cache leaf's logical axes: None for each stack dim, then
    its base axes (``CACHE_LEAF_AXES``)."""
    base = CACHE_LEAF_AXES[name.split("_")[0]]
    return (None,) * (leaf.dim() - len(base)) + base


def _nope_range(cfg):
    """The ``attention/nope`` profiler range around an attention without
    positional encoding (``rope`` off); a null context otherwise."""
    return profiler_range("attention/nope") if not cfg.rope \
        else contextlib.nullcontext()


def _norm(x, scale, eps, fused):
    """RMSNorm, by the fused kernel when ``fused``."""
    return (pw.rms_norm_cuda if fused else rms_norm)(x, scale, eps)


def _sinusoid(n: int, d: int) -> torch.Tensor:
    """The encoder's positions (n, d): sin | cos of pos / 10000^(2i/d),
    computed in numpy float64 and returned in fp32, as the reference's."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32))


def _heads(t: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """A projection (B, S, n*hd) as (B, S, n, hd). DTensor cannot split a
    dim sharded over more ranks than its n heads (phi3's 10 KV heads on a
    model axis of 16): such a projection is gathered along its last dim
    first, as the attention's ``shard_map`` would gather it anyway."""
    if rules.is_dtensor(t) and n % rules.dim_shards(t, t.dim() - 1):
        t = rules.gather_dims(t, (t.dim() - 1,))
    return t.reshape(t.shape[0], s, n, t.shape[-1] // n)


def _write_lanes(cache: torch.Tensor, new: torch.Tensor,
                 slot: torch.Tensor) -> None:
    """Each lane's new row, new (B, Hkv, hd), into its cache view (B, S,
    Hkv, hd) in place at ``slot`` (B,), computed on the device: no host
    sync, no branch on a device value. A cache sharded over a mesh (a
    DTensor, for which DTensor has no in-place indexed write) is written
    shard by shard: each rank writes the lanes of its batch shard whose
    slot falls in its sequence shard, and rewrites the others' rows as
    they are."""
    if not rules.is_dtensor(cache):
        b, smax = cache.shape[:2]
        rows = torch.arange(b, device=cache.device) * smax + slot
        cache.view(b * smax, *cache.shape[2:]).index_copy_(
            0, rows, new.to(cache.dtype))
        return
    loc, off = rules.local_part(cache)
    bl, sl = loc.shape[:2]
    lanes = slice(off[0], off[0] + bl)
    slot = rules.replicate(slot).to_local()[lanes]
    new = rules.replicate(new).to_local()[lanes].to(loc.dtype)
    inside = (slot >= off[1]) & (slot < off[1] + sl)
    rows = torch.arange(bl, device=loc.device) * sl + \
        (slot - off[1]).clamp(0, sl - 1)
    flat = loc.view(bl * sl, *loc.shape[2:])
    flat.index_copy_(0, rows, torch.where(inside[:, None, None], new,
                                          flat[rows]))


def _place(dst: torch.Tensor, src: torch.Tensor, rolling: bool) -> None:
    """One layer's prefill K or V, src (B, S, Hkv, hd), into its cache view
    dst (B, Smax, Hkv, hd) in place: rows 0..S-1, or in a rolling buffer of
    w slots position p at slot p % w, keeping the last w positions when
    S > w (the reference's ``place_rolling``, with no rolled copy). A
    cache sharded over a mesh is written shard by shard
    (:func:`_place_sharded`)."""
    if rules.is_dtensor(dst):
        _place_sharded(dst, src, rolling)
        return
    s, w = src.shape[1], dst.shape[1]
    if not rolling or s <= w:
        dst[:, :s].copy_(src)
        return
    r = s % w                  # slot of position s - w, the oldest kept
    dst[:, r:].copy_(src[:, s - w:s - r])
    dst[:, :r].copy_(src[:, s - r:])


def _place_sharded(dst, src, rolling: bool) -> None:
    """:func:`_place` for a cache view sharded over a mesh: the source (a
    DTensor) is laid out as the view, but whole along its sequence, and
    each rank fills the slots of its sequence shard with the positions
    :func:`_place` puts there."""
    loc, off = rules.local_part(dst)
    # the source in the destination's layout, but whole along the sequence
    srcl = src.redistribute(dst.device_mesh, rules.gathered(
        dst.placements, (1,))).to_local()
    s, w = srcl.shape[1], dst.shape[1]
    j = torch.arange(off[1], off[1] + loc.shape[1])
    if rolling and s > w:
        pos = (s - w) + torch.remainder(j - (s - w), w)
    else:
        pos = torch.where(j < s, j, -1)
    sel = (pos >= 0).nonzero()[:, 0]
    loc.index_copy_(1, sel.to(loc.device),
                    srcl.index_select(1, pos[sel].to(srcl.device)).to(
                        loc.dtype))
