"""Model configuration dataclasses and the architecture registry.

A copy of ``repro.models.config`` (pure Python, no framework import) with
two deliberate differences:

1. ``ModelConfig.attn_impl`` defaults to ``"kernel"``, the hand-written
   CUDA flash-attention kernel, and the port reads it
   (``models/attention.py:context_attention``); ``"chunked"`` selects the
   hand-written two-pass kernel.
2. ``ModelConfig.ssd_impl`` (absent in the reference) is the config-level
   counterpart of the reference's ``mamba_block(use_kernel=...)``:
   ``"kernel"`` (default) runs prefill's SSD scan in the hand-written CUDA
   kernel, ``"blocked"`` in the plain-torch block decomposition
   (``models/ssm.py:ssd_ref``), which is what the reference's models run.

Beyond the reference, the hybrid family takes Zyphra's published layout
(``hybrid_layer_ids`` non-empty; zamba2-7b-instruct): the fields below
that field, and ``SSMConfig.n_groups`` / ``conv_bias``; and a layer pattern
given as data (``layer_types`` non-empty; granite-4.0-h-small): one mixer a
layer, Mamba2 or attention, each followed by its own FFN (a MoE with
``MoEConfig.dropless``, beside a shared SwiGLU expert), with the fields
after ``layer_types`` (no RoPE, a softmax scale, the embedding, residual
and logits multipliers). Their defaults keep the reference's variant and
every other configuration unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """A MoE FFN: ``top_k`` of ``n_experts`` SwiGLU experts of width
    ``d_ff_expert`` a token. Each expert takes at most C assignments a
    step, C = ceil(T k / E * ``capacity_factor``) of the step's T tokens,
    and drops the rest (Switch/GShard) wherever more than C tokens pick
    it. ``dropless`` sets C = T: a token picks an expert at most once, so
    no assignment is ever dropped (``models/moe.py``)."""
    n_experts: int
    top_k: int
    d_ff_expert: int
    # a dense SwiGLU of width d_ff on the same normed input, added to the
    # experts' output: arctic's residual MLP, Granite's shared expert
    dense_residual: bool = False
    capacity_factor: float = 1.25
    dropless: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2                   # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256
    # B and C come in ``n_groups`` groups of d_state each; head h reads
    # group h // (n_heads / n_groups). The gated norm runs over each group
    # of d_inner / n_groups channels.
    n_groups: int = 1
    conv_bias: bool = False           # a bias after the depthwise conv

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: Kind
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # Sliding-window pattern: every `global_every`-th layer is global, others
    # use a `window`-token local attention (gemma3: 5 local : 1 global).
    window: int = 0                   # 0 -> full attention everywhere
    global_every: int = 6
    # Hybrid (zamba2): mamba blocks with a shared attention block applied
    # every `shared_attn_every` layers (weights shared across applications).
    shared_attn_every: int = 0
    # Hybrid, Zyphra's published layout (set by a non-empty
    # `hybrid_layer_ids`): every layer is a Mamba2 layer; before each layer
    # listed here one of `n_mem_blocks` shared blocks (application j takes
    # block j mod n_mem_blocks) attends over concat(x, token embedding),
    # `attn_in` wide with `head_dim`-wide heads and softmax scale
    # (head_dim / 2)^-1/2, then runs a GeGLU MLP whose gate and up products
    # gain application j's rank-`adapter_rank` adapter; its output, through
    # application j's own d x d linear, is added to the Mamba2 layer's input
    # (not to the residual stream).
    hybrid_layer_ids: tuple[int, ...] = ()
    n_mem_blocks: int = 1
    attn_in: int = 0                  # 0 -> d_model
    adapter_rank: int = 0
    # Hybrid, a layer pattern as data (set by a non-empty `layer_types`,
    # one entry a layer: "mamba" or "attention"; IBM's Granite 4.0-H):
    # layer i runs its mixer (a Mamba2 layer or a GQA attention block,
    # each behind its own input norm), then its own FFN (`ln_mlp`, then
    # the MoE of `moe` with its dense residual as the shared expert). Each
    # branch's output is multiplied by `residual_multiplier` before its
    # residual add.
    layer_types: tuple[str, ...] = ()
    rope: bool = True                 # False: no positional encoding (NoPE)
    softmax_scale: float = 0.0        # 0 -> the attention's own default
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0       # the head's logits are divided by it
    # Encoder-decoder (whisper): number of encoder layers; frontend stub emits
    # `enc_len` precomputed frame embeddings.
    n_enc_layers: int = 0
    enc_len: int = 0
    # VLM (internvl): first `n_patches` positions come from the vision stub.
    n_patches: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # Prefill attention: 'kernel' (the CUDA flash kernel for CUDA tensors,
    # its plain version for CPU tensors), 'chunked' (the CUDA two-pass
    # kernel, likewise), 'xla_flash' (chunked plain torch), 'naive' (O(S^2)
    # oracle, small tests only).
    attn_impl: str = "kernel"
    # Prefill SSD scan: 'kernel' (the CUDA kernel for CUDA tensors, its
    # plain version for CPU tensors) or 'blocked' (plain-torch chunked
    # block decomposition).
    ssd_impl: str = "kernel"
    remat: bool = True
    scan_layers: bool = True

    # ------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def zyphra(self) -> bool:
        """Whether this is the hybrid family's published (Zyphra) layout."""
        return self.kind == "hybrid" and bool(self.hybrid_layer_ids)

    @property
    def attn_width(self) -> int:
        """Width of an attention block's input: ``attn_in`` or d_model."""
        return self.attn_in or self.d_model

    @property
    def patterned(self) -> bool:
        """Whether this is the hybrid family's layer pattern given as data
        (``layer_types``)."""
        return self.kind == "hybrid" and bool(self.layer_types)

    @property
    def attn_scale(self) -> float | None:
        """Softmax scale of the attention scores where it is not the
        attention's default hd^-1/2: ``softmax_scale`` where it is set
        (Granite's ``attention_multiplier``), (hd / 2)^-1/2 in Zyphra's
        shared blocks, None elsewhere."""
        if self.softmax_scale:
            return self.softmax_scale
        return (self.hd / 2) ** -0.5 if self.zyphra else None

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 128 (Megatron-style padding);
        the sampler masks the padding columns."""
        return ((self.vocab + 127) // 128) * 128

    def is_global_layer(self, i: int) -> bool:
        if self.window <= 0:
            return True
        return (i % self.global_every) == self.global_every - 1

    def layer_window(self, i: int) -> int:
        """0 means full/global attention for layer i."""
        return 0 if self.is_global_layer(i) else self.window

    # --------------------------------------------------- parameter counting
    def param_count(self) -> tuple[int, int]:
        """(total params, active params) — analytic, matches init."""
        d, v = self.d_model, self.vocab
        embed = v * d
        head = 0 if self.tie_embeddings else v * d
        total = embed + head + d  # final norm
        active = total

        def attn_params() -> int:
            return d * (self.n_heads * self.hd) + 2 * d * (self.n_kv_heads * self.hd) \
                + (self.n_heads * self.hd) * d + 2 * d  # qkv, o, 2 norms

        def mlp_params(ff: int) -> int:
            return 3 * d * ff  # SwiGLU: gate, up, down

        def ssm_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv = di + 2 * s.n_groups * s.d_state
            # in_proj (z, x, B, C, dt), conv (+ bias), A, D, dt_bias, norm,
            # out_proj, ln_ssm
            in_proj = d * (di + conv + nh)
            return in_proj + (s.conv_width + s.conv_bias) * conv + 3 * nh \
                + di + di * d + d

        if self.kind == "ssm":
            total += self.n_layers * ssm_params()
            active = total
            return total, active

        if self.patterned:
            n_attn = self.layer_types.count("attention")
            m = self.moe
            # ln_mlp, the router, the experts and the shared expert
            ffn = d + d * m.n_experts + m.n_experts * 3 * d * m.d_ff_expert \
                + m.dense_residual * mlp_params(self.d_ff)
            ffn_active = ffn - (m.n_experts - m.top_k) * 3 * d * m.d_ff_expert
            # attn_params() counts ln_mlp too: the FFN's own here
            mixers = (self.n_layers - n_attn) * ssm_params() \
                + n_attn * (attn_params() - d)
            total += mixers + self.n_layers * ffn
            active += mixers + self.n_layers * ffn_active
            return total, active

        if self.zyphra:
            a, f, r = self.attn_width, self.d_ff, self.adapter_rank
            hq, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
            block = a + a * (hq + 2 * hkv) * hd + hq * hd * d + d + 3 * d * f
            per_app = d * r + 2 * r * f + d * d   # adapter and linear
            total += self.n_layers * ssm_params() \
                + self.n_mem_blocks * block \
                + len(self.hybrid_layer_ids) * per_app
            return total, total

        if self.kind == "hybrid":
            per = ssm_params()  # the MLP lives in the shared block only
            total += self.n_layers * per
            if self.shared_attn_every:
                total += attn_params() + mlp_params(self.d_ff)
            active = total
            return total, active

        per_dense = attn_params() + mlp_params(self.d_ff)
        if self.kind in ("encdec", "audio"):
            # encoder blocks + decoder blocks with cross attention + enc norm
            cross = attn_params() - 2 * d + d  # cross qkv/o + its norm
            total += self.n_enc_layers * per_dense \
                + self.n_layers * (per_dense + cross) + d
            return total, total
        if self.moe is None:
            total += self.n_layers * per_dense
            return total, total

        m = self.moe
        router = d * m.n_experts
        expert = 3 * d * m.d_ff_expert
        per_moe = attn_params() + router + m.n_experts * expert
        per_moe_active = attn_params() + router + m.top_k * expert
        if m.dense_residual:
            per_moe += mlp_params(self.d_ff)
            per_moe_active += mlp_params(self.d_ff)
        total += self.n_layers * per_moe
        active = embed + head + d + self.n_layers * per_moe_active
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input shape of the dry-run's cells: a step of ``mode`` over
    ``global_batch`` sequences of ``seq_len`` tokens."""
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs that also get the long_500k cell (the others are pure
# full-attention, which the cell skips).
LONG_CONTEXT_ARCHS = {"mamba2-1.3b", "zamba2-7b", "gemma3-1b", "gemma3-12b"}


def shape_cells(arch: str) -> list[str]:
    """The dry-run cells defined for an architecture."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if arch in LONG_CONTEXT_ARCHS:
        cells.append("long_500k")
    return cells


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _SMOKE[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    # Importing repro_torch.configs registers every ported architecture.
    import repro_torch.configs  # noqa: F401


def human(n: float) -> str:
    """``n`` with a K/M/B/T/P suffix and one decimal."""
    for unit in ("", "K", "M", "B", "T"):
        if abs(n) < 1000:
            return f"{n:.1f}{unit}"
        n /= 1000
    return f"{n:.1f}P"
