#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a
machine with a CUDA GPU (Hopper, ``sm_90a``).

Phases, each printing one JSON line:
  build   : compile the CUDA kernels (flash attention, chunked two-pass
            attention, SSD scan) from the checkout's sources, timed, with
            the compiler's output (ptxas registers and spills), each
            kernel's registers, stack and local (spill) bytes
            (``cuobjdump -res-usage``), and count the tensor-core
            instructions (HGMMA, HMMA) in each kernel's SASS: every bf16
            attention body (head dims 32, 64, 112, 128, 256) and every
            bf16 SSD kernel that multiplies must hold some, the fp32 SSD
            body none.
  kernel  : the flash-attention kernel against its plain version
            (``attention_kernel_ref``) on the six reference cases and a
            case whose late rows see no key (those must be exactly 0) in
            fp32 (2e-5, the CUDA-core body) and bf16 (2e-2, the
            tensor-core body) and at phi3-medium-14b's prefill shape;
            kernel, plain and library
            (``scaled_dot_product_attention``, the yardstick only) times,
            the card's bound, TFLOP/s and the share of the bound.
  prefill : phi3-medium-14b at full width, bf16, random weights from a
            seeded generator: ``Model.prefill`` of 4 x 2048 tokens, 40
            kernel launches; every layer's cached K/V at every position
            and the last hidden state against a prefill whose attention
            is the plain chunked version, and against a control prefill
            whose causal mask lets each query see one key ahead (the
            gate must reject the control).
  decode  : 16 greedy ``decode_step``s from the prefilled cache; the
            same steps with the bf16 products widened to fp32 copies first
            (as before the fused fp32-output products) on a copy of the
            cache, and the count of greedy tokens that differ (logged).
  serve   : ``ServeEngine`` with 4 slots answers 6 requests, admitting the
            last two mid-run into freed slots, once with each engine step
            one replay of a captured CUDA graph (the engine's own step on
            CUDA) and once eagerly: every token must be equal in the two
            arms; each arm's step ms, requests/s and a torch.profiler
            trace of four engine steps (idle share, device ms, device ops
            and host launches a step). The first request's tokens must
            equal its bf16 solo run in an engine of the same 4 slots,
            captured and eager, and an fp32 witness of phi3's first 4
            layers (full width; the one cut of the phase) must give equal
            tokens served alone by 1 and by 4 slots, and eagerly by 4
            (see ``phase_serve``).
  profile : a torch.profiler trace of one prefill, four decode steps and
            four replays of the decode step captured as a CUDA graph:
            device busy time, idle share, device ops, host launches, top
            kernels.
  governed_serve : the SLO-governed serving scenario of
            ``examples/serve_pipeline.py`` on phi3 (4 slots, a bursty
            trace of 16 requests on the engine's sim clock, a governor
            re-planning off the DVB-S2 ``mac`` (period, energy) frontier,
            deadline-safe admission), its governed and max-performance
            arms. Each must miss no deadline, the governed arm complete
            every request with at least one "slo" re-plan and fewer
            joules per token (modelled: the ``mac`` power model's watts
            times the planned step time, not the card's energy); every
            decision (windows, governor events, admissions, finishes)
            must equal a replay of the same scenario on the CPU with the
            stablelm-3b smoke model; request 0's tokens must equal its
            4-slot solo run's. Both arms step by the captured graph; the
            governed arm runs once more eagerly and must decide and
            decode the same. Logs the card's wall ms per engine step,
            captured and eager, beside the plan's simulated step.
  pipeline : the paper's executor on phi3: its 44-task chain (ingest,
            embed, 40 layers, head, emit; 1 x 2048 tokens a frame)
            planned by ``plan_pipeline`` with both device classes the
            card (``H100_CLASS``) and run by ``StreamingPipelineRuntime``
            with real stage fns (``pipeline/stages.py``). Plan A, one
            stage on one card, for at least 5 s while ``nvidia-smi``
            samples the power draw: the samples become a RAPL log that
            ``parse_rapl_log`` reads and ``attribute_energy`` splits over
            the trace (energy above 0, mean watts at or below the power
            limit), logged beside the runtime's and the plan's modelled
            joules. Plan B, the reference's (2, 2) shape: three stages,
            the middle one two replicas, each replica on its own stream;
            last hidden states within 5e-2 of the monolithic prefill's,
            the device's idle share. Plan C: the two-pass kernel's
            multiplier fitted from a flash and a two-pass run, registered
            (``register_family``) and planned by ``variant_herad``. Every
            frame's token equals its monolithic prefill's, in order, and
            the flash / two-pass launches are exactly layers x frames of
            each variant. Logs a bf16 GEMM's and a device copy's rates
            beside the class's datasheet ones.
Then phi3's 28 GB are freed and zamba2-7b (Mamba2 + shared attention) runs:
  attention_kernels : the chunked two-pass kernel against
            ``attention_kernel_ref`` on the six reference cases and the
            no-key case (2e-5 / 2e-2), both attention
            kernels at zamba2's shared-attention shape (head dim 112);
            kernel, plain and library times and the bound.
  ssd_kernel : the SSD kernel against ``ssd_ref_sequential`` on the four
            reference cases (fp32 1e-4, bf16 5e-2), from zero and from a
            random initial state; on a fifth case with a chunk of 512 and
            a ragged tail, whose outputs reach ~40, and a sixth whose rows
            are not 16-byte aligned (relative max-norm: fp32 1e-4, bf16 y
            1e-2 and state 1e-3, see ``WIDE_CASE``); and
            at zamba2's and mamba2-1.3b's full-width layer shapes (y 1e-2
            and state 1e-3 relative max-norm); kernel and plain times, the
            bound, and each CUDA kernel's device time in one call
            (torch.profiler).
  prefill : zamba2-7b at full width and depth, bf16, seeded random
            weights: 4 x 2048 tokens, exactly 81 SSD and 13 flash
            launches, and with ``attn_impl="chunked"`` exactly 13 chunked
            ones. The last hidden state and every cache leaf (conv, state,
            k_shared, v_shared, conv_tail, state_tail) of both, and of the
            plain prefill (plain chunked attention, blocked plain SSD),
            against an fp32 prefill: each within 1.5x the plain path's
            error. The same two prefills in fp32 against the plain fp32
            one at 2e-3. A control whose SSD drops the carry between
            chunks must fail both gates. Two more plain bf16 paths
            (naive attention; the scan's output rounded to bf16) are
            logged beside them, the size of bf16's own noise.
  decode, serve, profile : as for phi3; the fp32 witness has every
            layer.
Then zamba2's 13 GB are freed and mamba2-1.3b (the ssm family, whole,
2.7 GB) serves as phi3 does, with an fp32 witness of every layer. Then
gemma3-12b (40 sliding-window layers of
window 1024 and 8 global layers, head dim 256) runs:
  gemma3_kernels : both attention kernels at head dim 256 against
            ``attention_kernel_ref`` on a causal and a sliding-window case,
            fp32 (2e-5) and bf16 (2e-2), and at gemma3-12b's two prefill
            shapes (4, 16, 8, 2048, 256), global causal and window 1024,
            in bf16: kernel, plain and library times, the bound of the
            pairs the mask shows; the D=256 bodies' registers and spills.
  prefill : gemma3-12b at full width and depth, bf16, seeded random
            weights: 4 x 2048 tokens (the windowed layers' caches roll),
            exactly 48 flash launches, or 48 chunked ones on the chunked
            path; both paths' last hidden state and every cached K/V row
            (rolled order included) against the plain prefill, as phi3's;
            the mask-one-ahead control and a control whose windowed
            layers ignore the window must fail the gate.
  decode  : 16 steps from position 2048 through rolling slots 0-15; then
            layer 0's rolling K/V must equal a fresh prefill's of the same
            2064 tokens, and a wrong-slot control must fail.
  serve, profile : as for phi3; the fp32 witness is the first superblock
            (6 of 48 layers).
Then gemma3's 23.5 GB are freed, and the MoE and VLM families run:
  moe_vlm_kernels : both attention kernels on a GQA group-7 case (arctic's
            56 q heads over 8 kv heads) in fp32 and bf16, and at the
            prefill shapes of arctic-480b (4, 56, 8, 2048, 128), kimi-k2
            (4, 64, 8, 2048, 112) and internvl2-26b (4, 48, 8, 2048, 128)
            in bf16: kernel, plain and library times, the bound.
  moe     : arctic-480b at full width cut to its first 2 of 35 layers
            (every layer is the same block; the whole model is 953 GB):
            the dispatch slots of its layer 0's routing of 8192 random
            hidden states on the card equal their CPU result exactly, kept
            slots unique and in their expert's range; ``moe_local`` with
            no drops against ``moe_dense_oracle`` on 1024 tokens (relative
            max-norm 2e-2), a control whose combine weights are not
            renormalised over the k chosen must fail it; ``moe_local``
            timed at the prefill (8192) and decode (4) token counts, with
            each part's device time, against the bound of its expert
            products and expert weights.
  prefill : 4 x 2048 tokens, exactly 2 flash launches (2 chunked on the
            chunked path). Rounding moves router logits, and a token that
            takes another expert moves by O(1), so the kernel, chunked and
            control paths replay the plain prefill's expert choices
            (``routing``): last hidden state, every position's hidden
            state and every cached K/V row within phi3's 5e-2 of the plain
            prefill; the mask-one-ahead control must fail. The unforced
            run's routing agreement and drops are logged.
  decode  : 16 steps from 2048; layer 0's K/V at positions 2048-2063 equal
            a fresh prefill's of the 2064 tokens, a next-position control
            fails. Then profile, and serve as phi3's, request 0 in slot 0;
            the fp32 witness is layer 0 at full width, cast in place after
            the bf16 gates (55.4 GB in fp32 does not fit beside 54.9 GB of
            bf16).
Then kimi-k2-1t at full width, cut to 1 of 61 layers: moe (dispatch,
oracle, control, times), prefill (1 flash, 1 chunked launch), decode and
serve, gated as arctic's, but with no fp32 witness: one layer is 72.8 GB
in fp32, and with its largest bf16 leaf (11.3 GB) it does not fit the
card (the reckoning is logged). Then internvl2-26b at full width and depth: prefill of
4 x 2048 tokens whose first 256 positions are patch embeddings, exactly 48
flash (or chunked) launches, phi3's gates, the mask-one-ahead control and
a control whose patches are not spliced; decode, serve (fp32 witness of
its first 4 layers), profile.
Then internvl2's 38.6 GB are freed and whisper-small (encoder-decoder)
runs at full width and depth:
  whisper_kernels : both attention kernels against
            ``attention_kernel_ref`` on a non-causal case of 1500 keys
            (a ragged last tile of 28) and at whisper's three prefill
            shapes, fp32 (2e-5) and bf16 (2e-2): the encoder's non-causal
            (16, 12, 1500, 1500, 64), the decoder's causal (16, 12, 224,
            224, 64) and the cross-attention (16, 12, 224 queries, 1500
            keys, 64); kernel times in both dtypes, and in bf16 plain and
            library times, the bound of the pairs the mask shows.
  prefill : 16 clips of 1500 frames and a 224-token prompt each into a
            448-position cache: exactly 36 flash launches (12 encoder, 12
            decoder self, 12 cross), or 36 chunked ones on the chunked
            path; both paths' last hidden state and every cached K/V row
            (self over the prompt, cross over all 1500 frames) against the
            plain prefill, as phi3's; a control whose encoder attention is
            causal must fail the gate on ``k_cross``; the cross K/V of
            ``init_cache(params=, batch=)`` equal the prefill's.
  decode  : 16 steps from position 224; layer 0's self K/V equal a fresh
            prefill's of the 240 tokens, a next-position control fails.
  serve, profile : as for phi3; the fp32 witness has every layer. The
            engine gives the model no frames (as the reference's), so it
            decodes over zero cross K/V.
Each whisper phase, and every serve phase, logs its device memory
peak.
Then the card's name and power limit, one JSON line of kernel records
(each with its body per dtype, ``design``, its TFLOP/s and its share of
the bound), and the result line. Any failure raises and exits non-zero; without a
CUDA device it exits 1 before any phase.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import itertools
import json
import math
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from torch.utils import cpp_extension  # noqa: E402

from repro_torch.configs.dvbs2 import serving_preset  # noqa: E402
from repro_torch.control import (  # noqa: E402
    Governor, bursty_arrivals, fit_variant_multipliers, observations_from_run,
    run_serve_scenario, stage_info_from_plan)
from repro_torch.core.variants import VariantRegistry, VariantSpec  # noqa: E402
from repro_torch.energy.model import PowerModel  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_attention import chunked as ca  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_kernel_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential  # noqa: E402
from repro_torch.models import (  # noqa: E402
    attention, embedloss, layers, moe, ssm, transformer)
from repro_torch.models.config import get_config, get_smoke_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    MetricsRegistry, Tracer, attribute_energy, parse_rapl_log,
    to_chrome_events)
from repro_torch.pipeline import (  # noqa: E402
    H100_CLASS, HeterogeneousSystem, StageSpec, StreamingPipelineRuntime,
    plan_pipeline)
from repro_torch.pipeline.stages import model_stage_builder  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionPlanner, Request, ServeEngine, SimClock)
from repro_torch.serve.graph import CapturedStep  # noqa: E402

# b, hq, hkv, sq, skv, d, causal, window (tests/test_kernels.py FLASH_CASES;
# its Pallas block sizes do not apply to this kernel)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 4, 4, 96, 96, 32, True, 0),
    (1, 6, 2, 100, 100, 32, True, 0),        # ragged
    (2, 8, 2, 64, 192, 64, False, 0),        # cross attention
    (1, 4, 1, 256, 256, 32, True, 48),       # sliding window
    (1, 2, 2, 64, 64, 128, True, 0),
]
# non-causal with a window of 8 over 16 keys: query rows 23 to 63 see no
# key, and the kernels give them 0
NO_KEY_CASE = (1, 2, 1, 64, 16, 32, False, 8)
NO_KEY_FIRST = 23
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# phi3-medium-14b prefill: batch, q heads, kv heads, prompt, head dim
PHI3_ATTN = (4, 40, 10, 2048, 128)
CACHE_LEN = 2064
DECODE_STEPS = 16
# bf16 prefill through 40 layers: the kernel and the plain version round
# at different places (fp32 accumulate in a different order, bf16 outputs
# per layer), so the last hidden state agrees to a few bf16 ulps of its
# largest entry, not bit for bit
PREFILL_REL_TOL = 5e-2
# largest per-position relative L2 error of a layer's cached K or V (over
# Hkv x hd) against the plain prefill's, over all layers and positions. On
# an H100 the sound kernel reads 2.2e-2 and the control (causal mask one
# key ahead) 1.23, 0.44 over the late half of the positions
KV_REL_TOL = 5e-2
# gemma3-12b's prefill: batch, q heads, kv heads, prompt, head dim; its
# windowed layers' window. 4 x 2048 tokens, so that the rolling caches of
# the windowed layers really roll
GEMMA_ATTN = (4, 16, 8, 2048, 256)
GEMMA_WINDOW = 1024
# both kernels at head dim 256 beside the reference grid: a causal case
# whose q rows end inside the second block's first warpgroup, and the grid's
# sliding-window case widened (b, hq, hkv, sq, skv, d, causal, window)
D256_CASES = [(1, 4, 2, 160, 160, 256, True, 0),
              (1, 4, 1, 256, 256, 256, True, 48)]
# the fp32 serve witnesses' depth where fp32 weights of every layer do not
# fit beside the bf16 ones (phase_serve): phi3's first 4 of 40 layers
# (5.4 GB + a 2.1 GB table beside 28 GB); gemma3's first superblock, 6 of
# 48 (5.4 GB + a 4.0 GB table beside 23.5 GB)
PHI3_WITNESS_LAYERS = 4
GEMMA_WITNESS_LAYERS = 6
# zamba2-7b's shared-attention prefill: batch, q heads, kv heads, prompt,
# head dim (3584 / 32 = 112)
ZAMBA_ATTN = (4, 32, 32, 2048, 112)
# the SSD layer shapes at full width (batch, prompt; heads, head dim, state
# and chunk come from each config)
SSD_ARCHS = ("zamba2-7b", "mamba2-1.3b")
SSD_BATCH, SSD_LEN = 4, 2048
# b, l, h, p, n, chunk (tests/test_kernels.py test_ssd_kernel)
SSD_CASES = [
    (2, 64, 4, 16, 8, 16),
    (1, 100, 2, 32, 16, 32),
    (2, 37, 3, 8, 8, 64),
    (1, 128, 1, 64, 32, 128),
]
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# a chunk wider than 256 and a ragged last chunk (700 = 512 + 188). Its
# outputs reach ~40, where the absolute limits above sit below the noise
# of exact arithmetic: the port's own blocked fp32 scan (ssm.ssd_ref)
# differs from the sequential recurrence there by more than 1e-4 in fp32
# and, rounded to bf16, by a whole ulp (0.0625 at |y| >= 8; both logged
# as plain_blocked_*). So it is held at the relative max-norm of its
# largest output: fp32 at SSD_TOL's 1e-4, bf16 at the full-width limits
# below; the absolute errors are logged beside them.
WIDE_CASE = (2, 700, 4, 64, 128, 512)
# head and state dims that are multiples of 4 but not of 8: rows of 24 and
# 40 bytes, which the bf16 body gathers element by element instead of
# copying in 16-byte pieces; held like WIDE_CASE
UNALIGNED_CASE = (1, 90, 3, 12, 20, 32)
# relative max-norm limits of the kernel at the full-width shapes against
# its plain version on the same bf16 inputs: y is rounded to bf16 (2^-8 =
# 3.9e-3 of its largest entries), the state stays fp32
SSD_Y_REL_TOL, SSD_STATE_REL_TOL = 1e-2, 1e-3
# zamba2's prefill through 81 Mamba2 layers and 13 shared-attention
# applications in bf16 is 8.5e-2 to 1.1e-1 (last hidden state, relative
# max-norm) from an fp32 prefill of the same weights on every path, the
# plain one included, and two plain paths that round attention at other
# places differ by 5.8e-2 (the logged paths of phase_zamba_prefill, NVIDIA
# H100 80GB HBM3, 700 W): below that noise floor a bf16-against-bf16 limit
# cannot tell a sound kernel from a faulty one. So each bf16 path is held
# against the fp32 prefill, to within BF16_RATIO_TOL times the plain bf16
# path's own error there (on the same card the sound paths read 0.81-1.33,
# the dropped-carry control 6.3-15.3; seeded data and deterministic
# kernels read the same on every run); and the same prefill in fp32,
# through the fp32 kernels, is held against the plain fp32 prefill at
# FP32_REL_TOL, on the last hidden state and every cache leaf's per-vector
# relative L2 (the sound paths read 4.7e-5 to 2.2e-4, the control 0.53 to
# 6.4; the limit is ~10x the sound maximum)
BF16_RATIO_TOL = 1.5
FP32_REL_TOL = 2e-3
# trailing dims of each zamba2 cache leaf that form one gated vector: K/V
# per (layer, lane, position) over Hkv x hd; conv inputs per (layer, lane,
# position) over di + 2N; SSM states per (layer, lane, head) over P x N
LEAF_VEC_DIMS = {"k_shared": 2, "v_shared": 2, "conv": 1, "conv_tail": 1,
                 "state": 2, "state_tail": 2}
PLAIN_REPS_SLOW = 5              # the sequential SSD recurrence, 2048 steps
# dense bf16 tensor-core FLOP/s and HBM bytes/s of the one card this script
# knows (NVIDIA's data sheet, SXM part, 700 W); any other card is refused
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}
# the body each kernel runs per dtype: "wgmma" (Hopper's warpgroup MMA on
# the tensor cores), "simt" (fp32 multiply-adds on the CUDA cores)
ATTN_DESIGN = {"float32": "simt", "bfloat16": "wgmma"}
SSD_DESIGN = {"float32": "simt",
              "bfloat16": "wgmma, four chunk-parallel phases"}
# the bf16 SSD body's CUDA kernels, in launch order: chunk cumsums, chunk
# states, the scan over chunks, outputs; the middle two of them multiply
SSD_PHASES = ("ssd_seg", "ssd_states", "ssd_pass", "ssd_out")
SSD_MMA = ("ssd_states", "ssd_out")
# a kernel's mangled SASS name: its name, then its template arguments where
# it has some (f: fp32, 13__nv_bfloat16: bf16, Li<d>E: the head dim or the
# padded state dim)
# the CUDA API calls (cuda*, and the lower-level cu*) that put work on
# the device
HOST_LAUNCH = re.compile(r"cu(da)?(LaunchKernel|LaunchCooperativeKernel|"
                         r"GraphLaunch|Memcpy|Memset)")
SASS_FN = re.compile(r"(flash_fwd_tc|chunked_fwd_tc|flash_fwd|chunked_fwd|"
                     r"ssd_fwd|ssd_seg|ssd_states|ssd_pass|ssd_out)"
                     r"(?:I(\w*?)EEv|E)")
# the MoE and VLM families: each architecture's depth on the card (the MoE
# models at full width, every layer the same block, cut to what fits one
# 80 GB card: arctic 27,451,755,520 parameters, 54.9 GB in bf16; kimi
# 18,204,218,368, 36.4 GB; internvl2 whole, 38.6 GB) and its prefill
# attention shape (batch, q heads, kv heads, prompt, head dim)
MOE_VLM_DEPTH = {"arctic-480b": 2, "kimi-k2-1t-a32b": 1, "internvl2-26b": 48}
MOE_VLM_ATTN = {"arctic-480b": (4, 56, 8, 2048, 128),
                "kimi-k2-1t-a32b": (4, 64, 8, 2048, 112),
                "internvl2-26b": (4, 48, 8, 2048, 128)}
# arctic's GQA group (56 / 8 = 7), a group no earlier path ran, on a small
# causal case (b, hq, hkv, sq, skv, d, causal, window)
GQA7_CASE = (1, 14, 2, 256, 256, 128, True, 0)
# MoE layer: tokens of the no-drop check against the per-expert oracle and
# its relative max-norm limit (bf16 products rounded at other places); the
# prefill (4 x 2048) and decode (4 slots) token counts it is timed at
MOE_ORACLE_T, MOE_REL_TOL = 1024, 2e-2
MOE_TIMED_T = (8192, 4)
# the fp32 serve witnesses: arctic's layer 0 (55.4 GB in fp32, built in
# place of the bf16 weights); internvl2's first 4 of 48 layers (8.5 GB)
ARCTIC_WITNESS_LAYERS = 1
VLM_WITNESS_LAYERS = 4
# an fp32 witness is built only where it needs at most this share of the
# card (witness_fits); kimi-k2's one layer does not fit
WITNESS_HEADROOM = 0.9
# the serve phase's engine steps traced by torch.profiler, every slot
# streaming its prompt (prompts are 32-64 tokens)
PROFILED_STEPS = (8, 9, 10, 11)
# whisper-small at full width and depth (encoder-decoder, 0.6 GB in bf16):
# a batch of 16 clips of 1500 encoder frames, a decoder prompt of 224
# tokens and whisper's decoder context of 448 positions
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_CACHE_LEN = 16, 224, 448
# both kernels, non-causal over a ragged last key tile (1500 = 23 * 64 +
# 28) beside whisper's own shapes (b, hq, hkv, sq, skv, d, causal, window)
WHISPER_CASES = [(1, 4, 4, 100, 1500, 64, False, 0)]
# the governed-serving scenario, with the constants of
# examples/serve_pipeline.py, and the smoke model of its CPU replay
GOV_PLATFORM = "mac"
GOV_TIME_SCALE = 2e-6            # engine seconds per chain µs
GOV_SAFETY = 1.5                 # admission derate, > the 1.3x inflation
GOV_WINDOWS = 10
GOV_INFLATION_AT = ((6, 1.3),)   # steps run 1.3x slower from window 6 on
GOV_NEW_TOKENS = 8               # bursty_arrivals' max_new_tokens
GOV_REPLAY_ARCH = "stablelm-3b"
# the pipeline phase: phi3's 44-task chain (ingest, embed, 40 layers, head,
# emit) planned by the port's planner with both device classes the card
# (H100_CLASS: datasheet rates) and run by the port's streaming runtime.
# Frames are 1 x 2048 tokens, drawn from a pool of PIPE_POOL distinct
# frames (each held against its monolithic prefill). Plan A (one stage)
# runs at least PIPE_STEADY_S of frames while nvidia-smi samples the
# card's power every PIPE_POWER_MS
PIPE_TOKENS = 2048
PIPE_POOL = 8
PIPE_STEADY_S, PIPE_MIN_STEADY_S = 7.0, 5.0
PIPE_FRAMES_B, PIPE_FRAMES_C, PIPE_FRAMES_FIT = 48, 24, 16
PIPE_POWER_MS = 100
# Plan B on (2 big, 2 little), both the card: the reference's planner gives
# three stages, the middle one two replicas (tests/test_torch_pipeline.py)
PIPE_B = (2, 2)
# a bf16 GEMM (M = N = K) and a device-to-device copy (bytes) that time the
# card's reachable rates beside the class's datasheet ones
RATE_GEMM, RATE_COPY_BYTES = 8192, 1 << 30
SEED = 0
DEVICE = "cuda"


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def require(ok, what) -> None:
    """A gate of the run: raise (exit non-zero) when it does not hold."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def qkv(gen, b, hq, hkv, sq, skv, d, dtype):
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) as transposed views of
    (B, S, H, D) tensors, the layout the model hands the kernel."""
    def make(s, h):
        return torch.randn((b, s, h, d), generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype).transpose(1, 2)
    return make(sq, hq), make(skv, hkv), make(skv, hkv)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def library_ms(q, k, v, window: int = 0, causal: bool = True) -> float:
    """One PyTorch call computing the same function (causal or unmasked,
    and with a ``window`` its causal mask as a boolean ``attn_mask``),
    timed as a yardstick; the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                    enable_gqa=True))
    pos = torch.arange(q.shape[2], device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    return time_ms(lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True))


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuobjdump(flag: str) -> str:
    """``cuobjdump <flag>`` of the built extension."""
    lib = build.BUILD_DIR / "repro_torch_kernels.so"
    tool = Path(cpp_extension.CUDA_HOME or "/usr/local/cuda") / "bin" / \
        "cuobjdump"
    return subprocess.run([str(tool), flag, str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def kernel_name(line: str) -> str:
    """The readable name (``name<dtype[, dim]>``) of the kernel whose
    mangled name a cuobjdump ``Function`` line holds."""
    fn = SASS_FN.search(line)
    args = (fn.group(2) if fn else "") or ""
    dtype = "float32" if args.startswith("f") else "bfloat16"
    dim = re.search(r"Li(\d+)E", args + "E")
    return f"{fn.group(1) if fn else line.split()[-1]}<{dtype}" + (
        f", {dim.group(1)}>" if dim else ">")


def resource_usage() -> dict[str, dict[str, int]]:
    """Registers a thread, stack bytes and local memory bytes (where
    ptxas spills) of every kernel of the built extension, by readable
    name (``cuobjdump -res-usage``)."""
    usage, name = {}, None
    for line in cuobjdump("-res-usage").splitlines():
        if "Function " in line:
            name = kernel_name(line)
        elif name is not None and "REG:" in line:
            usage[name] = {k: int(v) for k, v in
                           re.findall(r"\b(REG|STACK|LOCAL):(\d+)", line)}
            name = None
    return usage


def sass_mma_counts() -> dict[str, dict[str, int]]:
    """Tensor-core instructions (HGMMA: warpgroup MMA; HMMA: warp MMA) in
    the SASS of every kernel of the built extension, by readable name."""
    counts, name = {}, None
    for line in cuobjdump("-sass").splitlines():
        if "Function : " in line:
            name = kernel_name(line)
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += f" {op}." in line
    return counts


def phase_build() -> dict[str, dict[str, int]]:
    t0 = time.perf_counter()
    build.extension(verbose=True)
    seconds = time.perf_counter() - t0
    counts = sass_mma_counts()
    bodies = [k for k in counts if k.split("<")[0] in
              ("flash_fwd_tc", "chunked_fwd_tc")]
    require(len(bodies) == 2 * len(fa.HEAD_DIMS),
            f"bf16 attention bodies in the SASS: {bodies}")
    require(all(counts[k]["HGMMA"] > 0 for k in bodies),
            f"a bf16 attention body without tensor-core instructions: "
            f"{counts}")
    ssd = {k: v for k, v in counts.items() if k.startswith("ssd_")}
    mma = [k for k in ssd if k.split("<")[0] in SSD_MMA]
    require(len(mma) == 4 and all(ssd[k]["HGMMA"] > 0 for k in mma),
            f"the bf16 SSD kernels that multiply (at padded state dims 64 "
            f"and 128) must all hold HGMMA: {ssd}")
    simt = [k for k in ssd if k.startswith("ssd_fwd")]
    require(simt == ["ssd_fwd<float32>"]
            and ssd[simt[0]] == {"HGMMA": 0, "HMMA": 0},
            f"the CUDA-core SSD body must exist for fp32 only: {ssd}")
    usage = resource_usage()
    d256 = [f"{k}_tc<bfloat16, 256>" for k in ("flash_fwd", "chunked_fwd")] \
        + [f"{k}<float32, 256>" for k in ("flash_fwd", "chunked_fwd")]
    require(all(k in usage for k in d256),
            f"the attention kernels at head dim 256: {sorted(usage)}")
    log(phase="build", seconds=seconds,
        sources=[str(s.relative_to(Path(__file__).resolve().parent))
                 for s in build.SOURCES], sass_mma=counts,
        registers_stack_local=usage)
    return usage


def attention_cases(gen, added, kernel, name: str) -> dict[str, float]:
    """An attention kernel against its plain version on the reference
    cases (inputs from ``gen``) and the no-key case (from ``added``), fp32
    and bf16; the rows that see no key must be exactly 0."""
    errs = {}
    for case in FLASH_CASES + [NO_KEY_CASE]:
        b, hq, hkv, sq, skv, d, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(added if case == NO_KEY_CASE else gen, b, hq, hkv,
                          sq, skv, d, dtype)
            out = kernel(q, k, v, causal=causal, window=window)
            ref = attention_kernel_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            require(out.shape == (b, hq, sq, d), (name, case, out.shape))
            require(err < TOL[dtype], (name, case, dtype, err))
            if case == NO_KEY_CASE:
                require(bool((out[:, :, NO_KEY_FIRST:] == 0).all()),
                        f"{name}: a row that sees no key is not 0")
            errs[f"{case}/{str(dtype)[6:]}"] = err
    return errs


def phase_kernel(gen, added, peaks: tuple[float, float]) -> dict:
    errs = attention_cases(gen, added, fa.flash_attention_cuda, "flash")

    b, hq, hkv, s, d = PHI3_ATTN
    q, k, v = qkv(gen, b, hq, hkv, s, s, d, torch.bfloat16)
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    ref = attention_kernel_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    require(torch.isfinite(out).all() and err < TOL[torch.bfloat16],
            f"phi3-shape kernel error {err}")
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_kernel_ref(q, k, v, causal=True),
                       reps=20)
    lib_ms = library_ms(q, k, v)
    flops, nbytes = attn_work(b, hq, hkv, s, d)
    rec = kernel_record("flash_attention", "flash_attention/csrc/"
                        "flash_attention.cu", "flash_attention/kernel.py:109",
                        err, ms, plain_ms, lib_ms, flops, nbytes, peaks,
                        ATTN_DESIGN)
    log(phase="kernel", cases=len(errs), max_abs_err_cases=errs,
        shape=list(PHI3_ATTN), dtype="bfloat16", causal=True,
        **{k: v for k, v in rec.items() if k != "launches"})
    return rec


def attn_work(b, hq, hkv, s, d, window: int = 0, *, skv: int | None = None,
              causal: bool = True) -> tuple[int, int]:
    """(flops, bytes) of prefill attention of S queries over ``skv`` keys
    (default S): 4 D flops (q.k and p.v) for each (query, key) pair the
    mask shows, per batch and q head: S (S + 1) / 2 causal pairs, fewer
    under a ``window`` of w (w (w + 1) / 2 + (S - w) w), S x Skv without
    the causal mask; q, o, k, v each moved once in bf16."""
    skv = s if skv is None else skv
    if causal:
        w = min(window or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w
    else:
        pairs = s * skv
    return 4 * b * hq * pairs * d, 2 * b * d * (2 * hq * s + 2 * hkv * skv)


def bound(flops, nbytes, peaks) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the
    operations over the bf16 tensor-core peak and the bytes over the
    memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / peaks[0], nbytes / peaks[1]
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def kernel_record(name, source, replaces, err, ms, plain_ms, lib_ms, flops,
                  nbytes, peaks, design) -> dict:
    """One entry of the kernels line; ``launches`` is filled in by the main
    path's run. ``tflops`` is the algorithm's work over the kernel's time,
    ``share_of_bound`` the bound over the kernel's time."""
    bound_ms, bound_by = bound(flops, nbytes, peaks)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/" + source,
            "replaces": "src/repro/kernels/" + replaces,
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "design": design,
            "tflops": flops / ms / 1e9, "share_of_bound": bound_ms / ms}


def slot_positions(s: int, slots: int, device) -> torch.Tensor:
    """The position each cache slot holds after a prefill of ``s`` tokens:
    rows 0..s-1 of a full leaf, or the last ``slots`` positions of a
    rolling leaf shorter than ``s``, position p at slot p % slots."""
    if slots >= s:
        return torch.arange(s, device=device)
    j = torch.arange(slots, device=device)
    return s - slots + torch.remainder(j - s, slots)


def kv_rel_err(cache, ref, s: int, rows: dict | None = None
               ) -> tuple[float, float, str]:
    """Largest per-position relative L2 error (over Hkv x hd) of every
    cached K/V row of every layer against ``ref``'s, the rolling leaves in
    their rolled order, over layers, lanes and positions: (all positions,
    the late half of the prompt, the worst leaf and layer). A leaf named
    in ``rows`` holds that many rows (an encoder-decoder's cross K/V: the
    frames), the others the prompt's ``s``."""
    worst, late, where = 0.0, 0.0, ""
    for key in cache:
        if key == "pos":
            continue
        leaf, other = cache[key], ref[key]
        n = (rows or {}).get(key, s)
        layers = leaf.reshape(-1, *leaf.shape[-4:])
        others = other.reshape(-1, *other.shape[-4:])
        pos = slot_positions(n, leaf.shape[-3], leaf.device)
        is_late = pos >= n // 2
        for i in range(layers.shape[0]):
            a = layers[i, :, :len(pos)].float().flatten(2)
            b = others[i, :, :len(pos)].float().flatten(2)
            e = (a - b).norm(dim=-1) / b.norm(dim=-1)
            if float(e.max()) > worst:
                worst, where = float(e.max()), f"{key}[{i}]"
            if bool(is_late.any()):
                late = max(late, float(e[:, is_late].max()))
    return worst, late, where


@contextlib.contextmanager
def prefill_attention(fn):
    """Every prefill attention call of the model replaced by ``fn(q, k, v,
    causal, window)``: a control."""
    saved = transformer.context_attention
    transformer.context_attention = \
        lambda q, k, v, *, causal, window, impl: fn(q, k, v, causal, window)
    try:
        yield
    finally:
        transformer.context_attention = saved


def causal_mask_one_ahead():
    """The control: prefill attention (plain chunked) whose causal mask
    lets every query see the key one position ahead, the off-by-one a
    faulty kernel could make."""
    return prefill_attention(
        lambda q, k, v, causal, window: attention.flash_attention_xla(
            q, k, v, causal=causal, window=window, q_offset=1))


def window_ignored():
    """The control: prefill attention (plain chunked) whose sliding-window
    layers see every earlier key (window 0), a kernel or model that drops
    the window."""
    return prefill_attention(
        lambda q, k, v, causal, window: attention.flash_attention_xla(
            q, k, v, causal=causal, window=0))


def phase_prefill(gen, rec: dict):
    cfg = get_config("phi3-medium-14b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_only_peak = torch.cuda.max_memory_allocated()
    b, _, _, s, _ = PHI3_ATTN
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    model.prefill(params, batch, CACHE_LEN)          # warm-up
    torch.cuda.synchronize()
    # the peak of init and the warm-up prefill; the timed prefill's own
    # peak is read apart
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    fa.launches = 0
    t0 = time.perf_counter()
    cache, last = model.prefill(params, batch, CACHE_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = fa.launches
    require(launches == cfg.n_layers, f"{launches} kernel launches")
    rec["launches"] = launches

    plain = Model(dataclasses.replace(cfg, attn_impl="xla_flash"))
    plain_cache, plain_last = plain.prefill(params, batch, CACHE_LEN)
    with causal_mask_one_ahead():
        ctrl_cache, ctrl_last = plain.prefill(params, batch, CACHE_LEN)
    torch.cuda.synchronize()

    def last_rel(x):
        return max_err(x, plain_last) / float(plain_last.float().abs().max())

    rel, ctrl_rel = last_rel(last), last_rel(ctrl_last)
    kv, kv_late, kv_layer = kv_rel_err(cache, plain_cache, s)
    ctrl_kv, ctrl_kv_late, _ = kv_rel_err(ctrl_cache, plain_cache, s)
    del plain_cache, ctrl_cache
    require(last.shape == (b, cfg.d_model) and torch.isfinite(last).all(),
            "last hidden state shape or finiteness")
    require(rel <= PREFILL_REL_TOL,
            f"prefill relative error {rel} > {PREFILL_REL_TOL}: more than "
            "bf16 rounding at different places over 40 layers explains")
    require(kv <= KV_REL_TOL,
            f"prefilled K/V relative error {kv} (layer {kv_layer}) > "
            f"{KV_REL_TOL}: more than bf16 rounding explains")
    require(min(ctrl_kv, ctrl_kv_late) > KV_REL_TOL,
            f"the control (causal mask one key ahead) reads {ctrl_kv}, "
            f"{ctrl_kv_late} over the late half, not above {KV_REL_TOL}: "
            "the K/V gate cannot see an off-by-one mask")
    log(phase="prefill", arch=cfg.name, params=sum(
        t.numel() for t in [params["embed"], params["ln_final"],
                            *params["layers"].values()]),
        init_s=init_s, batch=b, prompt=s, cache_len=CACHE_LEN,
        prefill_s=prefill_s, prefill_tokens_per_s=b * s / prefill_s,
        flash_attention_launches=launches, rel_err_vs_plain=rel,
        rel_err_limit=PREFILL_REL_TOL, control_rel_err=ctrl_rel,
        kv_rel_err=kv, kv_rel_err_late_half=kv_late, kv_worst_layer=kv_layer,
        kv_rel_err_limit=KV_REL_TOL, control_kv_rel_err=ctrl_kv,
        control_kv_rel_err_late_half=ctrl_kv_late,
        init_peak_mem_gb=init_peak / 1e9,
        init_only_peak_mem_gb=init_only_peak / 1e9,
        prefill_peak_mem_gb=prefill_peak / 1e9)
    return cfg, model, params, cache, last


@contextlib.contextmanager
def widened():
    """The bf16 decode products as the code computed them before the
    fused path: every operand widened to an fp32 copy first (greedy's
    table, decode attention's K/V cache), then an fp32 product."""
    saved = attention.fused_f32, layers.fused_f32
    attention.fused_f32 = layers.fused_f32 = lambda *ts: False
    try:
        yield
    finally:
        attention.fused_f32, layers.fused_f32 = saved


def phase_decode(cfg, model, params, cache, last, prompt: int):
    """``DECODE_STEPS`` greedy steps from a prefilled cache, timed one by
    one; returns the tokens (B, DECODE_STEPS + 1), the first from the
    prefill's last hidden state. A copy of the cache then decodes the same
    tokens with the products widened (``widened``): the count of its
    greedy tokens that differ from these is logged, not gated (the fused
    products sum the same bf16 products in another order)."""
    copy = {key: leaf.clone() for key, leaf in cache.items()}
    tok = embedloss.greedy(last, params["embed"], valid_vocab=cfg.vocab)
    toks, times = [tok], []
    for _ in range(DECODE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, cache = model.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        toks.append(tok)
    toks = torch.stack(toks, dim=1)
    require(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
            "a decoded token outside the vocab")
    require(bool((cache["pos"] == prompt + DECODE_STEPS).all()),
            "cache positions after decode")
    with widened():
        wide = [embedloss.greedy(last, params["embed"],
                                 valid_vocab=cfg.vocab)]
        for i in range(DECODE_STEPS):     # fed the fused run's tokens
            wide.append(model.decode_step(params, copy, toks[:, i])[0])
    del copy
    differ = torch.stack(wide, dim=1) != toks
    log(phase="decode", arch=cfg.name, batch=toks.shape[0],
        steps=DECODE_STEPS,
        step_ms_p50=statistics.median(times) * 1e3,
        step_ms_max=max(times) * 1e3, tokens=toks[0].tolist(),
        widened_tokens_differ=int(differ.sum()),
        widened_tokens_compared=differ.numel(),
        widened_first_differing_step=(int(differ.any(0).nonzero()[0])
                                      if differ.any() else None))
    return toks


def solo_tokens(model, params, prompt, slots: int, max_len: int = 128,
                eager: bool = False) -> list[int]:
    """Request 0 served alone by an engine of ``slots`` slots, in slot 0:
    by the captured step, or ``eager``ly."""
    solo = ServeEngine(model, params, batch_slots=slots, max_len=max_len)
    if eager:
        solo._step = model.decode_step
    alone = Request(rid=0, prompt=prompt, max_new_tokens=16)
    solo.submit(alone)
    solo.step()
    require(solo.slots[0] is alone, "a solo request is not in slot 0")
    solo.run_until_idle()
    return alone.out


def first_diff(a, b):
    """The first index where two token lists differ, or None."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def fp32_witness(cfg, params, n_layers: int | None, in_place=False):
    """An fp32 model of the first ``n_layers`` layers (all with None) and
    its weights: the bf16 weights cut along their stack dims to that
    depth and cast (bf16 -> fp32 is exact). Full width: every layer's
    shapes, the embedding table and the final norm are the model's.

    ``in_place``: the weights are built inside ``params``, which is
    consumed, for a witness that does not fit beside the bf16 weights
    (arctic's layer 0: 55.4 GB): first every leaf is cut to its depth (the
    deeper layers freed), then cast one leaf at a time, each bf16 leaf
    freed as its fp32 copy lands, so the peak is the fp32 weights plus
    the largest bf16 leaf."""
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32",
                                n_layers=n_layers or cfg.n_layers)
    m32 = Model(cfg32)
    shapes = m32.param_shapes()

    def cut(t, shape):
        return t[tuple(slice(0, n) for n in shape)]

    if not in_place:
        return m32, {g: ({k: cut(params[g][k], sh).float()
                          for k, sh in sub.items()}
                         if isinstance(sub, dict)
                         else cut(params[g], sub).float())
                     for g, sub in shapes.items()}
    leaves = []
    for g, sub in shapes.items():
        if isinstance(sub, dict):
            leaves += [(params[g], k, sh) for k, sh in sub.items()]
        else:
            leaves.append((params, g, sub))
    for tree, k, sh in leaves:
        if tuple(tree[k].shape) != tuple(sh):
            tree[k] = cut(tree[k], sh).clone()
    for tree, k, _ in leaves:
        tree[k] = tree[k].float()
    return m32, params


def serve_run(model, params, prompts, eager: bool) -> tuple[list, dict]:
    """The requests through a 4-slot engine, by the captured step (the
    engine's own on CUDA) or ``eager``ly (``engine._step =
    model.decode_step``). Each step is timed on the host; each ends in the
    copy of its tokens to the host. The first step holds the capture, so
    it is logged apart; engine steps ``PROFILED_STEPS`` (every slot
    streaming a prompt) run under the profiler and are left out of the
    step times, and of the wall time all but the traced steps' own wall
    time. Returns the requests and the arm's record."""
    engine = ServeEngine(model, params, batch_slots=4, max_len=128)
    if eager:
        engine._step = model.decode_step
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    times, prof, first_admit = [], None, None
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    while engine.queue or any(r is not None for r in engine.slots):
        if len(times) == PROFILED_STEPS[0] and prof is None:
            tp = time.perf_counter()
            prof = _profile(lambda: [engine.step()
                                     for _ in range(len(PROFILED_STEPS))])
            # the profiler's set-up and trace processing are not serving
            untraced = time.perf_counter() - tp - prof["wall_ms"] / 1e3
            continue
        ts = time.perf_counter()
        engine.step()
        times.append(time.perf_counter() - ts)
        if first_admit is None:
            first_admit = {r.rid for r in reqs if r.admitted_s is not None}
            require(engine.slots[0] is reqs[0], "request 0 is not in slot 0")
            held = torch.cuda.memory_allocated() - held
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - untraced
    del engine
    require(all(r.done and len(r.out) == 16 for r in reqs),
            "a request did not finish with 16 tokens")
    require(all(0 <= t < model.cfg.vocab for r in reqs for t in r.out),
            "a served token outside the vocab")
    mid_run = [r.rid for r in reqs if r.rid not in first_admit]
    require(mid_run, "no request was admitted mid-run")
    n = len(PROFILED_STEPS)
    steady = times[1:]
    return reqs, {
        "steps": len(times) + n, "wall_s": wall,
        "requests_per_s": len(reqs) / wall,
        "tokens_per_s": 16 * len(reqs) / wall,
        "first_step_s": times[0],
        "requests_per_s_after_first_step": len(reqs) / (wall - times[0]),
        "step_ms_p50": statistics.median(steady) * 1e3,
        "step_ms_max": max(steady) * 1e3,
        "first_step_mem_held_gb": held / 1e9,
        "admitted_mid_run": mid_run,
        "profile_steps": list(PROFILED_STEPS),
        "idle_share": prof["idle_share"],
        "device_busy_ms_per_step": prof["device_busy_ms"] / n,
        "device_ops_per_step": prof["device_ops"] / n,
        "host_launches_per_step": prof["host_launches"] / n,
        "wall_ms_per_profiled_step": prof["wall_ms"] / n}


def witness_fits(cfg, params, n_layers: int | None, in_place: bool) -> dict:
    """Whether the fp32 witness can be built, reckoned before building it:
    beside the bf16 weights, its fp32 weights must fit in what is free;
    ``in_place``, its fp32 weights plus the largest bf16 leaf (the peak of
    the leaf-by-leaf cast) must fit in what is free plus the bf16 weights
    it consumes (free: the card's, and what the allocator holds unused).
    Both within ``WITNESS_HEADROOM`` of the card, for the allocator's
    fragmentation among leaves of several GB."""
    m32 = Model(dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers))
    sizes = [math.prod(sh) for sub in m32.param_shapes().values()
             for sh in (sub.values() if isinstance(sub, dict) else [sub])]
    bf16 = sum(t.numel() * t.element_size() for g in params.values()
               for t in (g.values() if isinstance(g, dict) else [g]))
    free, total = torch.cuda.mem_get_info()
    free += torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    need = 4 * sum(sizes) + (2 * max(sizes) if in_place else 0)
    room = free + (bf16 if in_place else 0) - (1 - WITNESS_HEADROOM) * total
    return {"fits": need <= room, "need_gb": need / 1e9,
            "room_gb": room / 1e9, "card_gb": total / 1e9}


def phase_serve(gen, cfg, model, params, witness_layers=None,
                in_place=False) -> None:
    """Six requests through four slots, by the captured step and again
    eagerly: every request's tokens must be equal in the two arms (the
    replay runs the eager step's kernels on the same addresses), through
    the mid-run admissions and lane resets. Request 0 must get the tokens
    it gets served alone by an engine of the same four slots, captured and
    eager alike: in bf16 the different rounding of cuBLAS's M=1 and M=4
    GEMMs turns into other greedy tokens within a few steps (on zamba2,
    and on phi3 and gemma3 for some prompts), so a 1-slot solo run is
    only logged, while with four slots in both runs lane 0's rows meet the
    same kernels and only a leak from the other lanes' admissions and
    resets can change its tokens. An fp32 witness, where that rounding is
    2^16 times finer, must give equal tokens served alone by one and by
    four slots, and its eager 4-slot run the same, so that a fault of one
    slot alone cannot hide behind the rounding. It runs at full width and,
    where fp32 weights of every layer do not fit beside the bf16 ones,
    over the first ``witness_layers`` layers: the one cut of this phase
    (phi3: 4 of 40 layers; gemma3: one superblock, 6 of 48; zamba2,
    mamba2 and whisper: every layer; arctic: layer 0, built ``in_place`` of the bf16
    weights after the bf16 gates, so ``params`` is consumed; internvl2: 4
    of 48). Where even that does not fit (``witness_fits``: kimi-k2's one
    layer is 72.8 GB in fp32, and its largest bf16 leaf 11.3 GB), there is
    no witness, and the reckoning is logged.

    Request 0 is admitted to slot 0 (the first free slot) in every run.
    In a MoE layer a decode step's tokens share each expert's capacity of
    C = 1 in (slot, choice) order, so slot 0's assignments are never
    dropped and its tokens do not depend on what the other slots hold."""
    solo_slots = 4
    lens = torch.randint(32, 65, (6,), generator=gen, device=DEVICE).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=DEVICE).tolist() for n in lens]
    reqs, captured = serve_run(model, params, prompts, eager=False)
    eager_reqs, eager = serve_run(model, params, prompts, eager=True)
    for r, e in zip(reqs, eager_reqs):
        require(r.out == e.out,
                f"{cfg.name}: request {r.rid}'s captured tokens differ from "
                f"the eager engine's from token {first_diff(r.out, e.out)}")

    extra = {}
    one = solo_tokens(model, params, prompts[0], 1)
    extra["one_slot_solo_equal"] = one == reqs[0].out
    extra["one_slot_solo_first_diff"] = first_diff(one, reqs[0].out)
    solo = solo_tokens(model, params, prompts[0], solo_slots)
    require(solo == reqs[0].out,
            f"the first request's tokens differ from its solo run "
            f"({solo_slots} slots) from token "
            f"{first_diff(solo, reqs[0].out)}")
    solo_eager = solo_tokens(model, params, prompts[0], solo_slots,
                             eager=True)
    require(solo_eager == solo,
            f"{cfg.name}: request 0's captured solo run differs from the "
            f"eager one from token {first_diff(solo, solo_eager)}")
    torch.cuda.reset_peak_memory_stats()
    fit = witness_fits(cfg, params, witness_layers, in_place)
    extra["fp32_witness_reckoning"] = fit
    if fit["fits"]:
        m32, p32 = fp32_witness(cfg, params, witness_layers, in_place)
        extra["fp32_witness_build_peak_mem_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        one32, four32, eager32 = (
            solo_tokens(m32, p32, prompts[0], n, eager=e)
            for n, e in ((1, False), (solo_slots, False),
                         (solo_slots, True)))
        del p32
        extra["fp32_witness_layers"] = m32.cfg.n_layers
        extra["fp32_one_slot_solo_first_diff"] = first_diff(one32, four32)
        extra["fp32_solo_tokens"] = four32
        require(one32 == four32,
                f"fp32 witness ({m32.cfg.n_layers} of {cfg.n_layers} "
                f"layers): solo runs with 1 and {solo_slots} slots part at "
                f"token {extra['fp32_one_slot_solo_first_diff']}")
        require(eager32 == four32,
                f"fp32 witness: the captured {solo_slots}-slot solo run "
                f"differs from the eager one from token "
                f"{first_diff(four32, eager32)}")
    else:
        extra["fp32_witness_layers"] = 0
    log(phase="serve", arch=cfg.name, requests=len(reqs), prompt_lens=lens,
        captured=captured, eager=eager, captured_equals_eager=True,
        first_request_equals_solo=True, solo_slots=solo_slots,
        solo_captured_equals_eager=True, **extra)


def _profile(fn) -> dict:
    """Device time of ``fn`` from a torch.profiler trace: the union of the
    CUDA activity intervals against the host's wall time (the profiler's
    own host overhead is in the wall time), the top kernels by device
    time, and the host's launches (CUDA API calls that launch a kernel, a
    copy, a fill or a graph): a graph's kernels show on the device one by
    one, but cost the host one launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device activity only: the ranges ``moe_local`` opens (user
    # annotations) also show on the device's timeline, spanning kernels
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    launches = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and HOST_LAUNCH.match(e.name))
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_ops": len(spans),
            "host_launches": launches,
            "top_ms": [[name, t / 1e3] for name, t in top]}


def phase_profile(gen, cfg, model, params, b: int, s: int,
                  extra: dict | None = None, cache_len: int = CACHE_LEN
                  ) -> None:
    """One prefill of ``b`` x ``s`` random tokens (plus ``extra`` inputs,
    an encoder-decoder's frames), four eager decode steps and then four
    replays of the same step captured as a CUDA graph (the serving
    engine's ``CapturedStep``; its capture, with its warm-up, is timed
    apart), each traced."""
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=DEVICE), **(extra or {})}
    out = {}
    prefill = _profile(lambda: out.update(
        res=model.prefill(params, batch, cache_len)))
    cache, last = out["res"]
    tok = embedloss.greedy(last, params["embed"], valid_vocab=cfg.vocab)
    decode = _profile(lambda: [model.decode_step(params, cache, tok)
                               for _ in range(4)])
    step = CapturedStep(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["tok"] = step(params, cache, tok)[0]
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def replays():
        for _ in range(4):
            out["tok"] = step(params, cache, out["tok"])[0]

    captured = _profile(replays)
    del step
    log(phase="profile", arch=cfg.name, prefill=prefill,
        decode_4_steps=decode, decode_4_steps_captured=captured,
        capture_and_first_step_s=capture_s)


def governed_arm(model, params, governed: bool, tracer=None,
                 eager: bool = False):
    """One arm of ``examples/serve_pipeline.py``'s scenario: a 4-slot
    engine on a sim clock with deadline-safe admission over the governor's
    frontier, paced by the governor (``governed``) or pinned at
    max-performance; on the card by the captured step, or ``eager``ly."""
    preset = serving_preset(GOV_PLATFORM)
    gov = Governor(preset["chain"], preset["b"], preset["l"],
                   preset["power"], preset["budget"],
                   slo_period=preset["slo_period"], upshift_margin=0.02)
    planner = AdmissionPlanner(frontier=gov.frontier(),
                               time_scale=GOV_TIME_SCALE,
                               cap_w=preset["cap_w"], safety=GOV_SAFETY)
    engine = ServeEngine(model, params, batch_slots=4, max_len=64,
                         clock=SimClock(), planner=planner, pace="fixed",
                         tracer=tracer, metrics=MetricsRegistry())
    if eager:
        engine._step = model.decode_step
    arrivals = bursty_arrivals(GOV_WINDOWS, base_rate=1, burst_rate=4,
                               burst_windows=(3, 4), latency_slo_s=0.5)
    res = run_serve_scenario(
        gov, engine, arrivals, time_scale=GOV_TIME_SCALE,
        n_windows=GOV_WINDOWS, window_dt=1.0, inflation_at=GOV_INFLATION_AT,
        governed=governed, metrics=engine.metrics)
    return preset, arrivals, engine, res


def decisions(res) -> tuple:
    """Everything the scenario decided, none of it the model's tokens:
    each window record, each governor event (trigger, time, the adopted
    plan's period and watts), each request's admission and outcome, and
    the totals. NaN stands as the string "nan", so that it equals
    itself."""
    def num(x):
        return "nan" if isinstance(x, float) and x != x else x

    def event(e):
        return (e.trigger, e.t, e.plan.predicted_period,
                e.plan.predicted_watts)

    windows = tuple(
        tuple(tuple(event(e) for e in w.events) if f.name == "events"
              else num(getattr(w, f.name)) for f in dataclasses.fields(w))
        for w in res.windows)
    requests = tuple((r.rid, r.rejected, r.admitted_s, r.finished_s,
                      r.missed) for r in res.requests)
    return (windows, tuple(event(e) for e in res.events), requests,
            res.completed, res.rejected, res.deadline_misses, res.tokens,
            res.joules)


def phase_governed_serve(cfg, model, params) -> None:
    """The SLO-governed serving scenario on the model already on the card
    (phi3 at full width and depth, bf16), both arms. The engine's clock is
    simulated (each step advances it by the planned step time), so every
    admission and re-plan is independent of the model and the device: the
    card's decisions must equal a CPU replay's with the stablelm-3b smoke
    model, asked for with ``device="cpu"``. The joules are modelled (the
    DVB-S2 ``mac`` power model's watts times the simulated step time), not
    measured on the card. Both arms run by the captured step; the governed
    arm runs once more eagerly, and its decisions and tokens must equal
    the captured run's. Logs the card's wall ms per engine step beside the
    plan's simulated step, captured and eager. Draws nothing from the
    run's generators."""
    replay = Model(get_smoke_config(GOV_REPLAY_ARCH))
    replay_params = replay.init(SEED, device="cpu")
    reset_launches()
    out = {}
    for governed, eager in ((True, False), (False, False), (True, True)):
        arm = ("governed" if governed else "max_perf") + \
            ("_eager" if eager else "")
        tracer = Tracer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preset, arrivals, engine, res = governed_arm(model, params, governed,
                                                     tracer, eager)
        wall = time.perf_counter() - t0
        ref = governed_arm(replay, replay_params, governed)[3]
        require(decisions(res) == decisions(ref),
                f"governed serve ({arm}): the card's decisions differ from "
                f"the CPU replay's")
        require(res.deadline_misses == 0,
                f"governed serve ({arm}): {res.deadline_misses} deadline "
                f"misses")
        for r in res.requests:
            if not r.rejected:
                require(len(r.out) == GOV_NEW_TOKENS
                        and all(0 <= t < cfg.vocab for t in r.out),
                        f"governed serve ({arm}): request {r.rid} has "
                        f"tokens {r.out}")
        spans = [e.dur * 1e3 for e in tracer.drain()
                 if e.ph == "X" and e.name == "serve/step"]
        walls = sorted(spans)
        planned = engine.metrics.snapshot()["histograms"]["serve/step_s"]
        log(phase="governed_serve", arch=cfg.name, arm=arm,
            step="eager" if eager else "captured",
            engine_steps=len(walls), first_step_ms=spans[0],
            wall_ms_per_step_p50=statistics.median(walls),
            wall_ms_per_step_p99=walls[max(0, math.ceil(0.99 * len(walls))
                                           - 1)],
            planned_ms_per_step_p50=planned["p50"] * 1e3,
            planned_ms_per_step_p99=planned["p99"] * 1e3,
            wall_s=wall, requests=len(res.requests),
            completed=res.completed, rejected=res.rejected,
            deadline_misses=res.deadline_misses, tokens=res.tokens,
            replans=[e.trigger for e in res.replans],
            modelled_joules=res.joules,
            modelled_joules_per_token=res.joules_per_token,
            joules_model=f"DVB-S2 {GOV_PLATFORM} power model "
                         f"(energy/model.py), not measured on the card",
            frontier_points=len(preset["frontier"]),
            slo_ms_per_step=preset["slo_period"] * GOV_TIME_SCALE * 1e3,
            cap_w_modelled=preset["cap_w"],
            decisions_equal_cpu_replay=True, replay_arch=GOV_REPLAY_ARCH)
        out[arm] = res
    gov, maxp = out["governed"], out["max_perf"]
    require(decisions(out["governed_eager"]) == decisions(gov)
            and [r.out for r in out["governed_eager"].requests]
            == [r.out for r in gov.requests],
            "governed serve: the eager arm's decisions or tokens differ "
            "from the captured arm's")
    require(gov.completed == len(arrivals),
            f"governed serve: {gov.completed} of {len(arrivals)} requests "
            f"completed")
    require(any(e.trigger == "slo" for e in gov.replans),
            "governed serve: no \"slo\" re-plan")
    require(gov.joules_per_token < maxp.joules_per_token,
            f"governed serve: {gov.joules_per_token} modelled J/token, not "
            f"below max-perf's {maxp.joules_per_token}")
    first = gov.requests[0]
    require(first.admitted_s is not None and first.admitted_s
            < min(r.admitted_s for r in gov.requests[1:]
                  if r.admitted_s is not None),
            "governed serve: request 0 was not admitted first")
    solo = solo_tokens(model, params, first.prompt, 4, max_len=64)
    for arm, res in out.items():
        require(res.requests[0].out == solo[:GOV_NEW_TOKENS],
                f"governed serve ({arm}): request 0's tokens differ from "
                f"its 4-slot solo run from token "
                f"{first_diff(solo, res.requests[0].out)}")
    log(phase="governed_serve", arch=cfg.name, launches=launch_counts(),
        governed_captured_equals_eager=True,
        modelled_joules_per_token_saved=1 - gov.joules_per_token
        / maxp.joules_per_token,
        first_request_equals_solo=True, solo_slots=4)



# ================================================================= pipeline
class PowerSampler:
    """The card's power draw, ``nvidia-smi ... -lms PIPE_POWER_MS`` in a
    subprocess for the span of a ``with`` block: ``samples()`` gives
    (host perf_counter seconds, watts), the card's wall-clock timestamps
    mapped onto the clock the runtime's trace uses."""

    def __enter__(self):
        cmd = ["nvidia-smi", "--query-gpu=timestamp,power.draw",
               "--format=csv,noheader,nounits", "-lms", str(PIPE_POWER_MS)]
        if shutil.which("stdbuf"):
            cmd = ["stdbuf", "-oL"] + cmd    # a line a sample, not a block
        self.offset = time.time() - time.perf_counter()
        self.lines: list[str] = []
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def __exit__(self, *exc):
        self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(timeout=10)
        return False

    def samples(self) -> list[tuple[float, float]]:
        out = []
        for line in self.lines:
            if not line.strip():
                continue
            stamp, watts = (x.strip() for x in line.split(","))
            t = datetime.datetime.strptime(
                stamp, "%Y/%m/%d %H:%M:%S.%f").timestamp() - self.offset
            out.append((t, float(watts)))
        return out


def rapl_log(samples: list[tuple[float, float]]) -> str:
    """Power samples integrated (trapezoids) into a RAPL-format log: one
    cumulative µJ counter of the card, domain ``package``, that does not
    wrap."""
    lines = ["# rapl v1", f"# domain package max_energy_uj={1 << 62}"]
    uj, prev = 0.0, None
    for t, watts in samples:
        if prev is not None:
            if t <= prev[0]:
                continue
            uj += (watts + prev[1]) / 2 * (t - prev[0]) * 1e6
        lines.append(f"{t:.6f} package {int(round(uj))}")
        prev = (t, watts)
    return "\n".join(lines) + "\n"


def card_power_limit_w() -> float:
    return float(smi_name_power().rsplit(",", 1)[1].strip().split()[0])


def monolithic(cfg, model, params, frame):
    """One frame (1, S) through ``Model.forward`` on the default stream:
    its greedy token (host numpy) and last hidden state (host fp32)."""
    x = model.forward(params, {"tokens": torch.as_tensor(frame,
                                                         device=DEVICE)})
    last = x[:, -1]
    tok = embedloss.greedy(last, params["embed"], valid_vocab=cfg.vocab)
    return tok.cpu().numpy(), last.float().cpu()


def pipe_run(rt, frames, warmup: int, around=None):
    """``warmup`` frames through the started runtime ``rt`` (every replica
    makes its stream, the first launches), then ``frames`` with the
    launch counts set to 0 just before and read just after, inside the
    context ``around`` (the power sampler). Returns (stats, launches)."""
    rt.run(frames[:warmup], timeout_s=600.0)
    if rt.tracer is not None:
        rt.tracer.drain()
    torch.cuda.synchronize()
    reset_launches()
    with around or contextlib.nullcontext():
        stats = rt.run(frames, timeout_s=600.0)
    launches = launch_counts()
    return stats, launches


def check_frames(plan: str, stats, order, refs) -> float:
    """Every frame delivered once, in order, with its monolithic prefill's
    greedy token; returns the largest relative error of a last hidden
    state against the monolithic one."""
    n = len(order)
    seq = stats["seq_ids"]
    require(stats["frames_dropped"] == 0 and len(stats["outputs"]) == n
            and seq == list(range(seq[0], seq[0] + n)),
            f"pipeline plan {plan}: frames dropped or out of order")
    worst = 0.0
    for i, ((tok, hidden), k) in enumerate(zip(stats["outputs"], order)):
        want_tok, want_hidden = refs[k]
        require(np.array_equal(tok, want_tok),
                f"pipeline plan {plan}: frame {i} gives token {tok}, its "
                f"monolithic prefill {want_tok}")
        worst = max(worst, max_err(hidden, want_hidden)
                    / float(want_hidden.abs().max()))
    return worst


def stage_layers(plan, variant: str) -> int:
    """Layer tasks in the plan's stages of ``variant``."""
    stages = plan.freq_solution.stages if plan.freq_solution \
        else plan.solution.stages
    return sum(sum(1 for t in range(st.start, st.end + 1)
                   if plan.chain.names[t].startswith("layer"))
               for st in stages if getattr(st, "variant", "base") == variant)


def phase_rates(peaks) -> dict:
    """What the card reaches beside the H100 class's datasheet rates: a bf16
    GEMM (M = N = K = RATE_GEMM) and a device-to-device copy of
    RATE_COPY_BYTES (read once, written once), CUDA-event medians."""
    n = RATE_GEMM
    a = torch.randn(n, n, device=DEVICE, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=DEVICE, dtype=torch.bfloat16)
    gemm_ms = time_ms(lambda: a @ b)
    src = torch.empty(RATE_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    rates = {"gemm_flop_s": 2 * n ** 3 / (gemm_ms * 1e-3),
             "copy_bytes_s": 2 * RATE_COPY_BYTES / (copy_ms * 1e-3)}
    log(phase="pipeline", part="rates", gemm_mnk=n, gemm_ms=gemm_ms,
        copy_bytes=RATE_COPY_BYTES, copy_ms=copy_ms, **rates,
        class_flop_s=H100_CLASS.peak_flops, class_bytes_s=H100_CLASS.hbm_bw,
        gemm_share_of_class=rates["gemm_flop_s"] / H100_CLASS.peak_flops,
        copy_share_of_class=rates["copy_bytes_s"] / H100_CLASS.hbm_bw,
        peaks_of_card=list(peaks))
    return rates


def phase_pipeline(cfg, model, params, peaks) -> dict:
    """phi3's layer chain planned by the port's planner and run by its
    streaming runtime on the model already on the card, with real stage
    functions (``pipeline/stages.py``: one CUDA stream per replica thread,
    each stage fn waits for its stream, so busy time is device time).
    Plan A: one stage of all 44 tasks on one card, under measured power.
    Plan B: (2 big, 2 little), both the card: three stages, the middle
    one two replicas. Plan C: the two-pass kernel's multiplier fitted from
    a flash and a two-pass run of plan A's chain, registered, and a
    ``variant_herad`` plan run. Gates: every frame's token equals its
    monolithic prefill's, frames in order, exact flash / two-pass launch
    counts; Plan B's last hidden states within PREFILL_REL_TOL; the power
    capture parses, holds energy and averages at or below the card's
    power limit. Frames come from a generator of their own, so the
    phases after it see the data they saw before it was added. Returns
    each attention kernel's launches per run of the phase."""
    pipe = torch.Generator(device=DEVICE)
    pipe.manual_seed(SEED + 2)
    pool = [torch.randint(0, cfg.vocab, (1, PIPE_TOKENS), generator=pipe,
                          device=DEVICE).to(torch.int32).cpu().numpy()
            for _ in range(PIPE_POOL)]
    monolithic(cfg, model, params, pool[0])             # warm-up
    refs, mono_ms = [], []
    for f in pool:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refs.append(monolithic(cfg, model, params, f))
        mono_ms.append((time.perf_counter() - t0) * 1e3)
    n_layers = cfg.n_layers

    def frames(n):
        order = [i % PIPE_POOL for i in range(n)]
        return order, [pool[k] for k in order]

    def system(b, l):
        return HeterogeneousSystem(dataclasses.replace(H100_CLASS, count=b),
                                   dataclasses.replace(H100_CLASS, count=l))

    def plan(b, l, **kw):
        return plan_pipeline(cfg, system=system(b, l),
                             tokens_per_step=PIPE_TOKENS, mode="prefill",
                             **kw)

    def stages(p):
        return [[p.chain.names[st.start], p.chain.names[st.end], st.cores,
                 st.ctype, getattr(st, "variant", "base"),
                 getattr(st, "freq", 1.0)]
                for st in (p.freq_solution or p.solution).stages]

    rates = phase_rates(peaks)
    limit_w = card_power_limit_w()

    # ---- Plan A: one stage, one card, under measured power
    sys_a = system(1, 0)
    plan_a = plan(1, 0)
    require([(st.start, st.end, st.cores) for st in plan_a.solution.stages]
            == [(0, len(plan_a.chain.names) - 1, 1)],
            f"plan A is not one stage of all tasks: {stages(plan_a)}")
    name_a = f"s0-{len(plan_a.chain.names) - 1}"
    builder = model_stage_builder(model, params, plan_a.chain.names,
                                  device=DEVICE)
    tracer = Tracer()
    rt = StreamingPipelineRuntime.from_plan(
        plan_a, builder, power=PowerModel.from_device_classes(sys_a),
        tracer=tracer).start()
    try:
        rt.run(frames(2)[1], timeout_s=600.0)
        probe = rt.run(frames(4)[1], timeout_s=600.0)
        n_a = max(PIPE_POOL, math.ceil(PIPE_STEADY_S
                                       / (probe["total_s"] / 4)))
        order_a, frames_a = frames(n_a)
        sampler = PowerSampler()
        stats_a, launches_a = pipe_run(rt, frames_a, warmup=2,
                                       around=sampler)
        events = to_chrome_events(tracer.drain(), t0=0.0)
        prof_a = _profile(lambda: rt.run(frames_a[:8], timeout_s=600.0))
    finally:
        rt.stop()
    rel_a = check_frames("A", stats_a, order_a, refs)
    require(launches_a == {"ssd_scan": 0, "chunked_attention": 0,
                           "flash_attention": n_layers * n_a},
            f"pipeline plan A: launches {launches_a}, not "
            f"{n_layers} x {n_a} flash")
    samples = sampler.samples()
    capture = parse_rapl_log(rapl_log(samples))
    attr = attribute_energy(events, capture,
                            stage_info=stage_info_from_plan(plan_a.solution),
                            power=PowerModel.from_device_classes(sys_a))
    require(attr.extent_s >= PIPE_MIN_STEADY_S,
            f"pipeline plan A: {attr.extent_s} s of frames, not "
            f"{PIPE_MIN_STEADY_S}")
    require(attr.measured_j > 0 and capture.total_energy() > 0,
            f"pipeline plan A: the power capture holds "
            f"{capture.total_energy()} J, {attr.measured_j} J in the trace")
    require(attr.measured_w <= limit_w,
            f"pipeline plan A: {attr.measured_w} W measured over the "
            f"card's limit {limit_w} W")
    report_a = plan_a.energy_report(sys_a)
    log(phase="pipeline", plan="A", arch=cfg.name, system=[1, 0],
        stages=stages(plan_a), frames=n_a, tokens_per_frame=PIPE_TOKENS,
        planned_period_ms=plan_a.period_us / 1e3,
        measured_period_ms=stats_a["period_s"] * 1e3,
        planned_over_measured=plan_a.period_us / 1e3
        / (stats_a["period_s"] * 1e3),
        monolithic_forward_ms_p50=statistics.median(mono_ms),
        profile_8_frames={k: v for k, v in prof_a.items() if k != "top_ms"},
        profile_top_ms=prof_a["top_ms"],
        tokens_per_s=PIPE_TOKENS * stats_a["throughput_fps"],
        busy_s=stats_a["busy_s"][(name_a, 0)], total_s=stats_a["total_s"],
        launches=launches_a, tokens_equal_monolithic=True,
        last_hidden_rel_err=rel_a, power_samples=len(samples),
        power_sampler_ms=PIPE_POWER_MS, capture_s=capture.extent,
        trace_extent_s=attr.extent_s, measured_j=attr.measured_j,
        measured_w=attr.measured_w, power_limit_w=limit_w,
        measured_j_per_frame=attr.measured_j / n_a,
        runtime_modelled_j_per_frame=stats_a["energy_j"] / n_a,
        plan_modelled_j_per_frame=report_a.total * 1e-6,
        plan_modelled_w=report_a.avg_watts,
        model_over_measured=attr.prediction_error,
        power_model="H100_CLASS 700 W busy, 10 % idle (from_device_classes)")

    # ---- Plan B: the reference's heterogeneous shape on one card
    plan_b = plan(*PIPE_B)
    shape = [(st.cores, plan_b.chain.is_rep(st.start, st.end))
             for st in plan_b.solution.stages]
    require(len(shape) == 3 and shape[1] == (2, True),
            f"plan B is not three stages, the middle one two replicas: "
            f"{stages(plan_b)}")
    builder = model_stage_builder(model, params, plan_b.chain.names,
                                  device=DEVICE)
    order_b, frames_b = frames(PIPE_FRAMES_B)
    rt = StreamingPipelineRuntime.from_plan(plan_b, builder).start()
    try:
        stats_b, launches_b = pipe_run(rt, frames_b, warmup=6)
        prof = _profile(lambda: rt.run(frames_b[:16], timeout_s=600.0))
    finally:
        rt.stop()
    rel_b = check_frames("B", stats_b, order_b, refs)
    require(launches_b == {"ssd_scan": 0, "chunked_attention": 0,
                           "flash_attention": n_layers * PIPE_FRAMES_B},
            f"pipeline plan B: launches {launches_b}")
    require(rel_b <= PREFILL_REL_TOL,
            f"pipeline plan B: last hidden state {rel_b} from the "
            f"monolithic prefill's, over {PREFILL_REL_TOL}")
    log(phase="pipeline", plan="B", arch=cfg.name, system=list(PIPE_B),
        stages=stages(plan_b), frames=PIPE_FRAMES_B,
        planned_period_ms=plan_b.period_us / 1e3,
        measured_period_ms=stats_b["period_s"] * 1e3,
        measured_over_planned=stats_b["period_s"] * 1e6 / plan_b.period_us,
        measured_over_plan_a=stats_b["period_s"] / stats_a["period_s"],
        tokens_per_s=PIPE_TOKENS * stats_b["throughput_fps"],
        busy_s={f"{k[0]}/r{k[1]}": v for k, v in stats_b["busy_s"].items()},
        queue_wait_s={f"{k[0]}/r{k[1]}": v
                      for k, v in stats_b["queue_wait_s"].items()},
        replica_frames={f"{k[0]}/r{k[1]}": v
                        for k, v in stats_b["replica_frames"].items()},
        total_s=stats_b["total_s"], launches=launches_b,
        tokens_equal_monolithic=True, last_hidden_rel_err=rel_b,
        rel_err_limit=PREFILL_REL_TOL,
        profile_16_frames={k: v for k, v in prof.items() if k != "top_ms"})

    # ---- Plan C: fit the two-pass multiplier, plan by variant, run it
    observations, fit_runs = [], {}
    for variant, key in (("base", "flash_attention"),
                         ("chunked", "chunked_attention")):
        fn = model_stage_builder(
            model, params, plan_a.chain.names, device=DEVICE,
)(0, len(plan_a.chain.names) - 1,
                                types.SimpleNamespace(variant=variant))
        order_f, frames_f = frames(PIPE_FRAMES_FIT)
        rt = StreamingPipelineRuntime([StageSpec(
            name_a, fn, device_class="big", variant=variant)]).start()
        try:
            stats_f, launches_f = pipe_run(rt, frames_f, warmup=2)
        finally:
            rt.stop()
        check_frames(f"C fit ({variant})", stats_f, order_f, refs)
        want = {"ssd_scan": 0, "chunked_attention": 0, "flash_attention": 0}
        want[key] = n_layers * PIPE_FRAMES_FIT
        require(launches_f == want,
                f"pipeline plan C fit ({variant}): launches {launches_f}")
        observations += observations_from_run(rt.stages, stats_f)
        fit_runs[variant] = stats_f["period_s"] * 1e3
    fit = fit_variant_multipliers(observations)
    mult = fit["chunked"]["B"]
    reg = VariantRegistry()
    for i in range(n_layers):
        registry.register_family(reg, f"layer{i}", "flash_attention",
                                 {"chunked": (mult, mult)})
    spec = reg.spec_for(plan_a.chain)
    # the registry's callables are kernels, not stage builders, and the
    # runtime would call them as builders: the plan carries the measured
    # multipliers, and the stage builder reads each stage's variant
    plan_c = plan(*PIPE_B, strategy="variant_herad",
                  variants=VariantSpec(spec.names, spec.task_names,
                                       spec.mult))
    builder = model_stage_builder(model, params, plan_c.chain.names,
                                  device=DEVICE)
    order_c, frames_c = frames(PIPE_FRAMES_C)
    rt = StreamingPipelineRuntime.from_plan(plan_c, builder).start()
    try:
        stats_c, launches_c = pipe_run(rt, frames_c, warmup=6)
    finally:
        rt.stop()
    rel_c = check_frames("C", stats_c, order_c, refs)
    want_c = {"ssd_scan": 0,
              "flash_attention": stage_layers(plan_c, "base") * PIPE_FRAMES_C,
              "chunked_attention": stage_layers(plan_c, "chunked")
              * PIPE_FRAMES_C}
    require(launches_c == want_c,
            f"pipeline plan C: launches {launches_c}, the plan's variants "
            f"imply {want_c}")
    log(phase="pipeline", plan="C", arch=cfg.name, system=list(PIPE_B),
        fit_period_ms=fit_runs, fitted_chunked_multiplier=mult,
        fit=fit, tpu_round_preset=[1.30, 0.82],
        preset_source="configs/dvbs2.py VARIANT_MULTIPLIERS (unchanged)",
        stages=stages(plan_c), frames=PIPE_FRAMES_C,
        planned_period_ms=plan_c.period_us / 1e3,
        measured_period_ms=stats_c["period_s"] * 1e3,
        launches=launches_c, launches_implied=want_c,
        tokens_equal_monolithic=True, last_hidden_rel_err=rel_c)
    log(phase="pipeline", arch=cfg.name, one_card_one_class=True,
        gemm_flop_s=rates["gemm_flop_s"], copy_bytes_s=rates["copy_bytes_s"])
    runs = {"A": launches_a, "B": launches_b, "C": launches_c}
    return {key: {plan: n[key] for plan, n in runs.items()}
            for key in ("flash_attention", "chunked_attention")}


# ================================================================ zamba2-7b
def phase_attention_kernels(gen, added, peaks, fa_rec: dict) -> dict:
    """The chunked kernel on the reference cases; both attention kernels at
    zamba2's shared-attention shape (head dim 112). Adds the flash kernel's
    zamba2 numbers to ``fa_rec``; returns the chunked kernel's record."""
    errs = attention_cases(gen, added, ca.chunked_attention_cuda,
                           "chunked")

    b, hq, hkv, s, d = ZAMBA_ATTN
    q, k, v = qkv(gen, b, hq, hkv, s, s, d, torch.bfloat16)
    ref = attention_kernel_ref(q, k, v, causal=True)
    out_fa = fa.flash_attention_cuda(q, k, v, causal=True)
    out_ca = ca.chunked_attention_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    err_fa, err_ca = max_err(out_fa, ref), max_err(out_ca, ref)
    del out_fa, out_ca, ref
    for name, err in (("flash", err_fa), ("chunked", err_ca)):
        require(err < TOL[torch.bfloat16],
                f"{name} kernel error {err} at zamba2's shape")
    fa_ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    ca_ms = time_ms(lambda: ca.chunked_attention_cuda(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_kernel_ref(q, k, v, causal=True),
                       reps=20)
    lib_ms = library_ms(q, k, v)
    flops, nbytes = attn_work(b, hq, hkv, s, d)
    bound_ms, bound_by = bound(flops, nbytes, peaks)
    fa_rec["zamba2_shape"] = {
        "shape": list(ZAMBA_ATTN), "max_abs_err": err_fa, "ms": fa_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms, "tflops": flops / fa_ms / 1e9,
        "share_of_bound": bound_ms / fa_ms}
    rec = kernel_record("chunked_attention", "flash_attention/csrc/"
                        "chunked_attention.cu",
                        "flash_attention/chunked.py:110", err_ca, ca_ms,
                        plain_ms, lib_ms, flops, nbytes, peaks, ATTN_DESIGN)
    log(phase="attention_kernels", cases=len(errs),
        chunked_max_abs_err_cases=errs, shape=list(ZAMBA_ATTN),
        dtype="bfloat16", causal=True, flash_zamba2=fa_rec["zamba2_shape"],
        **{k: v for k, v in rec.items() if k != "launches"})
    return rec


def ssd_inputs(gen, b, l, h, p, n, dtype):
    """Inputs of the scan as ``mamba_block`` makes them: x, B and C are
    strided column views of one silu'd (B, L, H*P + 2N) tensor, dt is
    softplus(N(0, 1) + the model's dt_bias), a = -linspace(1, 16)."""
    xbc = F.silu(torch.randn((b, l, h * p + 2 * n), generator=gen,
                             device=DEVICE)).to(dtype)
    x = xbc[..., :h * p].reshape(b, l, h, p)
    bm, cm = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    bias = torch.log(torch.expm1(torch.linspace(0.001, 0.1, h,
                                                device=DEVICE)))
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device=DEVICE)
                    + bias)
    a = -torch.linspace(1.0, 16.0, h, device=DEVICE)
    return x, dt, a, bm, cm


def ssd_work(b, l, h, p, n, q, itemsize) -> tuple[int, int]:
    """(flops, bytes) the scan needs on these shapes: C.B^T over the causal
    pairs of each chunk (shared by the heads), the masked scores times x,
    C times the carried state, and the state update; x and y, B and C in
    their dtype, dt and a in fp32 read once, the fp32 state written once."""
    full, rem = divmod(l, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
    flops = 2 * b * pairs * n + 2 * b * h * pairs * p + 4 * b * h * l * n * p
    nbytes = (2 * b * l * h * p + 2 * b * l * n) * itemsize \
        + 4 * (b * l * h + h + b * h * p * n)
    return flops, nbytes


def rel_max(a, b) -> float:
    """Largest absolute difference relative to the reference's largest
    magnitude."""
    return max_err(a, b) / float(b.float().abs().max())


def ssd_case_inputs(gen, b, l, h, p, n, dtype):
    """x, dt, a, B, C with the reference test's distributions, and an
    N(0, 1) initial state."""
    x = torch.randn((b, l, h, p), generator=gen, device=DEVICE).to(dtype)
    dt = 0.01 + 0.29 * torch.rand((b, l, h), generator=gen, device=DEVICE)
    a = -(0.5 + 1.5 * torch.rand((h,), generator=gen, device=DEVICE))
    bm, cm = (torch.randn((b, l, n), generator=gen, device=DEVICE).to(dtype)
              for _ in range(2))
    s0 = torch.randn((b, h, p, n), generator=gen, device=DEVICE)
    return (x, dt, a, bm, cm), s0


def ssd_phase_ms(args, chunk, calls: int = 5) -> dict[str, float]:
    """Device time (ms) of each CUDA kernel of a bf16 ``ssd_cuda`` call,
    by the kernel names of ``SSD_PHASES``: the mean over the launches a
    torch.profiler trace of ``calls`` calls records (a trace can miss the
    first launch of its window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sk.ssd_cuda(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            sk.ssd_cuda(*args, chunk=chunk)
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        name = next((k for k in SSD_PHASES if k in e.name), None)
        if e.device_type == DeviceType.CUDA and name:
            spans.setdefault(name, []).append(
                (e.time_range.end - e.time_range.start) / 1e3)
    return {k: statistics.mean(v) for k, v in spans.items()}


def phase_ssd_kernel(gen, added, peaks) -> dict:
    """The SSD kernel against its plain version on the reference cases,
    from zero and from an N(0, 1) initial state, on ``WIDE_CASE`` and
    ``UNALIGNED_CASE``, and at zamba2's and mamba2-1.3b's full-width layer
    shapes."""
    errs, errs_init = {}, {}
    for case in SSD_CASES:
        b, l, h, p, n, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            (x, dt, a, bm, cm), s0 = ssd_case_inputs(gen, b, l, h, p, n,
                                                     dtype)
            for init, out in ((None, errs), (s0, errs_init)):
                y, st = sk.ssd_cuda(x, dt, a, bm, cm, chunk=chunk,
                                    init_state=init)
                yr, sr = ssd_ref_sequential(x, dt, a, bm, cm, init)
                torch.cuda.synchronize()
                err = max(max_err(y, yr), max_err(st, sr))
                require(y.shape == x.shape and y.dtype == dtype
                        and st.shape == (b, h, p, n),
                        (case, y.shape, st.shape))
                require(err < SSD_TOL[dtype],
                        ("ssd", case, dtype, init is not None, err))
                out[f"{case}/{str(dtype)[6:]}"] = err

    wide = {}
    for case, dtype in itertools.product((WIDE_CASE, UNALIGNED_CASE),
                                         (torch.float32, torch.bfloat16)):
        b, l, h, p, n, chunk = case
        args, s0 = ssd_case_inputs(added, b, l, h, p, n, dtype)
        limits = ((SSD_TOL[dtype], SSD_TOL[dtype]) if dtype == torch.float32
                  else (SSD_Y_REL_TOL, SSD_STATE_REL_TOL))
        for init in (None, s0):
            y, st = sk.ssd_cuda(*args, chunk=chunk, init_state=init)
            yr, sr = ssd_ref_sequential(*args, init)
            yb, sb = ssm.ssd_ref(*args, chunk=chunk, init_state=init)
            torch.cuda.synchronize()
            rec = {"y_rel": rel_max(y, yr), "state_rel": rel_max(st, sr),
                   "y_abs": max_err(y, yr), "state_abs": max_err(st, sr),
                   "plain_blocked_y_abs": max_err(yb.to(dtype), yr),
                   "plain_blocked_state_abs": max_err(sb, sr),
                   "y_max": float(yr.float().abs().max()), "limits": limits}
            require(y.shape == args[0].shape and y.dtype == dtype
                    and st.shape == (b, h, p, n), (case, y.shape))
            require(rec["y_rel"] <= limits[0]
                    and rec["state_rel"] <= limits[1],
                    ("ssd", case, dtype, init is not None, rec))
            wide[f"{case}/{str(dtype)[6:]}/"
                 f"{'init' if init is not None else 0}"] = rec

    shapes = {}
    for arch in SSD_ARCHS:
        sc, d = get_config(arch).ssm, get_config(arch).d_model
        b, l, h, p, n, q = (SSD_BATCH, SSD_LEN, sc.n_heads(d), sc.head_dim,
                            sc.d_state, sc.chunk)
        args = ssd_inputs(gen, b, l, h, p, n, torch.bfloat16)
        y, st = sk.ssd_cuda(*args, chunk=q)
        yr, sr = ssd_ref_sequential(*args)
        torch.cuda.synchronize()
        y_rel, st_rel = rel_max(y, yr), rel_max(st, sr)
        require(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                f"{arch}: non-finite SSD output")
        require(y_rel <= SSD_Y_REL_TOL and st_rel <= SSD_STATE_REL_TOL,
                f"{arch} SSD shape: y {y_rel} (limit {SSD_Y_REL_TOL}), "
                f"state {st_rel} (limit {SSD_STATE_REL_TOL})")
        ms = time_ms(lambda: sk.ssd_cuda(*args, chunk=q))
        phase_ms = ssd_phase_ms(args, q)
        plain_ms = time_ms(lambda: ssd_ref_sequential(*args),
                           reps=PLAIN_REPS_SLOW, warmup=1)
        flops, nbytes = ssd_work(b, l, h, p, n, q, 2)
        shapes[arch] = kernel_record(
            "ssd_scan", "ssd_scan/csrc/ssd_scan.cu",
            "ssd_scan/kernel.py:93", max(max_err(y, yr), max_err(st, sr)),
            ms, plain_ms, None, flops, nbytes, peaks, SSD_DESIGN)
        shapes[arch].update(shape=[b, l, h, p, n, q], y_rel_err=y_rel,
                            state_rel_err=st_rel, gflop=flops / 1e9,
                            mbytes=nbytes / 1e6, phase_ms=phase_ms)
        del args, y, st, yr, sr
    rec = dict(shapes["zamba2-7b"])
    rec["mamba2_shape"] = {k: shapes["mamba2-1.3b"][k] for k in (
        "shape", "max_abs_err", "y_rel_err", "state_rel_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "tflops", "share_of_bound",
        "phase_ms")}
    log(phase="ssd_kernel", cases=len(errs), max_abs_err_cases=errs,
        max_abs_err_cases_init_state=errs_init,
        relative_cases=[WIDE_CASE, UNALIGNED_CASE], relative_case_errs=wide,
        y_rel_err_limit=SSD_Y_REL_TOL, state_rel_err_limit=SSD_STATE_REL_TOL,
        shapes=shapes)
    return rec


def leaf_rel_err(cache, ref, s: int) -> dict[str, float]:
    """Per cache leaf, the largest relative L2 error of one gated vector
    (``LEAF_VEC_DIMS``) against ``ref``'s, over layers, lanes and
    positions or heads; K/V over the first ``s`` positions."""
    out = {}
    for key, vec in LEAF_VEC_DIMS.items():
        a, b = cache[key], ref[key]
        if key in ("k_shared", "v_shared"):
            a, b = a[:, :, :s], b[:, :, :s]
        a, b = a.float().flatten(-vec), b.float().flatten(-vec)
        e = (a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)
        out[key] = float(e.max())
    return out


@contextlib.contextmanager
def ssd_dropped_carry():
    """The control: the plain blocked SSD run on every chunk alone, so the
    state restarts at zero at each chunk (the inter-chunk carry is
    dropped), the fault a new scan kernel is most likely to have."""
    saved = ssm.ssd_ref

    def no_carry(x, dt, A, B, C, chunk=128, init_state=None):
        b, l, h, p = x.shape
        pad = (-l) % chunk
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
        nc = (l + pad) // chunk
        y, st = saved(x.reshape(b * nc, chunk, h, p),
                      dt.reshape(b * nc, chunk, h), A,
                      B.reshape(b * nc, chunk, -1),
                      C.reshape(b * nc, chunk, -1), chunk=chunk)
        return (y.reshape(b, nc * chunk, h, p)[:, :l],
                st.reshape(b, nc, *st.shape[1:])[:, -1])

    ssm.ssd_ref = no_carry
    try:
        yield
    finally:
        ssm.ssd_ref = saved


@contextlib.contextmanager
def scan_output_in_bf16():
    """The blocked plain SSD with its output rounded to bf16, as the kernel
    returns it (``ssd_tpu``'s contract): logged, not gated."""
    saved = ssm.ssd_ref

    def rounded(*args, **kw):
        y, state = saved(*args, **kw)
        return y.to(torch.bfloat16), state

    ssm.ssd_ref = rounded
    try:
        yield
    finally:
        ssm.ssd_ref = saved


def reset_launches() -> None:
    fa.launches = ca.launches = sk.launches = 0


def launch_counts() -> dict[str, int]:
    return {"ssd_scan": sk.launches, "flash_attention": fa.launches,
            "chunked_attention": ca.launches}


def prefill_errs(cache, last, ref_cache, ref_last, s: int) -> dict:
    """The last hidden state's relative max-norm error and every cache
    leaf's worst vector error against a reference prefill."""
    return {"last": rel_max(last, ref_last),
            **leaf_rel_err(cache, ref_cache, s)}


def phase_zamba_prefill(gen, fa_rec, ca_rec, ssd_rec):
    cfg = get_config("zamba2-7b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    b, _, _, s, _ = ZAMBA_ATTN
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    model.prefill(params, batch, CACHE_LEN)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: bf16, SSD and flash kernels
    reset_launches()
    t0 = time.perf_counter()
    cache, last = model.prefill(params, batch, CACHE_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"bf16 kernel": launch_counts()}
    want = {"ssd_scan": cfg.n_layers, "flash_attention": model.n_super,
            "chunked_attention": 0}
    require(launches["bf16 kernel"] == want,
            f"zamba2 prefill launches {launches['bf16 kernel']}, want {want}")
    require(last.shape == (b, cfg.d_model) and torch.isfinite(last).all(),
            "last hidden state shape or finiteness")
    # the same weights through the chunked kernel, and the plain paths
    chunked = Model(dataclasses.replace(cfg, attn_impl="chunked"))
    plain = Model(dataclasses.replace(cfg, attn_impl="xla_flash",
                                      ssd_impl="blocked"))
    reset_launches()
    t0 = time.perf_counter()
    runs = {"chunked": chunked.prefill(params, batch, CACHE_LEN)}
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launches["bf16 chunked"] = launch_counts()
    want_c = dict(want, flash_attention=0, chunked_attention=model.n_super)
    require(launches["bf16 chunked"] == want_c,
            f"chunked prefill launches {launches['bf16 chunked']}, "
            f"want {want_c}")
    runs["plain"] = plain.prefill(params, batch, CACHE_LEN)
    with ssd_dropped_carry():
        runs["control"] = plain.prefill(params, batch, CACHE_LEN)
    # logged only: two more plain paths that round at other places, the
    # size of bf16's own noise beside the gated paths
    runs["plain_naive"] = Model(dataclasses.replace(
        cfg, attn_impl="naive", ssd_impl="blocked")).prefill(
            params, batch, CACHE_LEN)
    with scan_output_in_bf16():
        runs["plain_round_y"] = plain.prefill(params, batch, CACHE_LEN)
    runs["kernel"] = (cache, last)
    vs_plain = {k: prefill_errs(*runs[k], *runs["plain"], s)
                for k in ("kernel", "chunked", "plain_naive",
                          "plain_round_y")}

    # fp32 weights and activations: the truth the bf16 paths round away
    # from, and the arithmetic in which the kernels must agree with the
    # plain path to FP32_REL_TOL
    m32, p32 = fp32_witness(cfg, params, None)
    cfg32 = m32.cfg
    truth = Model(dataclasses.replace(cfg32, attn_impl="xla_flash",
                                      ssd_impl="blocked")).prefill(
        p32, batch, CACHE_LEN)
    bf16 = {k: prefill_errs(*runs.pop(k), *truth, s) for k in list(runs)}
    ratio = {k: {leaf: e / max(bf16["plain"][leaf], 1e-30)
                 for leaf, e in bf16[k].items()}
             for k in ("kernel", "chunked", "control")}
    for k in ("kernel", "chunked"):
        worst = max(ratio[k], key=ratio[k].get)
        require(ratio[k][worst] <= BF16_RATIO_TOL,
                f"bf16 {k} prefill: {worst} is {ratio[k][worst]} times as "
                f"far from the fp32 prefill as the plain bf16 prefill is "
                f"(limit {BF16_RATIO_TOL}): {bf16[k]} vs {bf16['plain']}")
    require(min(ratio["control"].values()) > BF16_RATIO_TOL,
            f"the bf16 control (SSD without the inter-chunk carry) reads "
            f"{ratio['control']}, not all above {BF16_RATIO_TOL}: the gate "
            "cannot see a dropped carry")

    fp32 = {}
    for name, impls in (("kernel", {}), ("chunked", {"attn_impl": "chunked"})):
        reset_launches()
        run = Model(dataclasses.replace(cfg32, **impls)).prefill(
            p32, batch, CACHE_LEN)
        launches[f"fp32 {name}"] = launch_counts()
        fp32[name] = prefill_errs(*run, *truth, s)
        del run
    require(launches["fp32 kernel"] == want
            and launches["fp32 chunked"] == want_c,
            f"fp32 prefill launches {launches}")
    with ssd_dropped_carry():
        fp32["control"] = prefill_errs(*Model(dataclasses.replace(
            cfg32, attn_impl="xla_flash", ssd_impl="blocked")).prefill(
                p32, batch, CACHE_LEN), *truth, s)
    del p32, truth
    for k in ("kernel", "chunked"):
        worst = max(fp32[k], key=fp32[k].get)
        require(fp32[k][worst] <= FP32_REL_TOL,
                f"fp32 {k} prefill vs the plain fp32 prefill: {worst} "
                f"{fp32[k][worst]} > {FP32_REL_TOL}: {fp32[k]}")
    require(min(fp32["control"].values()) > FP32_REL_TOL,
            f"the fp32 control reads {fp32['control']}, not all above "
            f"{FP32_REL_TOL}: the gate cannot see a dropped carry")

    # each kernel's ``launches`` is the count of one prefill of its main
    # path (flash: phi3's, set in phase_prefill; SSD: zamba2's; chunked:
    # zamba2's chunked one); the other main-path prefills stand beside it
    main = {"zamba2-7b prefill": launches["bf16 kernel"],
            "zamba2-7b chunked prefill": launches["bf16 chunked"]}
    fa_rec["launches_by_path"] = {
        "phi3-medium-14b prefill": fa_rec["launches"],
        **{k: v["flash_attention"] for k, v in main.items()}}
    for rec, key, path in (
            (ssd_rec, "ssd_scan", "zamba2-7b prefill"),
            (ca_rec, "chunked_attention", "zamba2-7b chunked prefill")):
        rec["launches_by_path"] = {k: v[key] for k, v in main.items()}
        rec["launches"] = main[path][key]
    log(phase="prefill", arch=cfg.name, params=sum(
        t.numel() for g in params.values()
        for t in (g.values() if isinstance(g, dict) else [g])),
        init_s=init_s, batch=b, prompt=s, cache_len=CACHE_LEN,
        prefill_s=prefill_s, prefill_tokens_per_s=b * s / prefill_s,
        chunked_prefill_s=chunked_s, launches=launches,
        bf16_err_vs_fp32=bf16, bf16_ratio_to_plain=ratio,
        bf16_err_vs_plain_bf16=vs_plain,
        bf16_ratio_limit=BF16_RATIO_TOL, fp32_err_vs_plain_fp32=fp32,
        fp32_rel_err_limit=FP32_REL_TOL,
        init_peak_mem_gb=init_peak / 1e9,
        prefill_peak_mem_gb=prefill_peak / 1e9,
        run_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return cfg, model, params, cache, last


# =============================================================== gemma3-12b
def phase_gemma_kernels(gen, peaks, fa_rec, ca_rec, usage) -> None:
    """Both attention kernels at head dim 256: against their plain version
    on ``D256_CASES`` in fp32 (the CUDA-core bodies, 2e-5) and bf16 (the
    ``wgmma`` bodies, 2e-2), and at gemma3-12b's two prefill shapes in bf16
    (global causal, and the windowed layers' window of 1024), with kernel,
    plain and library times, the bound of the pairs the mask shows,
    TFLOP/s and the share of the bound. Adds each kernel's gemma3 numbers
    to its record."""
    errs = {}
    kernels = (("flash", fa.flash_attention_cuda, fa_rec),
               ("chunked", ca.chunked_attention_cuda, ca_rec))
    for case in D256_CASES:
        b, hq, hkv, sq, skv, d, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(gen, b, hq, hkv, sq, skv, d, dtype)
            ref = attention_kernel_ref(q, k, v, causal=causal, window=window)
            for name, kernel, _ in kernels:
                out = kernel(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                require(out.shape == ref.shape and err < TOL[dtype],
                        (name, case, dtype, err))
                errs[f"{name}/{case}/{str(dtype)[6:]}"] = err

    b, hq, hkv, s, d = GEMMA_ATTN
    q, k, v = qkv(gen, b, hq, hkv, s, s, d, torch.bfloat16)
    for shape, window in (("global", 0), ("window", GEMMA_WINDOW)):
        ref = attention_kernel_ref(q, k, v, causal=True, window=window)
        plain_ms = time_ms(lambda: attention_kernel_ref(
            q, k, v, causal=True, window=window), reps=20)
        lib_ms = library_ms(q, k, v, window)
        flops, nbytes = attn_work(b, hq, hkv, s, d, window)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        for name, kernel, rec in kernels:
            out = kernel(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            require(bool(torch.isfinite(out).all())
                    and err < TOL[torch.bfloat16],
                    f"{name} kernel error {err} at gemma3's {shape} shape")
            ms = time_ms(lambda: kernel(q, k, v, causal=True, window=window))
            rec.setdefault("gemma3_shapes", {})[shape] = {
                "shape": list(GEMMA_ATTN), "window": window,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "gflop": flops / 1e9,
                "tflops": flops / ms / 1e9, "share_of_bound": bound_ms / ms}
            del out
        del ref
    log(phase="gemma3_kernels", cases=len(errs), max_abs_err_cases=errs,
        flash=fa_rec["gemma3_shapes"], chunked=ca_rec["gemma3_shapes"],
        registers_stack_local_d256={
            k: v for k, v in usage.items() if k.endswith(", 256>")})


def phase_gemma_prefill(gen, fa_rec, ca_rec):
    """gemma3-12b at full width and depth, bf16, seeded random weights:
    4 x 2048 tokens through 40 windowed and 8 global layers, exactly 48
    flash launches, or 48 chunked ones on the chunked path. Both paths'
    last hidden state and every cached K/V row (the rolling leaves in
    their rolled order) against the plain prefill (windowed layers through
    ``window_attention_xla``), as phi3's; two controls must fail the same
    gate: the causal mask one key ahead, and windowed layers that ignore
    the window."""
    cfg = get_config("gemma3-12b")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    b, _, _, s, _ = GEMMA_ATTN
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    model.prefill(params, batch, CACHE_LEN)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    cache, last = model.prefill(params, batch, CACHE_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"kernel": launch_counts()}
    want = {"ssd_scan": 0, "flash_attention": cfg.n_layers,
            "chunked_attention": 0}
    require(launches["kernel"] == want,
            f"gemma3 prefill launches {launches['kernel']}, want {want}")
    require(last.shape == (b, cfg.d_model) and torch.isfinite(last).all(),
            "last hidden state shape or finiteness")
    require(cache["k_local"].shape[-3] == GEMMA_WINDOW < s,
            "the windowed layers' caches must roll")

    chunked = Model(dataclasses.replace(cfg, attn_impl="chunked"))
    reset_launches()
    t0 = time.perf_counter()
    runs = {"chunked": chunked.prefill(params, batch, CACHE_LEN)}
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launches["chunked"] = launch_counts()
    want_c = dict(want, flash_attention=0, chunked_attention=cfg.n_layers)
    require(launches["chunked"] == want_c,
            f"gemma3 chunked prefill launches {launches['chunked']}, "
            f"want {want_c}")
    runs["kernel"] = (cache, last)
    plain = Model(dataclasses.replace(cfg, attn_impl="xla_flash"))
    t0 = time.perf_counter()
    plain_cache, plain_last = plain.prefill(params, batch, CACHE_LEN)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for name, control in (("control_mask_one_ahead", causal_mask_one_ahead),
                          ("control_window_ignored", window_ignored)):
        with control():
            runs[name] = plain.prefill(params, batch, CACHE_LEN)
    errs = {}
    for name in list(runs):
        run_cache, run_last = runs.pop(name) if name != "kernel" \
            else runs[name]
        kv, kv_late, worst = kv_rel_err(run_cache, plain_cache, s)
        errs[name] = {"last": rel_max(run_last, plain_last), "kv": kv,
                      "kv_late_half": kv_late, "kv_worst": worst}
        del run_cache, run_last
    del runs, plain_cache
    for name in ("kernel", "chunked"):
        e = errs[name]
        require(e["last"] <= PREFILL_REL_TOL,
                f"gemma3 {name} prefill: last hidden state {e['last']} > "
                f"{PREFILL_REL_TOL}")
        require(e["kv"] <= KV_REL_TOL,
                f"gemma3 {name} prefill: K/V relative error {e['kv']} "
                f"({e['kv_worst']}) > {KV_REL_TOL}")
    for name in ("control_mask_one_ahead", "control_window_ignored"):
        e = errs[name]
        require(min(e["kv"], e["kv_late_half"]) > KV_REL_TOL,
                f"the {name} reads {e['kv']}, {e['kv_late_half']} over the "
                f"late half, not above {KV_REL_TOL}: the K/V gate cannot see "
                "it")
    fa_rec["launches_by_path"]["gemma3-12b prefill"] = \
        launches["kernel"]["flash_attention"]
    ca_rec["launches_by_path"]["gemma3-12b chunked prefill"] = \
        launches["chunked"]["chunked_attention"]
    log(phase="prefill", arch=cfg.name, params=sum(
        t.numel() for g in params.values()
        for t in (g.values() if isinstance(g, dict) else [g])),
        init_s=init_s, batch=b, prompt=s, cache_len=CACHE_LEN,
        window=cfg.window, prefill_s=prefill_s,
        prefill_tokens_per_s=b * s / prefill_s, chunked_prefill_s=chunked_s,
        plain_prefill_s=plain_s, launches=launches, err_vs_plain=errs,
        rel_err_limit=PREFILL_REL_TOL, kv_rel_err_limit=KV_REL_TOL,
        init_peak_mem_gb=init_peak / 1e9,
        prefill_peak_mem_gb=prefill_peak / 1e9,
        run_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return cfg, model, params, cache, last, tokens


def phase_gemma_decode(cfg, model, params, cache, last, tokens) -> None:
    """``DECODE_STEPS`` steps from position 2048, writing rolling slots 0
    to 15 of every windowed layer; then layer 0's rolling K/V, which depend
    only on the tokens and their positions, must equal those of a fresh
    prefill of the same 2064 tokens within ``KV_REL_TOL`` at every slot. A
    control reads the decoded slots against the fresh prefill's next slot
    (the off-by-one a wrong slot index makes) and must fail the gate on K,
    which RoPE ties to its position (V is logged only: greedy decoding may
    repeat a token, and then neighbouring V rows are equal)."""
    s = tokens.shape[1]
    toks = phase_decode(cfg, model, params, cache, last, s)
    seen = torch.cat([tokens, toks[:, :DECODE_STEPS].to(tokens.dtype)],
                     dim=1)
    fresh, _ = model.prefill(params, {"tokens": seen}, CACHE_LEN)
    errs = {}
    for key in ("k_local", "v_local"):
        a = cache[key][0, 0].float().flatten(2)
        b = fresh[key][0, 0].float().flatten(2)
        e = (a - b).norm(dim=-1) / b.norm(dim=-1)
        nxt = b.roll(-1, dims=1)[:, :DECODE_STEPS]   # each slot's next
        shifted = (a[:, :DECODE_STEPS] - nxt).norm(dim=-1) / nxt.norm(dim=-1)
        errs[key] = {"all_slots": float(e.max()),
                     "decoded_slots": float(e[:, :DECODE_STEPS].max()),
                     "control_next_slot": float(shifted.min())}
    del fresh
    for key, e in errs.items():
        require(e["all_slots"] <= KV_REL_TOL,
                f"layer 0 {key} after decode vs a fresh prefill: "
                f"{e['all_slots']} > {KV_REL_TOL}")
    require(errs["k_local"]["control_next_slot"] > KV_REL_TOL,
            f"layer 0 K: the next-slot control reads "
            f"{errs['k_local']['control_next_slot']}, not above "
            f"{KV_REL_TOL}: the gate cannot see a wrong slot")
    log(phase="decode_rolling", arch=cfg.name, start_pos=s,
        slots=[s % GEMMA_WINDOW, (s + DECODE_STEPS - 1) % GEMMA_WINDOW],
        layer0_rel_err_vs_fresh_prefill=errs, limit=KV_REL_TOL)


# ========================================================= moe and vlm
def phase_moe_vlm_kernels(gen, peaks, fa_rec, ca_rec) -> None:
    """Both attention kernels on ``GQA7_CASE`` in fp32 (2e-5) and bf16
    (2e-2), and at arctic's, kimi's and internvl2's prefill shapes in bf16:
    kernel, plain and library times, the bound, TFLOP/s and the share of
    the bound, added to each kernel's record under ``moe_vlm_shapes``."""
    kernels = (("flash", fa.flash_attention_cuda, fa_rec),
               ("chunked", ca.chunked_attention_cuda, ca_rec))
    errs = {}
    b, hq, hkv, sq, skv, d, causal, window = GQA7_CASE
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(gen, b, hq, hkv, sq, skv, d, dtype)
        ref = attention_kernel_ref(q, k, v, causal=causal, window=window)
        for name, kernel, _ in kernels:
            out = kernel(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            require(out.shape == ref.shape and err < TOL[dtype],
                    (name, GQA7_CASE, dtype, err))
            errs[f"{name}/{str(dtype)[6:]}"] = err
    for arch, (b, hq, hkv, s, d) in MOE_VLM_ATTN.items():
        q, k, v = qkv(gen, b, hq, hkv, s, s, d, torch.bfloat16)
        ref = attention_kernel_ref(q, k, v, causal=True)
        plain_ms = time_ms(lambda: attention_kernel_ref(q, k, v, causal=True),
                           reps=20)
        lib_ms = library_ms(q, k, v)
        flops, nbytes = attn_work(b, hq, hkv, s, d)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        for name, kernel, rec in kernels:
            out = kernel(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            require(bool(torch.isfinite(out).all())
                    and err < TOL[torch.bfloat16],
                    f"{name} kernel error {err} at {arch}'s shape")
            ms = time_ms(lambda: kernel(q, k, v, causal=True))
            rec.setdefault("moe_vlm_shapes", {})[arch] = {
                "shape": [b, hq, hkv, s, d], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
                "share_of_bound": bound_ms / ms}
            del out
        del q, k, v, ref
    log(phase="moe_vlm_kernels", gqa7_case=list(GQA7_CASE),
        gqa7_max_abs_err=errs, flash=fa_rec["moe_vlm_shapes"],
        chunked=ca_rec["moe_vlm_shapes"])


def init_model(arch: str):
    """``arch`` at full width and its ``MOE_VLM_DEPTH``, seeded random bf16
    weights on the card: (cfg, model, params, init record)."""
    cfg = dataclasses.replace(get_config(arch), n_layers=MOE_VLM_DEPTH[arch])
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    info = {"init_s": time.perf_counter() - t0,
            "init_peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "params": sum(t.numel() for g in params.values()
                          for t in (g.values() if isinstance(g, dict)
                                    else [g])),
            "depth": [cfg.n_layers, get_config(arch).n_layers]}
    log(phase="init", arch=arch, **info)
    return cfg, model, params, info


@contextlib.contextmanager
def route_replaced(fn):
    """Every ``moe.route`` call replaced by ``fn``."""
    saved = moe.route
    moe.route = fn
    try:
        yield
    finally:
        moe.route = saved


def routing(record: list | None = None, replay: list | None = None):
    """``moe.route`` watched or forced. With ``record`` each call's expert
    choices are appended to it; with ``replay`` (a list recorded from
    another run of the same batch) the i-th call takes the i-th recorded
    choices, weighted by the softmax of its own logits at those experts."""
    route = moe.route
    calls = iter(replay) if replay is not None else None

    def watched(x2d, w_router, top_k):
        if calls is None:
            weights, experts = route(x2d, w_router, top_k)
        else:
            experts = next(calls)
            logits = x2d.float() @ w_router.float()
            weights = torch.softmax(logits.gather(1, experts), dim=-1)
        if record is not None:
            record.append(experts)
        return weights, experts

    return route_replaced(watched)


def not_renormalised(x2d, w_router, top_k):
    """The control's routing: combine weights from the softmax over all E
    logits at the k chosen experts, not renormalised over the k."""
    probs = torch.softmax(x2d.float() @ w_router.float(), dim=-1)
    return torch.topk(probs, top_k, dim=-1)


def moe_parts_ms(x2d, p, mcfg, calls: int = 5) -> dict[str, float]:
    """Device time (ms) of each part of ``moe_local`` (its profiler ranges:
    routing and dispatch, the expert products, the combine): the mean over
    ``calls`` calls of the kernels each range launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    moe.moe_local(x2d, p, mcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            moe.moe_local(x2d, p, mcfg)
        torch.cuda.synchronize()
    parts = {}
    for e in prof.events():
        if e.name.startswith("moe/") and e.device_type == DeviceType.CPU:
            parts[e.name[4:]] = parts.get(e.name[4:], 0.0) \
                + e.device_time_total / 1e3 / calls
    return parts


def moe_work(t: int, mcfg, d: int) -> tuple[int, int]:
    """(flops, bytes) of one ``moe_local`` call on T tokens: the expert
    products over the E x C buffer rows this design multiplies (capacity
    padding included), and every expert's and the router's bf16 weights
    read once, the tokens read and written once."""
    e, f = mcfg.n_experts, mcfg.d_ff_expert
    c = moe._capacity(t, mcfg)
    return 6 * e * c * d * f, 2 * (3 * e * d * f + d * e + 2 * t * d)


def phase_moe(gen, cfg, params, peaks) -> dict:
    """One MoE layer at full width, on layer 0's bf16 weights: the
    dispatch slots of 8192 routed tokens on the card against their CPU
    result; ``moe_local`` without drops against ``moe_dense_oracle``, and
    the not-renormalised control; times at the prefill and decode token
    counts against the bound."""
    mcfg, d = cfg.moe, cfg.d_model
    e = mcfg.n_experts
    layer = params["layers"]
    p = {"router": layer["router"][0], "w_gate": layer["moe_gate"][0],
         "w_up": layer["moe_up"][0], "w_down": layer["moe_down"][0]}
    t = MOE_TIMED_T[0]
    x = torch.randn((t, d), generator=gen, device=DEVICE).to(torch.bfloat16)
    _, experts = moe.route(x, p["router"], mcfg.top_k)
    cap = moe._capacity(t, mcfg)
    slot = moe._dispatch_indices(experts, e, cap)
    cpu = moe._dispatch_indices(experts.cpu(), e, cap)
    require(torch.equal(slot.cpu(), cpu),
            f"{cfg.name}: dispatch slots on the card differ from the CPU's")
    kept = slot[slot < e * cap]
    require(kept.numel() == kept.unique().numel(),
            f"{cfg.name}: two kept assignments share a slot")
    require(bool((slot.div(cap, rounding_mode="floor") == experts)
                 [slot < e * cap].all()),
            f"{cfg.name}: a kept slot outside its expert's range")
    dispatch = {"tokens": t, "top_k": mcfg.top_k, "experts": e,
                "capacity": cap, "assignments": slot.numel(),
                "dropped": int((slot == e * cap).sum()),
                "busiest_expert": int(torch.bincount(
                    experts.flatten(), minlength=e).max())}

    # no drops: the capacity of the busiest expert's load (capacity factor
    # E, C = T k, would be a 42 GB buffer at kimi's width)
    xo = x[:MOE_ORACLE_T]
    load = int(torch.bincount(moe.route(xo, p["router"], mcfg.top_k)[1]
                              .flatten(), minlength=e).max())
    ample = dataclasses.replace(mcfg, capacity_factor=load * e / (
        MOE_ORACLE_T * mcfg.top_k))
    require(moe._capacity(MOE_ORACLE_T, ample) >= load,
            f"{cfg.name}: the no-drop capacity is below the busiest load")
    oracle = moe.moe_dense_oracle(xo, p, ample)
    rel = rel_max(moe.moe_local(xo, p, ample), oracle)
    with route_replaced(not_renormalised):
        ctrl = rel_max(moe.moe_local(xo, p, ample), oracle)
    require(rel <= MOE_REL_TOL,
            f"{cfg.name}: moe_local without drops vs the oracle {rel} > "
            f"{MOE_REL_TOL}")
    require(ctrl > MOE_REL_TOL,
            f"{cfg.name}: the not-renormalised control reads {ctrl}, not "
            f"above {MOE_REL_TOL}")

    timed = {}
    for t in MOE_TIMED_T:
        xt = x[:t]
        ms = time_ms(lambda: moe.moe_local(xt, p, mcfg))
        flops, nbytes = moe_work(t, mcfg, d)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        timed[t] = {"capacity": moe._capacity(t, mcfg), "ms": ms,
                    "part_ms": moe_parts_ms(xt, p, mcfg),
                    "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "share_of_bound": bound_ms / ms}
    rec = {"dispatch": dispatch, "no_drop_rel_err_vs_oracle": rel,
           "control_not_renormalised_rel_err": ctrl,
           "rel_err_limit": MOE_REL_TOL, "oracle_tokens": MOE_ORACLE_T,
           "timed": timed}
    log(phase="moe", arch=cfg.name, **rec)
    return rec


def hidden_rel_err(h, ref, s: int) -> tuple[float, float]:
    """Largest per-position relative L2 error (over D) of hidden states
    (B, S, D) against ``ref``'s: (all positions, the late half)."""
    e = (h.float() - ref.float()).norm(dim=-1) / ref.float().norm(dim=-1)
    return float(e.max()), float(e[:, s // 2:].max())


def forward_with_cache(model, params, batch):
    """``Model.prefill``'s work, returning every position's hidden state:
    (cache, hidden (B, S, D))."""
    cache = model.init_cache(batch["tokens"].shape[0], CACHE_LEN,
                             device=DEVICE)
    hidden = model.forward(params, batch, cache=cache)
    cache["pos"].fill_(batch["tokens"].shape[1])
    return cache, hidden


def routing_agreement(runs: list, ref: list, mcfg, t: int) -> dict:
    """Per MoE layer, the share of (token, choice) pairs of ``runs``' routing
    whose expert is among the same token's choices in ``ref``, and each
    run's dropped assignments."""
    cap = moe._capacity(t, mcfg)
    drop = mcfg.n_experts * cap

    def drops(ex):
        return int((moe._dispatch_indices(ex, mcfg.n_experts, cap)
                    == drop).sum())

    return {"capacity": cap,
            "agree_share": [float((a[:, :, None] == b[:, None, :]).any(-1)
                                  .float().mean()) for a, b in zip(runs, ref)],
            "dropped": [drops(a) for a in runs],
            "dropped_ref": [drops(b) for b in ref]}


def phase_moe_vlm_prefill(gen, cfg, model, params, info, fa_rec, ca_rec):
    """4 x 2048 tokens (internvl2: the first 256 positions patch
    embeddings drawn at the embedding table's scale): exactly n_layers
    flash launches, and chunked ones on the chunked path. The kernel and
    chunked paths against the plain prefill: last hidden state (relative
    max-norm), every position's hidden state and every cached K/V row
    (per-vector relative L2), each within ``PREFILL_REL_TOL`` /
    ``KV_REL_TOL``. MoE models replay the plain prefill's routing on the
    gated paths (``routing``); the unforced main run's agreement and drops
    are logged. Controls: the causal mask one key ahead (and for internvl2
    patches not spliced) must fail a gate."""
    b, _, _, s, _ = MOE_VLM_ATTN[cfg.name]
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    if cfg.kind == "vlm":
        batch["patches"] = (torch.randn(
            (b, cfg.n_patches, cfg.d_model), generator=gen, device=DEVICE)
            / math.sqrt(cfg.d_model)).to(torch.bfloat16)
    model.prefill(params, batch, CACHE_LEN)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    routes = {"main": [], "plain": []}
    reset_launches()
    t0 = time.perf_counter()
    with routing(record=routes["main"]):
        cache, last = model.prefill(params, batch, CACHE_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"kernel": launch_counts()}
    want = {"ssd_scan": 0, "flash_attention": cfg.n_layers,
            "chunked_attention": 0}
    require(launches["kernel"] == want,
            f"{cfg.name} prefill launches {launches['kernel']}, want {want}")
    require(last.shape == (b, cfg.d_model) and torch.isfinite(last).all(),
            "last hidden state shape or finiteness")

    plain = Model(dataclasses.replace(cfg, attn_impl="xla_flash"))
    t0 = time.perf_counter()
    with routing(record=routes["plain"]):
        ref_cache, ref_hidden = forward_with_cache(plain, params, batch)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    replay = routes["plain"]
    runs = {"main_unforced": (cache, last[:, None])}
    with routing(replay=replay):
        runs["kernel"] = forward_with_cache(model, params, batch)
    chunked = Model(dataclasses.replace(cfg, attn_impl="chunked"))
    reset_launches()
    t0 = time.perf_counter()
    with routing(replay=replay):
        runs["chunked"] = forward_with_cache(chunked, params, batch)
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launches["chunked"] = launch_counts()
    want_c = dict(want, flash_attention=0, chunked_attention=cfg.n_layers)
    require(launches["chunked"] == want_c,
            f"{cfg.name} chunked prefill launches {launches['chunked']}, "
            f"want {want_c}")
    controls = ["control_mask_one_ahead"]
    with routing(replay=replay), causal_mask_one_ahead():
        runs["control_mask_one_ahead"] = forward_with_cache(plain, params,
                                                            batch)
    if cfg.kind == "vlm":
        controls.append("control_patches_not_spliced")
        runs["control_patches_not_spliced"] = forward_with_cache(
            plain, params, {"tokens": tokens})
    errs = {}
    for name in list(runs):
        run_cache, run_hidden = runs.pop(name)
        kv, kv_late, worst = kv_rel_err(run_cache, ref_cache, s)
        errs[name] = {"last": rel_max(run_hidden[:, -1], ref_hidden[:, -1]),
                      "kv": kv, "kv_late_half": kv_late, "kv_worst": worst}
        if name != "main_unforced":
            errs[name]["hidden"], errs[name]["hidden_late_half"] = \
                hidden_rel_err(run_hidden, ref_hidden, s)
        del run_cache, run_hidden
    del ref_cache, ref_hidden
    for name in ("kernel", "chunked"):
        e = errs[name]
        require(e["last"] <= PREFILL_REL_TOL,
                f"{cfg.name} {name} prefill: last hidden state {e['last']} "
                f"> {PREFILL_REL_TOL}")
        require(e["kv"] <= KV_REL_TOL,
                f"{cfg.name} {name} prefill: K/V relative error {e['kv']} "
                f"({e['kv_worst']}) > {KV_REL_TOL}")
        require(e["hidden"] <= KV_REL_TOL,
                f"{cfg.name} {name} prefill: hidden states {e['hidden']} > "
                f"{KV_REL_TOL}")
    # a control must fail a gate the sound paths pass. The MoE models have
    # one attention layer before their last K/V (arctic) or none (kimi, whose
    # K/V cannot see attention at all), so theirs is the hidden states over
    # every position (a query among p keys moves by ~p^-1/2 when it sees one
    # key more: the early positions show it); internvl2's 48 layers carry
    # the mask control into the late half of the K/V, as phi3's do, and
    # unspliced patches move every layer's K/V at the first 256 positions
    for name in controls:
        e = errs[name]
        if cfg.kind == "moe":
            seen = e["hidden"]
        elif name == "control_mask_one_ahead":
            seen = min(e["kv"], e["kv_late_half"])
        else:
            seen = e["kv"]
        require(seen > KV_REL_TOL,
                f"{cfg.name}: the {name} reads {e}, not above {KV_REL_TOL}: "
                "the gates cannot see it")
    extra = {}
    if cfg.kind == "moe":
        # the prefill's own routings drop assignments (phase_moe's random
        # hidden states may not): their slots on the card equal the CPU's
        cap = moe._capacity(b * s, cfg.moe)
        require(all(torch.equal(
            moe._dispatch_indices(r, cfg.moe.n_experts, cap).cpu(),
            moe._dispatch_indices(r.cpu(), cfg.moe.n_experts, cap))
            for r in routes["main"] + replay),
            f"{cfg.name}: prefill dispatch slots on the card differ from "
            "the CPU's")
        extra["unforced_routing"] = routing_agreement(
            routes["main"], replay, cfg.moe, b * s)
    fa_rec["launches_by_path"][f"{cfg.name} prefill"] = \
        launches["kernel"]["flash_attention"]
    ca_rec["launches_by_path"][f"{cfg.name} chunked prefill"] = \
        launches["chunked"]["chunked_attention"]
    log(phase="prefill", arch=cfg.name, depth=info["depth"],
        params=info["params"], init_s=info["init_s"], batch=b, prompt=s,
        patches=cfg.n_patches if cfg.kind == "vlm" else 0,
        cache_len=CACHE_LEN, prefill_s=prefill_s,
        prefill_tokens_per_s=b * s / prefill_s, chunked_prefill_s=chunked_s,
        plain_prefill_s=plain_s, launches=launches, err_vs_plain=errs,
        rel_err_limit=PREFILL_REL_TOL, kv_rel_err_limit=KV_REL_TOL,
        init_peak_mem_gb=info["init_peak_mem_gb"],
        prefill_peak_mem_gb=prefill_peak / 1e9,
        run_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)
    return cache, last, batch


def phase_decode_kv(cfg, model, params, cache, last, batch,
                    keys=("k", "v"), cache_len: int = CACHE_LEN) -> None:
    """``DECODE_STEPS`` steps from the prompt's end (2048; whisper's 224);
    then layer 0's self-attention K/V (``keys``) at the decoded positions,
    which depend only on the tokens and their positions (layer 0 lies
    before any MoE, so the capacity of 4 decode tokens against 8256
    prefill tokens cannot separate them), must equal a fresh prefill's of
    the same prompt and decoded tokens (the rest of ``batch``, whisper's
    frames, as it was) within ``KV_REL_TOL``. A control reads each decoded
    row against the fresh prefill's next position and must fail on K."""
    tokens = batch["tokens"]
    s = tokens.shape[1]
    toks = phase_decode(cfg, model, params, cache, last, s)
    seen = torch.cat([tokens, toks[:, :DECODE_STEPS].to(tokens.dtype)],
                     dim=1)
    fresh, _ = model.prefill(params, dict(batch, tokens=seen), cache_len)
    n = s + DECODE_STEPS
    errs = {}
    for key in keys:
        a = cache[key][0, :, :n].float().flatten(2)
        b = fresh[key][0, :, :n].float().flatten(2)
        e = (a - b).norm(dim=-1) / b.norm(dim=-1)
        nxt = b.roll(-1, dims=1)[:, s:n]
        shifted = (a[:, s:n] - nxt).norm(dim=-1) / nxt.norm(dim=-1)
        errs[key] = {"all_positions": float(e.max()),
                     "decoded_positions": float(e[:, s:n].max()),
                     "control_next_position": float(shifted.min())}
    del fresh
    for key, e in errs.items():
        require(e["all_positions"] <= KV_REL_TOL,
                f"{cfg.name} layer 0 {key} after decode vs a fresh prefill: "
                f"{e['all_positions']} > {KV_REL_TOL}")
    control = errs[keys[0]]["control_next_position"]
    require(control > KV_REL_TOL,
            f"{cfg.name} layer 0 K: the next-position control reads "
            f"{control}, not above {KV_REL_TOL}")
    log(phase="decode_kv", arch=cfg.name, positions=[s, n - 1],
        layer0_rel_err_vs_fresh_prefill=errs, limit=KV_REL_TOL)


# ============================================================ whisper-small
def whisper_shapes(cfg) -> dict[str, tuple]:
    """The attention shapes of whisper's prefill (b, hq, hkv, sq, skv, d,
    causal): the encoder's self-attention over the frames, the decoder's
    causal self-attention over the prompt, and its cross-attention from
    the prompt to the frames."""
    b, s, t = WHISPER_BATCH, WHISPER_PROMPT, cfg.enc_len
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"encoder": (b, h, hkv, t, t, d, False),
            "decoder_self": (b, h, hkv, s, s, d, True),
            "cross": (b, h, hkv, s, t, d, False)}


def phase_whisper_kernels(gen, peaks, fa_rec, ca_rec) -> None:
    """Both attention kernels on ``WHISPER_CASES`` and at whisper's three
    prefill shapes, fp32 (the CUDA-core bodies, 2e-5) and bf16 (the
    ``wgmma`` bodies, 2e-2), against their plain version; kernel times in
    both dtypes, and in bf16 the plain and library (SDPA, unmasked or
    causal) times, the bound of the pairs the mask shows, TFLOP/s and the
    share of the bound, added to each kernel's record under
    ``whisper_shapes``."""
    kernels = (("flash", fa.flash_attention_cuda, fa_rec),
               ("chunked", ca.chunked_attention_cuda, ca_rec))
    errs = {}
    for case in WHISPER_CASES:
        b, hq, hkv, sq, skv, d, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(gen, b, hq, hkv, sq, skv, d, dtype)
            ref = attention_kernel_ref(q, k, v, causal=causal, window=window)
            for name, kernel, _ in kernels:
                out = kernel(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                require(out.shape == ref.shape and err < TOL[dtype],
                        (name, case, dtype, err))
                errs[f"{name}/{case}/{str(dtype)[6:]}"] = err

    cfg = get_config("whisper-small")
    for shape, (b, hq, hkv, sq, skv, d, causal) in whisper_shapes(
            cfg).items():
        flops, nbytes = attn_work(b, hq, hkv, sq, d, skv=skv, causal=causal)
        bound_ms, bound_by = bound(flops, nbytes, peaks)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(gen, b, hq, hkv, sq, skv, d, dtype)
            ref = attention_kernel_ref(q, k, v, causal=causal)
            bf16 = dtype == torch.bfloat16
            if bf16:
                plain_ms = time_ms(lambda: attention_kernel_ref(
                    q, k, v, causal=causal), reps=20)
                lib_ms = library_ms(q, k, v, causal=causal)
            for name, kernel, rec in kernels:
                out = kernel(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                require(bool(torch.isfinite(out).all()) and err < TOL[dtype],
                        f"{name} kernel error {err} ({str(dtype)[6:]}) at "
                        f"whisper's {shape} shape")
                ms = time_ms(lambda: kernel(q, k, v, causal=causal))
                entry = rec.setdefault("whisper_shapes", {}).setdefault(
                    shape, {"shape": [b, hq, hkv, sq, skv, d],
                            "causal": causal})
                if not bf16:
                    entry["fp32"] = {"max_abs_err": err, "ms": ms}
                    continue
                entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms, gflop=flops / 1e9,
                             mbytes=nbytes / 1e6, tflops=flops / ms / 1e9,
                             share_of_bound=bound_ms / ms)
                del out
            del q, k, v, ref
    log(phase="whisper_kernels", cases=list(WHISPER_CASES),
        max_abs_err_cases=errs, flash=fa_rec["whisper_shapes"],
        chunked=ca_rec["whisper_shapes"])


def encoder_made_causal():
    """The control: prefill attention (plain chunked) whose encoder
    self-attention is causal, as a kernel that ignored ``causal=False``
    would make it. The encoder's calls are the non-causal ones whose
    queries are their keys (Sq = Skv = 1500); cross-attention (224 queries
    over 1500 keys) stays unmasked, the decoder's self-attention causal."""
    return prefill_attention(
        lambda q, k, v, causal, window: attention.flash_attention_xla(
            q, k, v, causal=causal or q.shape[1] == k.shape[1],
            window=window))


def phase_whisper_prefill(gen, fa_rec, ca_rec):
    """whisper-small at full width and depth, bf16, seeded random weights:
    16 clips of 1500 frames (N(0, 1) from ``gen``, the frontend stub's
    embeddings) and a 224-token prompt each, into a 448-position cache.
    Exactly 36 flash launches (12 encoder, 12 decoder self, 12 cross
    attentions), or 36 chunked ones on the chunked path. Both paths' last
    hidden state (relative max-norm, ``PREFILL_REL_TOL``) and every cached
    K/V row (``KV_REL_TOL``: ``k_self`` / ``v_self`` over the prompt,
    ``k_cross`` / ``v_cross`` over all 1500 frames) against the plain
    prefill. A control whose encoder attention is causal must read above
    the limit on ``k_cross``; the cross K/V of ``init_cache(params=,
    batch=)`` must equal the prefill's within ``KV_REL_TOL``."""
    cfg = get_config("whisper-small")
    model = Model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    b, s, t = WHISPER_BATCH, WHISPER_PROMPT, cfg.enc_len
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=DEVICE),
             "frames": torch.randn((b, t, cfg.d_model), generator=gen,
                                   device=DEVICE)}
    model.prefill(params, batch, WHISPER_CACHE_LEN)      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    cache, last = model.prefill(params, batch, WHISPER_CACHE_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_peak = torch.cuda.max_memory_allocated()
    launches = {"kernel": launch_counts()}
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    want = {"ssd_scan": 0, "flash_attention": n_attn,
            "chunked_attention": 0}
    require(launches["kernel"] == want,
            f"whisper prefill launches {launches['kernel']}, want {want}")
    require(last.shape == (b, cfg.d_model) and torch.isfinite(last).all(),
            "last hidden state shape or finiteness")

    chunked = Model(dataclasses.replace(cfg, attn_impl="chunked"))
    reset_launches()
    t0 = time.perf_counter()
    runs = {"chunked": chunked.prefill(params, batch, WHISPER_CACHE_LEN)}
    torch.cuda.synchronize()
    chunked_s = time.perf_counter() - t0
    launches["chunked"] = launch_counts()
    want_c = dict(want, flash_attention=0, chunked_attention=n_attn)
    require(launches["chunked"] == want_c,
            f"whisper chunked prefill launches {launches['chunked']}, "
            f"want {want_c}")
    runs["kernel"] = (cache, last)
    plain = Model(dataclasses.replace(cfg, attn_impl="xla_flash"))
    t0 = time.perf_counter()
    plain_cache, plain_last = plain.prefill(params, batch, WHISPER_CACHE_LEN)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with encoder_made_causal():
        runs["control_encoder_causal"] = plain.prefill(params, batch,
                                                       WHISPER_CACHE_LEN)
    rows = {"k_cross": t, "v_cross": t}
    cross = ("k_cross", "v_cross")
    filled = model.init_cache(b, WHISPER_CACHE_LEN, device=DEVICE,
                              params=params, batch=batch)
    init_cross = kv_rel_err({k: filled[k] for k in cross}, cache, s, rows)
    del filled
    errs = {}
    for name in list(runs):
        run_cache, run_last = runs.pop(name) if name != "kernel" \
            else runs[name]
        kv, kv_late, worst = kv_rel_err(run_cache, plain_cache, s, rows)
        errs[name] = {"last": rel_max(run_last, plain_last), "kv": kv,
                      "kv_late_half": kv_late, "kv_worst": worst,
                      "k_cross": kv_rel_err(
                          {"k_cross": run_cache["k_cross"]}, plain_cache, s,
                          rows)[0]}
        del run_cache, run_last
    del runs, plain_cache
    for name in ("kernel", "chunked"):
        e = errs[name]
        require(e["last"] <= PREFILL_REL_TOL,
                f"whisper {name} prefill: last hidden state {e['last']} > "
                f"{PREFILL_REL_TOL}")
        require(e["kv"] <= KV_REL_TOL,
                f"whisper {name} prefill: K/V relative error {e['kv']} "
                f"({e['kv_worst']}) > {KV_REL_TOL}")
    ctrl = errs["control_encoder_causal"]["k_cross"]
    require(ctrl > KV_REL_TOL,
            f"the control (encoder made causal) reads {ctrl} on k_cross, "
            f"not above {KV_REL_TOL}: the gate cannot see the encoder's mask")
    require(init_cross[0] <= KV_REL_TOL,
            f"init_cache(params=, batch=)'s cross K/V vs the prefill's: "
            f"{init_cross[0]} ({init_cross[2]}) > {KV_REL_TOL}")
    fa_rec["launches_by_path"]["whisper-small prefill"] = \
        launches["kernel"]["flash_attention"]
    ca_rec["launches_by_path"]["whisper-small chunked prefill"] = \
        launches["chunked"]["chunked_attention"]
    log(phase="prefill", arch=cfg.name, params=sum(
        x.numel() for g in params.values()
        for x in (g.values() if isinstance(g, dict) else [g])),
        depth=[cfg.n_enc_layers, cfg.n_layers], init_s=init_s, batch=b,
        frames=t, prompt=s, cache_len=WHISPER_CACHE_LEN, prefill_s=prefill_s,
        prefill_tokens_per_s=b * s / prefill_s,
        prefill_frames_per_s=b * t / prefill_s, chunked_prefill_s=chunked_s,
        plain_prefill_s=plain_s, launches=launches, err_vs_plain=errs,
        init_cache_cross_rel_err_vs_prefill=init_cross[0],
        rel_err_limit=PREFILL_REL_TOL, kv_rel_err_limit=KV_REL_TOL,
        init_peak_mem_gb=init_peak / 1e9,
        prefill_peak_mem_gb=prefill_peak / 1e9,
        run_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return cfg, model, params, cache, last, batch


def peak_mem(arch: str, what: str, fn, *args, **kw):
    """``fn(*args, **kw)``, logging the device memory peak of the call."""
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kw)
    log(phase="peak_mem", arch=arch, of=what,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def free_model(arch: str) -> None:
    """Release what the last model left in the allocator's cache."""
    gc.collect()
    torch.cuda.empty_cache()
    log(phase="free", arch=arch,
        after_gb=torch.cuda.memory_allocated() / 1e9)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    require(card in PEAKS, f"no peak rates known for {card!r}")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED)
    # the cases added last (NO_KEY_CASE, WIDE_CASE, UNALIGNED_CASE) draw
    # from their own generator, so every other phase sees the data it saw
    # before they were added: phi3's serve gate, request 0's bf16 tokens
    # against its 1-slot solo run, holds for some prompts and not for
    # others (cuBLAS's M=1 and M=4 GEMMs round apart, as zamba2's do; see
    # phase_serve)
    added = torch.Generator(device=DEVICE)
    added.manual_seed(SEED + 1)

    peaks = PEAKS[card]
    usage = phase_build()
    fa_rec = phase_kernel(gen, added, peaks)
    reset_launches()
    cfg, model, params, cache, last = phase_prefill(gen, fa_rec)
    phase_decode(cfg, model, params, cache, last, PHI3_ATTN[3])
    del cache
    peak_mem(cfg.name, "serve", phase_serve, gen, cfg, model, params,
             witness_layers=PHI3_WITNESS_LAYERS)
    phase_profile(gen, cfg, model, params, PHI3_ATTN[0], PHI3_ATTN[3])
    peak_mem(cfg.name, "governed_serve", phase_governed_serve, cfg, model,
             params)
    pipeline_launches = peak_mem(cfg.name, "pipeline", phase_pipeline, cfg,
                                 model, params, peaks)
    fa_rec["pipeline_launches"] = pipeline_launches["flash_attention"]
    held = torch.cuda.memory_allocated()
    del cfg, model, params, last
    gc.collect()
    torch.cuda.empty_cache()
    log(phase="free", arch="phi3-medium-14b", held_gb=held / 1e9,
        after_gb=torch.cuda.memory_allocated() / 1e9)

    ca_rec = phase_attention_kernels(gen, added, peaks, fa_rec)
    ca_rec["pipeline_launches"] = pipeline_launches["chunked_attention"]
    ssd_rec = phase_ssd_kernel(gen, added, peaks)
    cfg, model, params, cache, last = phase_zamba_prefill(
        gen, fa_rec, ca_rec, ssd_rec)
    phase_decode(cfg, model, params, cache, last, ZAMBA_ATTN[3])
    del cache
    peak_mem(cfg.name, "serve", phase_serve, gen, cfg, model, params)
    phase_profile(gen, cfg, model, params, ZAMBA_ATTN[0], ZAMBA_ATTN[3])
    held = torch.cuda.memory_allocated()
    del cfg, model, params, last
    gc.collect()
    torch.cuda.empty_cache()
    log(phase="free", arch="zamba2-7b", held_gb=held / 1e9,
        after_gb=torch.cuda.memory_allocated() / 1e9)

    # the ssm family, whole: its decode step captured and served; prompts
    # from ``added``, so the phases after it see the data they saw before
    cfg = get_config("mamba2-1.3b")
    model = Model(cfg)
    params = model.init(seed=SEED, device=DEVICE)
    peak_mem(cfg.name, "serve", phase_serve, added, cfg, model, params)
    del cfg, model, params
    free_model("mamba2-1.3b")

    phase_gemma_kernels(gen, peaks, fa_rec, ca_rec, usage)
    cfg, model, params, cache, last, tokens = phase_gemma_prefill(
        gen, fa_rec, ca_rec)
    phase_gemma_decode(cfg, model, params, cache, last, tokens)
    del cache
    peak_mem(cfg.name, "serve", phase_serve, gen, cfg, model, params,
             witness_layers=GEMMA_WITNESS_LAYERS)
    phase_profile(gen, cfg, model, params, GEMMA_ATTN[0], GEMMA_ATTN[3])
    del cfg, model, params, last, tokens
    free_model("gemma3-12b")

    phase_moe_vlm_kernels(gen, peaks, fa_rec, ca_rec)
    cfg, model, params, info = init_model("arctic-480b")
    phase_moe(gen, cfg, params, peaks)
    cache, last, batch = phase_moe_vlm_prefill(gen, cfg, model, params, info,
                                               fa_rec, ca_rec)
    phase_decode_kv(cfg, model, params, cache, last, batch)
    del cache, last, batch
    phase_profile(gen, cfg, model, params, *MOE_VLM_ATTN[cfg.name][::3])
    peak_mem(cfg.name, "serve", phase_serve, gen, cfg, model, params,
             witness_layers=ARCTIC_WITNESS_LAYERS, in_place=True)
    del cfg, model, params
    free_model("arctic-480b")

    cfg, model, params, info = init_model("kimi-k2-1t-a32b")
    phase_moe(gen, cfg, params, peaks)
    cache, last, batch = phase_moe_vlm_prefill(gen, cfg, model, params, info,
                                               fa_rec, ca_rec)
    phase_decode_kv(cfg, model, params, cache, last, batch)
    del cache, last, batch
    # its prompts come from ``added``: the phases after it see the data
    # they saw before it was added
    peak_mem(cfg.name, "serve", phase_serve, added, cfg, model, params,
             in_place=True)
    del cfg, model, params
    free_model("kimi-k2-1t-a32b")

    cfg, model, params, info = init_model("internvl2-26b")
    cache, last, batch = phase_moe_vlm_prefill(gen, cfg, model, params, info,
                                               fa_rec, ca_rec)
    phase_decode(cfg, model, params, cache, last, MOE_VLM_ATTN[cfg.name][3])
    del cache, last, batch
    peak_mem(cfg.name, "serve", phase_serve, gen, cfg, model, params,
             witness_layers=VLM_WITNESS_LAYERS)
    phase_profile(gen, cfg, model, params, *MOE_VLM_ATTN[cfg.name][::3])
    del cfg, model, params
    free_model("internvl2-26b")

    arch = "whisper-small"
    peak_mem(arch, "kernels", phase_whisper_kernels, gen, peaks, fa_rec,
             ca_rec)
    cfg, model, params, cache, last, batch = phase_whisper_prefill(
        gen, fa_rec, ca_rec)
    peak_mem(arch, "decode", phase_decode_kv, cfg, model, params, cache,
             last, batch, keys=("k_self", "v_self"),
             cache_len=WHISPER_CACHE_LEN)
    del cache, last
    peak_mem(arch, "serve", phase_serve, gen, cfg, model, params)
    peak_mem(arch, "profile", phase_profile, gen, cfg, model, params,
             WHISPER_BATCH, WHISPER_PROMPT, extra={"frames": batch["frames"]},
             cache_len=WHISPER_CACHE_LEN)

    print(smi_name_power(), flush=True)
    print(json.dumps({"kernels": [fa_rec, ca_rec, ssd_rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
