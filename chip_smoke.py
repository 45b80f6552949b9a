#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a
machine with a CUDA GPU (Hopper, ``sm_90a``).

Phases, each printing one JSON line:
  build   : compile the CUDA kernels from the checkout's sources, timed,
            with the compiler's output (ptxas registers and spills).
  kernel  : the flash-attention kernel against its plain version
            (``attention_ref``) on the six reference cases in fp32 (2e-5)
            and bf16 (2e-2) and at phi3-medium-14b's prefill shape; kernel,
            plain and library (``scaled_dot_product_attention``, the
            yardstick only) times and the card's bound.
  prefill : phi3-medium-14b at full width, bf16, random weights from a
            seeded generator: ``Model.prefill`` of 4 x 2048 tokens, 40
            kernel launches; every layer's cached K/V at every position
            and the last hidden state against a prefill whose attention
            is the plain chunked version, and against a control prefill
            whose causal mask lets each query see one key ahead (the
            gate must reject the control).
  decode  : 16 greedy ``decode_step``s from the prefilled cache.
  serve   : ``ServeEngine`` with 4 slots answers 6 requests, admitting the
            last two mid-run into freed slots; the first request's tokens
            must equal its solo run.
  profile : a torch.profiler trace of one prefill and four decode steps:
            device busy time, idle share, top kernels.
Then the card's name and power limit, one JSON line of kernel records,
and the result line. Any failure raises and exits non-zero; without a
CUDA device it exits 1 before any phase.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import attention, embedloss, transformer  # noqa: E402
from repro_torch.models.config import get_config  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

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
# dense bf16 tensor-core FLOP/s and HBM bytes/s of the one card this script
# knows (NVIDIA's data sheet, SXM part, 700 W); any other card is refused
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}
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


def library_ms(q, k, v) -> float:
    """One PyTorch call computing the same function, timed as a yardstick;
    the port never calls it."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))


def smi_name_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    build.extension(verbose=True)
    log(phase="build", seconds=time.perf_counter() - t0,
        sources=[str(s.relative_to(Path(__file__).resolve().parent))
                 for s in build.SOURCES])


def phase_kernel(gen, peaks: tuple[float, float]) -> dict:
    errs = {}
    for case in FLASH_CASES:
        b, hq, hkv, sq, skv, d, causal, window = case
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = qkv(gen, b, hq, hkv, sq, skv, d, dtype)
            out = fa.flash_attention_cuda(q, k, v, causal=causal,
                                          window=window)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            require(out.shape == (b, hq, sq, d), (case, out.shape))
            require(err < TOL[dtype], (case, dtype, err))
            errs[f"{case}/{str(dtype)[6:]}"] = err

    b, hq, hkv, s, d = PHI3_ATTN
    q, k, v = qkv(gen, b, hq, hkv, s, s, d, torch.bfloat16)
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    ref = attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    require(torch.isfinite(out).all() and err < TOL[torch.bfloat16],
            f"phi3-shape kernel error {err}")
    ms = time_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = time_ms(lambda: attention_ref(q, k, v, causal=True), reps=20)
    lib_ms = library_ms(q, k, v)
    flops = 2 * b * hq * s * s * d               # causal: half of 4 B H S^2 D
    nbytes = 2 * b * s * (2 * hq + 2 * hkv) * d  # q, o, k, v in bf16
    peak_flops, peak_bw = peaks
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    rec = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/flash_attention/csrc/"
                     "flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:109",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms}
    log(phase="kernel", cases=len(errs), max_abs_err_cases=errs,
        shape=list(PHI3_ATTN), dtype="bfloat16", causal=True,
        tflops=flops / ms / 1e9, **{k: v for k, v in rec.items()
                                    if k != "launches"})
    return rec


def kv_rel_err(cache, ref, s: int) -> tuple[float, float, int]:
    """Largest per-position relative L2 error (over Hkv x hd) of the first
    ``s`` cached K/V rows against ``ref``'s, over layers, lanes and
    positions: (all positions, the late half, worst layer)."""
    worst, late, layer = 0.0, 0.0, -1
    for key in ("k", "v"):
        for i in range(cache[key].shape[0]):
            a = cache[key][i, :, :s].float().flatten(2)
            b = ref[key][i, :, :s].float().flatten(2)
            e = (a - b).norm(dim=-1) / b.norm(dim=-1)
            if float(e.max()) > worst:
                worst, layer = float(e.max()), i
            late = max(late, float(e[:, s // 2:].max()))
    return worst, late, layer


@contextlib.contextmanager
def causal_mask_one_ahead():
    """The control: prefill attention (plain chunked) whose causal mask
    lets every query see the key one position ahead, the off-by-one a
    faulty kernel could make."""
    def leaky(q, k, v, *, causal, window, impl):
        return attention.flash_attention_xla(q, k, v, causal=causal,
                                             window=window, q_offset=1)
    saved = transformer.context_attention
    transformer.context_attention = leaky
    try:
        yield
    finally:
        transformer.context_attention = saved


def phase_prefill(gen, rec: dict):
    cfg = get_config("phi3-medium-14b")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=SEED, device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    b, _, _, s, _ = PHI3_ATTN
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=DEVICE)
    batch = {"tokens": tokens}
    model.prefill(params, batch, CACHE_LEN)          # warm-up
    torch.cuda.synchronize()
    # init draws each leaf in fp32 before the cast: its largest leaf's
    # draw sets the run's peak, so the prefill's own peak is read apart
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
        prefill_peak_mem_gb=prefill_peak / 1e9)
    return cfg, model, params, cache, last


def phase_decode(cfg, model, params, cache, last) -> None:
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
    require(bool((cache["pos"] == PHI3_ATTN[3] + DECODE_STEPS).all()),
            "cache positions after decode")
    log(phase="decode", batch=toks.shape[0], steps=DECODE_STEPS,
        step_ms_p50=statistics.median(times) * 1e3,
        step_ms_max=max(times) * 1e3, tokens=toks[0].tolist())


def phase_serve(gen, cfg, model, params) -> None:
    lens = torch.randint(32, 65, (6,), generator=gen, device=DEVICE).tolist()
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen,
                             device=DEVICE).tolist() for n in lens]
    engine = ServeEngine(model, params, batch_slots=4, max_len=128)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    steps = 0
    first_admit = None
    t0 = time.perf_counter()
    while engine.queue or any(r is not None for r in engine.slots):
        engine.step()
        steps += 1
        if first_admit is None:
            first_admit = {r.rid for r in reqs if r.admitted_s is not None}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(all(r.done and len(r.out) == 16 for r in reqs),
            "a request did not finish with 16 tokens")
    require(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
            "a served token outside the vocab")
    mid_run = [r.rid for r in reqs if r.rid not in first_admit]
    require(mid_run, "no request was admitted mid-run")

    solo = ServeEngine(model, params, batch_slots=1, max_len=128)
    alone = Request(rid=0, prompt=prompts[0], max_new_tokens=16)
    solo.submit(alone)
    solo.run_until_idle()
    require(alone.out == reqs[0].out,
            "the first request's tokens differ from its solo run")
    log(phase="serve", requests=len(reqs), prompt_lens=lens, steps=steps,
        wall_s=wall, requests_per_s=len(reqs) / wall,
        tokens_per_s=16 * len(reqs) / wall, admitted_mid_run=mid_run,
        first_request_equals_solo=True)


def _profile(fn) -> dict:
    """Device time of ``fn`` from a torch.profiler trace: the union of the
    CUDA activity intervals against the host's wall time (the profiler's
    own host overhead is in the wall time), and the top kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, reach, by_name = 0.0, float("-inf"), {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + end - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / wall_us, "device_ops": len(spans),
            "top_ms": [[name, t / 1e3] for name, t in top]}


def phase_profile(gen, cfg, model, params) -> None:
    b, _, _, s, _ = PHI3_ATTN
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=DEVICE)}
    out = {}
    prefill = _profile(lambda: out.update(
        res=model.prefill(params, batch, CACHE_LEN)))
    cache, last = out["res"]
    tok = embedloss.greedy(last, params["embed"], valid_vocab=cfg.vocab)
    decode = _profile(lambda: [model.decode_step(params, cache, tok)
                               for _ in range(4)])
    log(phase="profile", prefill=prefill, decode_4_steps=decode)


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

    phase_build()
    rec = phase_kernel(gen, PEAKS[card])
    cfg, model, params, cache, last = phase_prefill(gen, rec)
    phase_decode(cfg, model, params, cache, last)
    del cache
    phase_serve(gen, cfg, model, params)
    phase_profile(gen, cfg, model, params)

    print(smi_name_power(), flush=True)
    print(json.dumps({"kernels": [rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
