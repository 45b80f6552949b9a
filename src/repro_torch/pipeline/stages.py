"""Stage functions of a model's layer chain for the streaming runtime.

:func:`model_stage_builder` is a ``from_plan`` stage builder over the task
names of :func:`~repro_torch.pipeline.planner.model_chain` (``ingest``,
``embed``, ``layer{i}``, ``head``, ``emit``): a stage runs its tasks in
order on one frame, a (B, S) array of token ids.

  - ``ingest`` copies the frame's tokens to the device;
  - ``embed`` is the token embedding (a frame that skipped ``ingest``
    is moved to the device here);
  - ``layer{i}`` is the model's ``i``-th layer in prefill form (no
    cache), its attention through the config's ``attn_impl``: the flash
    kernel by default, or the implementation the plan's stage variant
    names (``"chunked"``: the two-pass kernel);
  - ``head`` is the final norm, the greedy token of the last position
    and that position's hidden state;
  - ``emit`` copies both to the host (numpy tokens, a CPU fp32 hidden
    state).

A stage variant that no attention implementation answers to raises.

On CUDA every replica thread issues its work on a stream of its own, and a
stage fn waits for its stream before it returns, so the runtime's busy
time (wall time around the call) is device time and not launch time. A
tensor handed in from another replica's stream is recorded on this one
(``record_stream``), so the caching allocator cannot give its block to the
producer's stream while this stream still reads it.

With an enabled ``tracer`` (a :class:`repro_torch.obs.Tracer`) a stage fn
records one span per task, named as the task and in chain order (the
host's time to issue it: ``emit`` waits for its copies), and a
``stage/sync`` span around its wait for the stream; they nest in the
runtime's span of the frame.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import torch

from repro_torch.models import embedloss
from repro_torch.models.layers import rms_norm, rope_table
from repro_torch.models.transformer import DENSE_KINDS, Model

# plan variant name -> ``ModelConfig.attn_impl`` (the non-base variants of
# ``kernels/registry.py``'s flash_attention family); "base" keeps the
# config's own
VARIANT_ATTN_IMPL = {"chunked": "chunked", "xla": "xla_flash"}


def model_stage_builder(model: Model, params, names, *, device,
                        tracer=None):
    """A three-argument ``from_plan`` builder ``(start, end, stage)`` over
    the chain task ``names`` of a model whose every layer is an attention
    block (the dense, windowed dense, moe and vlm families); the stage's
    ``variant`` (default "base") selects the layers' attention
    implementation. ``tracer``: spans of each task and of the stream
    wait while it is enabled."""
    cfg = model.cfg
    if cfg.kind not in DENSE_KINDS:
        raise NotImplementedError(
            f"{cfg.name}: kind {cfg.kind!r}; the chain's stage fns run "
            f"the attention-block families {DENSE_KINDS}")
    device = torch.device(device)
    layers = list(model._layers(params))
    models = {}
    ropes = {}

    def rope(s: int):
        if s not in ropes:
            table = rope_table(torch.arange(s, device=device), cfg.hd,
                               cfg.rope_theta)
            if device.type == "cuda":
                # other replicas' streams read it as soon as it is shared
                torch.cuda.current_stream(device).synchronize()
            ropes[s] = table
        return ropes[s]

    def variant_model(variant: str) -> Model:
        if variant not in models:
            impl = cfg.attn_impl if variant == "base" \
                else VARIANT_ATTN_IMPL[variant]
            models[variant] = model if impl == cfg.attn_impl else Model(
                dataclasses.replace(cfg, attn_impl=impl))
        return models[variant]

    local = threading.local()

    def stream():
        if device.type != "cuda":
            return None
        if not hasattr(local, "stream"):
            local.stream = torch.cuda.Stream(device=device)
        return local.stream

    def to_device(tokens):
        return torch.as_tensor(tokens).to(device)

    def build(start: int, end: int, stage=None):
        m = variant_model(getattr(stage, "variant", "base"))
        tasks = [names[t] for t in range(start, end + 1)]
        for task in tasks:
            if task not in ("ingest", "embed", "head", "emit") and not (
                    task.startswith("layer") and task[5:].isdigit()):
                raise ValueError(f"unknown chain task {task!r}")

        def one(task, h):
            if task == "ingest":
                return to_device(h)
            if task == "embed":
                if not isinstance(h, torch.Tensor) or h.device != device:
                    h = to_device(h)
                return embedloss.embed_in(params["embed"], h,
                                          getattr(torch, cfg.compute_dtype))
            if task == "head":
                h = rms_norm(h, params["ln_final"], cfg.norm_eps)[:, -1]
                return (embedloss.greedy(h, params["embed"],
                                         valid_vocab=cfg.vocab), h)
            if task == "emit":
                return (h[0].cpu().numpy(), h[1].float().cpu())
            return _layer(m, layers[int(task[5:])], h, rope)

        def run(x, tracing):
            h = x
            for task in tasks:
                t = time.perf_counter() if tracing else 0.0
                h = one(task, h)
                if tracing:
                    tracer.complete(task, t, time.perf_counter() - t,
                                    cat="task")
            return h

        def fn(x):
            tracing = tracer is not None and tracer.enabled
            s = stream()
            if s is None:
                return run(x, tracing)
            for t in (x if isinstance(x, tuple) else (x,)):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(s)
            with torch.cuda.stream(s):
                out = run(x, tracing)
            t = time.perf_counter() if tracing else 0.0
            s.synchronize()
            if tracing:
                tracer.complete("stage/sync", t, time.perf_counter() - t,
                                cat="task")
            return out

        return fn

    return build


def _layer(model: Model, layer, x: torch.Tensor, rope) -> torch.Tensor:
    """One attention block of ``model._layers`` on the hidden state ``x``
    (B, S, D): ``Model._layer`` with no cache views, as ``Model.forward``
    runs it without a cache; ``rope(S)`` gives the (sin, cos) tables."""
    kind, p, _, window, rolling = layer
    return model._layer(kind, p, None, window, rolling, x,
                        *rope(x.shape[1]), None)
