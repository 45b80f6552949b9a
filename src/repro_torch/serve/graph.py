"""The serving engine's decode step as one CUDA graph: the port's
counterpart of the reference's ``jax.jit(model.decode_step,
donate_argnums=(1,))`` (``repro/serve/engine.py``).

``Model.decode_step`` has static shapes, reads ``pos`` on the device,
branches on no device value and writes the cache in place, so one step
captured over the engine's preallocated cache replays every later step:
one graph launch in place of the layer-by-layer launches from Python. A
capture that fails raises; nothing falls back to the eager step.
"""
from __future__ import annotations

import torch

WARMUP_STEPS = 2


class CapturedStep:
    """``model.decode_step`` captured once and replayed, called as
    ``decode_step`` is: ``(params, cache, tokens (B,) int32) ->
    (next_tokens (B,) int32, cache)``.

    The first call warms up on the capture stream over a scratch copy of
    the cache (so no lane's state moves), then captures one step over
    ``cache`` into a ``torch.cuda.CUDAGraph`` on that stream, reading a
    static (B,) int32 token buffer. Every call then copies ``tokens`` into
    that buffer and replays: the capture recorded the step without running
    it, so the first replay is the first step. The returned tokens are the
    graph's static output, overwritten by the next replay. The graph reads
    ``params`` and ``cache`` at their addresses at capture, so they must
    be the captured ones for its life (every write of ``decode_step`` is
    in place, and a lane reset zeroes rows in place); others raise."""

    def __init__(self, model):
        self.model = model
        self.graph: torch.cuda.CUDAGraph | None = None
        self.params = self.cache = self.tokens = self.out = None

    def __call__(self, params, cache, tokens: torch.Tensor):
        if self.graph is None:
            self._capture(params, cache, tokens)
        elif params is not self.params or cache is not self.cache:
            raise ValueError("a captured step replays over the params and "
                             "cache it was captured with")
        self.tokens.copy_(tokens, non_blocking=True)
        self.graph.replay()
        return self.out, cache

    def _capture(self, params, cache, tokens: torch.Tensor) -> None:
        device = cache["pos"].device
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA cache, not {device}")
        self.params, self.cache = params, cache
        self.tokens = torch.zeros(tokens.shape, dtype=torch.int32,
                                  device=device)
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph)
        # warm up on the capture stream, which torch makes once per
        # process: cuBLAS keeps a workspace per stream for the process's
        # life, so a stream per capture would hold one more each time
        stream = capture.capture_stream
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            scratch = {key: leaf.clone() for key, leaf in cache.items()}
            for _ in range(WARMUP_STEPS):
                self.model.decode_step(params, scratch, self.tokens)
        torch.cuda.current_stream(device).wait_stream(stream)
        del scratch
        with capture:
            self.out, _ = self.model.decode_step(params, cache, self.tokens)
        self.graph = graph          # only a whole capture is ever replayed
