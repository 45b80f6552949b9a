"""Deterministic synthetic data pipeline with host-side prefetch, the
port's own copy of ``repro.data.synthetic`` (numpy only): ``batch(step)``
is bit-identical to the reference's.

Tokens are a seeded Zipf-ish stream with a simple learnable structure
(next token depends on the previous token modulo a fixed permutation +
noise) so small-model training visibly reduces loss. Batches are keyed by
(seed, step) alone — restart-safe and host-shardable: host h of H draws the
[h::H] slice of the global batch, which is exactly the multi-host data
parallelism contract.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 17, structure: float = 0.9,
                 host_index: int = 0, host_count: int = 1,
                 extra_fields: dict | None = None):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.structure = structure
        self.host_index = host_index
        self.host_count = host_count
        self.extra_fields = extra_fields or {}
        rng = np.random.default_rng(seed)
        self.perm = rng.permutation(vocab)

    def batch(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 31 + self.host_index)
        b = self.global_batch // self.host_count
        toks = np.empty((b, self.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        noise = rng.random((b, self.seq_len)) > self.structure
        rand = rng.integers(0, self.vocab, size=(b, self.seq_len))
        for t in range(self.seq_len):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
        for name, shape_dtype in self.extra_fields.items():
            shape, dtype = shape_dtype
            out[name] = rng.standard_normal((b, *shape)).astype(dtype)
        return out


class Prefetcher:
    """Double-buffered background batch producer."""

    def __init__(self, source: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch(step)
            self._q.put((step, batch))
            step += 1

    def next(self):
        return self._q.get()

    def close(self):
        """Stop the producer and wait for it: drain the queue until the
        thread, whose pending ``put`` then succeeds, sees the stop and
        exits."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
