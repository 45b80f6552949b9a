"""The serving cells: ``repro_torch.serve.ServeEngine`` under open-loop
arrivals.

Set-up makes the weights from the seed, builds the engine (on CUDA its
step is captured as one CUDA graph on the first call), and serves one
short request to warm every path the window takes: the capture, a lane
reset at admission, prompt and output steps. The window then submits each
request of the mix when it is due, and steps the engine while it has
work; it sleeps only while it has none. Every due request is drained, up
to the mix's ``drain_s`` after the window closes; one that does not finish
by then has failed. The host stamps each request's submission, and each of
its tokens when the step that emits it returns.

The answers: a sample of the finished requests, drawn from the seed with
the longest among them, is run through the fp32 reference over its prompt
and the tokens it was served; the number compared is the widest gap by
which a served token's logit lies below the reference's best at its
position (greedy tokens, so 0 where the program agrees exactly).
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import traffic, weights
from bench.harness import Cell, Tracing, port_config
from bench.reference.model import Reference

WARMUP_PROMPT = 3
WARMUP_NEW = 3
# the reference's batch: sequences run together (right-padded, causal)
REF_BATCH = 4


class Run:
    def __init__(self, cell: Cell, tracing: Tracing):
        self.cell, self.tracing = cell, tracing
        self.mix = cell.mix

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        from repro_torch.models.transformer import STACK_DIMS, Model
        from repro_torch.serve.engine import Request

        self.Request = Request
        cfg = port_config(self.cell)
        self.model = Model(cfg)
        self.params = weights.make(self.model.param_shapes(), STACK_DIMS,
                                   self.cell.seed, self.cell.device,
                                   getattr(torch, self.cell.config["dtype"]))
        self.arrivals = traffic.requests(self.mix, self.cell.seconds,
                                         self.cell.seed, cfg.vocab)
        longest = max(len(a.prompt) + a.max_new_tokens
                      for a in self.arrivals)
        if longest > self.mix["max_len"]:
            raise ValueError(f"a request of {longest} tokens exceeds "
                             f"max_len {self.mix['max_len']}")
        self.new_engine()
        self.tracing.warm()
        self.sync()

    def new_engine(self) -> None:
        """A fresh engine over the weights, warmed by one short request
        (which captures its step on CUDA)."""
        from repro_torch.serve.engine import ServeEngine

        self.engine = ServeEngine(self.model, self.params,
                                  batch_slots=self.mix["batch_slots"],
                                  max_len=self.mix["max_len"])
        warm = self.Request(-1, list(range(1, WARMUP_PROMPT + 1)),
                            max_new_tokens=WARMUP_NEW)
        self.engine.submit(warm)
        self.engine.run_until_idle()

    def sync(self) -> None:
        if self.cell.device == "cuda":
            torch.cuda.synchronize()

    # --------------------------------------------------------------- window
    def window(self, meter) -> dict:
        """The mix's lead-in, then the measured window; ``meter`` is read
        as the window opens and closes."""
        eng, arrivals, tr = self.engine, self.arrivals, self.tracing
        seconds = self.cell.seconds
        n = len(arrivals)
        reqs = [self.Request(a.index, a.prompt, max_new_tokens=a.max_new_tokens)
                for a in arrivals]
        # the window's requests: those due after it opens (the lead-in's
        # only bring the engine to its steady load)
        ours = [k for k in range(n) if arrivals[k].due_s >= 0.0]
        submitted = [None] * n
        stamps: list[list[float]] = [[] for _ in range(n)]
        steps = []          # (t_before, t_after, lanes, keys, queued)
        fed = [0] * n                     # tokens each request has fed
        lane = [None] * n                 # the slot each request was given
        waiting, running = [], []
        slice_ = self.mix.get("trace_slice")
        t_lead = time.perf_counter()
        t0 = t_lead - arrivals[0].due_s if arrivals[0].due_s < 0 else t_lead
        due = [t0 + a.due_s for a in arrivals]
        end = t0 + seconds
        drain_end = end + self.mix["drain_s"]
        prof_start = t0 + slice_["start_s"] if slice_ else None
        prof_end = prof_start + slice_["seconds"] if slice_ else None
        i = 0
        while True:
            now = time.perf_counter()
            if now >= t0:
                meter.open()
            if now >= end:
                meter.close()
            if tr.on and prof_start is not None:
                if tr.prof is None and tr.result is None and now >= prof_start:
                    tr.start()
                elif tr.active and now >= prof_end:
                    tr.stop()
            if i < n and due[i] <= now:
                with tr.range("bench/submit"):
                    while i < n and due[i] <= now:
                        eng.submit(reqs[i])
                        submitted[i] = time.perf_counter()
                        waiting.append(i)
                        i += 1
            if not waiting and not running:
                if i >= n:
                    break
                with tr.range("bench/wait_arrival"):
                    time.sleep(max(0.0, min(due[i] - time.perf_counter(),
                                            0.002)))
                continue
            if now >= drain_end:
                break
            with tr.range("bench/engine.step"):
                before = time.perf_counter()
                eng.step()
                after = time.perf_counter()
            # the engine admits FIFO: the head of the waiting list moves
            while waiting and reqs[waiting[0]].admitted_s is not None:
                k = waiting.pop(0)
                lane[k] = next(j for j, r in enumerate(eng.slots)
                               if r is reqs[k])
                running.append(k)
            lanes = keys = 0
            still = []
            for k in running:
                r = reqs[k]
                fed[k] += 1
                lanes += 1
                keys += fed[k]
                if len(r.out) > len(stamps[k]):
                    stamps[k].append(after)
                if not r.done:
                    still.append(k)
            running = still
            steps.append((before, after, lanes, keys, len(waiting)))
        if tr.active:
            tr.stop()
        self.sync()
        time.sleep(max(0.0, end - time.perf_counter()))
        meter.open()
        meter.close()
        opened, closed = meter.t
        self.reqs, self.lanes, self.ours = reqs, lane, ours
        done = [r.done and len(r.out) == r.max_new_tokens for r in reqs]
        last = time.perf_counter()
        ttft, itl = [], []
        for k in ours:
            s = stamps[k]
            # a request that never finished misses every limit: its first
            # token, where it has none, is counted as the run's end
            ttft.append(((s[0] if s else last) - due[k]) * 1e3)
            itl.extend((b - a) * 1e3 for a, b in zip(s, s[1:]))
            if not done[k]:
                itl.append((last - (s[-1] if s else due[k])) * 1e3)
        # every token the window emitted, the lead-in's requests' too
        tokens = sum(1 for s in stamps for t in s if opened < t <= closed)
        return {
            "window_s": closed - opened, "attempted": len(ours),
            "failed": sum(1 for k in ours if not done[k]), "tokens": tokens,
            "samples": {"requests": len(ours), "lead_in_requests":
                        n - len(ours), "token_gaps": len(itl),
                        "steps": sum(1 for st in steps
                                     if opened <= st[0] and st[1] <= closed)},
            "ttft_ms": ttft, "itl_ms": itl,
            # the layers' numbers leave out what the profiler held up
            "serve": {
                "batch_slots": self.mix["batch_slots"],
                "gen_lag_ms": [(submitted[k] - due[k]) * 1e3
                               for k in ours if submitted[k]
                               and tr.clear(due[k])],
                "queue_wait_ms": [
                    (reqs[k].admitted_s - due[k]) * 1e3 for k in ours
                    if reqs[k].admitted_s is not None and tr.clear(due[k])],
                "steps": [st for st in steps
                          if opened <= st[0] and st[1] <= closed
                          and tr.clear(st[0], 0.0) and tr.clear(st[1], 0.0)],
                "t0": t0,
            },
        }

    def free(self) -> None:
        """Drop the program's state (the engine, its graph and cache)."""
        self.engine = None
        gc.collect()
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- answers
    def sample(self) -> list[int]:
        """The requests the check reads, ``check.sample_requests`` in all,
        of those due in the window: the longest finished one, and one drawn from the seed out of each
        of the others' groups by slot, so that every part of the batch is
        read."""
        done = [k for k in self.ours if self.reqs[k].done
                and len(self.reqs[k].out) == self.reqs[k].max_new_tokens]
        if not done:
            return []
        longest = max(done, key=lambda k: len(self.reqs[k].prompt)
                      + len(self.reqs[k].out))
        rest = sorted((k for k in done if k != longest),
                      key=lambda k: (self.lanes[k], k))
        groups = np.array_split(np.array(rest, dtype=np.int64),
                                min(len(rest),
                                    self.mix["check"]["sample_requests"] - 1))
        gen = traffic.rng(self.cell.seed, 5)
        return [longest] + sorted(int(gen.choice(g)) for g in groups
                                  if len(g))

    def gaps(self, ks: list[int], control: bool = False) -> np.ndarray:
        """The gap, under the fp32 reference, of each served token of the
        requests ``ks`` (or, as the control, of the token the fp8
        reference puts first at the same position)."""
        dims = self.cell.dims
        ref = Reference(dims, self.params)
        low = Reference(dims, self.params, fp8=True) if control else None
        out = []
        for b in range(0, len(ks), REF_BATCH):
            group = [self.reqs[k] for k in ks[b:b + REF_BATCH]]
            seqs = [r.prompt + r.out[:-1] for r in group]
            width = max(len(s) for s in seqs)
            tokens = torch.zeros((len(seqs), width), dtype=torch.long,
                                 device=self.cell.device)
            for j, s in enumerate(seqs):
                tokens[j, :len(s)] = torch.tensor(s)
            h = ref.hidden(tokens)
            hl = low.hidden(tokens) if control else None
            for j, r in enumerate(group):
                rows = slice(len(r.prompt) - 1, len(seqs[j]))
                logits = ref.logits(h[j, rows])
                if control:
                    pick = low.logits(hl[j, rows]).argmax(-1)
                else:
                    pick = torch.tensor(r.out, device=logits.device)
                best = logits.max(-1).values
                out.append((best - logits.gather(-1, pick[:, None])[:, 0])
                           .cpu().numpy())
            del h, hl
        return np.concatenate(out) if out else np.zeros(0)

    def check(self) -> dict:
        """The numbers ``correct`` compares, by name."""
        ks = self.sample()
        g = self.gaps(ks)
        return {"served_gap_max": float(g.max()) if g.size else float("inf"),
                "served_tokens_checked": int(g.size)}

    def control(self) -> dict:
        """The same numbers with the fp8 reference in the program's place."""
        ks = self.sample()
        g = self.gaps(ks, control=True)
        return {"served_gap_max": float(g.max()) if g.size else float("inf"),
                "served_tokens_checked": int(g.size)}
