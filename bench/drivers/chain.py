"""The chain cells: the paper's executor on the card.

``plan_pipeline`` plans the model's task chain (ingest, embed, each
layer, head, emit) for the mix's system of H100 classes;
``StreamingPipelineRuntime.from_plan`` runs it with
``pipeline/stages.py``'s ``model_stage_builder``. Set-up makes the
weights, plans, starts the runtime and pushes ``warmup_frames`` through
it (the kernels' first launches, every replica's stream). The window is
one ``run`` over all of the run's frames, available from the start (a
saturating closed loop), its fill and drain included.

The answers: a sample of the frames, drawn from the seed, is run through
the fp32 reference; the numbers compared are the widest relative gap
between the emitted last-position hidden state and the reference's, and
the widest gap by which the emitted greedy token's logit lies below the
reference's best.
"""
from __future__ import annotations

import dataclasses
import gc

import numpy as np
import torch

from bench import traffic, weights
from bench.harness import Cell, Tracing, port_config
from bench.reference.model import Reference


class Run:
    def __init__(self, cell: Cell, tracing: Tracing):
        self.cell, self.tracing = cell, tracing
        self.mix = cell.mix

    def setup(self) -> None:
        from repro_torch.models.transformer import STACK_DIMS, Model
        from repro_torch.pipeline import (
            H100_CLASS, HeterogeneousSystem, StreamingPipelineRuntime,
            plan_pipeline)
        from repro_torch.pipeline.stages import model_stage_builder

        cfg = port_config(self.cell)
        self.model = Model(cfg)
        self.params = weights.make(self.model.param_shapes(), STACK_DIMS,
                                   self.cell.seed, self.cell.device,
                                   getattr(torch, self.cell.config["dtype"]))
        system = self.mix["system"]
        self.plan = plan_pipeline(
            cfg, system=HeterogeneousSystem(
                dataclasses.replace(H100_CLASS, count=system["big"]),
                dataclasses.replace(H100_CLASS, count=system["little"])),
            tokens_per_step=self.mix["batch"] * self.mix["tokens_per_frame"],
            mode="prefill", strategy=self.mix["strategy"])
        builder = model_stage_builder(self.model, self.params,
                                      self.plan.chain.names,
                                      device=self.cell.device)
        self.runtime = StreamingPipelineRuntime.from_plan(
            self.plan, builder).start()
        self.frames = traffic.frames(self.mix, self.cell.seconds,
                                     self.cell.seed, cfg.vocab)
        warm = traffic.frames(self.mix, self.mix["frame_period_s"]
                              * self.mix["warmup_frames"],
                              self.cell.seed + 1, cfg.vocab)
        self.runtime.run(warm, timeout_s=self.mix["timeout_s"])
        self.tracing.warm()
        self.sync()

    def sync(self) -> None:
        if self.cell.device == "cuda":
            torch.cuda.synchronize()

    def window(self, meter) -> dict:
        """The measured window; ``meter`` is read as it opens and closes."""
        tr = self.tracing
        if tr.on:
            tr.start()
        meter.open()
        with tr.range("bench/runtime.run"):
            stats = self.runtime.run(self.frames, warmup=2,
                                     timeout_s=self.mix["timeout_s"])
        meter.close()
        if tr.on:
            tr.stop()
        self.stats = stats
        n = len(self.frames)
        delivered = len(stats["outputs"])
        tokens = self.mix["batch"] * self.mix["tokens_per_frame"]
        stages = (self.plan.freq_solution or self.plan.solution).stages
        return {
            "window_s": stats["total_s"], "attempted": n,
            "failed": n - delivered,
            "tokens": delivered * tokens,
            "samples": {"frames": delivered},
            "chain": {
                "frames": delivered, "tokens_per_frame": tokens,
                "period_s": stats["period_s"],
                "plan_period_s": self.plan.period_us * 1e-6,
                "busy_s": sum(stats["busy_s"].values()),
                "replicas": sum(st.cores for st in stages),
            },
        }

    def free(self) -> None:
        """Stop the runtime and drop its threads and streams."""
        self.runtime.stop()
        self.runtime = None
        gc.collect()
        if self.cell.device == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        n = len(self.stats["outputs"])
        gen = traffic.rng(self.cell.seed, 5)
        take = min(n, self.mix["check"]["sample_frames"])
        return sorted(gen.choice(n, take, replace=False).tolist())

    def readings(self, control: bool = False) -> dict:
        """The widest hidden-state gap and token-logit gap over the
        sampled frames, of the program's answers against the fp32
        reference (or, as the control, of the fp8 reference's)."""
        dims = self.cell.dims
        ref = Reference(dims, self.params)
        low = Reference(dims, self.params, fp8=True) if control else None
        rel, gap = [], []
        for k in self.sample():
            frame = torch.as_tensor(self.frames[k], device=self.cell.device)
            h = ref.hidden(frame)[:, -1]
            logits = ref.logits(h)
            if control:
                hp = low.hidden(frame)[:, -1]
                tok = low.logits(hp).argmax(-1)
            else:
                tok_np, hp = self.stats["outputs"][k]
                hp = hp.to(h.device)
                tok = torch.as_tensor(np.asarray(tok_np), device=h.device
                                      ).long().reshape(-1)
            rel.append(float(((hp.float() - h).norm(dim=-1)
                              / h.norm(dim=-1)).max()))
            best = logits.max(-1).values
            gap.append(float((best - logits.gather(-1, tok[:, None])[:, 0])
                             .max()))
        inf = float("inf")
        return {"hidden_rel_gap_max": max(rel) if rel else inf,
                "token_gap_max": max(gap) if gap else inf,
                "frames_checked": len(rel)}

    def check(self) -> dict:
        return self.readings()

    def control(self) -> dict:
        return self.readings(control=True)
