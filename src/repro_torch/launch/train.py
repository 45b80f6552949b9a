"""Training driver, the port's counterpart of ``repro.launch.train`` on one
device (``cuda`` unless ``--device`` names another):

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --device cpu --steps 20

It takes the reference's flags and prints its step lines.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.config import get_config, get_smoke_config
from repro_torch.models.transformer import Model
from repro_torch.train import (
    OptConfig, TrainConfig, init_train_state, make_train_step)
from repro_torch.train.optimizer import tree_leaves


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--opt", default="adamw8", choices=["adamw", "adamw8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    tcfg = TrainConfig(
        n_microbatches=args.microbatches,
        opt=OptConfig(name=args.opt, lr=args.lr, warmup=10,
                      total_steps=args.steps * 2),
    )
    data = SyntheticLM(cfg.vocab, args.seq, args.batch, seed=17)
    state = init_train_state(model, 0, tcfg, device=dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"opt={args.opt} batch={args.batch} seq={args.seq}")

    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume and mgr.latest_step() is not None:
        start = mgr.latest_step() + 1
        state, _ = mgr.restore(start - 1, state)
        print(f"resumed from step {start - 1}")

    step_fn = make_train_step(model, tcfg)
    pf = Prefetcher(data, start_step=start)
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            _, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            if i % 10 == 0 or i == args.steps - 1:
                dt = (time.time() - t0) / max(i - start + 1, 1)
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} [{dt:.2f}s/step]")
            if mgr and (i % args.ckpt_every == args.ckpt_every - 1):
                mgr.save(i, state)  # async
    finally:
        pf.close()
        if mgr:
            mgr.wait()
    print("done")


if __name__ == "__main__":
    main()
