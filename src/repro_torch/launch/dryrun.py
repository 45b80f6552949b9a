"""Multi-pod dry-run: every (architecture x input shape) cell's step run
abstractly on the single-pod (16, 16) and multi-pod (2, 16, 16)
production meshes, in one process (the counterpart of
``repro.launch.dryrun``).

The mesh is built over the "fake" process-group backend at world size 256
or 512 (rank 0), and every tensor lives on the ``meta`` device, so no
memory is allocated and no device is needed; collectives are issued and
counted but move nothing. The kernels' forwards are evaluated abstractly
(output shapes) and their work is added from their formulas.

Per cell this writes, into dryrun_out_torch/<arch>__<shape>__<mesh>.json:
  - per-device bytes of the step's arguments (the parameters among them)
    and outputs (the local shards);
  - per-device FLOPs (``FlopCounterMode``'s formulas over the ops each
    rank runs, plus the kernels' own);
  - per-kind collective count and per-device bytes (all-reduce counted
    twice its payload, as the reference's parse of the post-SPMD HLO);
  - the step's wall seconds; and the peak of temporaries when
    ``torch.distributed._tools.mem_tracker`` runs over meta tensors, else
    ``"peak": null`` and the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.flash_attention import chunked as fa_chunked
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.specs import (
    abstract_params_sharded, abstract_state_sharded, batch_specs,
    decode_specs)
from repro_torch.models.config import (
    SHAPES, get_config, list_archs, shape_cells)
from repro_torch.models.transformer import Model
from repro_torch.sharding import rules, use_ctx
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.step import (
    TrainConfig, make_train_step, shardings_of, train_state_axes)

OUT_DIR = Path(__file__).resolve().parents[3] / "dryrun_out_torch"
N_MICROBATCHES = 8
FSDP_THRESHOLD = 100e9  # params above this get FSDP + bf16 grad accumulation
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
# collective ops by their dispatcher names (functional and c10d)
_KIND = {
    "all_gather_into_tensor": "all-gather", "_allgather_base_": "all-gather",
    "allgather_": "all-gather", "all_reduce": "all-reduce",
    "allreduce_": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}


def train_config(cfg) -> TrainConfig:
    big = cfg.param_count()[0] > FSDP_THRESHOLD
    return TrainConfig(
        n_microbatches=N_MICROBATCHES, opt=OptConfig(name="adamw8"),
        grad_accum_dtype="bfloat16" if big else "float32", fsdp_params=big)


def _decode_rules(cfg):
    """Rule overrides for decode cells: MoE giants shard experts over
    'model' and the expert FF dim over ('pod', 'data')."""
    if cfg.kind == "moe":
        return {"batch": ("data",), "experts": ("model",),
                "expert_ff": ("pod", "data")}
    return None


def build_step(cfg, shape_name: str):
    """(fn, args) of the cell's step, as the reference's
    ``build_lowerable(variant="true")``: the train step (gradient and
    optimizer update) over the ZeRO/FSDP-laid state, the prefill, or the
    serve step."""
    model = Model(cfg)
    shape = SHAPES[shape_name]
    tcfg = train_config(cfg)
    if shape.mode == "train":
        state = abstract_state_sharded(model, tcfg)
        pshard = shardings_of(state["params"],
                              train_state_axes(model, tcfg)["params"])
        step = make_train_step(model, tcfg, param_shardings=pshard)
        return step, (state, batch_specs(cfg, shape))
    if shape.mode == "prefill":
        params = abstract_state_sharded(model, tcfg)["params"] \
            if tcfg.fsdp_params else abstract_params_sharded(model)

        def prefill_step(params, batch):
            return model.prefill(params, batch, cache_len=shape.seq_len)

        return prefill_step, (params, batch_specs(cfg, shape))
    cache, tokens = decode_specs(model, shape)
    return model.decode_step, (abstract_params_sharded(model), cache,
                               tokens)


# ------------------------------------------------------------- counting
def _attention_pairs(sq, skv, causal, window, q_offset) -> int:
    """The (query, key) pairs the mask lets through."""
    total = 0
    for r in range(sq):
        qa = q_offset + r
        hi = min(skv, qa + 1) if causal else skv
        lo = max(0, qa - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


class Census(TorchDispatchMode):
    """Per-device FLOPs and collectives of what runs under it. A DTensor
    op is handed back to DTensor (``NotImplemented``), so that the local
    ops and the collectives it issues on each rank's shards are what is
    counted, as the reference's per-device cost analysis counts."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.kernel_flops = 0
        self.collectives = {k: 0 for k in COLLECTIVES}
        self.collectives["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = getattr(func, "_overloadpacket", None)
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        kind = _KIND.get(packet.__name__ if packet else "")
        if kind and func.namespace in ("_c10d_functional", "c10d"):
            # the per-device result: a functional op's output, a c10d
            # op's output buffer (its first argument)
            t = out if func.namespace == "_c10d_functional" else args[0]
            t = t[0] if isinstance(t, (list, tuple)) else t
            self.collectives[kind] += t.numel() * t.element_size() * (
                2 if kind == "all-reduce" else 1)
            self.collectives["count"] += 1
        return out


def _abstract_kernels(census: Census):
    """The kernels' forwards as abstract evaluations on meta tensors,
    their work added to ``census`` from their formulas. Returns a restore
    function."""
    saved = (fa_kernel._flash_fwd, fa_chunked._chunked_fwd,
             ssd_kernel._ssd_fwd)

    def attention(q, k, v, causal, window, q_offset=0, scale=None):
        b, hq, sq, d = q.shape
        pairs = _attention_pairs(sq, k.shape[2], causal, window, q_offset)
        census.kernel_flops += 4 * b * hq * d * pairs
        return torch.empty((b, sq, hq, d), dtype=q.dtype,
                           device=q.device).transpose(1, 2)

    def ssd(x, dt, a, bmat, cmat, chunk, init_state):
        b, l, h, p = x.shape
        n = bmat.shape[-1]
        q = min(int(chunk), l)
        full, rem = divmod(l, q)
        pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
        census.kernel_flops += 2 * b * pairs * n + 2 * b * h * pairs * p \
            + 4 * b * h * l * n * p
        return (torch.empty_like(x, memory_format=torch.contiguous_format),
                torch.empty((b, h, p, n), dtype=torch.float32,
                            device=x.device))

    fa_kernel._flash_fwd = attention
    fa_chunked._chunked_fwd = attention
    ssd_kernel._ssd_fwd = ssd

    def restore():
        (fa_kernel._flash_fwd, fa_chunked._chunked_fwd,
         ssd_kernel._ssd_fwd) = saved

    return restore


def _local_bytes(tree) -> int:
    """Bytes of every tensor in a tree on one device: a DTensor's local
    shard, a plain tensor whole."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return 0
    t = tree.to_local() if rules.is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def _mem_tracker():
    """(a ``MemTracker`` to run the step under, None), or (None, the reason
    it cannot be had)."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        return MemTracker(), None
    except Exception as e:  # noqa: BLE001 - the reason is the record
        return None, f"{type(e).__name__}: {e}"[:300]


def _run(cfg, shape_name, mesh, rules_over) -> dict:
    """One run of the cell's step under the census and, beneath it, the
    memory tracker: the census hands DTensor ops to DTensor and counts the
    local ops, which then reach the tracker as each rank's allocations."""
    census = Census()
    restore = _abstract_kernels(census)
    tracker, reason = _mem_tracker()
    try:
        with use_ctx(mesh, rules=rules_over):
            fn, args = build_step(cfg, shape_name)
            params = args[0]["params"] if "params" in args[0] else args[0]
            rec = {"n_layers": cfg.n_layers,
                   "argument_bytes": _local_bytes(args),
                   "param_bytes": _local_bytes(params)}
            t0 = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if tracker is not None:
                    stack.enter_context(tracker)
                stack.enter_context(census)
                out = fn(*args)
            rec["wall_s"] = time.perf_counter() - t0
            rec["output_bytes"] = _local_bytes(out)
            rec["flops"] = census.flops + census.kernel_flops
            rec["kernel_flops"] = census.kernel_flops
            rec["collectives"] = dict(census.collectives)
            rec["peak"] = None
            if tracker is not None:
                try:
                    snap = tracker.get_tracker_snapshot("peak")
                    rec["peak"] = int(sum(v.get("Total", 0)
                                          for v in snap.values())) or None
                    if rec["peak"] is None:
                        reason = "mem_tracker saw no allocation"
                except Exception as e:  # noqa: BLE001 - recorded
                    reason = f"{type(e).__name__}: {e}"[:300]
            if reason:
                rec["peak_reason"] = reason
    finally:
        restore()
    return rec


def init_fake_group(world: int) -> None:
    """A single-process group of ``world`` ranks on the "fake" backend
    (rank 0). ``FakeStore`` lives in a private torch module: without it
    the dry-run cannot run, and says so."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry-run needs torch's fake process-group "
                           "backend (torch.testing._internal.distributed."
                           "fake_pg)") from e
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    world = math.prod(mesh_lib.production_shape(multi_pod).values())
    init_fake_group(world)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cpu")
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cfg = get_config(arch)
    mode = SHAPES[shape_name].mode
    rules_over = _decode_rules(cfg) if mode == "decode" else None
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "devices": world, "n_microbatches": N_MICROBATCHES}
    rec["true"] = show = _run(cfg, shape_name, mesh, rules_over)
    if verbose:
        coll = sum(v for k, v in show["collectives"].items() if k != "count")
        print(f"[{arch} {shape_name} {mesh_name}] wall={show['wall_s']:.2f}s "
              f"flops/dev={show['flops']:.3e} "
              f"args/dev={show['argument_bytes'] / 2**30:.2f}GiB "
              f"coll/dev={coll / 2**30:.2f}GiB", flush=True)
    return rec


def cell_path(arch: str, shape_name: str, multi_pod: bool) -> Path:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    return OUT_DIR / f"{arch}__{shape_name}__{mesh_name}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(exist_ok=True)

    cells: list[tuple[str, str, bool]] = []
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    for arch in archs:
        shapes = shape_cells(arch) if (args.all or args.shape is None) \
            else [args.shape]
        for sh in shapes:
            meshes = (False, True) if args.both_meshes else (args.multi_pod,)
            cells.extend((arch, sh, mp) for mp in meshes)

    failures = []
    try:
        for arch, sh, mp in cells:
            path = cell_path(arch, sh, mp)
            if path.exists() and not args.force:
                print(f"[skip] {path.name} exists")
                continue
            try:
                rec = run_cell(arch, sh, mp)
                path.write_text(json.dumps(rec, indent=1))
            except Exception as e:  # noqa: BLE001 - listed, then exit 1
                import traceback
                traceback.print_exc()
                failures.append((arch, sh, mp, f"{type(e).__name__}: {e}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print(f"dry-run OK: {len(cells)} cells")
    return 0


if __name__ == "__main__":
    sys.exit(main())
