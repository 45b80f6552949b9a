"""Checkpointing with asynchronous writes, the port's counterpart of
``repro.ckpt.manager``, on the same on-disk layout, so that a checkpoint
either package writes restores into the other:

  <dir>/step_<N>/
    manifest.json         step, user metadata, and each leaf's shape and
                          dtype (and ``shard_of``, the global shape)
    <leaf-path>.npy       one file per leaf; bf16 stored as uint16

A leaf's key is its path of dict keys joined by ``/`` (``params/embed``,
``opt/m/layers/wq/q``, ``opt/step``), its file the key with ``/`` as
``__``; leaves are listed in the reference's order (keys sorted at every
level). ``save`` takes a host snapshot of every leaf at once (the caller
may go on and change its tensors) and a writer thread persists it: a
``.tmp_step_<N>`` directory renamed into place, then the ``keep`` most
recent checkpoints retained.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch


def _flatten(tree, prefix=()):
    """(key, leaf) pairs of nested dicts, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


def _file(key: str) -> str:
    return key.replace("/", "__") + ".npy"


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy, bf16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, state, metadata: dict | None = None,
             blocking: bool = False) -> None:
        """Snapshot every leaf to host memory now; write to disk on a
        writer thread (one write outstanding at a time)."""
        self.wait()
        leaves = {}
        manifest = {"step": int(step), "metadata": metadata or {},
                    "leaves": {}}
        for key, leaf in _flatten(state):
            arr, dtype = _to_numpy(leaf)
            leaves[key] = arr
            manifest["leaves"][key] = {"shape": list(arr.shape),
                                       "dtype": dtype,
                                       "shard_of": list(arr.shape)}

        def write():
            tmp = self.dir / f".tmp_step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for key, arr in leaves.items():
                np.save(tmp / _file(key), arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            self._retain()

        def run():
            try:
                write()
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Wait for the outstanding write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _retain(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target, device=None):
        """Rebuild ``target``'s structure (nested dicts of tensors) from
        checkpoint ``step``: each leaf on ``device``, or where it is None
        on the target leaf's device. A leaf whose shape or dtype differs
        from the target's raises ``ValueError``. Returns (state,
        metadata)."""
        base = self.dir / f"step_{step}"
        manifest = json.loads((base / "manifest.json").read_text())

        def build(tree, prefix):
            if isinstance(tree, dict):
                return {k: build(v, prefix + (str(k),))
                        for k, v in tree.items()}
            key = "/".join(prefix)
            info = manifest["leaves"][key]
            t = _from_numpy(np.load(base / _file(key)), info["dtype"])
            if tuple(t.shape) != tuple(tree.shape) or t.dtype != tree.dtype:
                raise ValueError(
                    f"{key}: checkpoint {tuple(t.shape)} {t.dtype}, target "
                    f"{tuple(tree.shape)} {tree.dtype}")
            return t.to(tree.device if device is None else device)

        return build(target, ()), manifest["metadata"]
