"""Checkpointing: async, atomic, in the reference's layout. Port of
``repro.checkpoint.ckpt``.

* **atomic publish**: write to ``step_XXXXXXXX.tmp`` then rename — a crash
  mid-write never corrupts the restore point,
* **async**: the device->host copy happens on the caller's thread (so a
  train loop that updates its tensors in place may go on at once),
  serialization on a background thread,
* **the reference's files**: ``state.npz`` holds every leaf as a full
  array under the reference's key (``"/"``-joined dict keys, sequence
  indices and ``.field`` for a named tuple's fields, so ``AdamWState``'s
  moments are ``1/.mu/...``), ``meta.json`` the step. A checkpoint either
  package writes restores into the other's trees. bfloat16 leaves are
  stored as float32 (npz has no bfloat16) and cast back to the template's
  dtype on restore (lossless).

Trees are nested dicts, tuples, lists and named tuples of tensors (or
numpy arrays and scalars).
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, map_with_path, tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager"]

_STEP_DIR = re.compile(r"step_(\d+)")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        # a copy also on the CPU, where .cpu() would share the storage that
        # an in-place update writes while a background save reads it
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                       torch.float8_e5m2):
            t = t.float()    # npz can't store them; restore casts back
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {"/".join(path): _host(leaf)
            for path, leaf in leaves_with_path(tree)}


def _unflatten_into(template, flat: dict):
    def pick(path, leaf):
        arr = flat["/".join(path)]
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(
                device=leaf.device, dtype=leaf.dtype)
        return np.asarray(arr, dtype=np.asarray(leaf).dtype)
    return map_with_path(pick, template)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "state.npz"), **_flatten(tree))
    meta = {"step": step, **(extra or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := _STEP_DIR.fullmatch(d)))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, template: Any,
                       step: int | None = None):
    """Restore into new tensors shaped as ``template``'s leaves, each with
    its template leaf's dtype and device. Returns ``(tree, meta)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "state.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten_into(template, flat)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    return tree, meta


class CheckpointManager:
    """Async save + retention. ``save`` copies the tree to the host and
    returns; the write runs on a background thread; ``wait`` joins."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: list[concurrent.futures.Future] = []
        self._lock = threading.Lock()

    def save(self, step: int, tree: Any, extra: dict | None = None):
        host_tree = tree_map(_host, tree)  # D2H now

        def job():
            p = save_checkpoint(self.directory, step, host_tree, extra)
            self._gc()
            return p

        with self._lock:
            for f in self._pending:
                if f.done():
                    f.result()      # a failed earlier write raises here
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(self._pool.submit(job))

    def wait(self):
        with self._lock:
            pending = list(self._pending)
        for f in pending:
            f.result()

    def _gc(self):
        if not os.path.isdir(self.directory):
            return
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
