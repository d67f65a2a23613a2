"""Atomic, async checkpointing of the port's state trees.

Port of ``repro.checkpoint.checkpoint``, with its on-disk layout:
``<dir>/step_<n:08d>/`` holds one ``.npy`` per leaf, named by the leaf's
dotted path in the port's layout (``params.layers.3.core.wq.w``), plus
``manifest.json`` (``{"step", "leaves": {name: {"dtype"}}, "metadata"}``
with each leaf's logical dtype).  Writes go to ``step_<n>.tmp`` and are
renamed when whole, so a crash mid-write never corrupts the newest valid
checkpoint, and ``.tmp`` directories are never read.  bfloat16 (which
``.npy`` cannot hold) is stored as a uint16 view and float8 as uint8,
with the logical dtype in the manifest.  A checkpoint that the reference
wrote (its stacked ``units.slot{i}`` leaves) is read into the port's
layout by ``repro_torch.bridge.checkpoint_from_reference``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util

_MANIFEST = "manifest.json"
# logical dtype -> (the stored numpy view, a numpy and torch dtype of its width
# that both libraries hold)
_VIEW = {"bfloat16": (np.uint16, np.int16, torch.int16),
         "float8_e4m3fn": (np.uint8, np.uint8, torch.uint8),
         "float8_e5m2": (np.uint8, np.uint8, torch.uint8)}


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _logical(leaf) -> str:
    return str(leaf.dtype).replace("torch.", "")


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (tensor or array) as numpy, viewed as its
    storage type where ``.npy`` has no such dtype."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach().to("cpu")
    logical = _logical(t)
    if logical in _VIEW:
        stored, _, torch_view = _VIEW[logical]
        return t.view(torch_view).numpy().view(stored)
    return t.numpy()


def _save_tree(tree, out_dir: str) -> Dict[str, Dict[str, str]]:
    leaves: Dict[str, Dict[str, str]] = {}
    for name, leaf in tree_util.paths(tree):
        np.save(os.path.join(out_dir, name + ".npy"), _to_numpy(leaf), allow_pickle=False)
        leaves[name] = {"dtype": _logical(leaf)}
    return leaves


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: Optional[Dict] = None) -> str:
    """Atomic synchronous save; returns the final checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _save_tree(tree, tmp)
    manifest = {"step": step, "leaves": leaves, "metadata": metadata or {}}
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest whole checkpoint's step (``.tmp`` and manifest-less
    directories skipped), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST)):
                steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def read_checkpoint(ckpt_dir: str, step: int) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """Every leaf of one checkpoint as a CPU tensor in its logical dtype,
    by name, and the manifest's metadata."""
    final = step_dir(ckpt_dir, step)
    with open(os.path.join(final, _MANIFEST)) as f:
        manifest = json.load(f)
    out = {}
    for name, info in manifest["leaves"].items():
        arr = np.load(os.path.join(final, name + ".npy"))
        logical = info["dtype"]
        if logical in _VIEW:
            out[name] = torch.from_numpy(arr.view(_VIEW[logical][1])).view(getattr(torch, logical))
        else:
            out[name] = torch.from_numpy(arr)
    return out, manifest["metadata"]


def restore_checkpoint(ckpt_dir: str, step: int, target_tree) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree`` (its leaf names and
    shapes are the contract; each leaf lands on its target's device, in
    the logical dtype the manifest records).  Returns (tree, metadata)."""
    saved, metadata = read_checkpoint(ckpt_dir, step)
    out = []
    for name, leaf in tree_util.paths(target_tree):
        if name not in saved:
            raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
        t = saved[name]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint leaf {name}: shape {tuple(t.shape)}, target "
                             f"{tuple(leaf.shape)}")
        dev = getattr(leaf, "device", None)
        out.append(t.to(dev) if isinstance(dev, torch.device) and dev.type != "meta" else t)
    return tree_util.unflatten(target_tree, out), metadata


class CheckpointManager:
    """Async save + retention.  ``save`` copies the tree to the host
    synchronously and writes the files on a background thread, so the
    train loop overlaps the write with its next steps; ``wait()`` joins
    the write in flight.  The newest ``keep`` checkpoints are kept."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_write: bool = True):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_write = async_write
        self._lock = threading.Lock()
        self._inflight: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save(self, step: int, tree, metadata: Optional[Dict] = None):
        host_tree = tree_util.map_leaves(
            lambda t: t.detach().to("cpu", copy=True) if isinstance(t, torch.Tensor) else t,
            tree)

        def write():
            with self._lock:
                save_checkpoint(self.ckpt_dir, step, host_tree, metadata)
                self._gc()

        if self.async_write:
            self.wait()

            def run():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
                    self._error = e

            self._inflight = threading.Thread(target=run, daemon=True)
            self._inflight.start()
        else:
            write()

    def wait(self):
        """Join the write in flight; re-raise what it raised."""
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        self.wait()
        return latest_step(self.ckpt_dir)

    def restore(self, step: int, target_tree):
        self.wait()
        return restore_checkpoint(self.ckpt_dir, step, target_tree)

    def _gc(self):
        steps = sorted(
            int(n[len("step_"):]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(step_dir(self.ckpt_dir, s), ignore_errors=True)
