"""Checkpoints: one ``.npy`` per leaf and a manifest (the port of
``repro.training.checkpoint``, its on-disk schema).

* Every state leaf is one ``.npy`` of the whole array, named in
  ``manifest.json`` by its tree path ("params.decoder.units.0.1.mixer.wx")
  with its shape and dtype.  :func:`restore` looks leaves up by path, so it
  reads any tree whose paths it is given: the port's state, or the
  reference's (its ``units`` stacked) as ``convert.state_from_jax`` takes
  it.
* Writes are atomic: ``step_N.tmp`` is renamed ``step_N`` once the
  manifest is written, so a crash mid-save never leaves a newest
  checkpoint that is incomplete.
* :class:`AsyncCheckpointer` copies the state to host memory on the
  caller's thread (the train step then updates the device state in place)
  and writes the files on a worker thread.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

Pytree = Any


def _path_str(path) -> str:
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return ".".join(parts)


def _to_host(leaf) -> np.ndarray:
    """A numpy copy of ``leaf`` (never a view of a tensor that a later
    step overwrites)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf)


def save(ckpt_dir: str, step: int, state: Pytree) -> str:
    """Synchronous atomic save.  Returns the checkpoint path."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = {}
    flat, _ = pytree.tree_flatten_with_path(state)
    for i, (path, leaf) in enumerate(flat):
        name = f"leaf_{i:05d}.npy"
        arr = _to_host(leaf)
        np.save(os.path.join(tmp, name), arr)
        leaves[_path_str(path)] = {
            "file": name, "shape": list(arr.shape), "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": leaves}, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like: Pytree, device=None) -> Pytree:
    """The checkpoint of ``step`` in the tree of ``like``, whose leaves
    (tensors or arrays) give each path and shape: torch tensors on
    ``device``, or on each ``like`` tensor's own device, else the CPU."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat, spec = pytree.tree_flatten_with_path(like)
    out = []
    for leaf_path, leaf in flat:
        key = _path_str(leaf_path)
        meta = manifest["leaves"][key]
        arr = np.load(os.path.join(path, meta["file"]))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(torch.from_numpy(arr).to(dev))
    return pytree.tree_unflatten(out, spec)


def cleanup(ckpt_dir: str, keep: int = 3):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


class AsyncCheckpointer:
    """Saves on a worker thread, one in flight at a time."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, state: Pytree):
        self.wait()
        # The device-to-host copy before the next step updates the state
        # in place; the disk write in the background.
        host_state = pytree.tree_map(_to_host, state)

        def work():
            try:
                save(self.ckpt_dir, step, host_state)
                cleanup(self.ckpt_dir, self.keep)
            except Exception as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
