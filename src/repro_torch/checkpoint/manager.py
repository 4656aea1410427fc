"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``).

The on-disk format is the reference's, so either package restores what the
other wrote:

* ``step_<n>/proc<k>.npz`` holds this process's leaves, keyed by their tree
  paths joined with ``§`` (a dict's keys in sorted order, as JAX flattens
  it); ``proc0`` also writes ``manifest.json`` with every leaf's shape and
  dtype and the user metadata (``"step"`` among it).
* bfloat16 leaves are stored as their ``uint16`` bit patterns with
  ``"dtype": "bfloat16"`` in the manifest; ``None`` leaves appear there as
  ``{"none": true}``; a Python int leaf (the optimizer's ``"step"``) is
  stored as the reference stores its int32 0-d array.
* Atomic: a save writes ``step_<n>.tmp/`` and ``os.rename``\\ s it, so a crash
  mid-save never corrupts the newest checkpoint.
* Async: ``save(..., blocking=False)`` copies every leaf to host memory on
  the caller's thread and writes on a background thread.  The copy is a
  real one even for a CPU tensor (``.cpu()`` would hand back the same
  tensor, which the next step could change under the writer).
* Retention: keep the newest ``keep`` checkpoints, and every multiple of
  ``keep_every``.

``k`` is the ``torch.distributed`` rank when a process group is up, else 0.
Restore lays each leaf on the device of the target's leaf, in its dtype,
and requires grad where the target's leaf does; a leaf the checkpoint lacks
raises ``KeyError``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

_SEP = "§"


def _flatten(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path key, leaf) pairs in JAX's flattening order of a dict tree: keys
    sorted, ``None`` a leaf."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], prefix + (str(k),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten(target: Tree, vals: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Tree:
    """``target``'s structure with the leaf at each path key from ``vals``."""
    if isinstance(target, dict):
        return {k: _unflatten(v, vals, prefix + (str(k),)) for k, v in target.items()}
    return vals[_SEP.join(prefix)]


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf's host array as stored, and the dtype name the manifest
    gives it."""
    if isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
        return arr, str(arr.dtype)
    t = leaf.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """The async save's snapshot of a leaf: a copy on the host."""
    if leaf is None or isinstance(leaf, int):
        return leaf
    return leaf.detach().to("cpu", copy=True)


def save_pytree(tree: Tree, directory: str, metadata: Optional[Dict] = None):
    os.makedirs(directory, exist_ok=True)
    proc = _process_index()
    arrays, manifest = {}, {"leaves": {}, "metadata": metadata or {}}
    for key, leaf in _flatten(tree):
        if leaf is None:
            manifest["leaves"][key] = {"none": True}
            continue
        arr, dtype = _to_numpy(leaf)
        manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
        arrays[key] = arr
    np.savez(os.path.join(directory, f"proc{proc}.npz"), **arrays)
    if proc == 0:
        with open(os.path.join(directory, "manifest.json"), "w") as f:
            json.dump(manifest, f)


def _restore_leaf(arr: np.ndarray, info: Dict, like):
    """A stored array as the target's leaf ``like`` holds it: an int for an
    int, else a tensor on ``like``'s device in its dtype."""
    if isinstance(like, int):
        return int(arr.item())
    if info["dtype"] == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if like is None:
        return t
    t = t.to(device=like.device, dtype=like.dtype)
    return t.requires_grad_(True) if like.requires_grad else t


def restore_pytree(target: Tree, directory: str) -> Tree:
    """Restore into the structure of ``target``."""
    proc = _process_index()
    with np.load(os.path.join(directory, f"proc{proc}.npz")) as data:
        with open(os.path.join(directory, "manifest.json")) as f:
            manifest = json.load(f)
        vals = {}
        for key, leaf in _flatten(target):
            info = manifest["leaves"].get(key)
            if info is None:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            vals[key] = None if info.get("none") else _restore_leaf(data[key], info, leaf)
        return _unflatten(target, vals)


def load_metadata(directory: str) -> Dict:
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)["metadata"]


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, keep_every: int = 0):
        self.root = root
        self.keep = keep
        self.keep_every = keep_every
        os.makedirs(root, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- discovery -----------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    # -- save/restore ----------------------------------------------------------
    def save(self, step: int, tree: Tree, metadata: Optional[Dict] = None,
             blocking: bool = True):
        self.wait()  # one in-flight async save at a time
        # snapshot to host memory on the caller's thread
        host = _unflatten(tree, {k: _host_copy(v) for k, v in _flatten(tree)})
        meta = dict(metadata or {})
        meta["step"] = step

        def work():
            tmp = self.path(step) + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            save_pytree(host, tmp, meta)
            final = self.path(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, target: Tree, step: Optional[int] = None) -> Tuple[Tree, Dict]:
        step = step if step is not None else self.latest_step()
        assert step is not None, f"no checkpoint under {self.root}"
        d = self.path(step)
        return restore_pytree(target, d), load_metadata(d)

    def _gc(self):
        steps = self.all_steps()
        drop = steps[: -self.keep] if self.keep else []
        for s in drop:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self.path(s), ignore_errors=True)
