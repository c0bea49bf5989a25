"""Checkpoint and resume of the distributed training state, port of the
npz ``Checkpointer`` of ``distkeras_tpu/checkpoint.py``.

The whole ``DistState`` (center params, per-worker params with BatchNorm's
statistics, per-worker optimizer states, the round clock) round-trips
through disk, so a stopped job resumes exactly.  Format: one ``.npz`` per
step holding the state's leaves in order plus a JSON manifest; restore
takes a *target* tree of the same structure (e.g. a freshly initialised
state) and refills its leaves.  The port's files are its own: they need
not load in the JAX package (whose trees flatten in another order), and
the JAX package's orbax backend has no counterpart here.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^ckpt_(\d+)\.npz$")


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts (in key order), lists and tuples:
    tensors, numbers and arrays; ``None`` holds no leaf."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def _refill(tree, leaves):
    """``tree`` with its leaves taken in order from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return type(tree)((k, _refill(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        out = [_refill(v, leaves) for v in tree]
        return (type(tree)(*out) if hasattr(tree, "_fields")
                else type(tree)(out))
    return None if tree is None else next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16; exact
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _like(old, new: np.ndarray):
    """A stored array in the form of the target's leaf: a tensor of the
    target's dtype on its device, or a Python number."""
    if isinstance(old, torch.Tensor):
        return torch.as_tensor(new).to(device=old.device, dtype=old.dtype)
    if isinstance(old, bool):
        return bool(new)
    if isinstance(old, int):
        return int(new)
    if isinstance(old, float):
        return float(new)
    return new


class Checkpointer:
    """Directory of ``ckpt_<step>.npz`` files with retention."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = int(max_to_keep)
        os.makedirs(directory, exist_ok=True)

    # -- inventory ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    # -- save/restore ---------------------------------------------------------
    def save(self, step: int, state: Any,
             meta: Optional[dict] = None) -> str:
        """Atomically write the state tree for ``step``.  ``meta`` is a
        JSON dict recorded in the manifest (e.g. the trainer's checkpoint
        unit); ``read_meta`` gives it back, so a resume can check that it
        reads the step number the way the save meant it."""
        leaves = tree_leaves(state)
        arrays = {f"leaf_{i}": _to_numpy(leaf)
                  for i, leaf in enumerate(leaves)}
        manifest = json.dumps({"step": int(step), "num_leaves": len(leaves),
                               "meta": meta or {}})
        path = self._path(step)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, manifest=np.frombuffer(
                    manifest.encode(), dtype=np.uint8), **arrays)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._retain()
        return path

    def read_meta(self, step: Optional[int] = None) -> dict:
        """The ``meta`` dict recorded at save time."""
        step = self._resolve(step)
        with np.load(self._path(step)) as z:
            return json.loads(bytes(z["manifest"]).decode()).get("meta", {})

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        """Refill ``target``'s leaves from the checkpoint at ``step``
        (default latest).  Shapes must match; a tensor leaf comes back with
        the target's dtype on its device."""
        step = self._resolve(step)
        leaves = tree_leaves(target)
        with np.load(self._path(step)) as z:
            manifest = json.loads(bytes(z["manifest"]).decode())
            if manifest["num_leaves"] != len(leaves):
                raise ValueError(
                    f"checkpoint has {manifest['num_leaves']} leaves, target "
                    f"has {len(leaves)} — structure mismatch")
            loaded = [z[f"leaf_{i}"] for i in range(len(leaves))]
        for i, (old, new) in enumerate(zip(leaves, loaded)):
            if hasattr(old, "shape") and tuple(old.shape) != tuple(new.shape):
                raise ValueError(
                    f"leaf {i}: shape {tuple(new.shape)} in checkpoint vs "
                    f"{tuple(old.shape)} in target")
        return _refill(target, iter([_like(old, new) for old, new
                                     in zip(leaves, loaded)]))

    def wait(self):
        """No-op: saves are synchronous (the JAX package's interface)."""

    def close(self):
        """No-op (the JAX package's interface)."""

    def _resolve(self, step: Optional[int]) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"No checkpoints in {self.directory}")
        return int(step)

    def _retain(self):
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep]:
            os.unlink(self._path(s))


def foreign_checkpoints(directory: str, backend: str) -> List[int]:
    """Steps present in ``directory`` that were written by the *other*
    backend (npz ``ckpt_<step>.npz`` files vs orbax integer-named step
    directories).  Trainers use this to refuse a ``resume=True`` that would
    silently retrain from scratch because the configured backend cannot see
    the existing checkpoints."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if backend == "orbax":
            m = _STEP_RE.match(name)
            if m:
                steps.append(int(m.group(1)))
        elif name.isdigit() and os.path.isdir(os.path.join(directory, name)):
            steps.append(int(name))
    return sorted(steps)


def make_checkpointer(directory: str, backend: str = "npz", **kw):
    """Checkpointer factory of the trainers' ``checkpoint_backend``:
    ``"npz"``.  ``"orbax"`` raises: the port has no orbax backend."""
    if backend == "npz":
        return Checkpointer(directory, **kw)
    if backend == "orbax":
        raise NotImplementedError(
            "checkpoint_backend='orbax' is not ported (no orbax in the "
            "port); use 'npz'")
    raise ValueError(f"unknown checkpoint backend {backend!r} "
                     "(choose 'npz' or 'orbax')")
