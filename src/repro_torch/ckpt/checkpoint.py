"""Fault-tolerant checkpointing: per-leaf ``.npy`` files, atomic renames,
keep-N retention and an async writer, the counterpart of
`repro.ckpt.checkpoint` with the same directory layout:

    <root>/step_00000420.tmp/...   (written)
    <root>/step_00000420/          (atomic rename on completion)
        MANIFEST.json              (treedef, leaf paths/shapes/dtypes, meta)
        leaf_000000.npy ...

A state is a nest of dicts, lists and tuples whose leaves are numpy
arrays, torch tensors on any device, or Python scalars. It is flattened
with dict keys in sorted order, as ``jax.tree_util`` flattens, so the
port's leaf order and ``paths`` equal the reference's manifests and each
package reads the other's numpy checkpoints. ``save`` copies every leaf to
the host synchronously (a consistent snapshot) and leaves the disk writes
to the writer thread. A dtype numpy lacks (bfloat16, the float8 types) is
stored as an unsigned view of the same width with its own name in
``dtypes``, as the reference stores its ``ml_dtypes`` arrays, and restored
through torch views. The manifest's treedef string is informational:
restore rebuilds the nest from ``like``.
"""
from __future__ import annotations

import json
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import path_str

_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_SINT = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _leaves_with_path(tree, path=()) -> List[Tuple[tuple, Any]]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, list and tuple
    items in order, None an empty node."""
    if isinstance(tree, dict):
        return [lp for k in sorted(tree)
                for lp in _leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [lp for i, v in enumerate(tree)
                for lp in _leaves_with_path(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def _treedef_str(tree) -> str:
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(walk(v) for v in t) + \
                ("," if len(t) == 1 else "") + ")"
        return "None" if t is None else "*"
    return f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves: List) -> Any:
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            items = [build(v) for v in t]
            # a NamedTuple (a train state) takes its fields positionally
            return type(t)(*items) if hasattr(t, "_fields") \
                else type(t)(items)
        if t is None:
            return None
        return next(it)
    return build(like)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(host array as stored, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        # a copy even of a CPU tensor: a donated train step writes the
        # state in place while the writer thread may still hold it
        t = leaf.detach().to("cpu", copy=True).contiguous()
        name = str(t.dtype).removeprefix("torch.")
        try:
            return t.numpy(), name
        except TypeError:               # no numpy dtype: store the bits
            bits = t.view(_SINT[t.element_size()]).numpy()
            return bits.view(_UINT[t.element_size()]), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_stored(arr: np.ndarray, want: str):
    """The leaf as saved: a numpy array, or a CPU tensor for a dtype numpy
    lacks (stored as an unsigned view of the same width)."""
    if str(arr.dtype) == want:
        return arr
    dt = getattr(torch, want, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint leaf of unknown dtype {want!r}")
    signed = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
    return torch.from_numpy(signed.copy()).view(dt)


def _place(leaf, like_leaf, device):
    if device is None and isinstance(like_leaf, torch.Tensor):
        device = like_leaf.device
    if device is None:
        return leaf
    # np.ascontiguousarray would turn a 0-d leaf (a step counter) into 1-d
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.array(leaf, order="C"))
    return t.to(device)


class CheckpointManager:
    def __init__(self, root, *, keep: int = 3, async_write: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- public ------------------------------------------------------------

    def save(self, step: int, tree, *, meta: Optional[Dict] = None,
             block: bool = False):
        """Snapshot ``tree`` at ``step``. The device->host copy happens
        synchronously (consistent snapshot); disk IO is offloaded to the
        writer thread."""
        self._raise_pending()
        flat = _leaves_with_path(tree)
        host = [_to_host(leaf) for _, leaf in flat]      # sync gather
        paths = [path_str(p) for p, _ in flat]
        job = (int(step), host, _treedef_str(tree), paths, meta or {})
        if self.async_write:
            self._ensure_worker()
            self._q.put(job)
            if block:
                self._q.join()
        else:
            self._write(job)

    def restore(self, step: Optional[int] = None, *, like=None,
                device=None):
        """Load ``step`` (default latest) -> (tree or leaves, meta), or
        (None, None) without a checkpoint. ``like``: a nest of the saved
        structure, used to rebuild it; a leaf of ``like`` that is a tensor
        comes back as a tensor on its device. ``device``: put every leaf
        on it as a tensor (one card has no mesh to reshard onto)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        leaves = [_from_stored(np.load(d / f"leaf_{i:06d}.npy"),
                               manifest["dtypes"][i])
                  for i in range(manifest["n_leaves"])]
        if like is None:
            return [_place(leaf, None, device) for leaf in leaves], \
                manifest["meta"]
        like_leaves = [leaf for _, leaf in _leaves_with_path(like)]
        if len(like_leaves) != len(leaves):
            raise ValueError(f"`like` has {len(like_leaves)} leaves, the "
                             f"checkpoint {len(leaves)}")
        placed = [_place(leaf, ll, device)
                  for leaf, ll in zip(leaves, like_leaves)]
        return _unflatten(like, placed), manifest["meta"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.root.iterdir()
                      if p.is_dir() and p.name.startswith("step_")
                      and not p.name.endswith(".tmp"))

    def wait(self):
        if self._worker is not None:
            self._q.join()
        self._raise_pending()

    # -- internals -----------------------------------------------------------

    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._loop, daemon=True)
            self._worker.start()

    def _loop(self):
        while True:
            job = self._q.get()
            try:
                self._write(job)
            except BaseException as e:  # surfaced on next save()/wait()
                self._error = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _write(self, job):
        step, host, treedef_str, paths, meta = job
        final = self.root / f"step_{step:08d}"
        tmp = self.root / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, (arr, _) in enumerate(host):
            np.save(tmp / f"leaf_{i:06d}.npy", arr)
        manifest = {
            "step": step, "n_leaves": len(host), "treedef": treedef_str,
            "paths": paths, "meta": meta, "time": time.time(),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [name for _, name in host],
        }
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)


__all__ = ["CheckpointManager", "path_str"]
