"""Sharded checkpointing with atomic commit, on the JAX package's
on-disk layout.

Layout:
    <dir>/step_<N>.tmp-<nonce>/      (written)
    <dir>/step_<N>/                  (atomically renamed on completion)
        manifest.json                step, tree structure, shapes, dtypes
        leaf_<i>_chunk_<j>.npy       leaf i split along axis 0 into chunks

Leaves are numbered in ``utils.trees.tree_leaves`` order, which is
``jax.tree_util``'s (sorted dict keys, NamedTuple fields in order, a
``Q8State`` as its codes and scales), so a checkpoint written by either
package restores in the other.  A bfloat16 leaf is written as raw
16-bit words (numpy dtype ``|V2``, what numpy writes for ml_dtypes'
bfloat16) with ``"bfloat16"`` in the manifest, and read back by that
name: no ml_dtypes is needed.

  * Atomic rename means a crash mid-write never corrupts the latest
    complete checkpoint; ``latest_step`` only sees committed dirs.
  * ``CheckpointManager.save`` copies the tree to the host first
    (synchronising with the device) and hands the files to a writer
    thread, so the train loop overlaps checkpoint I/O with compute.
  * ``restore_checkpoint`` reassembles each leaf and puts it on the
    caller's device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import uuid
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")
_BF16_WORD = np.dtype("V2")


def _host_array(leaf) -> "tuple[np.ndarray, str]":
    """(numpy array, manifest dtype name) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORD), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _structure(tree) -> str:
    """The tree's structure with ``*`` for each leaf (informational)."""
    return str(tree_map(lambda _: "*", tree))


def save_checkpoint(directory: str, step: int, tree: Any,
                    chunk_elems: int = 1 << 24) -> str:
    """Blocking save; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp-{uuid.uuid4().hex[:8]}")
    os.makedirs(tmp)
    manifest = {"step": step, "treedef": _structure(tree), "leaves": []}
    for i, leaf in enumerate(tree_leaves(tree)):
        arr, dtype = _host_array(leaf)
        n_chunks = max(1, -(-arr.size // chunk_elems)) if arr.ndim > 0 else 1
        rows = arr.shape[0] if arr.ndim > 0 else 1
        n_chunks = min(n_chunks, max(rows, 1))
        entry = {"shape": list(arr.shape), "dtype": dtype, "chunks": n_chunks}
        if arr.ndim == 0 or n_chunks == 1:
            np.save(os.path.join(tmp, f"leaf_{i}_chunk_0.npy"), arr)
        else:
            for j, part in enumerate(np.array_split(arr, n_chunks, axis=0)):
                np.save(os.path.join(tmp, f"leaf_{i}_chunk_{j}.npy"), part)
        manifest["leaves"].append(entry)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _as_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def restore_checkpoint(directory: str, step: int, like: Any,
                       device: "torch.device | str | None" = None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, or of
    anything with a ``shape``).  Each leaf goes to ``device``, or where
    None to the device of ``like``'s leaf (the CPU for a non-tensor)."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = tree_leaves(like)
    if len(flat_like) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"expected {len(flat_like)}")
    out: List[torch.Tensor] = []
    for i, (ref, entry) in enumerate(zip(flat_like, manifest["leaves"])):
        parts = [np.load(os.path.join(path, f"leaf_{i}_chunk_{j}.npy"))
                 for j in range(entry["chunks"])]
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(
                f"leaf {i}: shape {arr.shape} != {tuple(ref.shape)}")
        dev = device if device is not None else (
            ref.device if isinstance(ref, torch.Tensor) else "cpu")
        out.append(_as_tensor(arr, entry["dtype"], dev))
    return tree_unflatten(like, out)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


class CheckpointManager:
    """Async checkpointing + retention.

    ``save`` synchronously copies the tree to the host and queues the
    file I/O on a writer thread; writes commit one at a time, in the
    order they were queued.  ``wait()`` blocks until all queued writes
    commit (call before exit) and raises the first write's error."""

    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._pending: List[threading.Thread] = []
        self._errors: List[Exception] = []

    def save(self, step: int, tree: Any) -> None:
        host_tree = tree_map(lambda x: x.detach().to("cpu", copy=True), tree)

        def work():
            try:
                with self._io_lock:
                    save_checkpoint(self.directory, step, host_tree)
                    self._gc()
            except Exception as e:  # re-raised by wait()
                with self._lock:
                    self._errors.append(e)

        if self.async_write:
            t = threading.Thread(target=work, daemon=True)
            with self._lock:
                self._pending.append(t)
            t.start()
        else:
            work()
            self._raise_errors()

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()
        self._raise_errors()

    def _raise_errors(self) -> None:
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def restore_latest(self, like: Any,
                       device: "torch.device | str | None" = None):
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, restore_checkpoint(self.directory, step, like, device)

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.directory)
            if (m := _STEP_RE.match(d)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)
