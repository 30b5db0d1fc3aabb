"""Fault-tolerant checkpointing: atomic, device-independent, async (the
reference's ``train/checkpoint.py``, same on-disk layout).

Layout (one directory per step):
    <root>/step_00000123.tmp/...    (written, fsynced)
    <root>/step_00000123/           (atomic rename marks commit)
        manifest.json               tree structure, shapes, dtypes, crc32
        arr_00000.npy ...           one file per leaf, host values

Leaves are numbered in ``pytree`` order (dict keys sorted, lists in index
order), the order ``jax.tree.flatten`` gives such trees, so a plain tree
that the reference saved restores here.  numpy has no bfloat16: a bf16
leaf is written as its raw 16 bits (int16) with ``"bfloat16"`` in the
manifest, and read back from those bits (the reference's files hold them
as ``V2`` records).  ``restore`` places each leaf on the device of the
matching leaf of ``like``.  CRCs catch torn writes; the atomic rename
means a crash leaves either the previous complete checkpoint or a
``.tmp`` that restore ignores.

``AsyncCheckpointer`` snapshots to host synchronously and does file IO on
a background thread so the step loop never blocks on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from . import pytree

PyTree = Any


def _host(leaf):
    """(numpy array, manifest dtype name) of a leaf: a bf16 tensor as its
    int16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(root: str, step: int, tree: PyTree, *, keep: int = 3) -> str:
    """Synchronous atomic checkpoint.  Returns the committed directory."""
    os.makedirs(root, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(root, name + ".tmp")
    final = os.path.join(root, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, skel = pytree.flatten(tree)
    manifest = {"step": step, "treedef": repr(skel), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _host(leaf)
        fn = f"arr_{i:05d}.npy"
        path = os.path.join(tmp, fn)
        np.save(path, arr, allow_pickle=False)
        with open(path, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest["leaves"].append({
            "file": fn, "shape": list(arr.shape), "dtype": dtype,
            "crc32": crc,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)                      # atomic commit
    _retain(root, keep)
    return final


def _retain(root: str, keep: int):
    steps = sorted(d for d in os.listdir(root)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(root, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(root: str, step: int, like: PyTree) -> PyTree:
    """Load checkpoint ``step`` shaped like ``like`` (a tree of tensors or
    arrays): each leaf a tensor on the device of ``like``'s leaf (the CPU
    for an array)."""
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, skel = pytree.flatten(like)
    if len(manifest["leaves"]) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, expected "
            f"{len(leaves)} (model/optimizer structure changed?)")
    out = []
    for meta, like_leaf in zip(manifest["leaves"], leaves):
        fp = os.path.join(path, meta["file"])
        with open(fp, "rb") as f:
            crc = zlib.crc32(f.read())
        if crc != meta["crc32"]:
            raise IOError(f"CRC mismatch in {fp} (torn write?)")
        arr = np.load(fp, allow_pickle=False)
        if tuple(arr.shape) != tuple(like_leaf.shape):
            raise ValueError(
                f"{meta['file']}: shape {arr.shape} != "
                f"{tuple(like_leaf.shape)}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        dev = (like_leaf.device if isinstance(like_leaf, torch.Tensor)
               else "cpu")
        out.append(t.to(dev))
    return pytree.unflatten(skel, out)


class AsyncCheckpointer:
    """Overlap checkpoint IO with training: snapshot now, write later."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: PyTree):
        self.wait()
        host_tree = pytree.tree_map(
            lambda x: (x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.array(x)),
            tree)

        def work():
            try:
                save(self.root, step, host_tree, keep=self.keep)
            except Exception as e:  # noqa: BLE001 - surfaced via wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
