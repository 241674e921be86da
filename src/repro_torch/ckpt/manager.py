"""Checkpoint manager: per-leaf .npy + JSON manifest, built for restarts.

The JAX package's ``ckpt/manager.py`` on tensors, with its on-disk format
byte for byte, so a checkpoint of either package restores in the other:

  - **atomic**: writes land in ``step_XXXXXXXX.<writer>.tmp`` and are
    renamed only after the manifest (with per-leaf checksums) is fsynced
    — a crash mid-save never corrupts the latest checkpoint.
  - **async**: ``save()`` takes a finished host copy of every leaf, then
    hands the file I/O to a worker thread; training continues (and may
    update its tensors in place: the thread never reads them).
  - **keep-k**: older checkpoints are garbage-collected.
  - **reshard-on-restore**: leaves are stored as full host arrays plus the
    tree structure; ``restore(..., sharding_fn=...)`` places each however
    the caller wants, for example a row block for a data rank.

A tree is nested dicts (keys in sorted order), lists or tuples (``#i``)
and dataclasses such as :class:`~repro_torch.optim.OptState` (fields in
order), with tensors or numpy arrays as leaves: the reference's pytree
flatten order and key paths (``SEP`` between the parts). A leaf's file
is ``sha1(key)[:16] + ".npy"``. A bfloat16 leaf is stored as the
reference's ``np.save`` of an ``ml_dtypes.bfloat16`` array stores it: the
raw 16-bit words under the header descr ``'<V2'``, with ``"bfloat16"`` as
the manifest's dtype name.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

SEP = "::"
BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix: tuple = ()) -> dict:
    """{key: leaf} in the reference's flatten order; None is an empty
    subtree, as in a pytree."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"#{i}", v) for i, v in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return {SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, prefix + (k,)))
    return out


def _rebuild(tree, leaves: dict, prefix: tuple = ()):
    """`tree`'s structure with each leaf replaced by ``leaves[key]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, prefix + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (f"#{i}",))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaves,
                             prefix + (f.name,))
            for f in dataclasses.fields(tree)})
    return leaves[SEP.join(prefix)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """(a host copy of `leaf`, its manifest dtype name); a bfloat16 leaf
    as its raw 16-bit words. A tensor is copied to the host with a
    blocking copy, so the result never changes under later updates."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return np.array(t.view(torch.int16).numpy()), BF16
        arr = np.array(t.numpy())
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    name = str(arr.dtype)
    if name == BF16:
        return arr.view(np.int16), BF16
    return arr, name


def _save_npy(path: str, arr: np.ndarray, dtype_name: str) -> None:
    if dtype_name != BF16:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _to_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The CPU tensor of a loaded leaf; a bfloat16 leaf from its words."""
    if dtype_name == BF16:
        return torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    if str(arr.dtype) != dtype_name:
        arr = arr.astype(np.dtype(dtype_name))
    return torch.from_numpy(np.array(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, block: bool = False) -> None:
        host = {k: _host(v) for k, v in _flatten_with_paths(tree).items()}
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        # a writer's own temporary directory: the save thread of a trainer
        # that failed may still be writing the step its successor writes
        tmp = f"{final}.{os.getpid()}-{threading.get_ident()}.tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for key, (arr, dtype_name) in host.items():
            fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            _save_npy(os.path.join(tmp, fname), arr, dtype_name)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": dtype_name,
                "sha1": hashlib.sha1(arr.tobytes()).hexdigest(),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---- restore ------------------------------------------------------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any,
                sharding_fn: Optional[Callable[[str, torch.Tensor], Any]]
                = None) -> Any:
        """Restore into `template`'s structure (leaves with a ``shape``:
        tensors, ``meta`` tensors or arrays).

        sharding_fn(key, host_tensor) -> tensor places each leaf (given as
        a CPU tensor of its dtype); by default a leaf goes to its template
        leaf's device (the CPU for an array or a ``meta`` tensor)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, tmpl in _flatten_with_paths(template).items():
            meta = manifest["leaves"][key]
            t = _to_tensor(np.load(os.path.join(path, meta["file"])),
                           meta["dtype"])
            if list(t.shape) != list(np.shape(tmpl)):
                raise ValueError(f"shape mismatch at {key}: ckpt "
                                 f"{tuple(t.shape)} vs {np.shape(tmpl)}")
            if sharding_fn is not None:
                leaves[key] = sharding_fn(key, t)
            elif isinstance(tmpl, torch.Tensor) and tmpl.device.type != "meta":
                leaves[key] = t.to(tmpl.device)
            else:
                leaves[key] = t
        return _rebuild(template, leaves)
