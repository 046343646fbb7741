"""Fault-tolerant checkpointing: step-atomic, async, resume-from-latest.

- Each checkpoint is a directory ``step_<N>/`` holding ``shard_0.npz``
  (every tensor of the tree) and a ``manifest.json`` (names, shapes,
  dtypes) written last.  Both are written into ``step_<N>.tmp/``, which is
  then renamed: a checkpoint without a manifest is incomplete and ignored
  by ``restore_latest`` (atomicity).
- ``save`` copies every tensor to host memory before it returns (the
  device-to-host snapshot); a background thread then serializes it while
  the loop goes on.  ``keep`` bounds how many checkpoints stay on disk.
- Tree names are the tree's dict keys and list indices joined by ``/``.
  NumPy has no bfloat16, so bfloat16 tensors are stored as their 16-bit
  patterns (int16) and the manifest names their dtype ``bfloat16``: a
  restore is bitwise.

On a mesh the tree's leaves are DTensors.  ``save`` gathers each one
whole (``full_tensor()``, a collective every rank joins) and rank 0 writes
``shard_0.npz`` with ``n_processes`` set to the world size; every rank
waits for the write in ``wait``.  ``restore(template, step)`` reads the
whole arrays and puts each back into its template leaf's placements
(``distribute_tensor``), so a checkpoint written at one world size
restores at another (elastic restart).  Plain templates restore as plain
tensors, as before.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, distribute_tensor


def _name(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _tree_flatten_with_names(tree):
    flat, treedef = pytree.tree_flatten_with_path(tree)
    return ([_name(path) for path, _ in flat], [leaf for _, leaf in flat],
            treedef)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``t`` (a DTensor gathered whole) as NumPy, and the
    name of its dtype."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, template: torch.Tensor):
    t = torch.from_numpy(arr)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    t = t.to(device=template.device, dtype=template.dtype)
    if isinstance(template, DTensor):
        return distribute_tensor(t, template.device_mesh,
                                 list(template.placements))
    return t


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._sync = False          # ranks wait for rank 0's write

    # -- save ---------------------------------------------------------------

    def save(self, tree: Any, step: int, blocking: bool = False) -> None:
        """Snapshot to host memory now; serialize in the background."""
        self.wait()
        names, leaves, _ = _tree_flatten_with_names(tree)
        host = [_to_host(leaf) for leaf in leaves]
        self._sync = _world() > 1

        def _write():
            path = os.path.join(self.dir, f"step_{step}")
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"a{i}": a for i, (a, _) in enumerate(host)})
            manifest = {
                "step": step,
                "names": names,
                "shapes": [list(a.shape) for a, _ in host],
                "dtypes": [dtype for _, dtype in host],
                "n_processes": _world(),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if _rank() == 0 and blocking:
            _write()
        elif _rank() == 0:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Until the last save is on disk, on every rank."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sync:
            dist.barrier()
            self._sync = False

    def _gc(self) -> None:
        for s in self.steps()[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                manifest = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(manifest):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def restore(self, template: Any, step: int):
        """Restore into the structure, devices, dtypes and placements of
        ``template``."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        names, leaves, treedef = _tree_flatten_with_names(template)
        if names != manifest["names"]:
            raise ValueError(f"checkpoint {path} does not match the "
                             f"template's tree")
        with np.load(os.path.join(path, "shard_0.npz")) as data:
            new_leaves = [_from_host(data[f"a{i}"], dtype, tmpl)
                          for i, (dtype, tmpl) in enumerate(
                              zip(manifest["dtypes"], leaves))]
        return pytree.tree_unflatten(new_leaves, treedef)

    def restore_latest(self, template: Any):
        steps = self.steps()
        if not steps:
            return None
        step = steps[-1]
        return self.restore(template, step), step
