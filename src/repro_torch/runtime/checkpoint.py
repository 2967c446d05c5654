"""Checkpointing: async, atomic, in the reference's on-disk format.

Counterpart of ``repro/runtime/checkpoint.py``:

* Every leaf is saved as ``leaf_{i}.npy`` under a step directory, with a
  ``manifest.json`` holding ``step``, ``n_leaves``, ``shapes``, ``dtypes``
  and ``treedef`` (written as null; the reference's restore never reads
  it). Leaves are numbered in the reference's flatten order (dict keys
  sorted, lists in order), so a checkpoint either package writes restores
  in the other.
* Writes go to ``step_N.tmp`` and are atomically renamed — a crashed writer
  never corrupts the latest checkpoint.
* ``save`` is asynchronous: the device→host copy happens on the caller's
  thread, serialization on a background thread, one write outstanding.
* ``restore`` checks the structure and every shape against the target and
  places the leaves on the target's device; with ``shardings`` (a tree of
  ``(device_mesh, placements)``, as ``distributed.sharding.
  tree_shardings`` gives) each leaf is placed on the mesh by them, each
  rank keeping its shard of what it reads: the reference's elastic
  restart onto another topology.
* A tree of placed leaves (DTensors: a mesh run's state) is saved whole:
  every rank gathers each leaf (a collective), rank 0 writes, and the
  ranks wait for the write at a barrier, so the step's directory is
  complete when ``save`` returns on any rank. Its files are those of an
  unplaced save; the mesh it came from is not recorded.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_unflatten
from repro_torch.distributed import placed
from repro_torch.distributed.sharding import sharding_leaves

__all__ = ["CheckpointManager"]


def _to_host(leaf) -> np.ndarray:
    """A numpy snapshot of ``leaf`` that later writes to it cannot reach."""
    if torch.is_tensor(leaf):
        t = leaf.detach()
        return t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
    return np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()  # one outstanding write at a time
        leaves, _ = tree_flatten(tree)
        mesh_run = any(placed.is_placed(l) for l in leaves)
        # pull to host NOW; the snapshot is consistent (a placed leaf is
        # gathered whole: a collective, every rank calls it)
        host_leaves = [_to_host(placed.plain(l)) for l in leaves]
        spec = {
            "step": step,
            "treedef": None,
            "n_leaves": len(host_leaves),
            "shapes": [list(l.shape) for l in host_leaves],
            "dtypes": [str(l.dtype) for l in host_leaves],
        }

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                for i, leaf in enumerate(host_leaves):
                    np.save(os.path.join(tmp, f"leaf_{i}.npy"), leaf)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(spec, f)
                if not os.path.exists(final):
                    os.replace(tmp, final)
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        if mesh_run:
            # rank 0 writes; every rank waits for the write
            import torch.distributed as dist
            if dist.get_rank() == 0:
                write()
            dist.barrier()
            self._raise_if_failed()
        elif blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any,
                shardings: Optional[Any] = None) -> Any:
        """Load ``step`` into the structure of ``target`` (a tree of
        tensors, or of anything with ``shape``, ``dtype`` and ``device``):
        each leaf becomes a tensor of the target leaf's dtype on the
        target leaf's device. With ``shardings`` (a matching tree of
        ``(device_mesh, placements)``) each leaf is placed by its own
        (``distribute_tensor``: every rank reads the file and keeps its
        shard), whatever mesh, or none, wrote it."""
        self.wait()
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            spec = json.load(f)
        leaves, treedef = tree_flatten(target)
        if len(leaves) != spec["n_leaves"]:
            raise ValueError(
                f"checkpoint has {spec['n_leaves']} leaves, target "
                f"{len(leaves)} — structure mismatch")
        shard_leaves = ([None] * len(leaves) if shardings is None
                        else sharding_leaves(shardings))
        if len(shard_leaves) != len(leaves):
            raise ValueError(f"{len(shard_leaves)} shardings for "
                             f"{len(leaves)} leaves")
        loaded = []
        for i, (ref, shd) in enumerate(zip(leaves, shard_leaves)):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            t = torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
            if shd is not None:
                from torch.distributed.tensor import distribute_tensor
                mesh, placements = shd
                t = distribute_tensor(t, mesh, placements,
                                      src_data_rank=None)
            loaded.append(t)
        return tree_unflatten(treedef, loaded)
