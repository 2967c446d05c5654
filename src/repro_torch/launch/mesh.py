"""Meshes: the production mesh's sizes, a local ``DeviceMesh`` over ranks,
and a runner that starts one process per rank.

Counterpart of ``repro/launch/mesh.py``. The reference's production meshes
are a TPU pod slice, (data 16, model 16) = 256 chips, and two of them,
(pod 2, data 16, model 16) = 512. No process group here holds 512 cards,
so :func:`make_production_mesh` returns the sizes alone
(:class:`AbstractMesh`), which is all that the sharding rules and the dry
run's per-device accounting read.

A local mesh is a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names. Torch runs one process per device, so a rank is
one card over NCCL on the card's machine (NCCL refuses two ranks on one
card) or one CPU process over gloo (``device="cpu"``). :func:`run_ranks`
spawns the ranks, opens the group in each (a ``file://`` rendezvous in a
temporary directory, a 60 s collective timeout), runs a function and
brings its return value back; the training CLI, ``chip_smoke.py`` and the
tests start ranks through it. A mesh of one rank can be opened in the
caller's own process.

:func:`fake_mesh` opens a mesh of any size in this one process over
torch's fake process group (every collective returns at once, its data
untouched): the production meshes, 256 and 512 ranks, seen from rank 0,
for counting what one device of them does (``launch/hlo_analysis.py``,
``launch/dryrun.py``). It computes nothing that a real mesh would.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import dp_axes_of

__all__ = ["MESH_AXES", "AbstractMesh", "make_production_mesh",
           "make_local_mesh", "close_local_mesh", "fake_mesh", "batch_axes",
           "backend_for", "run_ranks", "COLLECTIVE_TIMEOUT_S"]

MESH_AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
#: how long a collective may wait for a peer before the group raises
COLLECTIVE_TIMEOUT_S = 60


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes, with no devices behind it (the
    counterpart of ``jax.sharding.AbstractMesh``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: the reference's production meshes, as sizes."""
    if multi_pod:
        return AbstractMesh(MESH_AXES["multi"], (2, 16, 16))
    return AbstractMesh(MESH_AXES["single"], (16, 16))


def backend_for(device=None) -> Tuple[str, str]:
    """``(device type, backend)``: ``("cpu", "gloo")`` for ``device="cpu"``,
    else ``("cuda", "nccl")``; with no card and no ``device="cpu"`` it
    raises."""
    if device is not None and torch.device(device).type == "cpu":
        return "cpu", "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh of cards needs one card "
                           "a rank; pass device='cpu' for gloo ranks")
    if device is not None and torch.device(device).type != "cuda":
        raise ValueError(f"device {device!r}: 'cpu' or a card")
    return "cuda", "nccl"


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_local_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                    device=None):
    """A ``DeviceMesh`` of ``(data, model)`` ranks (``(pod, data, model)``
    with ``pod > 1``) named as the reference's. In a process started by
    :func:`run_ranks` it uses that group, whose size must be the mesh's;
    elsewhere it opens a group of one rank in this process (a mesh of
    one), on ``tcp://localhost`` at a free port. ``device=None`` is the
    card (NCCL); ``device="cpu"`` is gloo; with no card and no
    ``device="cpu"`` it raises."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dev_type, backend = backend_for(device)
    shape = (pod, data, model) if pod > 1 else (data, model)
    names = MESH_AXES["multi"] if pod > 1 else MESH_AXES["single"]
    n = data * model * pod
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs {n} processes: "
                               "start them with run_ranks")
        if dev_type == "cuda" and device is not None:
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    elif dist.get_world_size() != n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks; the group has "
                           f"{dist.get_world_size()}")
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the group's backend is {dist.get_backend()}, "
                           f"the mesh's device needs {backend}")
    return init_device_mesh(dev_type, shape, mesh_dim_names=names)


def close_local_mesh() -> None:
    """Destroy this process's group (after :func:`make_local_mesh` opened
    one of one rank), so a later mesh starts afresh."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(shape: Tuple[int, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` ((data, model) or (pod, data,
    model), named as the reference's) over an in-process fake process
    group of ``prod(shape)`` ranks, this process rank 0; the group is
    destroyed on exit. ``device_type`` ``"cuda"`` (the default: DTensor
    then picks the collectives NCCL would run) needs no card: the ranks'
    tensors may lie on ``meta``. Raises if a process group is open."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    names = {2: MESH_AXES["single"], 3: MESH_AXES["multi"]}.get(len(shape))
    if names is None:
        raise ValueError(f"mesh shape {shape}: (data, model) or (pod, "
                         "data, model)")
    if dist.is_initialized():
        raise RuntimeError("a process group is open: a fake mesh needs "
                           "this process to itself")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh(device_type, tuple(shape),
                               mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def batch_axes(mesh) -> tuple:
    """Mesh axes that shard the batch (DP axes)."""
    return dp_axes_of(mesh)


# ------------------------------------------------------------------ ranks

def _rank_main(fn, rank: int, world: int, dev_type: str, backend: str,
               init_method: str, args: Sequence, out_dir: str,
               threads: Optional[int]) -> None:
    import faulthandler
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    err = os.path.join(out_dir, f"rank{rank}.err")
    # a fatal signal (a native crash) leaves the rank's Python stacks here
    fault = open(os.path.join(out_dir, f"rank{rank}.fault"), "w")
    faulthandler.enable(file=fault)
    try:
        if dev_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(err, "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world_size: int, *, device=None,
              args: Sequence = (), timeout: float = 600.0,
              threads: Optional[int] = None,
              out_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes, one a
    rank, each in a process group of them all (NCCL on the cards, rank r
    on card ``r % device_count``; gloo for ``device="cpu"``). Returns
    each rank's return value, in rank order (saved with ``torch.save``:
    return host tensors and plain data). ``fn`` must be importable (a
    module-level function). Every rank is joined by ``timeout`` seconds
    in all; a rank that fails, or one still running then, is an error,
    and the ranks still running are killed. ``threads`` sets each rank's
    ``torch.set_num_threads`` (default on the CPU: this process's torch
    threads over the ranks, so a caller capped to fewer threads than
    cores, as under a parallel test run, does not oversubscribe them)."""
    import multiprocessing as mp
    dev_type, backend = backend_for(device)
    if dev_type == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards "
                           f"(one each); {torch.cuda.device_count()} visible")
    if threads is None and dev_type == "cpu":
        threads = max(1, torch.get_num_threads() // world_size)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, dev_type, backend,
                                   init, tuple(args), tmp, threads))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0 and r not in hung:
                path = os.path.join(tmp, f"rank{r}.fault")
                stacks = ""
                if os.path.exists(path):
                    with open(path) as f:
                        stacks = f.read()
                errors.append(f"rank {r}: exit code {p.exitcode}"
                              + (f"\n{stacks}" if stacks else ""))
        if hung:
            raise TimeoutError(f"ranks {hung} of {world_size} still running "
                               f"after {timeout:.0f} s (killed)"
                               + ("\n" + "\n".join(errors) if errors else ""))
        if errors:
            raise RuntimeError("\n".join(errors))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
