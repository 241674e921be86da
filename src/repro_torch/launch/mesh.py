"""A grid of ranks on one host: the port's counterpart of the JAX package's
``launch/mesh.py`` ``make_host_mesh``.

The reference lays its devices out as a ``(data, model)`` mesh and lets the
partitioner place the collectives. The port runs one process per rank and
issues the collectives itself (:mod:`repro_torch.dist.comm`), over
``torch.distributed`` process groups:

  - :class:`HostGrid` holds the ``(data, model)`` sizes, this rank's
    coordinates, the model and data sub-groups, the device and the backend;
  - :func:`make_host_grid` builds one in a rank (``torch.distributed``
    initialised from an explicit ``init_method``; a grid of size 1 creates
    no process group and issues no collective, as the reference's
    partitioner elides every reduction at model size 1);
  - :func:`spawn_grid` starts the ranks of a grid as processes in spawn
    mode (CUDA forbids fork), meeting at a ``file://`` rendezvous in a
    temporary directory, runs a function in each and returns what each
    returned.

Ranks are numbered row-major over ``(data, model)``, as the reference's
device ids are. The backend follows one explicit rule
(:func:`grid_backend`): ``nccl`` only where every rank owns a distinct
GPU, ``gloo`` otherwise — which includes one card shared by every rank (NCCL
refuses two ranks on one GPU) and the CPU. The device defaults to the card;
the CPU only when asked.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core.context import resolve_device

__all__ = ["HostGrid", "make_host_grid", "grid_devices", "grid_backend",
           "spawn_grid", "single_grid"]

# the time limit of every collective and of every wait on a peer
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(eq=False)
class HostGrid:
    """One rank's view of a ``(data, model)`` grid.

    ``model_group``/``data_group`` are the ``torch.distributed`` groups of
    this rank's row (the ranks that share its data coordinate) and column
    (those that share its model coordinate); None on a grid of size 1.
    ``log`` holds the collective records of :mod:`repro_torch.dist.comm`.
    """

    data: int
    model: int
    rank: int
    device: torch.device
    backend: Optional[str]
    model_group: Any = None
    data_group: Any = None
    timeout_s: float = DEFAULT_TIMEOUT_S
    log: dict = dataclasses.field(
        default_factory=lambda: {"step": [], "feed": []})

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.model)

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def name(self) -> str:
        """``"<data>x<model>"``, the manifest's mesh name."""
        return f"{self.data}x{self.model}"

    def axis_size(self, axis: str) -> int:
        return {"data": self.data, "model": self.model}[axis]

    def group(self, axis: str):
        """The process group of this rank along `axis`."""
        return {"data": self.data_group, "model": self.model_group}[axis]

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks of this rank's group along `axis`, in order."""
        if axis == "model":
            return [self.data_rank * self.model + m
                    for m in range(self.model)]
        return [d * self.model + self.model_rank for d in range(self.data)]

    def describe(self) -> dict:
        return {"data": self.data, "model": self.model, "rank": self.rank,
                "device": str(self.device), "backend": self.backend}

    def close(self) -> None:
        """Leave the process group (nothing on a grid of size 1)."""
        import torch.distributed as dist
        if self.size > 1 and dist.is_initialized():
            dist.destroy_process_group()


def grid_devices(device: str | torch.device, size: int
                 ) -> list[torch.device]:
    """The device of each rank of a grid of `size` ranks: the CPU for
    every rank when asked for it; else a card each where the host has one
    for every rank, and the one card shared by all where it has not."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * size
    if dev.index is None and torch.cuda.device_count() >= size:
        return [torch.device("cuda", i) for i in range(size)]
    shared = dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
    return [shared] * size


def grid_backend(devices: Sequence[torch.device]) -> str:
    """``nccl`` where every rank owns a distinct GPU, else ``gloo``."""
    if all(d.type == "cuda" for d in devices) \
            and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def single_grid(device: str | torch.device = "cuda") -> HostGrid:
    """The grid of one rank: no process group, no collective."""
    return HostGrid(data=1, model=1, rank=0, device=resolve_device(device),
                    backend=None)


def make_host_grid(model: int = 1, data: int = 1, *, rank: int = 0,
                   init_method: Optional[str] = None,
                   device: str | torch.device = "cuda",
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> HostGrid:
    """This rank's :class:`HostGrid` of ``data × model`` ranks.

    A grid of more than one rank joins ``torch.distributed`` at
    `init_method` (``file://…`` or ``tcp://host:port``) with the backend of
    :func:`grid_backend` and `timeout_s` on every collective, then makes
    the model groups (one per data row) and the data groups (one per model
    column); every rank makes every group, in the same order."""
    if model < 1 or data < 1:
        raise ValueError(f"grid sizes must be positive; got {data}x{model}")
    size = data * model
    if not 0 <= rank < size:
        raise ValueError(f"rank {rank} outside a grid of {size}")
    if size == 1:
        return single_grid(device)
    if init_method is None:
        raise ValueError("a grid of more than one rank needs init_method")
    import torch.distributed as dist
    devices = grid_devices(device, size)
    backend = grid_backend(devices)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    grid = HostGrid(data=data, model=model, rank=rank, device=dev,
                    backend=backend, timeout_s=timeout_s)
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if d == grid.data_rank:
            grid.model_group = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if m == grid.model_rank:
            grid.data_group = g
    return grid


def _rank_main(fn, args, rank, model, data, device, init_method, out,
               timeout_s) -> None:
    try:
        if resolve_device(device).type == "cpu":
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // (model * data)))
        grid = make_host_grid(model, data, rank=rank,
                              init_method=init_method, device=device,
                              timeout_s=timeout_s)
        try:
            result = fn(grid, *args)
        finally:
            grid.close()
        # by value: a tensor shared by handle would die with this process
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:                   # reported to the parent
        out.put((rank, False, traceback.format_exc()))


def _take(results: dict, failed: dict, rank: int, ok: bool,
          payload) -> None:
    if ok:
        results[rank] = pickle.loads(payload)
    else:
        failed[rank] = payload


def spawn_grid(fn: Callable, *, model: int, data: int = 1,
               device: str | torch.device = "cuda", args: tuple = (),
               timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(grid, *args)`` in every rank of a ``data × model`` grid of
    spawned processes; returns the ranks' results in rank order.

    `fn` must be importable by name; what it returns comes back pickled
    by value (CPU tensors are copied; `args` reach the ranks through
    shared memory). A rank that raises, or dies without a
    result, makes this raise with its traceback (the lowest such rank's)
    once the others have ended or `timeout_s` more has passed; they are
    then stopped. `timeout_s` also bounds every collective of the ranks,
    and 4 × `timeout_s` the whole run."""
    import torch.multiprocessing as mp
    size = model * data
    resolve_device(device)                  # the card, or raise here
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    deadline = time.monotonic() + 4 * timeout_s
    with tempfile.TemporaryDirectory(prefix="grid-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, model, data, str(device),
                                   init, out, timeout_s), daemon=True)
                 for r in range(size)]
        for p in procs:
            p.start()
        results: dict = {}
        failed: dict = {}
        grace_end = None
        try:
            while len(results) + len(failed) < size:
                now = time.monotonic()
                if now > deadline or (grace_end is not None
                                      and now > grace_end):
                    for r in range(size):
                        if r not in results and r not in failed:
                            failed[r] = "did not finish in time"
                    break
                try:
                    rank, ok, payload = out.get(timeout=0.5)
                except queue.Empty:
                    for r, p in enumerate(procs):
                        if r not in results and r not in failed \
                                and p.exitcode is not None:
                            # its last message may still be in the pipe
                            try:
                                rank, ok, payload = out.get(timeout=2.0)
                            except queue.Empty:
                                failed[r] = (f"rank {r} exited with code "
                                             f"{p.exitcode} and no result")
                            else:
                                _take(results, failed, rank, ok, payload)
                            break
                else:
                    _take(results, failed, rank, ok, payload)
                if failed and grace_end is None:
                    grace_end = time.monotonic() + timeout_s
        finally:
            for p in procs:
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
    if failed:
        rank = min(failed)
        raise RuntimeError(f"rank {rank} of a {data}x{model} grid failed:\n"
                           f"{failed[rank]}")
    return [results[r] for r in range(size)]
