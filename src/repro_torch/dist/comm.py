"""The collectives of the HE path across ranks, recorded.

The only module of the HE path that calls ``torch.distributed``. Each
wrapper runs one blocking collective over a :class:`~repro_torch.launch.\\
mesh.HostGrid` axis (``async_op=False``, issued after the producing
kernels on the current stream) and appends a record to one of the grid's
two logs:

  - ``"step"``: the collectives of a step itself (iCRT's cross-prime
    reductions) — the schedule that ``dist.sharding.he_expected_collectives``
    predicts and ``SHARD_MANIFEST.json`` measures for the reference;
  - ``"feed"``: the traffic that feeds a step — operands scattered to and
    results gathered from the ranks, keys and batches broadcast to the
    serving followers.

A record holds the kind, the dtype, the payload bytes S, the axis and its
size g, the host seconds the blocking call took, and the ring-model wire
bytes per rank, the model of
``launch/hlo_analysis.py`` in the JAX package: an all-reduce 2·S·(g−1)/g,
a reduce-scatter and an all-gather S·(g−1)/g of the full tensor, a
broadcast S·(g−1)/g.

Payloads are int64 and float64 (gloo refuses uint32; the port's 32-bit
words travel as int32, which every backend takes). Which devices a
backend takes for each collective is the static table
:data:`DEVICE_SUPPORT`; a tensor elsewhere is refused, never moved
silently. Gloo took CUDA tensors for all four on an H100 (torch 2.11, two
ranks on one card), so no collective of the HE path goes through a staged
host copy of its own.
"""

from __future__ import annotations

from typing import Optional

import time

import torch

__all__ = ["KINDS", "DEVICE_SUPPORT", "all_reduce", "reduce_scatter",
           "all_gather", "broadcast", "reset", "summary"]

KINDS = ("all-reduce", "reduce-scatter", "all-gather", "broadcast")

# device types each backend's collectives take (gloo: int64, float64 and
# int32 CUDA tensors for all four, found on an H100)
DEVICE_SUPPORT = {
    "gloo": {kind: {"cpu", "cuda"} for kind in KINDS},
    "nccl": {kind: {"cuda"} for kind in KINDS},
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _wire(kind: str, size: float, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (g - 1) / g
    return size * (g - 1) / g


def _record(grid, book: str, kind: str, t: torch.Tensor, full: int,
            axis: str, t0: float) -> None:
    g = grid.axis_size(axis)
    grid.log[book].append({
        "kind": kind, "dtype": str(t.dtype).removeprefix("torch."),
        "bytes": full, "axis": axis, "group_size": g,
        "wire_bytes": _wire(kind, full, g),
        "seconds": time.perf_counter() - t0})


def _check(grid, kind: str, t: torch.Tensor) -> None:
    """Refuse a tensor on a device the backend's `kind` does not take."""
    if t.device.type not in DEVICE_SUPPORT[grid.backend][kind]:
        raise ValueError(f"{grid.backend} {kind} takes tensors on "
                         f"{sorted(DEVICE_SUPPORT[grid.backend][kind])}; "
                         f"got one on {t.device}")


def all_reduce(grid, t: torch.Tensor, *, axis: str = "model",
               book: str = "step") -> torch.Tensor:
    """Sum `t` over the ranks of this rank's `axis` group, in place;
    returns `t`. Nothing is issued (or recorded) on an axis of size 1."""
    if grid.axis_size(axis) == 1:
        return t
    import torch.distributed as dist
    _check(grid, "all-reduce", t)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=grid.group(axis))
    _record(grid, book, "all-reduce", t, _nbytes(t), axis, t0)
    return t


def reduce_scatter(grid, t: torch.Tensor, *, axis: str = "model",
                   book: str = "step") -> torch.Tensor:
    """Sum `t` over the `axis` group and keep this rank's block of its
    leading dimension (which the group size must divide)."""
    g = grid.axis_size(axis)
    if g == 1:
        return t
    if t.shape[0] % g:
        raise ValueError(f"reduce_scatter of {t.shape[0]} rows over {g} "
                         f"ranks")
    import torch.distributed as dist
    _check(grid, "reduce-scatter", t)
    t0 = time.perf_counter()
    out = t.new_empty((t.shape[0] // g, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t.contiguous(), group=grid.group(axis))
    _record(grid, book, "reduce-scatter", t, _nbytes(t), axis, t0)
    return out


def all_gather(grid, t: torch.Tensor, *, axis: str = "model",
               book: str = "step") -> torch.Tensor:
    """Concatenate every `axis` rank's `t` along the leading dimension, in
    rank order."""
    g = grid.axis_size(axis)
    if g == 1:
        return t
    import torch.distributed as dist
    _check(grid, "all-gather", t)
    t0 = time.perf_counter()
    out = t.new_empty((g * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t.contiguous(), group=grid.group(axis))
    _record(grid, book, "all-gather", out, _nbytes(out), axis, t0)
    return out


def broadcast(grid, t: torch.Tensor, *, src: int = 0, axis: str = "model",
              book: str = "feed") -> torch.Tensor:
    """`t` of the group's rank `src` (its index along `axis`) into `t` on
    every rank of the group, in place; returns `t`."""
    if grid.axis_size(axis) == 1:
        return t
    import torch.distributed as dist
    _check(grid, "broadcast", t)
    t0 = time.perf_counter()
    dist.broadcast(t, src=grid.axis_ranks(axis)[src], group=grid.group(axis))
    _record(grid, book, "broadcast", t, _nbytes(t), axis, t0)
    return t


def reset(grid, book: Optional[str] = None) -> None:
    """Empty one log (or both)."""
    for b in ([book] if book else list(grid.log)):
        grid.log[b].clear()


def summary(grid, book: str = "step") -> dict:
    """One log in the manifest's terms: counts and wire bytes by kind,
    ``total_bytes`` and the axes the collectives ran over; the payload
    bytes and the seconds in all."""
    counts: dict = {}
    wire: dict = {}
    axes = set()
    for rec in grid.log[book]:
        k = rec["kind"]
        counts[k] = counts.get(k, 0) + 1
        wire[k] = wire.get(k, 0.0) + rec["wire_bytes"]
        axes.add(rec["axis"])
    return {"counts": counts, "bytes": wire,
            "total_bytes": float(sum(wire.values())),
            "group_axes": sorted(axes),
            "payload_bytes": sum(r["bytes"] for r in grid.log[book]),
            "seconds": sum(r["seconds"] for r in grid.log[book])}
