"""Explicit compressed collectives for the data-parallel training path.

`compressed_psum_grads` is the wire protocol `optim/compress.py`
documents: each rank int8-block-quantizes its local gradients (stochastic
rounding, per-256-block f32 scales), the int8 payloads and the scales are
all-gathered over the grid's data group (4× less traffic than an f32 ring
all-reduce; each gather is recorded in the grid's "step" log by
:mod:`repro_torch.dist.comm`), and every rank dequantizes per source and
averages in rank order. Every rank averages the same gathered words in
the same order, so all replicas hold bit-identical results.

The rounding noise of leaf i is drawn from a generator seeded by
:func:`leaf_seed` of (seed, i); the trainer passes a seed that is a pure
function of (its seed, the step), so a replay after a restart redraws the
same noise, and every rank draws the same noise, as every device does in
the reference (its key is replicated).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from repro_torch.dist import comm
from repro_torch.optim.compress import compress_int8, decompress_int8

__all__ = ["compressed_psum_grads", "leaf_seed", "step_seed"]

# The axis a collective runs over: one axis of a launch.mesh.HostGrid
# ("data" or "model"). The reference's may name several mesh axes at once;
# a grid has one process group an axis, so here it names one.
AxisNames = str

_MASK = (1 << 63) - 1


def _mix(*words: int) -> int:
    """A 63-bit seed from integers (splitmix64's finalizer over each)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & ((1 << 64) - 1))) * 0xBF58476D1CE4E5B9 % (1 << 64)
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB % (1 << 64)
        h ^= h >> 29
    return h & _MASK


def step_seed(seed: int, step: int) -> int:
    """The quantization seed of a training step: the counterpart of the
    reference's ``fold_in(key(seed), step)``."""
    return _mix(seed, step)


def leaf_seed(seed: int, index: int) -> int:
    """The seed of leaf `index`'s noise under a step's `seed`: the
    counterpart of the reference's ``split(key, n)[index]``."""
    return _mix(seed, index, 1)


def compressed_psum_grads(grads: Mapping[str, torch.Tensor], grid,
                          seed: int, axis: AxisNames = "data", *,
                          noise: Optional[Sequence[torch.Tensor]] = None
                          ) -> dict:
    """Mean-reduce {name: gradient} across `grid`'s `axis` group in int8.

    Leaves are taken in the mapping's order (leaf i's noise is drawn from
    ``leaf_seed(seed, i)``, or is ``noise[i]`` when given). Returns the
    dequantized mean of every leaf with its shape and dtype; every rank
    returns the same bits. Error per element is bounded by one
    quantization step (≤ max|g| / 127 of the worst shard). At an axis of
    size 1 nothing is issued, but the leaves are still quantized and
    dequantized, as on the reference's one-device mesh."""
    if noise is not None and len(noise) != len(grads):
        raise ValueError(f"{len(noise)} noise tensors for {len(grads)} "
                         f"leaves")
    w = grid.axis_size(axis)
    out = {}
    for i, (name, g) in enumerate(grads.items()):
        if noise is not None:
            q8, scale, meta = compress_int8(g, noise=noise[i])
        else:
            gen = torch.Generator(device=g.device).manual_seed(
                leaf_seed(seed, i))
            q8, scale, meta = compress_int8(g, gen)
        # the only wire traffic: the int8 payload and its scales
        q_all = comm.all_gather(grid, q8, axis=axis).reshape(
            (w,) + tuple(q8.shape))
        s_all = comm.all_gather(grid, scale, axis=axis).reshape(
            (w,) + tuple(scale.shape))
        total = decompress_int8(q_all[0], s_all[0], meta)
        for r in range(1, w):
            total = total + decompress_int8(q_all[r], s_all[r], meta)
        out[name] = (total / float(w)).to(g.dtype)
    return out
