"""Wrappers of the carry kernels (csrc/carry.cu): the BigInt carry chains
of the β = 2^32 step, one coefficient's limbs a thread.

``shift_round_op`` is ``bigint.shift_right_round(x, s, arithmetic=True,
out_limbs=...)`` (the key switch's ÷Q); ``add_mask_op`` is
``bigint.mask_bits(bigint.add(a, b), bits)`` (the combine). Both take
contiguous (..., L) int32 limb rows of any leading shape and any L; the
leading axes are the kernel's rows.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import common
from repro_torch.kernels.carry.ref import add_mask_ref, shift_round_ref

__all__ = ["shift_round_op", "add_mask_op"]


def _rows(name: str, t: torch.Tensor) -> int:
    """Refuse what the kernels do not take, on any device; the rows."""
    common.words32(t)
    if t.dim() < 1 or not t.shape[-1]:
        raise ValueError(f"{name}: expected (..., L) limb rows with L ≥ 1, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: limb rows must be contiguous")
    n = math.prod(t.shape[:-1])
    if n >= 1 << 31:
        raise ValueError(f"{name}: {n} rows, at most 2^31 − 1")
    return n


def shift_round_op(x: torch.Tensor, s: int, out_limbs: int | None = None
                   ) -> torch.Tensor:
    """round(x / 2^s) (round half up) of two's-complement (..., L) rows, as
    (..., out_limbs) rows (default L). CPU tensors run the plain version,
    CUDA tensors the kernel."""
    n = _rows("x", x)
    L = x.shape[-1]
    out_limbs = L if out_limbs is None else out_limbs
    if s < 0 or out_limbs < 1:
        raise ValueError(f"shift {s} and out_limbs {out_limbs}: need s ≥ 0, "
                         f"out_limbs ≥ 1")
    if common.plain(x):
        return shift_round_ref(x, s, out_limbs)
    out = x.new_empty((*x.shape[:-1], out_limbs))
    if n:
        dev = x.device
        common.launch("carry_shift", "carry_shift_round_launch",
                      common.check("x", x, x.shape, dev),
                      common.check("out", out, out.shape, dev),
                      n, L, s, out_limbs)
    return out


def add_mask_op(a: torch.Tensor, b: torch.Tensor, bits: int
                ) -> torch.Tensor:
    """(a + b) mod 2^bits of (..., L) rows of one shape. CPU tensors run
    the plain version, CUDA tensors the kernel."""
    n = _rows("a", a)
    _rows("b", b)
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)}: the "
                         f"rows must have one shape")
    if bits < 0:
        raise ValueError(f"bits {bits}: need bits ≥ 0")
    if common.plain(a):
        return add_mask_ref(a, b, bits)
    out = torch.empty_like(a)
    if n:
        dev = a.device
        common.launch("carry_add", "carry_add_mask_launch",
                      *[common.check(name, t, a.shape, dev)
                        for name, t in (("a", a), ("b", b), ("out", out))],
                      n, a.shape[-1], bits)
    return out
