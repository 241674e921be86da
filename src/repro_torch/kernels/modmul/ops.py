"""Wrapper of the pointwise-modmul CUDA kernel (csrc/modmul.cu)."""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.modmul.ref import pointwise_mont_ref

__all__ = ["pointwise_mont_op"]


def pointwise_mont_op(a, b, primes, pprime, r2):
    """(np, N) a⊙b mod p; inputs in [0, p). CPU tensors run the plain
    version, CUDA tensors the kernel."""
    common.words32(a)
    if common.plain(a):
        return pointwise_mont_ref(a, b, primes, pprime, r2)
    npn, N = a.shape
    if N % 4:
        raise ValueError(f"N={N} must be a multiple of 4")
    dev = a.device
    out = torch.empty_like(a)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("a", a, (npn, N)), ("b", b, (npn, N)), ("primes", primes, (npn,)),
        ("pprime", pprime, (npn,)), ("r2", r2, (npn,)),
        ("out", out, (npn, N)))]
    common.launch("modmul", "modmul_launch", *ptrs, npn, N)
    return out
