"""Wrapper of the CRT CUDA kernel (csrc/crt.cu)."""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.crt.ref import crt_ref

__all__ = ["crt_op"]


def crt_op(x, tb, tb_shoup, primes):
    """(N, K) limbs -> (np, N) residues; tb/tb_shoup are (np, Kt) with
    Kt ≥ max(K, 3)."""
    if common.plain(x):
        return crt_ref(x, tb, tb_shoup, primes)
    N, K = x.shape
    npn, kt = tb.shape
    if N & (N - 1) or kt < max(K, 3):
        raise ValueError(f"need N a power of two and ≥ {max(K, 3)} table "
                         f"columns; got N={N}, {kt} columns")
    dev = x.device
    out = torch.empty((npn, N), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (N, K)), ("tb", tb, (npn, kt)),
        ("tb_shoup", tb_shoup, (npn, kt)), ("primes", primes, (npn,)),
        ("out", out, (npn, N)))]
    common.launch("crt", "crt_launch", *ptrs, N, K, npn, kt)
    return out
