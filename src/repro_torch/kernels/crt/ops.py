"""Wrapper of the CRT CUDA kernel (csrc/crt.cu)."""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.crt.ref import crt_ref

__all__ = ["crt_op"]

# strategy -> (the launcher's `every`, launch counter)
_STRATEGIES = {"acc3": (0, "crt"), "mod2": (2, "crt_mod2"),
               "mod4": (4, "crt_mod4")}
_BLOCK = 128        # coefficients per block of crt_launch


def crt_op(x, tb, tb_shoup, primes, *, strategy: str = "acc3"):
    """(N, K) limbs -> (np, N) residues; tb/tb_shoup are (np, Kt) with
    Kt ≥ max(K, 3). Strategies: acc3 | mod2 | mod4 (paper Table VIII)."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown kernel CRT strategy {strategy!r}")
    if common.plain(x):
        return crt_ref(x, tb, tb_shoup, primes, strategy=strategy)
    N, K = x.shape
    npn, kt = tb.shape
    if N % min(N, _BLOCK) or kt < max(K, 3):
        raise ValueError(
            f"need N a multiple of {_BLOCK} or at most {_BLOCK} (the "
            f"launcher runs N/min(N, {_BLOCK}) blocks of min(N, {_BLOCK}) "
            f"coefficients) and ≥ {max(K, 3)} table columns; got N={N}, "
            f"{kt} columns")
    dev = x.device
    out = torch.empty((npn, N), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (N, K)), ("tb", tb, (npn, kt)),
        ("tb_shoup", tb_shoup, (npn, kt)), ("primes", primes, (npn,)),
        ("out", out, (npn, N)))]
    every, counter = _STRATEGIES[strategy]
    common.launch(counter, "crt_launch", *ptrs, N, K, npn, kt, every)
    return out
