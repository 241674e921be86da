"""Wrapper of the CRT CUDA kernel (csrc/crt.cu)."""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import SMEM_LIMIT
from repro_torch.kernels.crt.ref import crt_ref

__all__ = ["crt_op", "crt_geometry", "crt_args", "BLOCK"]

# strategy -> (the launcher's `every`, launch counter)
_STRATEGIES = {"acc3": (0, "crt"), "mod2": (2, "crt_mod2"),
               "mod4": (4, "crt_mod4")}
BLOCK = 256         # coefficients per block (kBM of csrc/crt.cu)
_THREADS = 256      # threads per block (kThreads)


def crt_geometry(N: int, K: int, npn: int, block: int = BLOCK,
                 threads: int = _THREADS) -> tuple[int, int, int]:
    """(blocks, threads, dynamic shared-memory bytes) of one launch over N
    coefficients of K limbs and `npn` primes. Raises where the launcher
    cannot take the shape: N neither a multiple of the block nor at most
    one block, or tiles beyond SMEM_LIMIT. `block` and `threads` are those
    of a build of csrc/crt.cu with other tile constants
    (kernels/crt/variants.py)."""
    if N > block and N % block:
        raise ValueError(f"CRT needs N a multiple of {block} or at most "
                         f"{block}; got N={N}")
    # the limb tile and all np rows of the table, K padded to a multiple
    # of 4 at a pitch of an odd number of 16-byte units, np padded to 8;
    # 8 words of fold constants a prime
    pitch = -(-K // 4) * 4 | 4
    np8 = -(-npn // 8) * 8
    words = pitch * (block + np8) + 8 * np8
    if 4 * words > SMEM_LIMIT:
        raise ValueError(f"CRT tiles of {K} limbs and {npn} primes need "
                         f"{4 * words} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return -(-N // block), threads, 4 * words


def crt_args(x, tb, tb_shoup, primes, every: int) -> tuple:
    """The output tensor and the arguments of ``crt_launch`` for CUDA limbs
    `x`, after checking every operand."""
    N, K = x.shape
    npn, kt = tb.shape
    if kt < max(K, 3):
        raise ValueError(f"need ≥ {max(K, 3)} table columns; got {kt}")
    geometry = crt_geometry(N, K, npn)
    dev = x.device
    out = torch.empty((npn, N), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (N, K)), ("tb", tb, (npn, kt)),
        ("tb_shoup", tb_shoup, (npn, kt)), ("primes", primes, (npn,)),
        ("out", out, (npn, N)))]
    return out, (*ptrs, N, K, npn, kt, every, *geometry)


def crt_op(x, tb, tb_shoup, primes, *, strategy: str = "acc3"):
    """(N, K) limbs -> (np, N) residues; tb/tb_shoup are (np, Kt) with
    Kt ≥ max(K, 3). Strategies: acc3 | mod2 | mod4 (paper Table VIII).
    Any N: one the launch cannot tile (above one block, not a multiple of
    it) runs zero-padded to a multiple of BLOCK."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown kernel CRT strategy {strategy!r}")
    common.words32(x)
    if common.plain(x):
        return crt_ref(x, tb, tb_shoup, primes, strategy=strategy)
    every, counter = _STRATEGIES[strategy]
    N, K = x.shape
    n = common.padded(N, BLOCK)
    if n != N:
        x = torch.cat([x, x.new_zeros((n - N, K))])
    out, args = crt_args(x, tb, tb_shoup, primes, every)
    common.launch(counter, "crt_launch", *args)
    return out if n == N else out[:, :N].contiguous()
