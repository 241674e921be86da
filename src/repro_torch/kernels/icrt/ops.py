"""Wrapper of the iCRT CUDA kernel (csrc/icrt.cu).

The kernel includes the JAX package's plain tail (−s·P, the ±1 ladder and
the center-lift, ``finalize_accum``), so one launch gives the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import SMEM_LIMIT
from repro_torch.kernels.icrt.ref import icrt_ref

__all__ = ["icrt_op", "icrt_geometry", "icrt_args", "BLOCK", "SMEM_LIMIT"]

BLOCK = 64          # coefficients per block (kBM of csrc/icrt.cu)
_CHUNK = 32         # columns of P/p_j per chunk (kBN)
_THREADS = 128      # threads per block (kThreads)


def icrt_geometry(N: int, npn: int, A: int, out_limbs: int
                  ) -> tuple[int, int, int]:
    """(blocks, threads, dynamic shared-memory bytes) of one launch over N
    coefficients of `npn` primes with an A-limb accumulator. Raises where
    the launcher cannot take the shape: N neither a multiple of BLOCK nor
    at most BLOCK, or tiles beyond SMEM_LIMIT."""
    if N > BLOCK and N % BLOCK:
        raise ValueError(f"iCRT needs N a multiple of {BLOCK} or at most "
                         f"{BLOCK}; got N={N}")
    np4 = -(-npn // 4) * 4
    # residue/temp tile, the pdivp chunk that the column sums reuse, the v
    # tile of min(out_limbs, A) limbs at a pitch of BLOCK + 1, and the
    # chunk's limbs of P and ⌊P/2⌋
    words = (np4 * BLOCK + max(np4 * _CHUNK, 3 * _CHUNK * BLOCK)
             + min(out_limbs, A) * (BLOCK + 1) + 2 * _CHUNK)
    if 4 * words > SMEM_LIMIT:
        raise ValueError(f"iCRT tiles of {npn} primes and {A} limbs need "
                         f"{4 * words} bytes of shared memory, above "
                         f"{SMEM_LIMIT}")
    return -(-N // BLOCK), _THREADS, 4 * words


def icrt_args(r, t: dict, out_limbs: int) -> tuple:
    """The output tensor and the arguments of ``icrt_launch`` for CUDA
    residues `r`, after checking every operand."""
    npn, N = r.shape
    PL, A = t["pdivp"].shape[1], t["P_limbs"].shape[0]
    if npn != t["pdivp"].shape[0]:
        raise ValueError(f"need {t['pdivp'].shape[0]} primes; got {npn}")
    geometry = icrt_geometry(N, npn, A, out_limbs)
    dev = r.device
    out = torch.empty((N, out_limbs), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, v, shape, dev, dtype) for name, v, shape, dtype
            in (("r", r, (npn, N), torch.int32),
                ("inv_P", t["inv_P"], (npn,), torch.int32),
                ("inv_P_shoup", t["inv_P_shoup"], (npn,), torch.int32),
                ("primes", t["primes"], (npn,), torch.int32),
                ("p_inv_f64", t["p_inv_f64"], (npn,), torch.float64),
                ("pdivp", t["pdivp"], (npn, PL), torch.int32),
                ("P_limbs", t["P_limbs"], (A,), torch.int32),
                ("P_half_limbs", t["P_half_limbs"], (A,), torch.int32),
                ("out", out, (N, out_limbs), torch.int32))]
    return out, (*ptrs, N, npn, PL, A, out_limbs, *geometry)


def icrt_op(r, t: dict, out_limbs: int):
    """(np, N) eval residues -> (N, out_limbs) centered two's complement.
    `t` holds the tables of :func:`~repro_torch.kernels.icrt.ref.icrt_inputs`
    (a region table has them) on r's device. Any N: one the launch cannot
    tile (above one block, not a multiple of it) runs zero-padded to a
    multiple of BLOCK."""
    common.words32(r)
    if common.plain(r):
        return icrt_ref(r, t, out_limbs)
    npn, N = r.shape
    n = common.padded(N, BLOCK)
    if n != N:
        r = torch.cat([r, r.new_zeros((npn, n - N))], dim=1)
    out, args = icrt_args(r, t, out_limbs)
    common.launch("icrt", "icrt_launch", *args)
    return out if n == N else out[:N]
