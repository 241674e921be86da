"""Wrappers of the iCRT CUDA kernels (csrc/icrt.cu).

``icrt_op``: the kernel includes the JAX package's plain tail (−s·P, the ±1
ladder and the center-lift, ``finalize_accum``), so one launch gives the
result. ``icrt_partial_op`` and ``icrt_finish_op``: the same function split
at the cross-prime sum, for primes spread over ranks
(``repro_torch.dist``): a shard's residues to the column sums and quotient
sum (``core.crt.icrt_partial``), and their sum over the shards to the
result (``core.crt.icrt_finish``). An empty shard launches nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import SMEM_LIMIT
from repro_torch.kernels.icrt.ref import (
    icrt_finish_ref, icrt_partial_ref, icrt_ref,
)

__all__ = ["icrt_op", "icrt_geometry", "icrt_args", "icrt_partial_op",
           "icrt_partial_geometry", "icrt_finish_op", "icrt_finish_geometry",
           "BLOCK", "ROWS", "FINISH_ROWS", "SMEM_LIMIT"]

BLOCK = 64          # coefficients per block (kBM of csrc/icrt.cu)
_CHUNK = 32         # columns of P/p_j per chunk (kBN)
_THREADS = 128      # threads per block (kThreads)
ROWS = 32           # coefficients a tile of the partial (kRows)
_PARTIAL_THREADS = 256  # the most threads a partial block has
FINISH_ROWS = 16    # coefficients a finish block (kFinRows)


def icrt_geometry(N: int, npn: int, A: int, out_limbs: int
                  ) -> tuple[int, int, int]:
    """(blocks, threads, dynamic shared-memory bytes) of one launch over N
    coefficients of `npn` primes with an A-limb accumulator. Raises where
    the launcher cannot take the shape: N neither a multiple of BLOCK nor
    at most BLOCK, or tiles beyond SMEM_LIMIT."""
    blocks = _tiles(N, "iCRT")
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
    return blocks, _THREADS, 4 * words


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
    N = r.shape[1]
    n = common.padded(N, BLOCK)
    out, args = icrt_args(_pad_cols(r, n), t, out_limbs)
    common.launch("icrt", "icrt_launch", *args)
    return out if n == N else out[:N]


def _tiles(N: int, what: str) -> int:
    if N > BLOCK and N % BLOCK:
        raise ValueError(f"{what} needs N a multiple of {BLOCK} or at most "
                         f"{BLOCK}; got N={N}")
    return -(-N // BLOCK)


def icrt_partial_geometry(N: int, npn: int, PL: int
                          ) -> tuple[int, int, int]:
    """(blocks, threads, dynamic shared-memory bytes) of one partial launch
    over N coefficients of a shard of `npn` ≥ 1 primes and PL columns:
    blocks is the tiles of ROWS coefficients (the launch runs as many of
    them as fit the card, each looping over tiles); a warp per four n8
    tiles of the (ROWS, 2W) f64 sums, W = PL rounded up to 4; the shared
    memory the lo and hi tile, temp and 1/p_j in f64, pdivp (W columns),
    a tile of residues and the Shoup tables. Any N ≥ 1."""
    if npn < 1:
        raise ValueError("an empty shard launches nothing")
    np4, W = -(-npn // 4) * 4, -(-PL // 4) * 4
    threads = 32 * -(-W // 16)
    nbytes = (16 * ROWS * PL + 8 * np4 * (ROWS + 5)
              + 4 * np4 * (W + ROWS + 3))
    if threads > _PARTIAL_THREADS or nbytes > SMEM_LIMIT:
        raise ValueError(f"iCRT partial tiles of {npn} primes and {PL} "
                         f"columns need {threads} threads and {nbytes} "
                         f"bytes of shared memory")
    return -(-N // ROWS), threads, nbytes


def icrt_finish_geometry(N: int, A: int, out_limbs: int, PL: int
                         ) -> tuple[int, int, int]:
    """(blocks, threads, dynamic shared-memory bytes) of one finish launch:
    a block of one warp a tile of FINISH_ROWS coefficients, with the
    tile's rows of lo and hi (FINISH_ROWS × PL int64 each, one bulk load
    apiece), its mbarrier, P and ⌊P/2⌋, the v tile of min(out_limbs, A)
    limbs and step 4's scratch. Any N ≥ 1."""
    L = min(out_limbs, A)
    nbytes = (16 * FINISH_ROWS * PL + 8
              + 4 * (2 * A + L * (FINISH_ROWS + 1) + FINISH_ROWS + L))
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"iCRT finish tiles need {nbytes} bytes")
    return -(-N // FINISH_ROWS), 32, nbytes


def _pad_cols(x, n: int):
    return x if x.shape[1] == n else torch.cat(
        [x, x.new_zeros((x.shape[0], n - x.shape[1]))], dim=1)


def icrt_partial_op(r, t: dict):
    """A shard's (np_s, N) eval residues -> (lo, hi, qsum) of
    ``core.crt.icrt_partial``: int64 (N, PL), int64 (N, PL), f64 (N,).
    `t` holds the shard's rows of :func:`~repro_torch.kernels.icrt.ref.\
icrt_inputs` (``pdivp`` keeps PL columns when the shard is empty). An
    empty shard (np_s = 0) gives zeros and launches nothing. Any N."""
    common.words32(r)
    npn, N = r.shape
    PL = t["pdivp"].shape[1]
    if npn != t["pdivp"].shape[0]:
        raise ValueError(f"need {t['pdivp'].shape[0]} primes; got {npn}")
    if npn == 0:
        z = torch.zeros((N, PL), dtype=torch.int64, device=r.device)
        return z, z.clone(), torch.zeros(N, dtype=torch.float64,
                                          device=r.device)
    if common.plain(r):
        return icrt_partial_ref(r, t)
    if r.data_ptr() % 16:   # a shard's rows of a width not a multiple of 4
        r = r.clone()
    geometry = icrt_partial_geometry(N, npn, PL)
    dev = r.device
    lo = torch.empty((N, PL), dtype=torch.int64, device=dev)
    hi = torch.empty((N, PL), dtype=torch.int64, device=dev)
    qsum = torch.empty(N, dtype=torch.float64, device=dev)
    ptrs = [common.check(name, v, shape, dev, dtype) for name, v, shape, dtype
            in (("r", r, (npn, N), torch.int32),
                ("inv_P", t["inv_P"], (npn,), torch.int32),
                ("inv_P_shoup", t["inv_P_shoup"], (npn,), torch.int32),
                ("primes", t["primes"], (npn,), torch.int32),
                ("p_inv_f64", t["p_inv_f64"], (npn,), torch.float64),
                ("pdivp", t["pdivp"], (npn, PL), torch.int32),
                ("lo", lo, (N, PL), torch.int64),
                ("hi", hi, (N, PL), torch.int64),
                ("qsum", qsum, (N,), torch.float64))]
    common.launch("icrt_partial", "icrt_partial_launch", *ptrs, N, npn, PL,
                  *geometry)
    return lo, hi, qsum


def icrt_finish_op(lo, hi, qsum, t: dict, out_limbs: int):
    """(lo, hi, qsum) summed over every shard of P's primes -> (N,
    out_limbs) centered two's complement, the words of :func:`icrt_op`.
    `t` holds ``P_limbs`` and ``P_half_limbs`` (A ≥ PL + 1 limbs). Any
    N."""
    if common.plain(lo):
        return icrt_finish_ref(lo, hi, qsum, t, out_limbs)
    N, PL = lo.shape
    A = t["P_limbs"].shape[0]
    geometry = icrt_finish_geometry(N, A, out_limbs, PL)
    dev = lo.device
    out = torch.empty((N, out_limbs), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, v, shape, dev, dtype) for name, v, shape, dtype
            in (("lo", lo, (N, PL), torch.int64),
                ("hi", hi, (N, PL), torch.int64),
                ("qsum", qsum, (N,), torch.float64),
                ("P_limbs", t["P_limbs"], (A,), torch.int32),
                ("P_half_limbs", t["P_half_limbs"], (A,), torch.int32),
                ("out", out, (N, out_limbs), torch.int32))]
    common.launch("icrt_finish", "icrt_finish_launch", *ptrs, N, PL, A,
                  out_limbs, *geometry)
    return out
