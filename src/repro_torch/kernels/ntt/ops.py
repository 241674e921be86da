"""Wrappers of the NTT/iNTT CUDA kernels (csrc/ntt.cu).

x may hold a batch of rows: (rows, N) with rows a multiple of the
twiddle tables' np, row r taking twiddle row r mod np (B ciphertexts of np
primes each, stacked). ``modified=True`` runs the paper's modified Shoup
and counts as ``ntt_modified``/``intt_modified``. Each transform is one
launch per pass of :func:`ntt_geometry` (two at N = 2^16), all in one flat
grid, so the number of rows is capped only by CUDA's 2^31 − 1 blocks.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import SMEM_LIMIT
from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref

__all__ = ["ntt_op", "intt_op", "ntt_geometry", "ntt_args"]

STAGES = 8              # stages a pass, at most (kStages of csrc/ntt.cu)
LOG_W = 4               # log2 of the words a lane holds (kLogW)
CHUNK_ROWS = 4          # rows an 8-stage chunk pass's block takes
_THREADS = 256          # threads a block (kThreads)
MAX_LOGN = 30           # the launcher's largest log2 N
MAX_BLOCKS = 2 ** 31 - 1  # CUDA's gridDim.x


def ntt_geometry(rows: int, logn: int, npn: int, log_w: int = LOG_W,
                 chunk_rows: int = CHUNK_ROWS
                 ) -> list[tuple[int, int, int, int, int, int]]:
    """(stages, log2 of the words a tile, rows a block, blocks, threads,
    dynamic shared-memory bytes) of each pass of a transform of `rows` rows
    of 2^logn words and `npn` twiddle rows, in forward order (the inverse
    launches them in reverse): the last min(logn, 8) stages on contiguous
    chunks, the ones before 8 at a time on columns; one flat grid, a block
    a tile of a row, or of `chunk_rows` rows of one twiddle row in a chunk
    pass of 8 stages over 8 warps' words. The one source of the launch,
    which refuses a geometry its kernels cannot run; raises where the
    launch cannot take the shape. `log_w` and `chunk_rows` are those of
    other builds (kernels/ntt/variants.py)."""
    if not 1 <= logn <= MAX_LOGN:
        raise ValueError(f"NTT needs 1 ≤ log2 N ≤ {MAX_LOGN}; got {logn}")
    if rows < npn or rows % npn:
        raise ValueError(f"{rows} rows are not a multiple of the {npn} "
                         f"twiddle rows")
    warp_log = 5 + log_w                # words a warp owns, log2
    chunk_log = warp_log + 3            # 8 warps' words
    last = min(logn, STAGES)
    stages = [min(STAGES, logn - last - s)
              for s in range(0, logn - last, STAGES)] + [last]
    passes = []
    for i, L in enumerate(stages):
        rpb = 1
        if i < len(stages) - 1:         # columns: 2^L rows of 32 words
            logT, sets = L + 5, 1
        else:                           # chunks of 2^L words
            logT = min(logn, chunk_log)
            sets = (1 << max(logT, warp_log)) >> L
            if L == STAGES and logT == chunk_log:
                rpb = chunk_rows
        blocks = npn * -(-(rows // npn) // rpb) << (logn - logT)
        smem = 4 * (1 << logT) + 8 * (sets << L)
        if blocks > MAX_BLOCKS or smem > SMEM_LIMIT:
            raise ValueError(f"NTT of {rows} rows of 2^{logn} words needs "
                             f"{blocks} blocks of {smem} bytes")
        passes.append((L, logT, rpb, blocks, _THREADS, smem))
    return passes


def ntt_args(rows: int, logn: int, npn: int, **geometry) -> tuple:
    """The geometry arguments of ``ntt_forward_launch`` and
    ``ntt_inverse_launch``: the number of passes and their
    :func:`ntt_geometry` as a C array of ints."""
    flat = [v for g in ntt_geometry(rows, logn, npn, **geometry) for v in g]
    return len(flat) // 6, (ctypes.c_int * len(flat))(*flat)


def _log2(N: int) -> int:
    logn = N.bit_length() - 1
    if N < 2 or 1 << logn != N:
        raise ValueError(f"N={N} must be a power of two ≥ 2")
    return logn


def ntt_op(x, psi_rev, psi_rev_shoup, primes, *, modified: bool = False):
    """Forward negacyclic NTT: (rows, N) residues -> bit-reversed eval."""
    common.words32(x)
    if common.plain(x):
        return ntt_ref(x, psi_rev, psi_rev_shoup, primes, modified=modified)
    npn, N = psi_rev.shape
    rows, logn, dev = x.shape[0], _log2(N), x.device
    geometry = ntt_args(rows, logn, npn)
    out = torch.empty_like(x)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (rows, N)), ("psi_rev", psi_rev, (npn, N)),
        ("psi_rev_shoup", psi_rev_shoup, (npn, N)),
        ("primes", primes, (npn,)), ("out", out, (rows, N)))]
    common.launch("ntt_modified" if modified else "ntt", "ntt_forward_launch",
                  *ptrs, rows, npn, logn, int(modified), *geometry)
    return out


def intt_op(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup, primes, *,
            modified: bool = False):
    """Inverse negacyclic NTT: bit-reversed eval -> (rows, N) residues."""
    common.words32(x)
    if common.plain(x):
        return intt_ref(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup,
                        primes, modified=modified)
    npn, N = ipsi_rev.shape
    rows, logn, dev = x.shape[0], _log2(N), x.device
    geometry = ntt_args(rows, logn, npn)
    out = torch.empty_like(x)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (rows, N)), ("ipsi_rev", ipsi_rev, (npn, N)),
        ("ipsi_rev_shoup", ipsi_rev_shoup, (npn, N)),
        ("n_inv", n_inv, (npn,)), ("n_inv_shoup", n_inv_shoup, (npn,)),
        ("primes", primes, (npn,)), ("out", out, (rows, N)))]
    common.launch("intt_modified" if modified else "intt",
                  "ntt_inverse_launch", *ptrs, rows, npn, logn,
                  int(modified), *geometry)
    return out
