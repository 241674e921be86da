"""Wrappers of the NTT/iNTT CUDA kernels (csrc/ntt.cu).

x may hold a batch of rows: (rows, N) with rows a multiple of the
twiddle tables' np, row r taking twiddle row r mod np (B ciphertexts of np
primes each, stacked). ``modified=True`` runs the paper's modified Shoup
and counts as ``ntt_modified``/``intt_modified``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref

__all__ = ["ntt_op", "intt_op"]


def _log2(N: int) -> int:
    logn = N.bit_length() - 1
    if N < 2 or 1 << logn != N:
        raise ValueError(f"N={N} must be a power of two ≥ 2")
    return logn


def _rows(x: torch.Tensor, npn: int) -> int:
    rows = x.shape[0]
    if rows % npn:
        raise ValueError(f"{rows} rows are not a multiple of the {npn} "
                         f"twiddle rows")
    return rows


def ntt_op(x, psi_rev, psi_rev_shoup, primes, *, modified: bool = False):
    """Forward negacyclic NTT: (rows, N) residues -> bit-reversed eval."""
    if common.plain(x):
        return ntt_ref(x, psi_rev, psi_rev_shoup, primes, modified=modified)
    npn, N = psi_rev.shape
    rows, logn, dev = _rows(x, npn), _log2(N), x.device
    out = torch.empty_like(x)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (rows, N)), ("psi_rev", psi_rev, (npn, N)),
        ("psi_rev_shoup", psi_rev_shoup, (npn, N)),
        ("primes", primes, (npn,)), ("out", out, (rows, N)))]
    common.launch("ntt_modified" if modified else "ntt", "ntt_forward_launch",
                  *ptrs, rows, npn, logn, int(modified))
    return out


def intt_op(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup, primes, *,
            modified: bool = False):
    """Inverse negacyclic NTT: bit-reversed eval -> (rows, N) residues."""
    if common.plain(x):
        return intt_ref(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup,
                        primes, modified=modified)
    npn, N = ipsi_rev.shape
    rows, logn, dev = _rows(x, npn), _log2(N), x.device
    out = torch.empty_like(x)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (rows, N)), ("ipsi_rev", ipsi_rev, (npn, N)),
        ("ipsi_rev_shoup", ipsi_rev_shoup, (npn, N)),
        ("n_inv", n_inv, (npn,)), ("n_inv_shoup", n_inv_shoup, (npn,)),
        ("primes", primes, (npn,)), ("out", out, (rows, N)))]
    common.launch("intt_modified" if modified else "intt",
                  "ntt_inverse_launch", *ptrs, rows, npn, logn,
                  int(modified))
    return out
