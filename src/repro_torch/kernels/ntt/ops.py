"""Wrappers of the NTT/iNTT CUDA kernels (csrc/ntt.cu)."""

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


def ntt_op(x, psi_rev, psi_rev_shoup, primes):
    """Forward negacyclic NTT: (np, N) residues -> bit-reversed eval."""
    if common.plain(x):
        return ntt_ref(x, psi_rev, psi_rev_shoup, primes)
    npn, N = x.shape
    logn, dev = _log2(N), x.device
    out = torch.empty_like(x)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (npn, N)), ("psi_rev", psi_rev, (npn, N)),
        ("psi_rev_shoup", psi_rev_shoup, (npn, N)),
        ("primes", primes, (npn,)), ("out", out, (npn, N)))]
    common.launch("ntt", "ntt_forward_launch", *ptrs, npn, logn)
    return out


def intt_op(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup, primes):
    """Inverse negacyclic NTT: bit-reversed eval -> (np, N) residues."""
    if common.plain(x):
        return intt_ref(x, ipsi_rev, ipsi_rev_shoup, n_inv, n_inv_shoup,
                        primes)
    npn, N = x.shape
    logn, dev = _log2(N), x.device
    out = torch.empty_like(x)
    ptrs = [common.check(name, t, shape, dev) for name, t, shape in (
        ("x", x, (npn, N)), ("ipsi_rev", ipsi_rev, (npn, N)),
        ("ipsi_rev_shoup", ipsi_rev_shoup, (npn, N)),
        ("n_inv", n_inv, (npn,)), ("n_inv_shoup", n_inv_shoup, (npn,)),
        ("primes", primes, (npn,)), ("out", out, (npn, N)))]
    common.launch("intt", "ntt_inverse_launch", *ptrs, npn, logn)
    return out
