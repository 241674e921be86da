"""CRT (paper Algo 1) and iCRT (Algo 5 → reordered Algo 6), plain torch.

These are the plain versions of the CRT and iCRT kernels
(:mod:`repro_torch.kernels.crt`, :mod:`repro_torch.kernels.icrt`), in the
formulation the kernels use: products are summed into a three-word
accumulator with one reduction at the end (paper Table VIII "GPU-C"), and
the iCRT limbs are column sums with a running carry. int32 words in and
out, int64 inside; every result is exact.
"""

from __future__ import annotations

import torch

from repro_torch.core import bigint
from repro_torch.core.wordops import (
    M32, cond_reduce, narrow, shoup_modmul, wide,
)

__all__ = ["crt", "icrt", "finalize_accum"]


# --------------------------------------------------------------------------
# CRT: (N, K) BigInt limbs -> (np, N) residues
# --------------------------------------------------------------------------

def crt(x: torch.Tensor, tb: torch.Tensor, tb_shoup: torch.Tensor,
        primes: torch.Tensor) -> torch.Tensor:
    """mod(Σ_k x[n,k]·β^k, p_j) for every coefficient n and prime j.

    x: (N, K) limbs; tb/tb_shoup: (np, Kt) = β^k mod p_j with
    Kt ≥ max(K, 3) (the fold reads k < 3); primes: (np,). Returns (np, N).
    """
    N, K = x.shape
    if tb.shape[1] < max(K, 3):
        raise ValueError(f"CRT table has {tb.shape[1]} columns; "
                         f"needs {max(K, 3)}")
    xw, t = wide(x), wide(tb)
    lo = torch.zeros((t.shape[0], N), dtype=torch.int64, device=x.device)
    hi = torch.zeros_like(lo)
    for k in range(K):
        prod = xw[None, :, k] * t[:, k, None]          # < 2^62
        lo += prod & M32
        hi += prod >> 32
    # the sum as three words a0 + a1·β + a2·β²
    mid = hi + (lo >> 32)
    return narrow(_fold3(lo & M32, mid & M32, mid >> 32, t, wide(tb_shoup),
                         wide(primes)))


def _fold3(a0, a1, a2, tb, tb_shoup, primes):
    """Reduce a 3-word accumulator via Shoup multiplies by β^k mod p."""
    p = primes[:, None]
    r0 = shoup_modmul(a0, tb[:, 0, None], tb_shoup[:, 0, None], p)
    r1 = shoup_modmul(a1, tb[:, 1, None], tb_shoup[:, 1, None], p)
    r2 = shoup_modmul(a2, tb[:, 2, None], tb_shoup[:, 2, None], p)
    return cond_reduce(r0 + r1 + r2, p, 4)


# --------------------------------------------------------------------------
# iCRT: (np, N) residues -> (N, out_limbs) two's-complement centered BigInt
# --------------------------------------------------------------------------

def icrt(r: torch.Tensor, primes: torch.Tensor, inv_P: torch.Tensor,
         inv_P_shoup: torch.Tensor, pdivp: torch.Tensor,
         P_limbs: torch.Tensor, P_half: torch.Tensor,
         p_inv_f64: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """Reconstruct centered BigInts from RNS residues (paper Algo 6).

    r: (np, N). Returns (N, out_limbs) two's-complement (low limbs of the
    centered value — callers mask to mod-q or shift for key-switching).
    The accumulator is as wide as P_limbs.
    """
    p = wide(primes)[:, None]
    # (1) Hadamard: temp[j,n] = mod(r[j,n]·(P/p_j)⁻¹, p_j)   [Shoup]
    temp = shoup_modmul(wide(r), wide(inv_P)[:, None],
                        wide(inv_P_shoup)[:, None], p)
    # (2) accum[n] = Σ_j temp[j,n]·(P/p_j)
    accum = _accum_columns(temp, wide(pdivp), P_limbs.shape[0])
    # (3) mod P via the float quotient: accum/P = Σ_j temp_j/p_j exactly;
    # the f64 error is ≪ 1, so ±1 corrections make it exact.
    s = torch.floor((temp.double() * p_inv_f64[:, None]).sum(0)).long()
    return finalize_accum(accum, s, P_limbs, P_half, out_limbs)


def _accum_columns(temp: torch.Tensor, pdivp: torch.Tensor,
                   accum_limbs: int) -> torch.Tensor:
    """Σ_j temp[j, n]·pdivp[j] as (N, accum_limbs) limbs (int64 words).

    Column k holds Σ_j temp_j·pdivp[j, k] = lo_k + hi_k·β; limb k of the
    sum is lo_k + hi_(k-1) plus the running carry.
    """
    npn, N = temp.shape
    PL = pdivp.shape[1]
    lo = torch.zeros((N, PL), dtype=torch.int64, device=temp.device)
    hi = torch.zeros_like(lo)
    for j in range(npn):
        prod = temp[j][:, None] * pdivp[j][None, :]    # < 2^62
        lo += prod & M32
        hi += prod >> 32
    out = torch.empty((N, accum_limbs), dtype=torch.int64,
                      device=temp.device)
    carry = torch.zeros(N, dtype=torch.int64, device=temp.device)
    for k in range(accum_limbs):
        v = carry
        if k < PL:
            v = v + lo[:, k]
        if 1 <= k <= PL:
            v = v + hi[:, k - 1]
        out[:, k] = v & M32
        carry = v >> 32
    return out


def finalize_accum(accum, s, P_limbs, P_half, out_limbs: int):
    """accum − s·P with ±1 quotient corrections, center-lift, truncate.

    `s` may be off by one in either direction; the correction ladder makes
    the result exact. Returns int32 words.
    """
    N, accum_limbs = accum.shape
    P = wide(P_limbs)
    red = bigint.sub(accum, bigint.mul_word(P.expand(N, accum_limbs), s))
    for _ in range(2):   # s may be off by one in either direction
        neg = bigint.sign_bit(red)
        red = bigint.select(neg, bigint.add(red, P), red)
        too_big = bigint.compare_ge(red, P) & ~neg
        red = bigint.select(too_big, bigint.sub(red, P), red)

    # center-lift: v >= P/2  ⇒  v -= P  (two's complement wrap is fine)
    high = bigint.compare_ge(red, P_half)
    red = bigint.select(high, bigint.sub(red, P), red)
    if out_limbs <= accum_limbs:
        return narrow(red[:, :out_limbs])
    fill = torch.where(bigint.sign_bit(red), M32, 0)
    return narrow(torch.cat(
        [red, fill[:, None].expand(N, out_limbs - accum_limbs)], -1))
