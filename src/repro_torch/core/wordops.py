"""Word-level modular arithmetic at β = 2^32 on int64 tensors.

Storage and arithmetic are kept apart:

  - Between stages, and at every kernel boundary, a word is a
    ``torch.int32`` holding the u32 bit pattern (the CUDA kernels read it
    as ``uint32_t*``). :func:`wide` and :func:`narrow` convert.
  - The plain torch versions here compute on ``torch.int64`` holding the
    word's value in [0, 2^32), because torch has no add, shift or compare
    on ``uint32``.

Where the u32 reference relies on wrap-around (x·y − q·p, t_lo·p′, the ADC
carry tests), the result is masked to 32 bits. A product of two full words
overflows int63, but it wraps mod 2^64, so ``((a*b) >> 32) & M32`` is still
the exact high word. Every function is elementwise and exact; the tests
hold them against the JAX package's word ops.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "M32", "wide", "narrow", "mul_wide", "mulhi_approx3", "modadd",
    "modsub", "cond_reduce", "shoup_modmul", "shoup_modmul_modified",
    "mont_redc", "mont_modmul", "acc3_add_product",
]

M32 = 0xFFFFFFFF


def wide(a: torch.Tensor) -> torch.Tensor:
    """Stored words (int32 bit patterns) -> int64 values in [0, 2^32).

    int64 input is taken as already widened and returned unchanged.
    """
    return a.long() & M32 if a.dtype == torch.int32 else a


def narrow(x: torch.Tensor) -> torch.Tensor:
    """int64 words (low 32 bits count) -> int32 bit patterns."""
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul_wide(a: torch.Tensor, b: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full 32×32→64 product of words as (hi, lo)."""
    prod = a * b                        # wraps mod 2^64: low bits exact
    return (prod >> 32) & M32, prod & M32


def mulhi_approx3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Approximate high word of a·b from THREE 16×16 products (the paper's
    modified Shoup, §V-B).

    The lo·lo product, which only feeds a carry, is dropped, so the result
    underestimates the true high word by at most 2. Each partial product
    and sum stays below 2^32, as in the u32 reference; the result is
    masked to 32 bits.
    """
    al, ah = a & 0xFFFF, a >> 16
    bl, bh = b & 0xFFFF, b >> 16
    lh = al * bh
    mid2 = ah * bl + (lh & 0xFFFF)
    return (ah * bh + (lh >> 16) + (mid2 >> 16)) & M32


def modadd(a, b, p):
    """(a + b) mod p for a, b in [0, p)."""
    s = a + b
    return torch.where(s >= p, s - p, s)


def modsub(a, b, p):
    """(a - b) mod p for a, b in [0, p)."""
    d = a + p - b
    return torch.where(d >= p, d - p, d)


def cond_reduce(x, p, kmax: int):
    """Reduce x < kmax·p to [0, p) by conditional power-of-two subtractions.
    """
    k = 1
    while k < kmax:
        k *= 2
    k //= 2
    while k >= 1:
        kp = p * k
        x = torch.where(x >= kp, x - kp, x)
        k //= 2
    return x


def shoup_modmul(x, y, y_shoup, p):
    """mod(x·y, p) with y_shoup = floor(y·β/p), p < β/4 (paper Algo 2)."""
    qu = mul_wide(x, y_shoup)[0]
    r = (x * y - qu * p) & M32          # true value < 2p
    return torch.where(r >= p, r - p, r)


def shoup_modmul_modified(x, y, y_shoup, p):
    """Paper's modified Shoup: the quotient from :func:`mulhi_approx3`
    leaves r in [0, 4p), brought into [0, p) by two conditional
    subtractions (needs p < β/4)."""
    qu = mulhi_approx3(x, y_shoup)
    r = (x * y - qu * p) & M32          # true value < 4p
    r = torch.where(r >= 2 * p, r - 2 * p, r)
    return torch.where(r >= p, r - p, r)


def mont_redc(t_hi, t_lo, p, pprime):
    """REDC: (t_hi·β + t_lo)·β⁻¹ mod p, for t < p·β. pprime = -p⁻¹ mod β."""
    m = (t_lo * pprime) & M32
    mp_hi = mul_wide(m, p)[0]            # m·p ≡ -t_lo (mod β)
    t = t_hi + mp_hi + (t_lo != 0).long()   # < 2p
    return torch.where(t >= p, t - p, t)


def mont_modmul(a, b, p, pprime, r2):
    """mod(a·b, p) via two REDCs (r2 = β² mod p). Domain-free."""
    hi, lo = mul_wide(a, b)
    t = mont_redc(hi, lo, p, pprime)        # a·b·β⁻¹ mod p
    hi2, lo2 = mul_wide(t, r2)
    return mont_redc(hi2, lo2, p, pprime)   # a·b mod p


def acc3_add_product(acc2, acc1, acc0, a, b):
    """3-word accumulator += a·b (paper's GPU-C: ADC chains, no modulo)."""
    hi, lo = mul_wide(a, b)
    s0 = acc0 + lo
    s1 = acc1 + hi + (s0 >> 32)
    return (acc2 + (s1 >> 32)) & M32, s1 & M32, s0 & M32
