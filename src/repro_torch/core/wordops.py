"""Word-level modular arithmetic at β = 2^32 and β = 2^64 on int64 tensors.

Storage and arithmetic are kept apart:

  - Between stages, and at every kernel boundary, a word is stored in the
    signed type of its width: at β = 2^32 a ``torch.int32`` holding the
    u32 bit pattern (the CUDA kernels read it as ``uint32_t*``), at
    β = 2^64 a ``torch.int64`` holding the u64 bit pattern.
    :func:`word_bits` reads β from the storage type; :func:`wide` and
    :func:`narrow` convert.
  - The plain torch versions here compute on ``torch.int64``: at β = 2^32
    holding the word's value in [0, 2^32), because torch has no add,
    shift or compare on ``uint32``; at β = 2^64 holding the bit pattern
    itself, because torch has no wider type.

Where the unsigned reference relies on wrap-around (x·y − q·p, t_lo·p′,
the ADC carry tests), the β = 2^32 result is masked to 32 bits, and the
β = 2^64 result is the int64 product, which wraps mod 2^64 on the CPU and
on the card alike. A product of two full 32-bit words overflows int63 but
wraps mod 2^64, so ``((a*b) >> 32) & M32`` is still the exact high word;
a product of two 64-bit words is built from 32-bit halves, as the
reference's :func:`mul_wide` builds it. ``>>`` on int64 is arithmetic, so
a logical shift masks (:func:`shr`), and an unsigned compare of values
that can reach 2^63 flips the sign bit first (:func:`ult`). The operands
of the ``bits`` keyword functions are int64 either way; ``bits`` says
which word they hold. Every function is elementwise and exact; the tests
hold them against the JAX package's word ops on ``uint32`` and ``uint64``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "M32", "word_bits", "wide", "narrow", "shr", "ult", "mul_wide",
    "mulhi_approx3", "modadd", "modsub", "cond_reduce", "shoup_modmul",
    "shoup_modmul_modified", "mont_redc", "mont_modmul",
    "acc3_add_product", "shoup_companion",
]

M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)                      # the int64 sign bit


def word_bits(a: torch.Tensor) -> int:
    """β of stored words: 32 for ``torch.int32``, 64 for ``torch.int64``."""
    if a.dtype == torch.int32:
        return 32
    if a.dtype == torch.int64:
        return 64
    raise TypeError(f"words are int32 (β = 2^32) or int64 (β = 2^64); "
                    f"got {a.dtype}")


def wide(a: torch.Tensor) -> torch.Tensor:
    """Stored words (int32 bit patterns) -> int64 values in [0, 2^32).

    int64 input is taken as already widened and returned unchanged.
    """
    return a.long() & M32 if a.dtype == torch.int32 else a


def narrow(x: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """int64 words -> stored words: int32 bit patterns of the low 32 bits
    at β = 2^32, unchanged at β = 2^64."""
    if bits == 64:
        return x
    x = x & M32
    return (x - ((x >> 31) << 32)).to(torch.int32)


def shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < k < 64."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def ult(a, b) -> torch.Tensor:
    """Unsigned a < b of int64 bit patterns (u64 words)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def mul_wide(a: torch.Tensor, b: torch.Tensor, bits: int = 32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full β×β→2β product of words as (hi, lo).

    At β = 2^64 from four 32×32 products, as the reference synthesizes
    it: (2^32−1)^2 + (2^32−1) < 2^64, so no partial sum wraps.
    """
    if bits == 64:
        al, ah = a & M32, shr(a, 32)
        bl, bh = b & M32, shr(b, 32)
        ll = al * bl
        mid = al * bh + shr(ll, 32)
        mid2 = ah * bl + (mid & M32)
        return (ah * bh + shr(mid, 32) + shr(mid2, 32),
                (mid2 << 32) | (ll & M32))
    prod = a * b                        # wraps mod 2^64: low bits exact
    return (prod >> 32) & M32, prod & M32


def mulhi_approx3(a: torch.Tensor, b: torch.Tensor, bits: int = 32
                  ) -> torch.Tensor:
    """Approximate high word of a·b from THREE half-word products (the
    paper's modified Shoup, §V-B).

    The lo·lo product, which only feeds a carry, is dropped, so the result
    underestimates the true high word by at most 2. At β = 2^32 each
    partial product and sum stays below 2^32, as in the u32 reference,
    and the result is masked to 32 bits; at β = 2^64 the halves are 32
    bits and every sum stays below 2^64.
    """
    if bits == 64:
        al, ah = a & M32, shr(a, 32)
        bl, bh = b & M32, shr(b, 32)
        lh = al * bh
        mid2 = ah * bl + (lh & M32)
        return ah * bh + shr(lh, 32) + shr(mid2, 32)
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


def shoup_modmul(x, y, y_shoup, p, bits: int = 32):
    """mod(x·y, p) with y_shoup = floor(y·β/p), p < β/4 (paper Algo 2).

    The true remainder is below 2p < 2^63, so at β = 2^64 the wrapped
    int64 difference is that remainder and a signed compare reduces it.
    """
    qu = mul_wide(x, y_shoup, bits)[0]
    r = x * y - qu * p                  # wraps mod 2^64; true value < 2p
    if bits == 32:
        r = r & M32
    return torch.where(r >= p, r - p, r)


def shoup_modmul_modified(x, y, y_shoup, p, bits: int = 32):
    """Paper's modified Shoup: the quotient from :func:`mulhi_approx3`
    leaves r in [0, 4p), brought into [0, p) by two conditional
    subtractions (needs p < β/4)."""
    qu = mulhi_approx3(x, y_shoup, bits)
    r = x * y - qu * p                  # wraps mod 2^64; true value < 4p
    if bits == 32:
        r = r & M32
    r = torch.where(r >= 2 * p, r - 2 * p, r)
    return torch.where(r >= p, r - p, r)


def mont_redc(t_hi, t_lo, p, pprime, bits: int = 32):
    """REDC: (t_hi·β + t_lo)·β⁻¹ mod p, for t < p·β. pprime = -p⁻¹ mod β."""
    m = t_lo * pprime
    if bits == 32:
        m = m & M32
    mp_hi = mul_wide(m, p, bits)[0]      # m·p ≡ -t_lo (mod β)
    t = t_hi + mp_hi + (t_lo != 0).long()   # < 2p
    return torch.where(t >= p, t - p, t)


def mont_modmul(a, b, p, pprime, r2, bits: int = 32):
    """mod(a·b, p) via two REDCs (r2 = β² mod p). Domain-free."""
    hi, lo = mul_wide(a, b, bits)
    t = mont_redc(hi, lo, p, pprime, bits)        # a·b·β⁻¹ mod p
    hi2, lo2 = mul_wide(t, r2, bits)
    return mont_redc(hi2, lo2, p, pprime, bits)   # a·b mod p


def acc3_add_product(acc2, acc1, acc0, a, b, bits: int = 32):
    """3-word accumulator += a·b (paper's GPU-C: ADC chains, no modulo).

    At β = 2^32 the carries are the high halves of int64 sums; at
    β = 2^64 they are unsigned compares, as in the reference."""
    hi, lo = mul_wide(a, b, bits)
    if bits == 64:
        new0 = acc0 + lo
        new1 = acc1 + hi
        c1 = ult(new1, hi).long()
        c0 = ult(new0, lo).long()
        new1b = new1 + c0
        c1b = ult(new1b, c0).long()
        return acc2 + c1 + c1b, new1b, new0
    s0 = acc0 + lo
    s1 = acc1 + hi + (s0 >> 32)
    return (acc2 + (s1 >> 32)) & M32, s1 & M32, s0 & M32


def shoup_companion(vals: torch.Tensor, primes: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """floor(vals·β / p) for words vals < p, exact; int64 in and out.

    vals is (np, ...) with primes (np,) broadcast over the trailing axes.
    At β = 2^32 one int64 division. At β = 2^64 the 128-by-64 division is
    long division in 3-bit digits: the remainder stays below p < 2^60,
    so shifting it by 3 stays below 2^63, and the quotient's 64 bits
    collect in an int64 bit pattern.
    """
    p = primes.reshape(-1, *([1] * (vals.dim() - 1)))
    if bits == 32:
        return torch.div(vals << 32, p, rounding_mode="floor")
    if int(primes.max()) >= 1 << 60:
        raise ValueError("β = 2^64 Shoup companions need primes below 2^60")
    q = torch.zeros_like(vals)
    r = vals.clone()
    for step in [3] * 21 + [1]:         # 64 quotient bits
        r = r << step
        digit = torch.div(r, p, rounding_mode="floor")
        r = r - digit * p
        q = (q << step) | digit
    return q
