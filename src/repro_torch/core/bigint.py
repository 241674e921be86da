"""Fixed-width BigInt arithmetic on little-endian limb tensors.

A BigInt is a (..., L) tensor of β-bit limbs, value = Σ a_k·β^k,
interpreted either as unsigned or as two's complement at width β·L (the
iCRT center-lift and the region-2 rounding shift need signed semantics).
Because HEAAN's q is a power of two, mod-q is :func:`mask_bits` and
rescaling is :func:`shift_right_round` — no BigInt division anywhere.

β comes from the limbs' storage type (:func:`~repro_torch.core.wordops.word_bits`):

  - β = 2^32: stored words are ``torch.int32`` bit patterns. ``add``,
    ``sub``, ``sign_bit``, ``compare_ge`` and ``mul_word`` also take int64
    values in [0, 2^32) (:func:`repro_torch.core.wordops.wide`) when called
    with ``bits=32``, as iCRT's accumulators are; each function returns
    the dtype of its first operand. Carries are the high halves of int64
    sums (arithmetic shift: a borrow is −1).
  - β = 2^64: limbs are ``torch.int64`` bit patterns. There is no headroom,
    so carries and borrows come from unsigned compares
    (:func:`~repro_torch.core.wordops.ult`), as in the reference.

Carry and borrow chains are Python loops over the limb axis (L ≤ ~120).
"""

from __future__ import annotations

import torch

from repro_torch.core.wordops import (
    M32, mul_wide, narrow, shr, ult, wide, word_bits,
)

__all__ = [
    "add", "sub", "neg", "mask_bits", "compare_ge",
    "shift_right_round", "shift_left_bits", "mul_word",
    "sign_bit", "select",
]


def _beta(a: torch.Tensor, bits: int | None) -> int:
    """β of limbs `a`: `bits` when given, else from the storage type."""
    return word_bits(a) if bits is None else bits


def _i64(v: int) -> int:
    """A u64 bit pattern as the int64 that holds it."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return narrow(x) if ref.dtype == torch.int32 else x & M32


def _chain(x: torch.Tensor, y: torch.Tensor, sign: int) -> torch.Tensor:
    """x + sign·y limb by limb with a signed carry; y broadcasts to x."""
    y = y.expand(x.shape)
    out = torch.empty_like(x)
    carry = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        s = x[..., k] + sign * y[..., k] + carry
        out[..., k] = s & M32
        carry = s >> 32                 # arithmetic: borrow is -1
    return out


def _chain64(x: torch.Tensor, y: torch.Tensor, sign: int) -> torch.Tensor:
    """x + sign·y on 64-bit limbs; the carry (borrow) out of limb k is
    an unsigned compare: a + b + c wraps past a, a − b − c below zero."""
    y = y.expand(x.shape)
    out = torch.empty_like(x)
    c = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    for k in range(x.shape[-1]):
        a, b = x[..., k], y[..., k]
        if sign > 0:
            s = a + b + c.long()
            c = ult(s, a) | (c & (s == a))
        else:
            s = a - b - c.long()
            c = ult(a, b) | (c & (a == b))
        out[..., k] = s
    return out


def add(a: torch.Tensor, b: torch.Tensor, *, bits: int | None = None
        ) -> torch.Tensor:
    """(a + b) mod β^L, limb-wise with carry; b broadcasts to a's shape."""
    if _beta(a, bits) == 64:
        return _chain64(a, b, 1)
    return _like(_chain(wide(a), wide(b), 1), a)


def sub(a: torch.Tensor, b: torch.Tensor, *, bits: int | None = None
        ) -> torch.Tensor:
    """(a - b) mod β^L (two's complement on underflow)."""
    if _beta(a, bits) == 64:
        return _chain64(a, b, -1)
    return _like(_chain(wide(a), wide(b), -1), a)


def neg(a: torch.Tensor) -> torch.Tensor:
    """Two's complement negation mod β^L."""
    return sub(torch.zeros_like(a), a)


def sign_bit(a: torch.Tensor, *, bits: int | None = None) -> torch.Tensor:
    """Top bit of the top limb (two's complement sign)."""
    if _beta(a, bits) == 64:
        return a[..., -1] < 0
    return ((wide(a[..., -1]) >> 31) & 1).bool()


def mask_bits(a: torch.Tensor, bits: int) -> torch.Tensor:
    """a mod 2^bits (zero limbs/bits above). Keeps the limb width."""
    L = a.shape[-1]
    w, r = divmod(bits, word_bits(a))
    if w >= L:
        return a
    out = a.clone()
    out[..., w] &= (1 << r) - 1
    out[..., w + 1:] = 0
    return out


def compare_ge(a: torch.Tensor, b: torch.Tensor, *, bits: int | None = None
               ) -> torch.Tensor:
    """Unsigned a >= b: a − b does not borrow out of the top limb."""
    if _beta(a, bits) == 64:
        b = b.expand(a.shape)
        borrow = torch.zeros(a.shape[:-1], dtype=torch.bool,
                             device=a.device)
        for k in range(a.shape[-1]):
            x, y = a[..., k], b[..., k]
            borrow = ult(x, y) | (borrow & (x == y))
        return ~borrow
    x, y = wide(a), wide(b).expand(a.shape)
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for k in range(a.shape[-1]):
        borrow = (x[..., k] - y[..., k] + borrow) >> 32
    return borrow == 0


def shift_left_bits(a: torch.Tensor, s: int) -> torch.Tensor:
    """(a << s) mod β^L; s is a static python int."""
    beta = word_bits(a)
    x = wide(a)
    w, r = divmod(s, beta)
    L = x.shape[-1]
    if w:
        x = torch.cat([torch.zeros_like(x[..., :w]), x[..., :L - w]], -1)
    if r:
        prev = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], -1)
        if beta == 64:
            return (x << r) | shr(prev, 64 - r)
        x = ((x << r) & M32) | (prev >> (32 - r))
    return _like(x, a) if beta == 32 else x


def _sign_fill(x: torch.Tensor, width: int, beta: int) -> torch.Tensor:
    """(..., width) limbs of all ones where x is negative, else zeros."""
    ones = -1 if beta == 64 else M32
    fill = torch.where(sign_bit(x, bits=beta), ones, 0)
    return fill[..., None].expand(*x.shape[:-1], width)


def shift_right_round(a: torch.Tensor, s: int, *, arithmetic: bool = True,
                      out_limbs: int | None = None) -> torch.Tensor:
    """round(a / 2^s) with round-half-up; a is two's complement at width β·L.

    Used for the region-2 key-switch shift (÷Q, paper Fig. 2) and for
    rescaling (÷p). s is static. Result width is out_limbs (default L).
    """
    beta = word_bits(a)
    x = wide(a)
    L = x.shape[-1]
    if s > 0:                            # +2^(s-1) for rounding
        half = torch.zeros(L, dtype=torch.int64, device=x.device)
        w_h, r_h = divmod(s - 1, beta)
        if w_h < L:
            # fill_ takes the word as a kernel argument; an indexed
            # assignment of a Python int copies it from the host, and a
            # blocking host-to-device copy synchronizes with the card
            half[w_h].fill_(_i64(1 << r_h))
        x = _chain64(x, half, 1) if beta == 64 else _chain(x, half, 1)
    w, r = divmod(s, beta)
    ext = (_sign_fill(x, max(w, 1) + 1, beta) if arithmetic
           else torch.zeros_like(x[..., :1]).expand(
               *x.shape[:-1], max(w, 1) + 1))
    x_ext = torch.cat([x, ext], -1)
    shifted = x_ext[..., w: w + L]
    if r:
        hi_next = x_ext[..., w + 1: w + 1 + L]
        if beta == 64:
            shifted = shr(shifted, r) | (hi_next << (64 - r))
        else:
            shifted = (shifted >> r) | ((hi_next << (32 - r)) & M32)
    if out_limbs is not None and out_limbs != L:
        if out_limbs < L:
            shifted = shifted[..., :out_limbs]
        else:
            shifted = torch.cat(
                [shifted, _sign_fill(shifted, out_limbs - L, beta)], -1)
    return _like(shifted, a) if beta == 32 else shifted


def mul_word(a: torch.Tensor, s: torch.Tensor, *, bits: int | None = None
             ) -> torch.Tensor:
    """(a · s) mod β^L for a word-sized scalar s (broadcast over batch)."""
    beta = _beta(a, bits)
    x = wide(a)
    sw = wide(s)[..., None].expand(x.shape)
    out = torch.empty_like(x)
    carry = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for k in range(x.shape[-1]):
        hi, lo = mul_wide(x[..., k], sw[..., k], beta)
        t = lo + carry
        if beta == 64:
            out[..., k] = t
            carry = hi + ult(t, lo).long()   # hi ≤ β-2: cannot wrap
        else:
            out[..., k] = t & M32
            carry = hi + (t >> 32)           # hi ≤ β-2, so this cannot wrap
    return out if beta == 64 else _like(out, a)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """Elementwise limb select: cond is (...,) bool, a/b are (..., L)."""
    return torch.where(cond[..., None], a, b)
