"""Fixed-width BigInt arithmetic on little-endian limb tensors (β = 2^32).

A BigInt is a (..., L) tensor of 32-bit limbs, value = Σ a_k·β^k,
interpreted either as unsigned or as two's complement at width 32·L (the
iCRT center-lift and the region-2 rounding shift need signed semantics).
Because HEAAN's q is a power of two, mod-q is :func:`mask_bits` and
rescaling is :func:`shift_right_round` — no BigInt division anywhere.

Limbs may come as stored words (``torch.int32`` bit patterns) or as int64
values (:func:`repro_torch.core.wordops.wide`); each function returns the
dtype of its first operand. Carry and borrow chains are Python loops over
the limb axis (L ≤ ~120), on int64 with arithmetic-shift carries.
"""

from __future__ import annotations

import torch

from repro_torch.core.wordops import M32, mul_wide, narrow, wide

__all__ = [
    "add", "sub", "neg", "mask_bits", "compare_ge",
    "shift_right_round", "shift_left_bits", "mul_word",
    "sign_bit", "select",
]


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


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod β^L, limb-wise with carry; b broadcasts to a's shape."""
    return _like(_chain(wide(a), wide(b), 1), a)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod β^L (two's complement on underflow)."""
    return _like(_chain(wide(a), wide(b), -1), a)


def neg(a: torch.Tensor) -> torch.Tensor:
    """Two's complement negation mod β^L."""
    return sub(torch.zeros_like(a), a)


def sign_bit(a: torch.Tensor) -> torch.Tensor:
    """Top bit of the top limb (two's complement sign)."""
    return ((wide(a[..., -1]) >> 31) & 1).bool()


def mask_bits(a: torch.Tensor, bits: int) -> torch.Tensor:
    """a mod 2^bits (zero limbs/bits above). Keeps the limb width."""
    L = a.shape[-1]
    w, r = divmod(bits, 32)
    if w >= L:
        return a
    out = a.clone()
    out[..., w] &= (1 << r) - 1
    out[..., w + 1:] = 0
    return out


def compare_ge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a >= b: a − b does not borrow out of the top limb."""
    x, y = wide(a), wide(b).expand(a.shape)
    borrow = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
    for k in range(a.shape[-1]):
        borrow = (x[..., k] - y[..., k] + borrow) >> 32
    return borrow == 0


def shift_left_bits(a: torch.Tensor, s: int) -> torch.Tensor:
    """(a << s) mod β^L; s is a static python int."""
    x = wide(a)
    w, r = divmod(s, 32)
    L = x.shape[-1]
    if w:
        x = torch.cat([torch.zeros_like(x[..., :w]), x[..., :L - w]], -1)
    if r:
        prev = torch.cat([torch.zeros_like(x[..., :1]), x[..., :-1]], -1)
        x = ((x << r) & M32) | (prev >> (32 - r))
    return _like(x, a)


def _sign_fill(x: torch.Tensor, width: int) -> torch.Tensor:
    """(..., width) limbs of all ones where x is negative, else zeros."""
    fill = torch.where(sign_bit(x), M32, 0)
    return fill[..., None].expand(*x.shape[:-1], width)


def shift_right_round(a: torch.Tensor, s: int, *, arithmetic: bool = True,
                      out_limbs: int | None = None) -> torch.Tensor:
    """round(a / 2^s) with round-half-up; a is two's complement at width β·L.

    Used for the region-2 key-switch shift (÷Q, paper Fig. 2) and for
    rescaling (÷p). s is static. Result width is out_limbs (default L).
    """
    x = wide(a)
    L = x.shape[-1]
    if s > 0:                            # +2^(s-1) for rounding
        half = torch.zeros(L, dtype=torch.int64, device=x.device)
        w_h, r_h = divmod(s - 1, 32)
        if w_h < L:
            # fill_ takes the word as a kernel argument; an indexed
            # assignment of a Python int copies it from the host, and a
            # blocking host-to-device copy synchronizes with the card
            half[w_h].fill_(1 << r_h)
        x = _chain(x, half, 1)
    w, r = divmod(s, 32)
    ext = (_sign_fill(x, max(w, 1) + 1) if arithmetic
           else torch.zeros_like(x[..., :1]).expand(
               *x.shape[:-1], max(w, 1) + 1))
    x_ext = torch.cat([x, ext], -1)
    shifted = x_ext[..., w: w + L]
    if r:
        hi_next = x_ext[..., w + 1: w + 1 + L]
        shifted = (shifted >> r) | ((hi_next << (32 - r)) & M32)
    if out_limbs is not None and out_limbs != L:
        if out_limbs < L:
            shifted = shifted[..., :out_limbs]
        else:
            shifted = torch.cat(
                [shifted, _sign_fill(shifted, out_limbs - L)], -1)
    return _like(shifted, a)


def mul_word(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(a · s) mod β^L for a word-sized scalar s (broadcast over batch)."""
    x = wide(a)
    sw = wide(s)[..., None].expand(x.shape)
    out = torch.empty_like(x)
    carry = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for k in range(x.shape[-1]):
        hi, lo = mul_wide(x[..., k], sw[..., k])
        t = lo + carry
        out[..., k] = t & M32
        carry = hi + (t >> 32)           # hi ≤ β-2, so this cannot wrap
    return _like(out, a)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """Elementwise limb select: cond is (...,) bool, a/b are (..., L)."""
    return torch.where(cond[..., None], a, b)
