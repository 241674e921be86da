"""Plain torch version of the pointwise-modmul kernel."""

from __future__ import annotations

from repro_torch.core.wordops import mont_modmul, narrow, wide, word_bits

__all__ = ["pointwise_mont_ref"]


def pointwise_mont_ref(a, b, primes, pprime, r2):
    """(np, N) a⊙b mod p via two Montgomery REDCs; stored words of either
    β (the kernel takes β = 2^32 only)."""
    bits = word_bits(a)
    col = [wide(v)[:, None] for v in (primes, pprime, r2)]
    return narrow(mont_modmul(wide(a), wide(b), *col, bits), bits)
