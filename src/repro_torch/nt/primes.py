"""NTT-friendly prime generation and roots of unity.

All functions here run host-side with Python ints (exact arithmetic); they
feed the precomputed tables in :mod:`repro_torch.core.context`. The paper requires
primes p ≡ 1 (mod 2N) so that a primitive 2N-th root of unity ψ exists,
enabling the negacyclic NTT over Z_p[X]/(X^N + 1).
"""

from __future__ import annotations

import random
from functools import lru_cache
from typing import List

# Deterministic Miller-Rabin witness sets (Jaeschke / Sorenson-Webster):
# valid for all n < 3.3e24, which covers every word size we use (< 2^64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)

_SMALL_PRIMES = (
    2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67,
    71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131, 137, 139,
)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n == p:
            return True
        if n % p == 0:
            return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        if a >= n:
            continue
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=None)
def find_ntt_primes(
    n_poly: int,
    count: int,
    lo_bits: int,
    hi_bits: int,
    descending: bool = True,
) -> tuple:
    """Find `count` primes p with 2^lo_bits < p < 2^hi_bits and p ≡ 1 (mod 2N).

    Scans candidates k·2N + 1 from the top of the range downward (as HEAAN
    does — the largest primes give the most headroom for delayed-modulo
    accumulation). Deterministic for reproducibility.
    """
    two_n = 2 * n_poly
    hi = (1 << hi_bits) - 1
    lo = 1 << lo_bits
    # Largest k with k*2N + 1 <= hi.
    k = (hi - 1) // two_n
    primes: List[int] = []
    while len(primes) < count and k > 0:
        cand = k * two_n + 1
        if cand < lo:
            break
        if is_prime(cand):
            primes.append(cand)
        k -= 1
    if len(primes) < count:
        raise ValueError(
            f"only found {len(primes)}/{count} primes ≡1 mod {two_n} "
            f"in (2^{lo_bits}, 2^{hi_bits})"
        )
    if not descending:
        primes.reverse()
    return tuple(primes)


def primitive_2nth_root(p: int, n_poly: int, seed: int = 0) -> int:
    """Find ψ of multiplicative order exactly 2N modulo prime p.

    Requires p ≡ 1 (mod 2N). ψ = x^((p-1)/2N) has order dividing 2N; the
    order is exactly 2N iff ψ^N ≡ -1 (mod p).
    """
    two_n = 2 * n_poly
    assert (p - 1) % two_n == 0, "p must be ≡ 1 (mod 2N)"
    exp = (p - 1) // two_n
    rng = random.Random(seed ^ p)
    while True:
        x = rng.randrange(2, p - 1)
        psi = pow(x, exp, p)
        if psi in (0, 1):
            continue
        if pow(psi, n_poly, p) == p - 1:
            return psi


def bit_reverse_indices(n: int) -> List[int]:
    """Bit-reversal permutation of range(n); n must be a power of two."""
    bits = n.bit_length() - 1
    assert 1 << bits == n, "n must be a power of two"
    out = [0] * n
    for i in range(n):
        r = 0
        x = i
        for _ in range(bits):
            r = (r << 1) | (x & 1)
            x >>= 1
        out[i] = r
    return out


def shoup_precompute(y: int, p: int, beta_bits: int) -> int:
    """Shoup constant floor(y·β / p) for Shoup modular multiplication."""
    return (y << beta_bits) // p
