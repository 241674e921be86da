"""CKKS canonical-embedding encode/decode (HEAAN's "special FFT").

This is the client-side boundary (paper §III-A): a message of n ≤ N/2
complex numbers becomes a degree-(N-1) integer polynomial via the inverse
canonical embedding, scaled by Δ and rounded. The paper does not accelerate
this step (it is not part of HE Mul), so it lives host-side in numpy,
implemented as HEAAN's rot-group butterfly network in O(n log n).

Conventions follow the reference HEAAN (Ring::EMB / EMBInv, Scheme::encode):
  - rotGroup[j] = 5^j mod 2N indexes the evaluation points,
  - real parts land at coefficients i·gap, imaginary parts at N/2 + i·gap,
    gap = (N/2)/n.
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.core.params import HEParams

__all__ = ["encode", "decode", "emb", "emb_inv", "message_hash"]


def message_hash(z: np.ndarray, log_delta: int) -> str:
    """Content hash of a slot message at an encoding scale.

    Two messages share a hash exactly when :func:`encode` would produce
    the same plaintext polynomial for them (same slot values, same scale
    2^log_delta), so ``(message_hash(z, Δ), logq)`` is a sound key for
    caching an encoded mul_plain/add_plain operand. It is the JAX
    package's hash, string for string, so caches of both key alike.
    Modulus and parameter set are not part of the hash.
    """
    z = np.ascontiguousarray(np.asarray(z, dtype=np.complex128))
    h = hashlib.sha256()
    h.update(f"{z.shape}|{int(log_delta)}|".encode())
    h.update(z.tobytes())
    return h.hexdigest()[:20]


def _bit_reverse_inplace(vals: np.ndarray) -> np.ndarray:
    n = len(vals)
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j >= bit:
            j -= bit
            bit >>= 1
        j += bit
        if i < j:
            vals[i], vals[j] = vals[j], vals[i]
    return vals


def _ksi_pows(M: int) -> np.ndarray:
    return np.exp(2j * np.pi * np.arange(M + 1) / M)


def _rot_group(Nh: int, M: int) -> np.ndarray:
    out = np.empty(Nh, dtype=np.int64)
    five = 1
    for i in range(Nh):
        out[i] = five
        five = (five * 5) % M
    return out


def emb(vals: np.ndarray, M: int) -> np.ndarray:
    """HEAAN Ring::EMB — slot evaluation (decode direction), in place."""
    vals = np.array(vals, dtype=np.complex128)
    n = len(vals)
    rot = _rot_group(max(n, 1), M)
    ksi = _ksi_pows(M)
    _bit_reverse_inplace(vals)
    length = 2
    while length <= n:
        lenh = length >> 1
        lenq = length << 2
        gap = M // lenq
        for i in range(0, n, length):
            idx_all = (rot[:lenh] % lenq) * gap
            u = vals[i: i + lenh].copy()
            v = vals[i + lenh: i + length] * ksi[idx_all]
            vals[i: i + lenh] = u + v
            vals[i + lenh: i + length] = u - v
        length <<= 1
    return vals


def emb_inv(vals: np.ndarray, M: int) -> np.ndarray:
    """HEAAN Ring::EMBInv — inverse embedding (encode direction)."""
    vals = np.array(vals, dtype=np.complex128)
    n = len(vals)
    rot = _rot_group(max(n, 1), M)
    ksi = _ksi_pows(M)
    length = n
    while length >= 1:
        if length == 1:
            break
        lenh = length >> 1
        lenq = length << 2
        gap = M // lenq
        for i in range(0, n, length):
            idx_all = lenq - (rot[:lenh] % lenq)
            idx_all = idx_all * gap
            u = vals[i: i + lenh] + vals[i + lenh: i + length]
            v = (vals[i: i + lenh] - vals[i + lenh: i + length]) * ksi[idx_all]
            vals[i: i + lenh] = u
            vals[i + lenh: i + length] = v
        length >>= 1
    _bit_reverse_inplace(vals)
    return vals / n


def encode(z: np.ndarray, params: HEParams, log_delta: int | None = None
           ) -> np.ndarray:
    """Complex message (n,) -> integer coefficient vector (N,) (python ints).

    n must be a power of two, n ≤ N/2. Negative coefficients are returned
    as signed python ints (callers map to mod-q two's complement).
    """
    z = np.asarray(z, dtype=np.complex128)
    n = len(z)
    N = params.N
    Nh = N // 2
    assert n <= Nh and (n & (n - 1)) == 0, "slots must be a power of two ≤ N/2"
    ld = params.log_delta if log_delta is None else log_delta
    delta = float(1 << ld)
    u = emb_inv(z, 2 * N)
    gap = Nh // n
    coeffs = np.zeros(N, dtype=object)
    for i in range(n):
        coeffs[i * gap] = int(np.round(u[i].real * delta))
        coeffs[Nh + i * gap] = int(np.round(u[i].imag * delta))
    return coeffs


def decode(coeffs: np.ndarray, n: int, params: HEParams,
           log_delta: int | None = None) -> np.ndarray:
    """Signed integer coefficients (N,) -> complex message (n,)."""
    N = params.N
    Nh = N // 2
    gap = Nh // n
    ld = params.log_delta if log_delta is None else log_delta
    delta = float(1 << ld)
    u = np.empty(n, dtype=np.complex128)
    for i in range(n):
        u[i] = (float(coeffs[i * gap]) + 1j * float(coeffs[Nh + i * gap])) \
            / delta
    return emb(u, 2 * N)
