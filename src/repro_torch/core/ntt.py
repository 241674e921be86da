"""Negacyclic NTT / iNTT over the RNS primes (paper Algo 3/4), plain torch.

Forward: merged-ψ Cooley-Tukey (natural order in, bit-reversed out), the
paper's Algo 3 with TB_W[m+j] = ψ^brv(m+j). Inverse: Gentleman-Sande with
ψ⁻¹ twiddles (bit-reversed in, natural out) and a final N⁻¹ scale. All
modmuls are Shoup (paper Algo 2); ``modified=True`` selects the paper's
modified Shoup (3 half-word multiplies, §V-B). Both are exact, so the
flag changes the arithmetic, never the result.

These are the plain versions of the NTT kernels
(:mod:`repro_torch.kernels.ntt`): stored words in and out, int32 at
β = 2^32 and int64 at β = 2^64 (the kernels take β = 2^32 only), int64
inside. Data layout is (np, N) with N minor.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.core.wordops import (
    modadd, modsub, narrow, shoup_modmul, shoup_modmul_modified, wide,
    word_bits,
)

__all__ = ["ntt", "intt", "pointwise_shoup_scale"]


def _modmul(modified: bool, bits: int):
    return partial(shoup_modmul_modified if modified else shoup_modmul,
                   bits=bits)


def ntt(x: torch.Tensor, psi_rev: torch.Tensor, psi_rev_shoup: torch.Tensor,
        primes: torch.Tensor, *, modified: bool = False) -> torch.Tensor:
    """Forward negacyclic NTT.

    x: (..., np, N) residues in natural order  ->  bit-reversed eval, same
    shape (leading dimensions are a batch). psi_rev[j, k] = ψ_j^brv(k);
    primes: (np,).
    """
    *lead, N = x.shape
    bits = word_bits(x)
    mm = _modmul(modified, bits)
    v, psi, psi_sh = wide(x), wide(psi_rev), wide(psi_rev_shoup)
    p = wide(primes)[:, None, None]
    t, m = N, 1
    while m < N:
        t //= 2
        # groups: (..., np, m, 2, t); twiddle S = psi_rev[:, m + i] per group
        xr = v.reshape(*lead, m, 2, t)
        u = xr[..., 0, :]
        vv = mm(xr[..., 1, :], psi[:, m: 2 * m, None],
                psi_sh[:, m: 2 * m, None], p)
        v = torch.stack([modadd(u, vv, p), modsub(u, vv, p)],
                        dim=-2).reshape(*lead, N)
        m *= 2
    return narrow(v, bits)


def intt(x: torch.Tensor, ipsi_rev: torch.Tensor,
         ipsi_rev_shoup: torch.Tensor, n_inv: torch.Tensor,
         n_inv_shoup: torch.Tensor, primes: torch.Tensor, *,
         modified: bool = False) -> torch.Tensor:
    """Inverse negacyclic NTT (Gentleman-Sande).

    x: (..., np, N) bit-reversed eval  ->  natural-order residues, same
    shape.
    """
    *lead, N = x.shape
    bits = word_bits(x)
    mm = _modmul(modified, bits)
    v, ipsi, ipsi_sh = wide(x), wide(ipsi_rev), wide(ipsi_rev_shoup)
    p = wide(primes)[:, None, None]
    t, m = 1, N
    while m > 1:
        h = m // 2
        xr = v.reshape(*lead, h, 2, t)
        u, w = xr[..., 0, :], xr[..., 1, :]
        hi = mm(modsub(u, w, p), ipsi[:, h: 2 * h, None],
                ipsi_sh[:, h: 2 * h, None], p)
        v = torch.stack([modadd(u, w, p), hi], dim=-2).reshape(*lead, N)
        t *= 2
        m = h
    # final elementwise ·N⁻¹ (paper §IV: iNTT's extra division by N)
    return narrow(mm(v, wide(n_inv)[:, None], wide(n_inv_shoup)[:, None],
                     p[:, :, 0]), bits)


def pointwise_shoup_scale(x: torch.Tensor, y: torch.Tensor,
                          y_shoup: torch.Tensor, primes: torch.Tensor, *,
                          modified: bool = False) -> torch.Tensor:
    """Elementwise x·y mod p where y has precomputed Shoup companions.

    Used for evk products (evk is precomputed in the eval domain, so its
    Shoup companions are too).
    """
    bits = word_bits(x)
    return narrow(_modmul(modified, bits)(wide(x), wide(y), wide(y_shoup),
                                          wide(primes)[:, None]), bits)
