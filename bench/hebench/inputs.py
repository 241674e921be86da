"""The benchmark's inputs, made on the device from the seed.

Ciphertexts and key-switching keys are uniform words: a ciphertext
(ax, bx) mod q and an RLWE key mod Q² are uniform to anyone who does not
hold the secret, and HE Mul and rotation compute the same words whatever
the secret, so the benchmark needs none. One generator on the device,
seeded once, draws everything in a fixed order.
"""

from __future__ import annotations

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def words(g: torch.Generator, shape: tuple, bits: int, beta: int,
          device: torch.device) -> torch.Tensor:
    """Uniform values in [0, 2^bits) as (..., K) little-endian words of β
    bits: int32 bit patterns at β = 32, int64 at β = 64."""
    lo = torch.randint(-2**31, 2**31, shape, dtype=torch.int32, generator=g,
                       device=device)
    if beta == 32:
        w = lo
    else:
        hi = torch.randint(-2**31, 2**31, shape, dtype=torch.int32,
                           generator=g, device=device)
        w = (hi.long() << 32) | (lo.long() & 0xFFFFFFFF)
    full, r = divmod(bits, beta)
    if full < shape[-1]:
        if r:
            w[..., full] &= (1 << r) - 1
            full += 1
        w[..., full:] = 0
    return w


def ciphertexts(g, n: int, N: int, logq: int, beta: int, device):
    """(ax, bx): n ciphertexts mod 2^logq, each (n, N, ceil(logq/β))."""
    K = -(-logq // beta)
    return tuple(words(g, (n, N, K), logq, beta, device) for _ in range(2))


def key(g, N: int, logQ: int, beta: int, device):
    """(ax, bx) of a key-switching key: coefficient words mod Q²."""
    K = -(-2 * logQ // beta)
    return tuple(words(g, (N, K), 2 * logQ, beta, device) for _ in range(2))
