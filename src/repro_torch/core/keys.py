"""Key generation and randomness sampling (HEAAN distributions, §III-A).

Sampling is host-side numpy, deterministic per seed, and makes the same
draws in the same order as the JAX package's ``core/keys.py``, so a seed
gives bit-identical keys. The polynomial products inside keygen run
through the same RNS pipeline as HE Mul.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bigint
from repro_torch.core import rns
from repro_torch.core.cipher import EvalKey, PublicKey, SecretKey
from repro_torch.core.context import device_tables, resolve_device
from repro_torch.core.params import HEParams
from repro_torch.core.rns import DEFAULT, PipelineConfig
from repro_torch.core.wordops import (
    narrow, shoup_companion, wide, word_bits,
)

__all__ = [
    "sample_hwt", "sample_zo", "sample_gauss", "sample_uniform_limbs",
    "keygen",
]


def sample_hwt(rng: np.random.Generator, N: int, h: int) -> np.ndarray:
    """Ternary secret with exactly h nonzeros (HEAAN HWT distribution)."""
    s = np.zeros(N, dtype=np.int8)
    idx = rng.choice(N, size=h, replace=False)
    s[idx] = rng.choice(np.array([-1, 1], dtype=np.int8), size=h)
    return s


def sample_zo(rng: np.random.Generator, N: int, prob: float = 0.5
              ) -> np.ndarray:
    """ZO(prob): ±1 each with prob/2, else 0 (paper: u's distribution)."""
    r = rng.random(N)
    return (np.where(r < prob / 2, -1,
                     np.where(r < prob, 1, 0))).astype(np.int8)


def sample_gauss(rng: np.random.Generator, N: int, sigma: float
                 ) -> np.ndarray:
    """Rounded discrete Gaussian, σ = 3.2 (paper §III-A)."""
    return np.round(rng.normal(0.0, sigma, size=N)).astype(np.int64)


def sample_uniform_limbs(rng: np.random.Generator, N: int, bits: int,
                         n_limbs: int, device: torch.device,
                         beta_bits: int = 32) -> torch.Tensor:
    """Uniform in [0, 2^bits): random limbs + mask (q is a power of two).

    A 64-bit limb is 62 random bits shifted up by 2 and 2 more random
    bits below, the reference's two draws in its order."""
    if beta_bits == 32:
        raw = rng.integers(0, 1 << 32, size=(N, n_limbs), dtype=np.uint64)
        arr = torch.from_numpy(raw.astype(np.uint32).view(np.int32))
    else:
        raw = (rng.integers(0, 1 << 62, size=(N, n_limbs), dtype=np.uint64)
               << np.uint64(2)) | rng.integers(
                   0, 4, size=(N, n_limbs), dtype=np.uint64)
        arr = torch.from_numpy(raw.view(np.int64))
    return bigint.mask_bits(arr.to(device), bits)


def _shoup(vals: torch.Tensor, primes: torch.Tensor) -> torch.Tensor:
    """floor(vals·β / p) for (np, N) residues of either β; exact."""
    bits = word_bits(vals)
    return narrow(shoup_companion(wide(vals), wide(primes), bits), bits)


def keygen(params: HEParams, seed: int = 0, cfg: PipelineConfig = DEFAULT,
           device: str | torch.device = "cuda"
           ) -> tuple[SecretKey, PublicKey, EvalKey]:
    """Generate (sk, pk, evk) on `device`.

    pk:  ax ~ U(R_Q),  bx = -ax·s + e  (mod Q)
    evk: ax ~ U(R_Q²), bx = -ax·s + e + Q·s²  (mod Q²)
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    g = device_tables(params, dev)
    N = params.N
    logQ = params.logQ
    beta = params.beta_bits
    qlimbs = params.qlimbs(logQ)
    q2limbs = params.limbs_for_bits(2 * logQ)

    s = torch.from_numpy(sample_hwt(rng, N, params.h)).to(dev)

    # ---- public key over Q -------------------------------------------------
    pk_ax = sample_uniform_limbs(rng, N, logQ, qlimbs, dev, beta)
    np_pk = params.np_for_bits(params.primes, logQ + params.logN + 3)
    as_prod = rns.from_eval(
        rns.eval_mul(rns.to_eval(pk_ax, np_pk, g, cfg),
                     rns.to_eval_small(s, np_pk, g, cfg), g, cfg),
        params, qlimbs, g, cfg)                      # centered a·s
    e = rns.small_ints_to_limbs(sample_gauss(rng, N, params.sigma),
                                qlimbs, dev, beta)
    pk_bx = bigint.mask_bits(bigint.add(bigint.neg(as_prod), e), logQ)

    # ---- evaluation key over Q² --------------------------------------------
    evk_ax = sample_uniform_limbs(rng, N, 2 * logQ, q2limbs, dev, beta)
    np_evk = params.np_for_bits(params.primes, 2 * logQ + params.logN + 3)
    as2 = rns.from_eval(
        rns.eval_mul(rns.to_eval(evk_ax, np_evk, g, cfg),
                     rns.to_eval_small(s, np_evk, g, cfg), g, cfg),
        params, q2limbs, g, cfg)                     # centered evk_ax·s
    # s² via a tiny exact product (coeffs bounded by N)
    np_ss = params.np_for_bits(params.primes, 2 + params.logN + 3)
    ss = rns.from_eval(
        rns.eval_mul(rns.to_eval_small(s, np_ss, g, cfg),
                     rns.to_eval_small(s, np_ss, g, cfg), g, cfg),
        params, q2limbs, g, cfg)
    q_ss = bigint.shift_left_bits(ss, logQ)          # Q·s²
    e2 = rns.small_ints_to_limbs(sample_gauss(rng, N, params.sigma),
                                 q2limbs, dev, beta)
    evk_bx = bigint.mask_bits(
        bigint.add(bigint.add(bigint.neg(as2), e2), q_ss), 2 * logQ)

    # ---- evk into the eval domain (region-2 primes, max np2) ---------------
    np2_max = params.np_region2(logQ)
    primes = g.primes[:np2_max]
    ax_ev = rns.to_eval(evk_ax, np2_max, g, cfg)
    bx_ev = rns.to_eval(evk_bx, np2_max, g, cfg)

    return (SecretKey(s=s),
            PublicKey(ax=pk_ax, bx=pk_bx),
            EvalKey(ax_ev=ax_ev, ax_ev_shoup=_shoup(ax_ev, primes),
                    bx_ev=bx_ev, bx_ev_shoup=_shoup(bx_ev, primes)))
