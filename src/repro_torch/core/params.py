"""HEAAN parameter sets (paper Table III / Table VI).

Two word-size modes, mirroring the paper's §V:
  - ``beta_bits=64``: the paper's CPU (AVX-512) configuration — qLimbs=19,
    primes in (2^57, 2^60), np 41/61 at log Q = 1200. ``repro_torch`` runs
    it on its plain torch path (int64 words), as the reference runs it in
    jnp; the CUDA kernels refuse it.
  - ``beta_bits=32``: the paper's GPU configuration — qLimbs=38, primes in
    (2^27, 2^30), np 81/122; the CUDA kernels' word size.

q is a power of two (q = 2^logq, faithful to HEAAN), so mod-q is limb
masking and rescaling is a bit shift. All modular heavy lifting happens on
the RNS primes.
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache
from typing import Tuple

from repro_torch.nt.primes import find_ntt_primes


@dataclasses.dataclass(frozen=True)
class HEParams:
    """Static HEAAN parameters. Everything derives from these."""

    logN: int = 16
    logQ: int = 1200
    logp: int = 30          # rescaling factor (paper: 2^30)
    log_delta: int = 30     # encoding scale Δ (paper: 2^30)
    beta_bits: int = 32     # word size β: 32 (GPU) or 64 (paper CPU)
    sigma: float = 3.2      # error stddev
    h: int = 64             # secret-key Hamming weight (HEAAN default)

    def __post_init__(self):
        assert self.beta_bits in (32, 64)
        assert self.logQ % self.logp == 0, "L = logQ/logp must be integral"

    # ---- sizes -----------------------------------------------------------
    @property
    def N(self) -> int:
        return 1 << self.logN

    @property
    def n_slots_max(self) -> int:
        return self.N // 2

    @property
    def L(self) -> int:
        """Multiplicative depth."""
        return self.logQ // self.logp

    @property
    def Q(self) -> int:
        return 1 << self.logQ

    @property
    def qlimbs_max(self) -> int:
        return self.limbs_for_bits(self.logQ)

    def limbs_for_bits(self, bits: int) -> int:
        return max(1, math.ceil(bits / self.beta_bits))

    def qlimbs(self, logq: int) -> int:
        return self.limbs_for_bits(logq)

    # ---- prime ranges (paper Table VI) ----------------------------------
    @property
    def prime_lo_bits(self) -> int:
        # β=2^32: 2^27 < p < 2^30 (paper GPU; lower bound raised to 2^28 to
        # keep np down — footnote 2 of the paper discusses this trade-off).
        # β=2^64: 2^57 < p < 2^60 (paper CPU/AVX-512 uses 2^57 lower bound).
        return 28 if self.beta_bits == 32 else 57

    @property
    def prime_hi_bits(self) -> int:
        return 30 if self.beta_bits == 32 else 60

    # ---- np derivation (paper §III-B / Table VI) --------------------------
    def region1_target_bits(self, logq: int) -> int:
        """Product of region-1 primes must exceed 2·N·q² (signed conv bound)."""
        return 2 * logq + self.logN + 2

    def region2_target_bits(self, logq: int) -> int:
        """Region 2 multiplies a log q-bit poly with a log Q²-bit evk."""
        return logq + 2 * self.logQ + self.logN + 2

    def np_for_bits(self, primes: Tuple[int, ...], target_bits: int) -> int:
        acc = 0.0
        for j, p in enumerate(primes):
            acc += math.log2(p)
            if acc >= target_bits:
                return j + 1
        raise ValueError(
            f"prime pool too small: {len(primes)} primes cover "
            f"{acc:.0f} bits < {target_bits}"
        )

    @property
    def max_np(self) -> int:
        """Primes needed for region 2 at the top level (logq = logQ)."""
        return self._np_cached(self.region2_target_bits(self.logQ))

    def np_region1(self, logq: int) -> int:
        return self._np_cached(self.region1_target_bits(logq))

    def np_region2(self, logq: int) -> int:
        return self._np_cached(self.region2_target_bits(logq))

    def _np_cached(self, target_bits: int) -> int:
        return self.np_for_bits(self.primes, target_bits)

    # ---- the prime pool ---------------------------------------------------
    @property
    def primes(self) -> Tuple[int, ...]:
        return _prime_pool(
            self.N, self.prime_lo_bits, self.prime_hi_bits, self.beta_bits,
            self.logQ, self.logN,
        )


@lru_cache(maxsize=None)
def _prime_pool(
    n_poly: int, lo_bits: int, hi_bits: int, beta_bits: int,
    logQ: int, logN: int,
) -> Tuple[int, ...]:
    """Largest-first pool of NTT primes, big enough for region 2 at logQ."""
    # Worst case bits needed: region2 target at top level.
    target = 3 * logQ + logN + 2
    # Conservative count using the lower bound on prime size.
    count = math.ceil(target / lo_bits) + 2
    return find_ntt_primes(n_poly, count, lo_bits, hi_bits)


# Canonical parameter presets ------------------------------------------------

def paper_params(beta_bits: int = 32) -> HEParams:
    """The paper's representative parameters (Table III/VI)."""
    return HEParams(logN=16, logQ=1200, logp=30, log_delta=30,
                    beta_bits=beta_bits)


def test_params(logN: int = 5, beta_bits: int = 32, logQ: int = 120,
                logp: int = 24) -> HEParams:
    """Small parameters for fast CPU tests (NOT secure)."""
    return HEParams(logN=logN, logQ=logQ, logp=logp, log_delta=logp,
                    beta_bits=beta_bits, h=min(64, (1 << logN) // 2))
