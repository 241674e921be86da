"""Galois rotations and conjugation (HEAAN leftRotate / conjugate).

Slot rotation by r steps is the ring automorphism σ_k : t(X) → t(X^k),
k = 5^r mod 2N (conjugation: k = 2N−1). On coefficients, index i maps to
i·k mod 2N with a sign flip when the image lands in [N, 2N) — a static
permutation + negation, precomputed host-side per k and moved to a device
once.

A rotated ciphertext decrypts under σ_k(s), so a key-switch with the
rotation key rk_k = (a, −a·s + e + Q·σ_k(s)) mod Q² follows — the same
region-2 chain as HE Mul (paper Fig. 2): CRT → NTT at np₂ primes, two
Shoup products against the key, iNTT → iCRT, then ÷Q. Keygen makes the
JAX package's draws in its order, so a seed gives the same key words.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.core import bigint, rns
from repro_torch.core.cipher import Ciphertext, EvalKey, SecretKey
from repro_torch.core.context import (
    device_tables, make_context, resolve_device,
)
from repro_torch.core.keys import (
    _shoup, sample_gauss, sample_uniform_limbs,
)
from repro_torch.core.params import HEParams
from repro_torch.core.rns import DEFAULT, PipelineConfig

__all__ = ["rot_keygen", "conj_keygen", "he_rotate", "he_conjugate",
           "automorphism_poly", "automorphism_maps", "rotation_k",
           "conjugation_k"]


def rotation_k(params: HEParams, r: int) -> int:
    """Galois element for a left-rotation by r slots."""
    return pow(5, r, 2 * params.N)


def conjugation_k(params: HEParams) -> int:
    """Galois element σ₋₁ for slot-wise complex conjugation (k = 2N−1)."""
    return 2 * params.N - 1


@lru_cache(maxsize=None)
def _auto_maps(N: int, k: int):
    """(dest index, negate?) for coefficient i -> i·k mod 2N."""
    idx = (np.arange(N, dtype=np.int64) * k) % (2 * N)
    neg = idx >= N
    return idx % N, neg


def automorphism_maps(N: int, k: int):
    """Host-side σ_k coefficient maps: (dest indices, negate mask). k is
    odd, so dest is a permutation of range(N)."""
    return _auto_maps(N, k)


@lru_cache(maxsize=None)
def _device_maps(N: int, k: int, device: torch.device):
    """The maps of :func:`automorphism_maps` as tensors on `device`:
    (dest int64 (N,), negate bool (N, 1))."""
    dest, neg = _auto_maps(N, k)
    return (torch.from_numpy(dest).to(device),
            torch.from_numpy(neg[:, None]).to(device))


def automorphism_poly(poly: torch.Tensor, params: HEParams, k: int,
                      logq: int) -> torch.Tensor:
    """Apply σ_k to mod-q limb polynomials (..., N, L): one indexed
    assignment along the coefficient axis −2, so a batch (B, N, L) goes
    through in one call."""
    dest, neg = _device_maps(params.N, k, poly.device)
    negated = bigint.mask_bits(bigint.neg(poly), logq)
    out = torch.empty_like(poly, memory_format=torch.contiguous_format)
    out[..., dest, :] = torch.where(neg, negated, poly)
    return out


def _galois_key(params: HEParams, sk: SecretKey, k: int, seed: int,
                cfg: PipelineConfig, device: torch.device) -> EvalKey:
    """Key-switching key from σ_k(s) to s over Q² (same shape as evk)."""
    g = device_tables(params, device)
    s = sk.s.cpu().numpy()
    N, logQ = params.N, params.logQ
    q2limbs = params.limbs_for_bits(2 * logQ)
    rng = np.random.default_rng(seed)

    # σ_k(s) on the small-int secret (sign tracked directly)
    dest, neg = _auto_maps(N, k)
    s_rot = np.zeros_like(s)
    s_rot[dest] = np.where(neg, -s.astype(np.int64), s.astype(np.int64))

    beta = params.beta_bits
    ax = sample_uniform_limbs(rng, N, 2 * logQ, q2limbs, device, beta)
    np_kk = params.np_for_bits(params.primes, 2 * logQ + params.logN + 3)
    as_prod = rns.from_eval(
        rns.eval_mul(rns.to_eval(ax, np_kk, g, cfg),
                     rns.to_eval_small(sk.s.to(device), np_kk, g, cfg),
                     g, cfg), params, q2limbs, g, cfg)
    e = rns.small_ints_to_limbs(sample_gauss(rng, N, params.sigma),
                                q2limbs, device, beta)
    srot_limbs = rns.small_ints_to_limbs(s_rot, q2limbs, device, beta)
    q_srot = bigint.shift_left_bits(srot_limbs, logQ)
    bx = bigint.mask_bits(
        bigint.add(bigint.add(bigint.neg(as_prod), e), q_srot), 2 * logQ)

    np2_max = params.np_region2(logQ)
    primes = g.primes[:np2_max]
    ax_ev = rns.to_eval(ax, np2_max, g, cfg)
    bx_ev = rns.to_eval(bx, np2_max, g, cfg)
    return EvalKey(ax_ev=ax_ev, ax_ev_shoup=_shoup(ax_ev, primes),
                   bx_ev=bx_ev, bx_ev_shoup=_shoup(bx_ev, primes))


def rot_keygen(params: HEParams, sk: SecretKey, r: int, seed: int = 100,
               cfg: PipelineConfig = DEFAULT,
               device: str | torch.device = "cuda") -> EvalKey:
    """Rotation key for a left-rotation by r slots, on `device`."""
    return _galois_key(params, sk, rotation_k(params, r),
                       seed + r, cfg, resolve_device(device))


def conj_keygen(params: HEParams, sk: SecretKey, seed: int = 200,
                cfg: PipelineConfig = DEFAULT,
                device: str | torch.device = "cuda") -> EvalKey:
    """Conjugation key, on `device`."""
    return _galois_key(params, sk, conjugation_k(params),
                       seed, cfg, resolve_device(device))


def _apply_galois(ct: Ciphertext, k: int, key: EvalKey, params: HEParams,
                  cfg: PipelineConfig) -> Ciphertext:
    logq = ct.logq
    ctx = make_context(params, logq, ct.ax.device)
    g = ctx.tables
    qlimbs = ctx.qlimbs
    np2 = ctx.np2
    ks_limbs = params.limbs_for_bits(logq + params.logQ) + 1

    ax_r = automorphism_poly(ct.ax[:, :qlimbs], params, k, logq)
    bx_r = automorphism_poly(ct.bx[:, :qlimbs], params, k, logq)

    e2 = rns.to_eval(ax_r, np2, g, cfg)
    ks_ax = rns.from_eval(
        rns.eval_mul_shoup(e2, key.ax_ev[:np2], key.ax_ev_shoup[:np2], g,
                           cfg),
        params, ks_limbs, g, cfg)
    ks_bx = rns.from_eval(
        rns.eval_mul_shoup(e2, key.bx_ev[:np2], key.bx_ev_shoup[:np2], g,
                           cfg),
        params, ks_limbs, g, cfg)
    ks_ax = bigint.shift_right_round(ks_ax, params.logQ, out_limbs=qlimbs)
    ks_bx = bigint.shift_right_round(ks_bx, params.logQ, out_limbs=qlimbs)

    return Ciphertext(
        ax=bigint.mask_bits(ks_ax, logq),
        bx=bigint.mask_bits(bigint.add(bx_r, ks_bx), logq),
        logq=logq, logp=ct.logp, n_slots=ct.n_slots)


def he_rotate(ct: Ciphertext, r: int, rk: EvalKey, params: HEParams,
              cfg: PipelineConfig = DEFAULT) -> Ciphertext:
    """Rotate message slots left by r (rk must be keyed for the same r)."""
    return _apply_galois(ct, rotation_k(params, r), rk, params, cfg)


def he_conjugate(ct: Ciphertext, ck: EvalKey, params: HEParams,
                 cfg: PipelineConfig = DEFAULT) -> Ciphertext:
    """Complex-conjugate every slot."""
    return _apply_galois(ct, conjugation_k(params), ck, params, cfg)
