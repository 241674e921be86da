"""HEAAN scheme operations: encrypt / decrypt / HE Add / HE Mul / rescale,
the plaintext-operand ops and the level ops (mod-down, mod-raise).

HE Mul is the paper's Fig. 2 pipeline:

  region 1 (np₁ primes, P₁ > 2N·q²):
      4× (CRT → NTT)  for ax1, bx1, ax2, bx2
      3× pointwise    d0 = b̂1⊙b̂2,  d2 = â1⊙â2,
                      d1 = (â1+b̂1)⊙(â2+b̂2) − d0 − d2     (eval-domain adds)
      3× (iNTT → iCRT)
  region 2 (np₂ primes, P₂ > 2N·q·Q², key switching):
      1× (CRT → NTT)  for d2
      2× pointwise    against evk (precomputed in eval domain, Shoup)
      2× (iNTT → iCRT), then ÷Q with rounding (bit shift; Q = 2^1200)
  combine:  c3.ax = d1 + (d2·evk.ax)/Q,  c3.bx = d0 + (d2·evk.bx)/Q  (mod q)

Because q and Q are powers of two (faithful HEAAN), mod-q is masking and
÷Q / rescale are rounding bit-shifts — all BigInt division lives in iCRT.
Every op runs on the device of its operands; the randomness is host-side
numpy with the JAX package's draws, so a seed gives identical ciphertexts.
Limbs are the stored words of ``params.beta_bits`` (int32 at β = 2^32,
int64 at β = 2^64; :mod:`repro_torch.core.wordops`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bigint
from repro_torch.core import rns
from repro_torch.core.cipher import Ciphertext, EvalKey, PublicKey, SecretKey
from repro_torch.core.context import (
    device_tables, make_context, resolve_device,
)
from repro_torch.core.encoding import decode, encode
from repro_torch.core.keys import sample_gauss, sample_zo
from repro_torch.core.params import HEParams
from repro_torch.core.rns import DEFAULT, PipelineConfig
from repro_torch.core.wordops import M32, narrow, wide, word_bits
from repro_torch.nt.residue import ints_to_limb_array

__all__ = [
    "encrypt_coeffs", "encrypt_message", "decrypt_coeffs", "decrypt_message",
    "he_add", "he_sub", "he_neg", "he_mul", "rescale", "rescale_poly",
    "he_mod_down", "mod_down_poly", "he_mod_raise", "mod_raise_poly",
    "he_mul_plain", "he_add_plain", "encode_plain",
]


# --------------------------------------------------------------------------
# encryption / decryption
# --------------------------------------------------------------------------

def encrypt_coeffs(pt_limbs: torch.Tensor, pk: PublicKey, params: HEParams,
                   n_slots: int, seed: int = 1,
                   cfg: PipelineConfig = DEFAULT) -> Ciphertext:
    """Encrypt plaintext coefficients (N, QLimbs) at the top level logQ.

    c.ax = u·pk.ax + e1,  c.bx = u·pk.bx + e0 + t   (mod Q)
    """
    rng = np.random.default_rng(seed)
    dev = pk.ax.device
    g = device_tables(params, dev)
    N = params.N
    logQ = params.logQ
    qlimbs = params.qlimbs(logQ)
    u = torch.from_numpy(sample_zo(rng, N)).to(dev)
    np_enc = params.np_for_bits(params.primes, logQ + params.logN + 3)
    u_ev = rns.to_eval_small(u, np_enc, g, cfg)

    def mul_u(poly_limbs):
        prod = rns.eval_mul(rns.to_eval(poly_limbs, np_enc, g, cfg),
                            u_ev, g, cfg)
        return rns.from_eval(prod, params, qlimbs, g, cfg)

    e1 = rns.small_ints_to_limbs(sample_gauss(rng, N, params.sigma),
                                 qlimbs, dev, params.beta_bits)
    e0 = rns.small_ints_to_limbs(sample_gauss(rng, N, params.sigma),
                                 qlimbs, dev, params.beta_bits)
    ax = bigint.mask_bits(bigint.add(mul_u(pk.ax), e1), logQ)
    bx = bigint.mask_bits(
        bigint.add(bigint.add(mul_u(pk.bx), e0), pt_limbs), logQ)
    return Ciphertext(ax=ax, bx=bx, logq=logQ, logp=params.log_delta,
                      n_slots=n_slots)


def encrypt_message(z: np.ndarray, pk: PublicKey, params: HEParams,
                    seed: int = 1, cfg: PipelineConfig = DEFAULT
                    ) -> Ciphertext:
    """Encode a complex message and encrypt it on pk's device."""
    pt = encode_plain(z, params, params.logQ, device=pk.ax.device)
    return encrypt_coeffs(pt, pk, params, len(z), seed, cfg)


def decrypt_coeffs(ct: Ciphertext, sk: SecretKey, params: HEParams,
                   cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """t ≈ bx + ax·s (mod q), returned as (N, qlimbs) mod-q limbs."""
    g = device_tables(params, ct.ax.device)
    qlimbs = params.qlimbs(ct.logq)
    np_dec = params.np_for_bits(params.primes, ct.logq + params.logN + 3)
    prod = rns.from_eval(
        rns.eval_mul(rns.to_eval(ct.ax[:, :qlimbs].contiguous(), np_dec,
                                  g, cfg),
                     rns.to_eval_small(sk.s, np_dec, g, cfg), g, cfg),
        params, qlimbs, g, cfg)
    return bigint.mask_bits(bigint.add(ct.bx[:, :qlimbs], prod), ct.logq)


def decrypt_message(ct: Ciphertext, sk: SecretKey, params: HEParams,
                    cfg: PipelineConfig = DEFAULT) -> np.ndarray:
    """Decrypt and decode to complex slots (scale 2^ct.logp assumed)."""
    t = decrypt_coeffs(ct, sk, params, cfg)
    ints = rns.limbs_to_centered_ints(t, ct.logq)
    return decode(np.array(ints, dtype=object), ct.n_slots, params,
                  log_delta=ct.logp)


# --------------------------------------------------------------------------
# HE Add / Sub / Neg (paper §III-B: limb adds + mask — q is a power of two)
# --------------------------------------------------------------------------

def he_add(c1: Ciphertext, c2: Ciphertext) -> Ciphertext:
    assert c1.logq == c2.logq and c1.logp == c2.logp
    return Ciphertext(
        ax=bigint.mask_bits(bigint.add(c1.ax, c2.ax), c1.logq),
        bx=bigint.mask_bits(bigint.add(c1.bx, c2.bx), c1.logq),
        logq=c1.logq, logp=c1.logp, n_slots=c1.n_slots)


def he_sub(c1: Ciphertext, c2: Ciphertext) -> Ciphertext:
    assert c1.logq == c2.logq and c1.logp == c2.logp
    return Ciphertext(
        ax=bigint.mask_bits(bigint.sub(c1.ax, c2.ax), c1.logq),
        bx=bigint.mask_bits(bigint.sub(c1.bx, c2.bx), c1.logq),
        logq=c1.logq, logp=c1.logp, n_slots=c1.n_slots)


def he_neg(c: Ciphertext) -> Ciphertext:
    return Ciphertext(ax=bigint.mask_bits(bigint.neg(c.ax), c.logq),
                      bx=bigint.mask_bits(bigint.neg(c.bx), c.logq),
                      logq=c.logq, logp=c.logp, n_slots=c.n_slots)


# --------------------------------------------------------------------------
# HE Mul (paper Fig. 2) and rescale
# --------------------------------------------------------------------------

def he_mul(c1: Ciphertext, c2: Ciphertext, evk: EvalKey, params: HEParams,
           cfg: PipelineConfig = DEFAULT) -> Ciphertext:
    assert c1.logq == c2.logq, "operands must share a modulus (paper §III-B)"
    logq = c1.logq
    ctx = make_context(params, logq, c1.ax.device)
    g = ctx.tables
    qlimbs = ctx.qlimbs
    np1, np2 = ctx.np1, ctx.np2

    ax1, bx1 = c1.ax[:, :qlimbs], c1.bx[:, :qlimbs]
    ax2, bx2 = c2.ax[:, :qlimbs], c2.bx[:, :qlimbs]

    # ---- region 1 ----------------------------------------------------------
    ea1 = rns.to_eval(ax1.contiguous(), np1, g, cfg)
    eb1 = rns.to_eval(bx1.contiguous(), np1, g, cfg)
    ea2 = rns.to_eval(ax2.contiguous(), np1, g, cfg)
    eb2 = rns.to_eval(bx2.contiguous(), np1, g, cfg)

    d0_ev = rns.eval_mul(eb1, eb2, g, cfg)
    d2_ev = rns.eval_mul(ea1, ea2, g, cfg)
    d1_ev = rns.eval_mul(rns.eval_add(ea1, eb1, g),
                         rns.eval_add(ea2, eb2, g), g, cfg)
    d1_ev = rns.eval_sub(rns.eval_sub(d1_ev, d0_ev, g), d2_ev, g)

    d0 = rns.from_eval(d0_ev, params, qlimbs, g, cfg)
    d1 = rns.from_eval(d1_ev, params, qlimbs, g, cfg)
    d2 = bigint.mask_bits(rns.from_eval(d2_ev, params, qlimbs, g, cfg), logq)

    # ---- region 2 (key switching) ------------------------------------------
    ks_limbs = params.limbs_for_bits(logq + params.logQ) + 1
    e2 = rns.to_eval(d2, np2, g, cfg)
    ks_ax = rns.from_eval(
        rns.eval_mul_shoup(e2, evk.ax_ev[:np2], evk.ax_ev_shoup[:np2], g,
                           cfg),
        params, ks_limbs, g, cfg)
    ks_bx = rns.from_eval(
        rns.eval_mul_shoup(e2, evk.bx_ev[:np2], evk.bx_ev_shoup[:np2], g,
                           cfg),
        params, ks_limbs, g, cfg)
    ks_ax = bigint.shift_right_round(ks_ax, params.logQ, out_limbs=qlimbs)
    ks_bx = bigint.shift_right_round(ks_bx, params.logQ, out_limbs=qlimbs)

    # ---- combine ------------------------------------------------------------
    ax3 = bigint.mask_bits(bigint.add(d1, ks_ax), logq)
    bx3 = bigint.mask_bits(bigint.add(d0, ks_bx), logq)
    return Ciphertext(ax=ax3, bx=bx3, logq=logq,
                      logp=c1.logp + c2.logp, n_slots=c1.n_slots)


def encode_plain(z: np.ndarray, params: HEParams, logq: int,
                 log_delta: int | None = None,
                 device: str | torch.device = "cuda") -> torch.Tensor:
    """Encode a message into (N, qlimbs) mod-q plaintext words on `device`
    (for the plain-ct ops)."""
    coeffs = encode(z, params, log_delta=log_delta)
    q = 1 << logq
    enc = ints_to_limb_array([int(c) % q for c in coeffs],
                             params.qlimbs(logq), params.beta_bits)
    stored = enc.view(np.int32 if params.beta_bits == 32 else np.int64)
    return torch.from_numpy(stored).to(resolve_device(device))


def he_mul_plain(ct: Ciphertext, pt_limbs: torch.Tensor, params: HEParams,
                 pt_logp: int | None = None,
                 cfg: PipelineConfig = DEFAULT) -> Ciphertext:
    """Ciphertext × plaintext (no key switching — cheap, paper Fig. 2's
    region 1 only). pt is an encoded polynomial at scale 2^pt_logp."""
    g = device_tables(params, ct.ax.device)
    logq = ct.logq
    qlimbs = params.qlimbs(logq)
    pt_logp = params.log_delta if pt_logp is None else pt_logp
    npn = params.np_for_bits(params.primes, 2 * logq + params.logN + 2)
    pt_ev = rns.to_eval(pt_limbs[:, :qlimbs].contiguous(), npn, g, cfg)

    def mul_poly(poly):
        prod = rns.eval_mul(
            rns.to_eval(poly[:, :qlimbs].contiguous(), npn, g, cfg), pt_ev,
            g, cfg)
        return bigint.mask_bits(
            rns.from_eval(prod, params, qlimbs, g, cfg), logq)

    return Ciphertext(ax=mul_poly(ct.ax), bx=mul_poly(ct.bx), logq=logq,
                      logp=ct.logp + pt_logp, n_slots=ct.n_slots)


def he_add_plain(ct: Ciphertext, pt_limbs: torch.Tensor, params: HEParams
                 ) -> Ciphertext:
    """Ciphertext + plaintext (added to bx; scales must match)."""
    qlimbs = params.qlimbs(ct.logq)
    return Ciphertext(
        ax=ct.ax,
        bx=bigint.mask_bits(
            bigint.add(ct.bx[:, :qlimbs], pt_limbs[:, :qlimbs]), ct.logq),
        logq=ct.logq, logp=ct.logp, n_slots=ct.n_slots)


def mod_down_poly(poly: torch.Tensor, params: HEParams, logq2: int
                  ) -> torch.Tensor:
    """Mask a mod-q limb polynomial down to modulus 2^logq2 and drop the
    now-zero high limbs."""
    return bigint.mask_bits(poly, logq2)[..., :params.qlimbs(logq2)]


def he_mod_down(ct: Ciphertext, params: HEParams, logq2: int) -> Ciphertext:
    """Switch to a smaller modulus q' | q without touching the scale.

    q and q' are powers of two, so this is pure masking (level alignment
    before HE Add/Mul between ciphertexts of different depths).
    """
    assert 0 < logq2 <= ct.logq
    return Ciphertext(
        ax=mod_down_poly(ct.ax, params, logq2),
        bx=mod_down_poly(ct.bx, params, logq2),
        logq=logq2, logp=ct.logp, n_slots=ct.n_slots)


def _center(x: torch.Tensor, logq: int, beta: int) -> torch.Tensor:
    """The mod-q lift of int64 limbs (..., L) of β = 2^beta, sign-extended
    above bit logq − 1 across all L limbs. Indexing is on the trailing
    limb axis only, so leading batch axes pass through."""
    ones = M32 if beta == 32 else -1    # a limb of all ones
    sign = ((x[..., (logq - 1) // beta] >> ((logq - 1) % beta)) & 1).bool()
    w, r = divmod(logq, beta)
    limb_sel = torch.arange(x.shape[-1], device=x.device) >= (
        w + (1 if r else 0))
    lifted = torch.where(limb_sel & sign[..., None], ones,
                         torch.where(limb_sel, 0, x))
    if r:
        lifted[..., w] = x[..., w] | torch.where(
            sign, (ones << r) & ones, 0)
    return lifted


def mod_raise_poly(poly: torch.Tensor, params: HEParams, logq: int,
                   logq2: int) -> torch.Tensor:
    """Lift a mod-q limb polynomial into the larger modulus 2^logq2.

    The coefficient is zero-padded to qlimbs(logq2) limbs, centered
    (sign-extended above bit logq−1 from its mod-q lift) and re-masked at
    logq2 — the bootstrap mod-raise: the decrypted value becomes
    t + q·I(X) for small I. Leading batch axes pass through, so the
    batched step of :mod:`repro_torch.hserve.engine` shares this code.
    """
    assert 0 < logq < logq2 <= params.logQ
    L2 = params.qlimbs(logq2)
    beta = word_bits(poly)
    x = wide(poly)
    pad = L2 - x.shape[-1]
    if pad > 0:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], -1)
    else:
        x = x[..., :L2]
    return bigint.mask_bits(narrow(_center(x, logq, beta), beta), logq2)


def he_mod_raise(ct: Ciphertext, params: HEParams, logq2: int
                 ) -> Ciphertext:
    """Raise to a larger modulus q' = 2^logq2 > q (bootstrap step 1).

    The scale is untouched; the underlying plaintext gains a q·I(X)
    error term (|I| small) that a bootstrap's EvalMod stage removes.
    """
    assert ct.logq < logq2 <= params.logQ
    return Ciphertext(
        ax=mod_raise_poly(ct.ax, params, ct.logq, logq2),
        bx=mod_raise_poly(ct.bx, params, ct.logq, logq2),
        logq=logq2, logp=ct.logp, n_slots=ct.n_slots)


def rescale_poly(poly: torch.Tensor, params: HEParams, logq: int,
                 dlogp: int) -> torch.Tensor:
    """Rounding-divide a mod-q limb polynomial by 2^dlogp (paper §III-A).

    The coefficient is centered (sign-extended above bit logq−1 from its
    mod-q lift), rounding-shifted right by dlogp, and re-masked at
    logq' = logq − dlogp. Leading batch axes pass through.
    """
    logq2 = logq - dlogp
    assert logq2 > 0, "ciphertext exhausted (needs bootstrapping)"
    beta = word_bits(poly)
    out = bigint.shift_right_round(
        narrow(_center(wide(poly), logq, beta), beta), dlogp)
    return bigint.mask_bits(out, logq2)[..., :max(params.qlimbs(logq2), 1)]


def rescale(ct: Ciphertext, params: HEParams, dlogp: int | None = None
            ) -> Ciphertext:
    """Divide by the rescaling factor p = 2^logp (paper §III-A).

    Coefficients are centered (mod-q lift), rounding-shifted, and re-masked
    at logq' = logq − dlogp (see :func:`rescale_poly`).
    """
    dlogp = params.logp if dlogp is None else dlogp
    return Ciphertext(
        ax=rescale_poly(ct.ax, params, ct.logq, dlogp),
        bx=rescale_poly(ct.bx, params, ct.logq, dlogp),
        logq=ct.logq - dlogp, logp=ct.logp - dlogp, n_slots=ct.n_slots)
