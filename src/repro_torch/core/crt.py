"""CRT (paper Algo 1) and iCRT (Algo 5 → reordered Algo 6), plain torch.

CRT strategies (the JAX package's, paper Table VIII ladder):
  - "shoup"  : per-term Shoup modmul, modulo every iteration.
  - "mod2"/"mod4" : raw wide products summed, remainder every 2/4 terms.
               Four products of < 2^62 can pass 2^63, so the sum is kept
               as two words (hi, lo) and reduced from them.
  - "acc3"   : three-word accumulation, one Shoup fold by {1, β, β²} at
               the end (GPU-C). The CRT kernel's default; its plain version.
  - "matmul" : the stage-1 sum on 16-bit input halves. CUDA torch has no
               int64 matrix product, so it is a loop over K of elementwise
               products, on either device.

iCRT strategies ("matmul", "acc3", "naive" as in the JAX package; the
accumulator sum over the primes differs, the result does not):
  - "matmul" : Algo 6 on 16-bit halves of P/p_j, summed column by column.
  - "acc3"   : Algo 6 with per-(n, k) three-word accumulators.
  - "naive"  : Algo 5, a word × BigInt product and BigInt add per prime.
The iCRT kernel's own formulation, column sums with a running carry, is
not a strategy: its plain version (kernels/icrt/ref.py) reaches it through
``_icrt(..., _accum_columns)``.

Split at the cross-prime sum (:func:`icrt_partial`, summed over shards of
the primes, then :func:`icrt_finish`), every strategy at either β gives
the same words too: "matmul" at β = 2^32 leaves its (lo, hi) column
halves, the others 32-bit column sums of the accumulator.

Words in and out are the port's stored words at either β
(:mod:`repro_torch.core.wordops`), int64 inside. At β = 2^64 the routing
is the reference's at ``uint64``: the wide accumulators of CRT "matmul",
"mod2" and "mod4" and iCRT "matmul" have no room, so they run as "acc3"
(the carries of a three-word accumulator come from unsigned compares).
Every strategy is exact, so all give the same words.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.core import bigint
from repro_torch.core.wordops import (
    M32, acc3_add_product, cond_reduce, modadd, narrow, shoup_modmul, wide,
    word_bits,
)

__all__ = ["crt", "icrt", "icrt_partial", "icrt_finish", "finalize_accum"]


# --------------------------------------------------------------------------
# CRT: (N, K) BigInt limbs -> (np, N) residues
# --------------------------------------------------------------------------

def crt(x: torch.Tensor, tb: torch.Tensor, tb_shoup: torch.Tensor,
        primes: torch.Tensor, *, strategy: str = "matmul") -> torch.Tensor:
    """mod(Σ_k x[n,k]·β^k, p_j) for every coefficient n and prime j.

    x: (N, K) limbs; tb/tb_shoup: (np, Kt) = β^k mod p_j with
    Kt ≥ max(K, 3) (the acc3 fold reads k < 3); primes: (np,).
    Returns (np, N).
    """
    N, K = x.shape
    if tb.shape[1] < max(K, 3):
        raise ValueError(f"CRT table has {tb.shape[1]} columns; "
                         f"needs {max(K, 3)}")
    if word_bits(x) == 64:
        return _crt64(x, tb, tb_shoup, primes, strategy)
    xw, t, p = wide(x), wide(tb), wide(primes)[:, None]
    zeros = torch.zeros((t.shape[0], N), dtype=torch.int64, device=x.device)

    if strategy == "matmul":
        s_lo, s_hi = zeros, zeros.clone()
        for k in range(K):
            s_lo += t[:, k, None] * (xw[None, :, k] & 0xFFFF)   # < K·2^46
            s_hi += t[:, k, None] * (xw[None, :, k] >> 16)
        return narrow((s_lo + ((s_hi % p) << 16)) % p)

    if strategy == "shoup":
        acc, tsh = zeros, wide(tb_shoup)
        for k in range(K):
            acc = modadd(acc, shoup_modmul(xw[None, :, k], t[:, k, None],
                                           tsh[:, k, None], p), p)
        return narrow(acc)

    if strategy in ("mod2", "mod4"):
        every = int(strategy[3:])
        lo, hi = zeros, zeros.clone()       # the sum is hi·2^32 + lo
        for k in range(K):
            prod = t[:, k, None] * xw[None, :, k]          # < 2^62
            lo = lo + (prod & M32)
            hi = hi + (prod >> 32)
            if (k + 1) % every == 0:
                lo, hi = (((hi % p) << 32) + lo) % p, zeros
        return narrow((((hi % p) << 32) + lo) % p)

    if strategy == "acc3":
        lo, hi = zeros, zeros.clone()
        for k in range(K):
            prod = xw[None, :, k] * t[:, k, None]          # < 2^62
            lo += prod & M32
            hi += prod >> 32
        # the sum as three words a0 + a1·β + a2·β²
        mid = hi + (lo >> 32)
        return narrow(_fold3(lo & M32, mid & M32, mid >> 32, t,
                             wide(tb_shoup), wide(primes)))

    raise ValueError(f"unknown CRT strategy {strategy!r}")


def _crt64(x, tb, tb_shoup, primes, strategy: str) -> torch.Tensor:
    """:func:`crt` on 64-bit words: "shoup", or "acc3" for the others."""
    if strategy not in ("matmul", "shoup", "mod2", "mod4", "acc3"):
        raise ValueError(f"unknown CRT strategy {strategy!r}")
    p = primes[:, None]
    if strategy == "shoup":
        acc = torch.zeros((tb.shape[0], x.shape[0]), dtype=torch.int64,
                          device=x.device)
        for k in range(x.shape[1]):
            acc = modadd(acc, shoup_modmul(x[None, :, k], tb[:, k, None],
                                           tb_shoup[:, k, None], p, 64), p)
        return acc
    a2 = a1 = a0 = torch.zeros((tb.shape[0], x.shape[0]), dtype=torch.int64,
                               device=x.device)
    for k in range(x.shape[1]):
        a2, a1, a0 = acc3_add_product(a2, a1, a0, x[None, :, k],
                                      tb[:, k, None], 64)
    return _fold3(a0, a1, a2, tb, tb_shoup, primes, 64)


def _fold3(a0, a1, a2, tb, tb_shoup, primes, bits: int = 32):
    """Reduce a 3-word accumulator via Shoup multiplies by β^k mod p."""
    p = primes[:, None]
    r0 = shoup_modmul(a0, tb[:, 0, None], tb_shoup[:, 0, None], p, bits)
    r1 = shoup_modmul(a1, tb[:, 1, None], tb_shoup[:, 1, None], p, bits)
    r2 = shoup_modmul(a2, tb[:, 2, None], tb_shoup[:, 2, None], p, bits)
    return cond_reduce(r0 + r1 + r2, p, 4)


# --------------------------------------------------------------------------
# iCRT: (np, N) residues -> (N, out_limbs) two's-complement centered BigInt
# --------------------------------------------------------------------------

def icrt(r: torch.Tensor, primes: torch.Tensor, inv_P: torch.Tensor,
         inv_P_shoup: torch.Tensor, pdivp: torch.Tensor,
         P_limbs: torch.Tensor, P_half: torch.Tensor,
         p_inv_f64: torch.Tensor, out_limbs: int, *,
         strategy: str = "matmul") -> torch.Tensor:
    """Reconstruct centered BigInts from RNS residues (paper Algo 5/6).

    r: (np, N). Returns (N, out_limbs) two's-complement (low limbs of the
    centered value — callers mask to mod-q or shift for key-switching).
    The accumulator is as wide as P_limbs.
    """
    if strategy not in _ACCUM:
        raise ValueError(f"unknown iCRT strategy {strategy!r}")
    accumulate = _ACCUM[strategy]
    if word_bits(r) == 64:
        accumulate = partial(_accum_naive if strategy == "naive"
                             else _accum_acc3, bits=64)
    return _icrt(r, primes, inv_P, inv_P_shoup, pdivp, P_limbs, P_half,
                 p_inv_f64, out_limbs, accumulate)


def _icrt(r, primes, inv_P, inv_P_shoup, pdivp, P_limbs, P_half, p_inv_f64,
          out_limbs: int, accumulate) -> torch.Tensor:
    """:func:`icrt` with the accumulator sum `accumulate`."""
    bits = word_bits(r)
    p = wide(primes)[:, None]
    # (1) Hadamard: temp[j,n] = mod(r[j,n]·(P/p_j)⁻¹, p_j)   [Shoup]
    temp = shoup_modmul(wide(r), wide(inv_P)[:, None],
                        wide(inv_P_shoup)[:, None], p, bits)
    # (2) accum[n] = Σ_j temp[j,n]·(P/p_j)
    accum = accumulate(temp, wide(pdivp), P_limbs.shape[0])
    # (3) mod P via the float quotient: accum/P = Σ_j temp_j/p_j exactly;
    # the f64 error is ≪ 1 (temp < p < 2^60 at either β), so ±1
    # corrections make it exact.
    s = torch.floor((temp.double() * p_inv_f64[:, None]).sum(0)).long()
    return finalize_accum(accum, s, P_limbs, P_half, out_limbs, bits=bits)


def icrt_partial(r: torch.Tensor, primes: torch.Tensor, inv_P: torch.Tensor,
                 inv_P_shoup: torch.Tensor, pdivp: torch.Tensor,
                 p_inv_f64: torch.Tensor, *, strategy: str = "matmul",
                 accum_limbs: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """iCRT up to the cross-prime sum, over the primes of one shard.

    r: (np_s, N) residues of the shard's primes, stored words of either β;
    the tables are the rows of those primes in the tables of the whole
    product P (np_s may be 0). Every strategy sums the same integer
    Σ_j temp_j·(P/p_j) over the shard's primes; they differ in how, and so
    in the form of the sum they leave. Returns (lo, hi, qsum):

      "matmul" at β = 2^32 (the split kernels' form):
        lo, hi  int64 (N, PL): column k's sum Σ_j temp_j·pdivp[j, k] as
                lo + hi·2^32 with lo < 2^32 (the canonical pair); the sum
                is Σ_k (lo_k + hi_k·2^32)·β^k;
      "acc3" (and "matmul" at β = 2^64, which runs as acc3, as in
        :func:`icrt`): each (n, k)'s three-word sum a0 + a1·β + a2·β² of
        Σ_j temp_j·pdivp[j, k], its words placed at limbs k, k + 1 and
        k + 2 and not carried;
      "naive": the shard's BigInt accumulator (paper Algo 5), A limbs;

      for "acc3" and "naive", lo is the sum as 32-bit column sums, int64
      (N, A·β/2^32) with A = `accum_limbs` (the width of P_limbs): column
      c weighs 2^(32c); a 64-bit word is split into its two halves, at
      columns 2k and 2k + 1. hi is None.
      qsum  f64 (N,): Σ_j temp_j·p_inv_j, summed over j in order, each
            product and each sum rounded (no fused multiply-add), with no
            floor.

    Summing these over the shards of P's primes (in any grouping, the
    same strategy on every shard) and calling :func:`icrt_finish` gives
    :func:`icrt`'s words. Bounds on a column after a sum over g shards,
    with np ≤ 122 primes below 2^31 at β = 2^32 and np ≤ 61 below 2^60
    at β = 2^64:

      matmul: temp_j < 2^31 and a pdivp word < 2^32, so a product is
        below 2^63; its low halves sum below 122·2^32 < 2^39 and its high
        halves below 122·2^31 < 2^38. So lo < 2^32 and hi < 2^38 + 2^7 on
        one shard, and lo < g·2^32 and hi < g·(2^38 + 2^7) after g;
      acc3: a0 and a1 are words; a2 counts the carries out of two words
        of a sum below np·β² (β = 2^32: below 2^7; β = 2^64: below 2^6).
        A 32-bit column takes one half of each of at most three words,
        so it is below 3·2^32 < 2^34, and below g·2^34 after g;
      naive: a column is a half of a canonical limb, below 2^32, and
        below g·2^32 after g;

    each far below 2^62, where :func:`icrt_finish`'s carry stays exact in
    int64, for any g < 2^27. The shard's sum itself is below the whole
    sum, which is below β^A, so the columns past A·β/2^32 are zero and
    are not kept.
    """
    bits = word_bits(r)
    if strategy not in _ACCUM:
        raise ValueError(f"unknown iCRT strategy {strategy!r}")
    if bits == 64 and strategy == "matmul":
        strategy = "acc3"
    p = wide(primes)[:, None]
    temp = shoup_modmul(wide(r), wide(inv_P)[:, None],
                        wide(inv_P_shoup)[:, None], p, bits)
    pd = wide(pdivp)
    N, PL = r.shape[1], pd.shape[1]
    qsum = torch.zeros(N, dtype=torch.float64, device=r.device)
    for j in range(temp.shape[0]):
        qsum = qsum + temp[j].double() * p_inv_f64[j]
    if strategy == "matmul":
        lo = torch.zeros((N, PL), dtype=torch.int64, device=r.device)
        hi = torch.zeros_like(lo)
        for j in range(temp.shape[0]):
            prod = temp[j][:, None] * pd[j][None, :]       # < 2^63
            lo += prod & M32
            hi += prod >> 32
        hi += lo >> 32
        return lo & M32, hi, qsum
    if accum_limbs is None:
        raise ValueError(f"iCRT {strategy!r} partials need accum_limbs")
    if strategy == "acc3":
        a2 = a1 = a0 = torch.zeros((N, PL), dtype=torch.int64,
                                   device=r.device)
        for j in range(temp.shape[0]):
            a2, a1, a0 = acc3_add_product(a2, a1, a0, temp[j][:, None],
                                          pd[j][None, :], bits)
        cols = sum(_halves(_placed(a, k, accum_limbs), bits)
                   for k, a in enumerate((a0, a1, a2)))
    else:
        cols = _halves(_accum_naive(temp, pd, accum_limbs, bits), bits)
    return cols, None, qsum


def _halves(limbs: torch.Tensor, bits: int) -> torch.Tensor:
    """(N, A) words of β = 2^bits -> (N, A·bits/32) 32-bit columns: a
    64-bit word's low half at column 2k, its high half at 2k + 1."""
    if bits == 32:
        return limbs
    N, A = limbs.shape
    return torch.stack([limbs & M32, (limbs >> 32) & M32], -1).reshape(
        N, 2 * A)


def icrt_finish(lo: torch.Tensor, hi: torch.Tensor | None,
                qsum: torch.Tensor, P_limbs: torch.Tensor,
                P_half: torch.Tensor, out_limbs: int) -> torch.Tensor:
    """iCRT after the cross-prime sum: (lo, hi, qsum) summed over every
    shard of P's primes (see :func:`icrt_partial`) -> (N, out_limbs)
    centered two's complement, the words of :func:`icrt`, of the word
    size of P_limbs.

    The matmul form: lo goes to column k and hi to column k + 1 of the
    accumulator (β = 2^32). The column form (hi None): lo's 32-bit
    columns. Either is carried into limbs; s = ⌊qsum⌋ and
    :func:`finalize_accum` do the rest. The f64 quotient is exact only
    through the ±1 ladder there: qsum estimates Σ_j temp_j/p_j, a sum of
    np ≤ 122 terms each in [0, 1) (temp_j < p_j < 2^60 at either β).
    Each 1/p_j is rounded (relative error 2^-53), each product and each
    partial sum (below 2^7, so an error of at most 2^-46 each) too, and a
    sum across g shards adds g − 1 more roundings of the same size: the
    error stays below 2^-37 whatever the grouping and order, far below 1.
    So ⌊qsum⌋ is the true quotient or one off it in either direction, even
    where the sum lies within 2^-40 of an integer, and the ladder makes
    the result exact. The sum across ranks may round otherwise than one
    rank's: the words do not change.
    """
    bits = word_bits(P_limbs)
    A = P_limbs.shape[0]
    N = lo.shape[0]
    if hi is not None:
        PL = lo.shape[1]
        cols = torch.zeros((N, A), dtype=torch.int64, device=lo.device)
        cols[:, :PL] += lo
        cols[:, 1: PL + 1] += hi
        accum = _carry_columns(cols)
    else:
        limbs = _carry_columns(lo)          # 32-bit limbs, < β^A
        accum = limbs if bits == 32 else \
            limbs[:, 0::2] | (limbs[:, 1::2] << 32)
    s = torch.floor(qsum).long()
    return finalize_accum(accum, s, P_limbs, P_half, out_limbs, bits=bits)


def _carry_columns(cols: torch.Tensor) -> torch.Tensor:
    """(N, A) column sums (int64, < 2^62) -> (N, A) limbs, carried up."""
    out = torch.empty_like(cols)
    carry = torch.zeros(cols.shape[0], dtype=torch.int64, device=cols.device)
    for k in range(cols.shape[1]):
        v = cols[:, k] + carry
        out[:, k] = v & M32
        carry = v >> 32
    return out


def _accum_matmul(temp: torch.Tensor, pdivp: torch.Tensor,
                  accum_limbs: int) -> torch.Tensor:
    """Loop-reordered Algo 6 on 16-bit halves of the P/p_j limbs."""
    N, PL = temp.shape[1], pdivp.shape[1]
    s_lo = torch.zeros((N, PL), dtype=torch.int64, device=temp.device)
    s_hi = torch.zeros_like(s_lo)
    for j in range(temp.shape[0]):                     # sums < np·2^46
        s_lo += temp[j][:, None] * (pdivp[j] & 0xFFFF)
        s_hi += temp[j][:, None] * (pdivp[j] >> 16)
    # value_k = s_lo + s_hi·2^16 contributes to limbs k and k+1
    cols = torch.zeros((N, accum_limbs), dtype=torch.int64,
                       device=temp.device)
    cols[:, :PL] += (s_lo & M32) + ((s_hi & 0xFFFF) << 16)
    cols[:, 1: PL + 1] += (s_lo >> 32) + (s_hi >> 16)
    return _carry_columns(cols)


def _accum_acc3(temp: torch.Tensor, pdivp: torch.Tensor,
                accum_limbs: int, bits: int = 32) -> torch.Tensor:
    """Algo 6 with per-(n, k) three-word accumulators (GPU-C flavour)."""
    N, PL = temp.shape[1], pdivp.shape[1]
    a2 = a1 = a0 = torch.zeros((N, PL), dtype=torch.int64,
                               device=temp.device)
    for j in range(temp.shape[0]):
        a2, a1, a0 = acc3_add_product(a2, a1, a0, temp[j][:, None],
                                      pdivp[j][None, :], bits)
    # assemble Σ_k (a0 + a1β + a2β²)_k · β^k with three shifted adds
    acc = _placed(a0, 0, accum_limbs)
    acc = bigint.add(acc, _placed(a1, 1, accum_limbs), bits=bits)
    return bigint.add(acc, _placed(a2, 2, accum_limbs), bits=bits)


def _accum_naive(temp: torch.Tensor, pdivp: torch.Tensor,
                 accum_limbs: int, bits: int = 32) -> torch.Tensor:
    """Paper Algo 5: a word × BigInt product and a BigInt add per prime
    (N-parallel only; the slow baseline)."""
    N, PL = temp.shape[1], pdivp.shape[1]
    acc = torch.zeros((N, accum_limbs), dtype=torch.int64,
                      device=temp.device)
    for j in range(temp.shape[0]):
        row = _placed(pdivp[j].expand(N, PL), 0, accum_limbs)
        acc = bigint.add(acc, bigint.mul_word(row, temp[j], bits=bits),
                         bits=bits)
    return acc


def _accum_columns(temp: torch.Tensor, pdivp: torch.Tensor,
                   accum_limbs: int) -> torch.Tensor:
    """Σ_j temp[j, n]·pdivp[j] as (N, accum_limbs) limbs (int64 words).

    Column k holds Σ_j temp_j·pdivp[j, k] = lo_k + hi_k·β; limb k of the
    sum is lo_k + hi_(k-1) plus the running carry.
    """
    N, PL = temp.shape[1], pdivp.shape[1]
    lo = torch.zeros((N, PL), dtype=torch.int64, device=temp.device)
    hi = torch.zeros_like(lo)
    for j in range(temp.shape[0]):
        prod = temp[j][:, None] * pdivp[j][None, :]    # < 2^62
        lo += prod & M32
        hi += prod >> 32
    cols = torch.zeros((N, accum_limbs), dtype=torch.int64,
                       device=temp.device)
    cols[:, :PL] += lo
    cols[:, 1: PL + 1] += hi
    return _carry_columns(cols)


def _placed(words: torch.Tensor, offset: int, accum_limbs: int
            ) -> torch.Tensor:
    """(N, PL) words -> (N, accum_limbs) BigInt shifted by `offset` limbs.

    Words beyond the accumulator width are provably zero and are dropped.
    """
    N, PL = words.shape
    keep = min(PL, accum_limbs - offset)
    out = torch.zeros((N, accum_limbs), dtype=words.dtype,
                      device=words.device)
    out[:, offset: offset + keep] = words[:, :keep]
    return out


_ACCUM = {"matmul": _accum_matmul, "acc3": _accum_acc3,
          "naive": _accum_naive}


def finalize_accum(accum, s, P_limbs, P_half, out_limbs: int, *,
                   bits: int = 32):
    """accum − s·P with ±1 quotient corrections, center-lift, truncate.

    `accum` holds int64 limbs of β = 2^bits (values at 32, bit patterns at
    64); `s` may be off by one in either direction; the correction ladder
    makes the result exact. Returns stored words of β = 2^bits.
    """
    N, accum_limbs = accum.shape
    P = wide(P_limbs)
    red = bigint.sub(accum, bigint.mul_word(P.expand(N, accum_limbs), s,
                                            bits=bits), bits=bits)
    for _ in range(2):   # s may be off by one in either direction
        neg = bigint.sign_bit(red, bits=bits)
        red = bigint.select(neg, bigint.add(red, P, bits=bits), red)
        too_big = bigint.compare_ge(red, P, bits=bits) & ~neg
        red = bigint.select(too_big, bigint.sub(red, P, bits=bits), red)

    # center-lift: v >= P/2  ⇒  v -= P  (two's complement wrap is fine)
    high = bigint.compare_ge(red, P_half, bits=bits)
    red = bigint.select(high, bigint.sub(red, P, bits=bits), red)
    if out_limbs <= accum_limbs:
        return narrow(red[:, :out_limbs], bits)
    fill = torch.where(bigint.sign_bit(red, bits=bits),
                       -1 if bits == 64 else M32, 0)
    return narrow(torch.cat(
        [red, fill[:, None].expand(N, out_limbs - accum_limbs)], -1), bits)
