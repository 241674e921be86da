"""Stage 3: EvalMod — approximate t mod q via the scaled sine.

After CoeffToSlot the slots hold u = (m + e + q·I)/Δ as complex values
(real/imag = paired coefficients). In slot units with q_s = q/Δ the
target map is

    f(x) = (q_s / 2π) · sin(2π x / q_s)        (elementwise, x real)

— periodic in q_s (so the q·I term vanishes) and ≈ x near 0 (so the
message survives, up to the cubic deviation (2π/q_s)²·x³/6 that the
pipeline's error contract states).

The evaluation is HEAAN's complex-exponential method: a short Taylor
series for exp(iθ/2^r) where |θ/2^r| ≤ 1, then r repeated squarings
(each one served mul / one level) to reach exp(iθ), then
sin θ = Im = (v − v̄)/2i via one conjugation. Both the real and the
imaginary coefficient streams need the map, so the pipeline splits
u into u ± ū, runs two evaluations, and recombines — the ±1/2 and ±i
bookkeeping constants are folded into the surrounding mul_plain
scalars so the split itself costs no extra level.

Everything here builds TRACED handles (`repro_torch.client`): level
alignment, rescales, CSE (the two shared powers of w), and plain-scalar
encoding all come from the compile pass. The order in which handles are
built is the JAX package's, so the compile pass emits the reference's
node order.
"""

from __future__ import annotations

import math

__all__ = ["exp_taylor_coeffs", "poly_eval", "eval_mod"]


def exp_taylor_coeffs(degree: int):
    """[1/k! for k ≤ degree] — exp's Taylor coefficients, precomputed
    host-side (floats; encoding quantizes them at the use level)."""
    if degree < 1:
        raise ValueError(f"need degree >= 1, got {degree}")
    return [1.0 / math.factorial(k) for k in range(degree + 1)]


def poly_eval(w, coeffs):
    """Evaluate Σ coeffs[k]·w^k over a traced handle in
    ⌈log₂(deg+1)⌉ multiplicative levels (balanced power-of-two split,
    Paterson–Stockmeyer-style), not Horner's deg levels.

    The power ladder w, w², w⁴, … is shared across both split halves —
    handle identity (plus compile-pass CSE) keeps each squaring a
    single served mul.
    """
    if len(coeffs) < 2:
        raise ValueError("need a degree >= 1 polynomial")
    pows = {1: w}
    m = 1
    while 2 * m < len(coeffs):
        pows[2 * m] = pows[m] * pows[m]
        m *= 2

    def ev(cs):
        # returns a handle when any non-constant term survives,
        # else the bare constant (folded into the parent's add)
        if len(cs) == 1:
            return cs[0]
        m = 1
        while 2 * m < len(cs):
            m *= 2
        hi = ev(cs[m:])
        lo = ev(cs[:m])
        term = pows[m] * hi                   # mul_plain or mul
        return term + lo

    return ev(list(coeffs))


def eval_mod(u, *, q_s_bits: int, degree: int, r: int):
    """The full modular-reduction stage on a complex slot vector.

    u: traced handle whose slots hold x_re + i·x_im with each part to be
       reduced mod q_s = 2^q_s_bits independently.
    degree: Taylor degree for exp(iθ/2^r).
    r: squaring count — requires |θ|/2^r ≲ 1 (the pipeline sizes r from
       the mod-raise interval bound).

    Level cost: 1 (argument scaling) + ⌈log₂(degree+1)⌉ (Taylor)
    + r (squarings) + 1 (Im extraction) — the split/recombine adds and
    conjugations are free.
    """
    q_s = 2.0 ** q_s_bits
    coeffs = exp_taylor_coeffs(degree)

    def branch(doubled, c_arg, c_out):
        # doubled = 2x (or 2i·x); w = c_arg·doubled = iθ/2^r
        w = doubled * c_arg
        v = poly_eval(w, coeffs)              # ≈ exp(iθ/2^r)
        for _ in range(r):
            v = v * v                         # ≈ exp(iθ)
        # (v − v̄) = 2i·sin θ; c_out folds 1/2i and q_s/2π (and, for the
        # imaginary branch, the recombination factor i)
        return (v - v.conj()) * c_out

    uc = u.conj()
    s_re = branch(u + uc,                     # 2·Re u
                  1j * math.pi / (q_s * 2.0 ** r),
                  -1j * q_s / (4.0 * math.pi))
    s_im = branch(u - uc,                     # 2i·Im u
                  math.pi / (q_s * 2.0 ** r),
                  q_s / (4.0 * math.pi))
    return s_re + s_im                        # f(x_re) + i·f(x_im)
