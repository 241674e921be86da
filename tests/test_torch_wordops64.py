"""repro_torch's β = 2^64 word ops and BigInt equal the JAX package's on
uint64, bit for bit.

The port holds a 64-bit word as the int64 with its bit pattern: products
wrap mod 2^64, right shifts are masked to be logical and unsigned
compares flip the sign bit. The edge words 0, 1, p−1, 2^32−1, 2^32,
2^63−1, 2^63 and 2^64−1 are in every operand, with random words and the
primes of find_ntt_primes(64, 6, 57, 60). Also here: the Shoup companion
long division against python ints, the β = 2^64 samplers and limb
conversions against the reference's, and convert's uint64 round trip.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core  # noqa: F401  (enables x64)
from repro.core import bigint as JB
from repro.core import keys as jkeys
from repro.core import rns as jrns
from repro.core import wordops as JW
from repro.core.cipher import Ciphertext as JCiphertext
from repro.nt.primes import find_ntt_primes

from repro_torch import convert
from repro_torch.core import bigint as TB
from repro_torch.core import rns as trns
from repro_torch.core import wordops as TW
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.keys import sample_uniform_limbs

EDGES = [0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1]
PRIMES = find_ntt_primes(64, 6, 57, 60)


def _words(rng, shape, extra=()):
    w = rng.integers(0, 2**64, size=shape, dtype=np.uint64)
    flat = w.reshape(-1)
    edges = np.array(EDGES + list(extra), dtype=np.uint64)
    flat[: min(len(edges), flat.size)] = edges[: flat.size]
    return w


def _t(a):
    """uint64 numpy -> the port's int64 words (bit patterns)."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64))


def _i64(v) -> int:
    """A u64 word as the python int of its int64 bit pattern (a torch
    scalar)."""
    v = int(v)
    return v - 2**64 if v >= 2**63 else v


def _np(t):
    if t.dtype == torch.bool:
        return t.numpy()
    assert t.dtype == torch.int64
    return t.numpy().view(np.uint64)


def test_word_bits_wide_narrow():
    w = _words(np.random.default_rng(0), (16,))
    t = _t(w)
    assert TW.word_bits(t) == 64 and TW.word_bits(t.to(torch.int32)) == 32
    assert TW.wide(t) is t and TW.narrow(t, 64) is t
    with pytest.raises(TypeError):
        TW.word_bits(t.double())
    a, b = _words(np.random.default_rng(1), (2, 64))
    np.testing.assert_array_equal(TW.ult(_t(a), _t(b)).numpy(), a < b)


def test_products_wrap_mod_2_64():
    """int64 products and sums wrap mod 2^64 (the property every β = 2^64
    op relies on), on the edge words."""
    e = np.array(EDGES, dtype=np.uint64)
    a, b = np.repeat(e, len(e)), np.tile(e, len(e))
    want = np.array([(int(x) * int(y)) % 2**64 for x, y in zip(a, b)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(_np(_t(a) * _t(b)), want)
    np.testing.assert_array_equal(_np(_t(a) + _t(b)), a + b)


def test_mul_wide_and_mulhi_approx3_match_reference():
    rng = np.random.default_rng(2)
    a, b = _words(rng, (512,)), _words(rng, (512,))
    b[: len(EDGES)] = np.array(EDGES[::-1], dtype=np.uint64)
    hj, lj = JW.mul_wide(jnp.asarray(a), jnp.asarray(b))
    ht, lt = TW.mul_wide(_t(a), _t(b), 64)
    np.testing.assert_array_equal(_np(ht), np.asarray(hj))
    np.testing.assert_array_equal(_np(lt), np.asarray(lj))
    full = [int(x) * int(y) for x, y in zip(a, b)]
    assert [int(h) for h in _np(ht)] == [v >> 64 for v in full]
    np.testing.assert_array_equal(
        _np(TW.mulhi_approx3(_t(a), _t(b), 64)),
        np.asarray(JW.mulhi_approx3(jnp.asarray(a), jnp.asarray(b))))


def _operands(p, seed, n=512):
    """x, y in [0, p) with 0 and p−1, y's Shoup companion, any word, and
    the Montgomery constants of p."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, p, size=n, dtype=np.uint64)
    y = rng.integers(0, p, size=n, dtype=np.uint64)
    x[:3], y[:3] = [0, p - 1, p - 1], [p - 1, 0, p - 1]
    ysh = np.array([(int(v) << 64) // p for v in y], dtype=np.uint64)
    R = 1 << 64
    return x, y, ysh, _words(rng, (n,), [p - 1, p]), \
        np.uint64((-pow(p, -1, R)) % R), np.uint64(R * R % p)


@pytest.mark.parametrize("p", PRIMES)
def test_modular_ops_match_reference(p):
    x, y, ysh, full, pprime, r2 = _operands(p, p % 1000)
    jx, jy, jsh = jnp.asarray(x), jnp.asarray(y), jnp.asarray(ysh)
    jp = jnp.uint64(p)
    tx, ty, tsh = _t(x), _t(y), _t(ysh)
    tp = p                                    # p < 2^60: its own int64
    cases = [
        (JW.modadd(jx, jy, jp), TW.modadd(tx, ty, tp)),
        (JW.modsub(jx, jy, jp), TW.modsub(tx, ty, tp)),
        (JW.cond_reduce(jx + jy + jy, jp, 3), TW.cond_reduce(
            tx + ty + ty, tp, 3)),
        (JW.shoup_modmul(jx, jy, jsh, jp),
         TW.shoup_modmul(tx, ty, tsh, tp, 64)),
        (JW.shoup_modmul_modified(jx, jy, jsh, jp),
         TW.shoup_modmul_modified(tx, ty, tsh, tp, 64)),
        (JW.mont_modmul(jx, jy, jp, pprime, r2),
         TW.mont_modmul(tx, ty, tp, _i64(pprime), _i64(r2), 64)),
    ]
    for j, t in cases:
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    want = np.array([int(a) * int(b) % p for a, b in zip(x, y)],
                    dtype=np.uint64)
    np.testing.assert_array_equal(_np(cases[3][1]), want)
    # any 64-bit word times y = 1 reduces it (the CRT fold's k = 0 term)
    one_sh = np.uint64((1 << 64) // p)
    jr = JW.shoup_modmul(jnp.asarray(full), jnp.uint64(1), one_sh, jp)
    tr = TW.shoup_modmul(_t(full), 1, _i64(one_sh), tp, 64)
    np.testing.assert_array_equal(_np(tr), np.asarray(jr))
    np.testing.assert_array_equal(_np(tr), full % np.uint64(p))


@pytest.mark.parametrize("p", PRIMES[:2])
def test_mont_redc_matches_reference(p):
    """REDC on (hi, lo) = a·b for any words a, b of which one is < p."""
    rng = np.random.default_rng(p % 997)
    a = rng.integers(0, p, size=256, dtype=np.uint64)
    b = _words(rng, (256,))
    hj, lj = JW.mul_wide(jnp.asarray(a), jnp.asarray(b))
    ht, lt = TW.mul_wide(_t(a), _t(b), 64)
    pprime = (-pow(p, -1, 1 << 64)) % (1 << 64)
    want = JW.mont_redc(hj, lj, jnp.uint64(p), jnp.uint64(pprime))
    got = TW.mont_redc(ht, lt, p, _i64(pprime), 64)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_acc3_add_product_matches_reference():
    """Chains of products into a three-word accumulator that carries at
    every word (the accumulators start at the edge words)."""
    rng = np.random.default_rng(4)
    acc = [_words(rng, (256,)) for _ in range(3)]
    jacc = [jnp.asarray(a) for a in acc]
    tacc = [_t(a) for a in acc]
    for step in range(6):
        a, b = _words(rng, (256,)), _words(rng, (256,))
        jacc = list(JW.acc3_add_product(*jacc, jnp.asarray(a),
                                        jnp.asarray(b)))
        tacc = list(TW.acc3_add_product(*tacc, _t(a), _t(b), 64))
        for j, t in zip(jacc, tacc):
            np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("p", PRIMES[:3])
def test_shoup_companion_is_the_python_int_quotient(p):
    rng = np.random.default_rng(p % 991)
    v = rng.integers(0, p, size=(2, 300), dtype=np.uint64)
    v[0, :3] = [0, 1, p - 1]
    primes = _t(np.array([p, p], dtype=np.uint64))
    got = _np(TW.shoup_companion(_t(v), primes, 64))
    assert [int(q) for q in got.reshape(-1)] == \
        [(int(x) << 64) // p for x in v.reshape(-1)]
    with pytest.raises(ValueError, match="below 2\\^60"):
        TW.shoup_companion(_t(v), _t(np.array([2**61 + 1] * 2,
                                              dtype=np.uint64)), 64)


def _limbs(rng, rows, L):
    a = _words(rng, (rows, L))
    a[0] = 2**64 - 1                          # −1
    a[1] = 0
    a[2, :-1], a[2, -1] = 0, 2**63            # most negative
    a[3, :-1], a[3, -1] = 2**64 - 1, 2**63 - 1
    a[4, :] = 2**63                           # every limb at the sign bit
    return a


@pytest.mark.parametrize("L", [1, 2, 3, 5])
def test_bigint_ops_match_reference(L):
    rng = np.random.default_rng(20 + L)
    a, b = _limbs(rng, 16, L), _limbs(rng, 16, L)[::-1].copy()
    b[5] = a[5]                               # equal rows
    s = _words(rng, (16,))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t(a), _t(b)
    cases = [
        (JB.add(ja, jb), TB.add(ta, tb)),
        (JB.sub(ja, jb), TB.sub(ta, tb)),
        (JB.neg(ja), TB.neg(ta)),
        (JB.sign_bit(ja), TB.sign_bit(ta)),
        (JB.compare_ge(ja, jb), TB.compare_ge(ta, tb)),
        (JB.compare_ge(jb, ja), TB.compare_ge(tb, ta)),
        (JB.compare_ge(ja, ja), TB.compare_ge(ta, ta)),
        (JB.mul_word(ja, jnp.asarray(s)), TB.mul_word(ta, _t(s))),
        (JB.select(JB.sign_bit(ja), ja, jb),
         TB.select(TB.sign_bit(ta), ta, tb)),
        (JB.add(ja, jb[0]), TB.add(ta, tb[0])),
    ]
    for bits in (0, 5, 63, 64, 65, 64 * L - 1, 64 * L + 3):
        cases.append((JB.mask_bits(ja, bits), TB.mask_bits(ta, bits)))
    for sh in (1, 31, 63, 64, 65, 100, 64 * L - 1):
        cases.append((JB.shift_left_bits(ja, sh),
                      TB.shift_left_bits(ta, sh)))
    for j, t in cases:
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("L,s,out_limbs", [
    (2, 1, None), (2, 63, None), (2, 64, None), (3, 90, 2), (3, 128, 4),
    (4, 200, 2), (2, 0, 3), (3, 64, 5)])
def test_shift_right_round_matches_reference(L, s, out_limbs):
    rng = np.random.default_rng(L * 1000 + s)
    a = _limbs(rng, 16, L)
    for arith in (True, False):
        j = JB.shift_right_round(jnp.asarray(a), s, arithmetic=arith,
                                 out_limbs=out_limbs)
        t = TB.shift_right_round(_t(a), s, arithmetic=arith,
                                 out_limbs=out_limbs)
        np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_samplers_and_limb_conversions_match_reference():
    """The β = 2^64 uniform limbs (two draws a limb, the reference's
    order), small signed ints sign-filled across 64-bit limbs, and the
    centered lift of decryption."""
    for bits, L in ((120, 2), (240, 4), (100, 2)):
        got = sample_uniform_limbs(np.random.default_rng(bits), 16, bits,
                                   L, torch.device("cpu"), 64)
        want = jkeys.sample_uniform_limbs(np.random.default_rng(bits), 16,
                                          bits, L, 64)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    v = np.array([0, 1, -1, 5, -7, 2**40, -(2**40)], dtype=np.int64)
    for L in (1, 2, 3):
        got = trns.small_ints_to_limbs(v, L, torch.device("cpu"), 64)
        np.testing.assert_array_equal(
            _np(got), np.asarray(jrns.small_ints_to_limbs(v, L, 64)))
        assert trns.limbs_to_centered_ints(got, 64 * L - 1) == \
            jrns.limbs_to_centered_ints(_np(got), 64, 64 * L - 1)


def test_convert_round_trips_uint64_words():
    """uint64 arrays come in as int64 bit patterns and go back as uint64
    with beta_bits=64; at the default β = 2^32 int64 stays int64."""
    rng = np.random.default_rng(9)
    ax, bx = _words(rng, (8, 2)), _words(rng, (8, 2))
    jct = JCiphertext(ax=jnp.asarray(ax), bx=jnp.asarray(bx), logq=120,
                      logp=24, n_slots=4)
    fields = {k: np.asarray(v) if hasattr(v, "shape") else v
              for k, v in vars(jct).items()}
    tct = convert.from_numpy(Ciphertext, fields, device="cpu")
    assert tct.ax.dtype == torch.int64
    back = convert.to_numpy(tct, 64)
    assert back["ax"].dtype == np.uint64 and back["logq"] == 120
    np.testing.assert_array_equal(back["ax"], ax)
    np.testing.assert_array_equal(back["bx"], bx)
    assert convert.to_numpy(tct)["ax"].dtype == np.int64
    with pytest.raises(ValueError):
        convert.to_numpy(tct, 48)
