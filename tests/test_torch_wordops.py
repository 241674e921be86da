"""repro_torch word ops and BigInt equal the JAX package's, bit for bit.

Random 32-bit words plus the wrap and carry edge values (0, 1, 2^31,
2^32−1, p−1). Words go to the port as int32 bit patterns, as the port
stores them; the int64 word ops get the widened values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core  # noqa: F401  (enables x64)
from repro.core import bigint as JB
from repro.core import wordops as JW
from repro.nt.primes import find_ntt_primes

from repro_torch.core import bigint as TB
from repro_torch.core import wordops as TW

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 dtype=np.uint32)
PRIMES = find_ntt_primes(64, 4, 28, 30)


def _words(rng, shape):
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    w = w.astype(np.uint32)
    flat = w.reshape(-1)
    flat[: len(EDGES)] = EDGES[: flat.size]
    return w


def _t(a):
    """uint32 numpy -> the port's int64 word values."""
    return torch.from_numpy(np.asarray(a, dtype=np.uint32).astype(np.int64))


def _t32(a):
    """uint32 numpy -> the port's stored int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32))


def _np(t):
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return t.numpy().astype(np.uint32)


def test_wide_narrow_roundtrip():
    w = _words(np.random.default_rng(0), (64,))
    stored = _t32(w)
    assert torch.equal(TW.wide(stored), _t(w))
    assert torch.equal(TW.narrow(_t(w)), stored)


def test_mul_wide_matches_reference():
    rng = np.random.default_rng(1)
    a, b = _words(rng, (512,)), _words(rng, (512,))
    a[:7], b[:7] = EDGES, EDGES[::-1]
    hj, lj = JW.mul_wide(jnp.asarray(a), jnp.asarray(b))
    ht, lt = TW.mul_wide(_t(a), _t(b))
    np.testing.assert_array_equal(_np(ht), np.asarray(hj))
    np.testing.assert_array_equal(_np(lt), np.asarray(lj))


@pytest.mark.parametrize("p", PRIMES)
def test_modular_ops_match_reference(p):
    rng = np.random.default_rng(p)
    n = 512
    x = (rng.integers(0, p, size=n)).astype(np.uint32)
    y = (rng.integers(0, p, size=n)).astype(np.uint32)
    x[:3], y[:3] = [0, p - 1, p - 1], [p - 1, 0, p - 1]
    ysh = ((y.astype(np.uint64) << 32) // p).astype(np.uint32)
    full = _words(rng, (n,))                 # any word, reduced by y = 1
    one = np.ones(n, np.uint32)
    one_sh = np.full(n, (1 << 32) // p, np.uint32)
    R = 1 << 32
    pp = np.uint32((-pow(p, -1, R)) % R)
    r2 = np.uint32((R * R) % p)
    pj = jnp.asarray(np.uint32(p))
    cases = [
        (JW.shoup_modmul(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ysh), pj),
         TW.shoup_modmul(_t(x), _t(y), _t(ysh), p)),
        (JW.shoup_modmul(jnp.asarray(full), jnp.asarray(one),
                         jnp.asarray(one_sh), pj),
         TW.shoup_modmul(_t(full), _t(one), _t(one_sh), p)),
        (JW.mont_modmul(jnp.asarray(x), jnp.asarray(y), pj, jnp.asarray(pp),
                        jnp.asarray(r2)),
         TW.mont_modmul(_t(x), _t(y), p, int(pp), int(r2))),
        (JW.modadd(jnp.asarray(x), jnp.asarray(y), pj),
         TW.modadd(_t(x), _t(y), p)),
        (JW.modsub(jnp.asarray(x), jnp.asarray(y), pj),
         TW.modsub(_t(x), _t(y), p)),
        (JW.cond_reduce(jnp.asarray(x) * 3 + jnp.asarray(y), pj, 4),
         TW.cond_reduce(_t(x) * 3 + _t(y), p, 4)),
    ]
    for j, t in cases:
        np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_mont_redc_matches_reference():
    rng = np.random.default_rng(3)
    p = PRIMES[0]
    R = 1 << 32
    pp = np.uint32((-pow(p, -1, R)) % R)
    hi = rng.integers(0, p, size=256).astype(np.uint32)   # t < p·β
    lo = _words(rng, (256,))
    j = JW.mont_redc(jnp.asarray(hi), jnp.asarray(lo), jnp.uint32(p),
                     jnp.asarray(pp))
    t = TW.mont_redc(_t(hi), _t(lo), p, int(pp))
    np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_acc3_chain_matches_reference():
    rng = np.random.default_rng(4)
    a, b = _words(rng, (96, 64)), _words(rng, (96, 64))
    a[:, :7], b[:, :7] = 0xFFFFFFFF, 0xFFFFFFFF          # carry storms
    accj = [jnp.zeros(64, jnp.uint32)] * 3
    acct = [torch.zeros(64, dtype=torch.int64)] * 3
    for k in range(96):
        accj = JW.acc3_add_product(*accj, jnp.asarray(a[k]),
                                   jnp.asarray(b[k]))
        acct = TW.acc3_add_product(*acct, _t(a[k]), _t(b[k]))
    for j, t in zip(accj, acct):
        np.testing.assert_array_equal(_np(t), np.asarray(j))


def _limbs(rng, rows, L, signed_edges=True):
    a = _words(rng, (rows, L))
    if signed_edges:
        a[0] = 0xFFFFFFFF                     # −1
        a[1] = 0
        a[2, :-1], a[2, -1] = 0, 0x80000000   # most negative
        a[3, :-1], a[3, -1] = 0xFFFFFFFF, 0x7FFFFFFF
    return a


@pytest.mark.parametrize("L", [1, 3, 7])
def test_bigint_ops_match_reference(L):
    rng = np.random.default_rng(10 + L)
    a, b = _limbs(rng, 16, L), _limbs(rng, 16, L)[::-1].copy()
    s = _words(rng, (16,))
    s[:3] = [0, 1, 0xFFFFFFFF]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _t32(a), _t32(b)
    cases = [
        (JB.add(ja, jb), TB.add(ta, tb)),
        (JB.sub(ja, jb), TB.sub(ta, tb)),
        (JB.neg(ja), TB.neg(ta)),
        (JB.sign_bit(ja), TB.sign_bit(ta)),
        (JB.compare_ge(ja, jb), TB.compare_ge(ta, tb)),
        (JB.compare_ge(ja, ja), TB.compare_ge(ta, ta)),
        (JB.mul_word(ja, jnp.asarray(s)), TB.mul_word(ta, _t32(s))),
        (JB.select(JB.sign_bit(ja), ja, jb),
         TB.select(TB.sign_bit(ta), ta, tb)),
        (JB.add(ja, jb[0]), TB.add(ta, tb[0])),
    ]
    for bits in (0, 5, 32, 33, 32 * L - 1, 32 * L + 3):
        cases.append((JB.mask_bits(ja, bits), TB.mask_bits(ta, bits)))
    for sh in (1, 31, 32, 45, 32 * L - 1):
        cases.append((JB.shift_left_bits(ja, sh), TB.shift_left_bits(ta, sh)))
    for j, t in cases:
        got = t.numpy() if t.dtype == torch.bool else _np(t)
        np.testing.assert_array_equal(got, np.asarray(j))
        if t.dtype != torch.bool:
            assert t.dtype == torch.int32


@pytest.mark.parametrize("L,s,out_limbs", [
    (3, 1, None), (3, 31, None), (3, 32, None), (4, 45, 2), (4, 64, 6),
    (7, 100, 3), (2, 0, 3)])
def test_shift_right_round_matches_reference(L, s, out_limbs):
    rng = np.random.default_rng(L * 1000 + s)
    a = _limbs(rng, 16, L)
    for arith in (True, False):
        j = JB.shift_right_round(jnp.asarray(a), s, arithmetic=arith,
                                 out_limbs=out_limbs)
        t = TB.shift_right_round(_t32(a), s, arithmetic=arith,
                                 out_limbs=out_limbs)
        np.testing.assert_array_equal(_np(t), np.asarray(j))


def test_mulhi_approx3_matches_reference():
    rng = np.random.default_rng(5)
    a, b = _words(rng, (512,)), _words(rng, (512,))
    a[:7], b[:7] = EDGES, EDGES[::-1]
    np.testing.assert_array_equal(
        _np(TW.mulhi_approx3(_t(a), _t(b))),
        np.asarray(JW.mulhi_approx3(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("p", PRIMES)
def test_shoup_modmul_modified_matches_reference(p):
    """Any word x (0, p−1 and 2^32−1 included) times y in [0, p)."""
    rng = np.random.default_rng(p + 1)
    x = _words(rng, (512,))
    y = rng.integers(0, p, size=512).astype(np.uint32)
    x[:4], y[:4] = [0, p - 1, 0xFFFFFFFF, 0xFFFFFFFF], [p - 1, p - 1, p - 1, 0]
    ysh = ((y.astype(np.uint64) << 32) // p).astype(np.uint32)
    want = JW.shoup_modmul_modified(jnp.asarray(x), jnp.asarray(y),
                                    jnp.asarray(ysh), jnp.uint32(p))
    got = TW.shoup_modmul_modified(_t(x), _t(y), _t(ysh), p)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(
        _np(got), (x.astype(np.uint64) * y % p).astype(np.uint32))
