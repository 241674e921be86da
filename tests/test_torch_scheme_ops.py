"""repro_torch's remaining scheme ops against the JAX package, bit for bit.

he_sub, he_neg, encode_plain, he_mul_plain, he_add_plain,
mod_raise_poly / he_mod_raise, rns.poly_mul and encoding.message_hash of
the port run on CPU tensors (the plain versions of the kernels) and must
give the JAX package's words and strings. The keys and ciphertexts are
made by the port (bit for bit the JAX package's, tests/test_torch_heaan.py)
and carried into JAX with ``repro_torch.convert``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import heaan as JH
from repro.core import rns as jrns
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.context import build_global_tables as j_build_global_tables
from repro.core.encoding import message_hash as j_message_hash

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.core import rns as trns
from repro_torch.core import test_params as t_test_params
from repro_torch.core.context import device_tables
from repro_torch.core.encoding import message_hash
from repro_torch.core.keys import keygen as t_keygen

LOGN, LOGQ, LOGP, SEED = 5, 120, 24, 7
CPU = torch.device("cpu")


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _to_jax(obj):
    return JCiphertext(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                          else v for k, v in convert.to_numpy(obj).items()})


def _assert_ct_equal(tct, jct):
    assert (tct.logq, tct.logp, tct.n_slots) == (jct.logq, jct.logp,
                                                 jct.n_slots)
    np.testing.assert_array_equal(_np(tct.ax), np.asarray(jct.ax))
    np.testing.assert_array_equal(_np(tct.bx), np.asarray(jct.bx))


@pytest.fixture(scope="module")
def setup():
    pj = j_test_params(logN=LOGN, beta_bits=32, logQ=LOGQ, logp=LOGP)
    pt = t_test_params(logN=LOGN, beta_bits=32, logQ=LOGQ, logp=LOGP)
    sk, pk, _ = t_keygen(pt, seed=SEED, device="cpu")
    rng = np.random.default_rng(3)
    zs = [rng.normal(size=8) + 1j * rng.normal(size=8) for _ in range(2)]
    tcts = [TH.encrypt_message(z, pk, pt, seed=30 + i)
            for i, z in enumerate(zs)]
    return pj, pt, sk, zs, tcts, [_to_jax(c) for c in tcts]


def test_sub_and_neg_match_reference(setup):
    pj, pt, sk, (z1, z2), (t1, t2), (j1, j2) = setup
    tsub = TH.he_sub(t1, t2)
    _assert_ct_equal(tsub, JH.he_sub(j1, j2))
    _assert_ct_equal(TH.he_neg(t1), JH.he_neg(j1))
    assert np.abs(TH.decrypt_message(tsub, sk, pt) - (z1 - z2)).max() < 1e-3


@pytest.mark.parametrize("logq,log_delta", [(120, None), (96, None),
                                            (72, 20)])
def test_encode_plain_matches_reference(setup, logq, log_delta):
    pj, pt = setup[:2]
    w = np.random.default_rng(logq).normal(size=8) * (1 - 2j)
    got = TH.encode_plain(w, pt, logq, log_delta=log_delta, device="cpu")
    assert got.dtype == torch.int32 and got.device == CPU
    assert got.shape == (pt.N, pt.qlimbs(logq))
    np.testing.assert_array_equal(
        _np(got), np.asarray(JH.encode_plain(w, pj, logq,
                                             log_delta=log_delta)))


@pytest.mark.parametrize("logq", [120, 96])
def test_plain_ops_match_reference(setup, logq):
    """mul_plain / add_plain at two levels, as tests/test_hserve.py serves
    them; decrypted within its 1e-2."""
    pj, pt, sk, (z, _), (t1, _), (j1, _) = setup
    if logq < pt.logQ:
        t1, j1 = TH.he_mod_down(t1, pt, logq), JH.he_mod_down(j1, pj, logq)
    w = np.random.default_rng(logq + 1).normal(size=8) + 0.5j
    tpt = TH.encode_plain(w, pt, logq, device="cpu")
    jpt = JH.encode_plain(w, pj, logq)
    tmul = TH.he_mul_plain(t1, tpt, pt)
    _assert_ct_equal(tmul, JH.he_mul_plain(j1, jpt, pj))
    tadd = TH.he_add_plain(t1, tpt, pt)
    _assert_ct_equal(tadd, JH.he_add_plain(j1, jpt, pj))
    got = TH.decrypt_message(TH.rescale(tmul, pt), sk, pt)
    np.testing.assert_allclose(got, z * w, atol=1e-2)
    np.testing.assert_allclose(TH.decrypt_message(tadd, sk, pt), z + w,
                               atol=1e-2)


# logq a multiple of 32 (r = 0) and not (r ≠ 0), raised to logQ and below
@pytest.mark.parametrize("logq,logq2", [(96, 120), (64, 100), (72, 120),
                                        (48, 96)])
def test_mod_raise_matches_reference(setup, logq, logq2):
    pj, pt, sk, (z, _), (t1, _), (j1, _) = setup
    tlow, jlow = TH.he_mod_down(t1, pt, logq), JH.he_mod_down(j1, pj, logq)
    _assert_ct_equal(TH.he_mod_raise(tlow, pt, logq2),
                     JH.he_mod_raise(jlow, pj, logq2))
    # every sign and word pattern: random limbs with the sign bit both ways
    rng = np.random.default_rng(logq)
    words = rng.integers(0, 1 << 32, size=(3, pt.N, pt.qlimbs(logq)),
                         dtype=np.uint64).astype(np.uint32)
    got = TH.mod_raise_poly(torch.from_numpy(words.view(np.int32)), pt,
                            logq, logq2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _np(got), np.asarray(JH.mod_raise_poly(jnp.asarray(words), pj,
                                               logq, logq2)))


def test_poly_mul_matches_reference(setup):
    pj, pt = setup[:2]
    rng = np.random.default_rng(9)
    x = rng.integers(0, 1 << 32, size=(pt.N, 2), dtype=np.uint64)
    y = rng.integers(0, 1 << 32, size=(pt.N, 3), dtype=np.uint64)
    x[:, 1] &= (1 << 18) - 1                        # 50-bit coefficients
    y[:, 2] &= (1 << 8) - 1                         # 72-bit coefficients
    x, y = x.astype(np.uint32), y.astype(np.uint32)
    got = trns.poly_mul(torch.from_numpy(x.view(np.int32)),
                        torch.from_numpy(y.view(np.int32)), 50, 72, pt,
                        device_tables(pt, CPU), 5)
    want = jrns.poly_mul(jnp.asarray(x), jnp.asarray(y), 50, 72, pj,
                         j_build_global_tables(pj), 5)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("z,log_delta", [
    (np.arange(8) * (1 + 1j), 24),
    (np.arange(8) * (1 + 1j), 30),
    (np.linspace(-1, 1, 5), 24),
    ([0.5, -0.25j], 40),
])
def test_message_hash_matches_reference(z, log_delta):
    assert message_hash(z, log_delta) == j_message_hash(z, log_delta)
