"""repro_torch's rotations and conjugation against the JAX package.

The automorphism maps, the Galois keys (rot_keygen / conj_keygen from the
same secret and seeds), he_rotate for r ∈ {1, 2, 3, 5} and he_conjugate
of the port run on CPU tensors and must give the JAX package's words; a
JAX rotation key carried into the port with ``repro_torch.convert`` gives
the same rotation, and the rotations decrypt within the 1e-3 of
tests/test_rotate.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import heaan as JH
from repro.core import rotate as jrot
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import SecretKey as JSecretKey

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.core import rotate as trot
from repro_torch.core import test_params as t_test_params
from repro_torch.core.cipher import EvalKey
from repro_torch.core.keys import keygen as t_keygen

LOGN, ROTATIONS = 5, (1, 2, 3, 5)
KEY_FIELDS = ("ax_ev", "ax_ev_shoup", "bx_ev", "bx_ev_shoup")


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _assert_ct_equal(tct, jct):
    assert (tct.logq, tct.logp, tct.n_slots) == (jct.logq, jct.logp,
                                                 jct.n_slots)
    np.testing.assert_array_equal(_np(tct.ax), np.asarray(jct.ax))
    np.testing.assert_array_equal(_np(tct.bx), np.asarray(jct.bx))


@pytest.fixture(scope="module")
def setup():
    """Both packages' Galois keys from one secret, and one ciphertext."""
    pj = j_test_params(logN=LOGN, beta_bits=32)
    pt = t_test_params(logN=LOGN, beta_bits=32)
    tsk, tpk, _ = t_keygen(pt, seed=0, device="cpu")
    jsk = JSecretKey(s=jnp.asarray(tsk.s.numpy()))
    z = np.random.default_rng(0).normal(size=8) * (1 + 0.5j)
    tct = TH.encrypt_message(z, tpk, pt, seed=1)
    jct = JCiphertext(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in convert.to_numpy(tct).items()})
    tkeys = {r: trot.rot_keygen(pt, tsk, r, device="cpu") for r in ROTATIONS}
    jkeys = {r: jrot.rot_keygen(pj, jsk, r) for r in ROTATIONS}
    tkeys["conj"] = trot.conj_keygen(pt, tsk, device="cpu")
    jkeys["conj"] = jrot.conj_keygen(pj, jsk)
    return pj, pt, tsk, z, tct, jct, tkeys, jkeys


@pytest.mark.parametrize("r", [*ROTATIONS, "conj"])
def test_automorphism_maps_match_reference(setup, r):
    pj, pt = setup[:2]
    k = trot.conjugation_k(pt) if r == "conj" else trot.rotation_k(pt, r)
    assert k == (jrot.conjugation_k(pj) if r == "conj"
                 else jrot.rotation_k(pj, r))
    for got, want in zip(trot.automorphism_maps(pt.N, k),
                         jrot.automorphism_maps(pj.N, k)):
        np.testing.assert_array_equal(got, want)
    # on a batch the automorphism indexes the coefficient axis: each item
    # is the reference's automorphism_poly of it
    words = np.random.default_rng(k).integers(
        0, 1 << 32, size=(3, pt.N, 4), dtype=np.uint64).astype(np.uint32)
    got = trot.automorphism_poly(torch.from_numpy(words.view(np.int32)), pt,
                                 k, pt.logQ)
    for i in range(3):
        np.testing.assert_array_equal(
            _np(got[i]), np.asarray(jrot.automorphism_poly(
                jnp.asarray(words[i]), pj, k, pj.logQ)))


@pytest.mark.parametrize("r", [*ROTATIONS, "conj"])
def test_galois_keys_match_reference(setup, r):
    tkey, jkey = setup[6][r], setup[7][r]
    for name in KEY_FIELDS:
        np.testing.assert_array_equal(_np(getattr(tkey, name)),
                                      np.asarray(getattr(jkey, name)))


@pytest.mark.parametrize("r", [*ROTATIONS, "conj"])
def test_rotate_and_conjugate_match_reference(setup, r):
    """Bit for bit with the JAX package, and decrypted within the 1e-3 of
    tests/test_rotate.py."""
    pj, pt, tsk, z, tct, jct, tkeys, jkeys = setup
    if r == "conj":
        tout = trot.he_conjugate(tct, tkeys[r], pt)
        jout = jrot.he_conjugate(jct, jkeys[r], pj)
        want = np.conj(z)
    else:
        tout = trot.he_rotate(tct, r, tkeys[r], pt)
        jout = jrot.he_rotate(jct, r, jkeys[r], pj)
        want = np.roll(z, -r)
    _assert_ct_equal(tout, jout)
    assert np.abs(TH.decrypt_message(tout, tsk, pt) - want).max() < 1e-3


def test_jax_rotation_key_carried_in_gives_the_same_rotation(setup):
    pj, pt, _, _, tct, jct, _, jkeys = setup
    key = convert.from_numpy(
        EvalKey, {k: np.asarray(getattr(jkeys[3], k)) for k in KEY_FIELDS},
        device="cpu")
    low_t = TH.he_mod_down(tct, pt, pt.logQ - pt.logp)
    low_j = JH.he_mod_down(jct, pj, pj.logQ - pj.logp)
    _assert_ct_equal(trot.he_rotate(low_t, 3, key, pt),
                     jrot.he_rotate(low_j, 3, jkeys[3], pj))


def test_entry_points_default_to_cuda_and_raise_without_it(setup,
                                                          monkeypatch):
    from repro_torch.dist.he_pipeline import he_static
    from repro_torch.hserve import engine
    pt, tsk = setup[1], setup[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: trot.rot_keygen(pt, tsk, 1),
                 lambda: trot.conj_keygen(pt, tsk),
                 lambda: TH.encode_plain(np.ones(4), pt, pt.logQ),
                 lambda: engine.make_he_rotate_step(
                     he_static(pt, pt.logQ), "cuda", 5),
                 lambda: engine.make_rescale_step(
                     he_static(pt, pt.logQ), "cuda", pt.logp)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
