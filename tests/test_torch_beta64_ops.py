"""repro_torch's rotations, plaintext ops and mod-raise at β = 2^64.

At test_params(logN = 4 and 5, beta_bits = 64) on the CPU: encode_plain,
he_mul_plain + rescale, he_add_plain, mod_raise_poly / he_mod_raise,
he_rotate and he_conjugate of the port equal the JAX package's words, and
decrypt within the reference's bounds (tests/test_heaan.py,
tests/test_rotate.py). The keys (rotation and conjugation keys included)
are made by the port and carried into JAX with ``repro_torch.convert``;
the JAX side is module-scoped so each op compiles once a ring. The tables,
transforms, he_mul and the level ops are in tests/test_torch_beta64.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import heaan as JH
from repro.core import rotate as jrot
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.core import rotate as trot
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen as t_keygen
from repro_torch.core.rns import PipelineConfig

PLAIN = PipelineConfig(use_kernels=False)
SEED = 7


def _u64(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64
    return t.cpu().numpy().view(np.uint64)


def _to_jax(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj, 64).items()})


def _assert_ct_equal(tct, jct):
    assert (tct.logq, tct.logp, tct.n_slots) == (jct.logq, jct.logp,
                                                 jct.n_slots)
    np.testing.assert_array_equal(_u64(tct.ax), np.asarray(jct.ax))
    np.testing.assert_array_equal(_u64(tct.bx), np.asarray(jct.bx))


@pytest.fixture(scope="module", params=[4, 5], ids=["logN4", "logN5"])
def world(request):
    """Both packages' params, the port's keys (rotation by 1 and
    conjugation included) with JAX copies, a message, its encryption and
    a plaintext operand, at one ring."""
    logN = request.param
    pj = j_test_params(logN=logN, beta_bits=64)
    pt = t_test_params(logN=logN, beta_bits=64)
    sk, pk, _ = t_keygen(pt, seed=SEED, cfg=PLAIN, device="cpu")
    rk = trot.rot_keygen(pt, sk, 1, cfg=PLAIN, device="cpu")
    ck = trot.conj_keygen(pt, sk, cfg=PLAIN, device="cpu")
    rng = np.random.default_rng(logN + 10)
    z = rng.normal(size=4) + 1j * rng.normal(size=4)
    wv = rng.normal(size=4) + 1j * rng.normal(size=4)
    ct = TH.encrypt_message(z, pk, pt, seed=31, cfg=PLAIN)
    return SimpleNamespace(
        pj=pj, pt=pt, sk=sk, z=z, w=wv, ct=ct,
        jrk=_to_jax(JEvalKey, rk),
        jck=_to_jax(JEvalKey, ck), rk=rk, ck=ck,
        jct=_to_jax(JCiphertext, ct))


def _decrypt(w, tct):
    """The port's decryption (the words are already the reference's, and
    tests/test_torch_beta64.py holds decryption itself against JAX)."""
    return TH.decrypt_message(tct, w.sk, w.pt, PLAIN)


def test_encode_plain_and_plaintext_ops_match_reference(world):
    """encode_plain at two levels (two 64-bit limbs and one), he_mul_plain
    then rescale, and he_add_plain."""
    w = world
    for logq in (120, 48):
        tpt = TH.encode_plain(w.w, w.pt, logq, device="cpu")
        assert tpt.dtype == torch.int64
        np.testing.assert_array_equal(
            _u64(tpt), np.asarray(JH.encode_plain(w.w, w.pj, logq)))
    tpt = TH.encode_plain(w.w, w.pt, w.pt.logQ, device="cpu")
    jpt = JH.encode_plain(w.w, w.pj, w.pj.logQ)
    tmul = TH.rescale(TH.he_mul_plain(w.ct, tpt, w.pt, cfg=PLAIN), w.pt)
    jmul = JH.rescale(JH.he_mul_plain(w.jct, jpt, w.pj), w.pj)
    _assert_ct_equal(tmul, jmul)
    assert np.abs(_decrypt(w, tmul) - w.z * w.w).max() < 1e-3
    tadd = TH.he_add_plain(w.ct, tpt, w.pt)
    jadd = JH.he_add_plain(w.jct, jpt, w.pj)
    _assert_ct_equal(tadd, jadd)
    assert np.abs(_decrypt(w, tadd) - (w.z + w.w)).max() < 2e-4


@pytest.mark.parametrize("logq,logq2", [(48, 120), (96, 120), (48, 72)])
def test_mod_raise_matches_reference(world, logq, logq2):
    """he_mod_raise from one limb to two and within two limbs: the
    centered lift sign-fills whole 64-bit limbs."""
    w = world
    tlow = TH.he_mod_down(w.ct, w.pt, logq)
    jlow = JH.he_mod_down(w.jct, w.pj, logq)
    _assert_ct_equal(TH.he_mod_raise(tlow, w.pt, logq2),
                     JH.he_mod_raise(jlow, w.pj, logq2))
    # a batch axis passes through mod_raise_poly
    batch = torch.stack([tlow.ax, tlow.bx])
    np.testing.assert_array_equal(
        _u64(TH.mod_raise_poly(batch, w.pt, logq, logq2)),
        np.stack([np.asarray(JH.mod_raise_poly(jlow.ax, w.pj, logq, logq2)),
                  np.asarray(JH.mod_raise_poly(jlow.bx, w.pj, logq,
                                               logq2))]))


def test_rotate_matches_reference(world):
    """he_rotate by one slot under the port's rotation key."""
    w = world
    trt = trot.he_rotate(w.ct, 1, w.rk, w.pt, PLAIN)
    jrt = jrot.he_rotate(w.jct, 1, w.jrk, w.pj)
    _assert_ct_equal(trt, jrt)
    out = _decrypt(w, trt)
    assert np.abs(out - np.roll(w.z, -1)).max() < 1e-3


def test_conjugate_matches_reference(world):
    w = world
    tcj = trot.he_conjugate(w.ct, w.ck, w.pt, PLAIN)
    jcj = jrot.he_conjugate(w.jct, w.jck, w.pj)
    _assert_ct_equal(tcj, jcj)
    out = _decrypt(w, tcj)
    assert np.abs(out - np.conj(w.z)).max() < 1e-3
