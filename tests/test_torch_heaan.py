"""repro_torch's HEAAN scheme against the JAX package, bit for bit.

keygen, encrypt_message, he_mul → rescale → decrypt_message, he_mod_down
and he_add of the port run on the CPU (the plain versions of the kernels)
from the same seeds as ``repro.core`` and must give the same words. The
decoded floats are compared exactly too: decode is the same numpy on the
same integers. convert.py carries keys and ciphertexts both ways.
"""

import numpy as np
import pytest
import torch

from repro.core import heaan as JH
from repro.core import test_params as j_test_params
from repro.core.cipher import EvalKey as JEvalKey
from repro.core.keys import keygen as j_keygen

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.core import test_params as t_test_params
from repro_torch.core.cipher import Ciphertext, EvalKey
from repro_torch.core.keys import keygen as t_keygen
from repro_torch.core.rns import PipelineConfig
from repro_torch.kernels import common

CPU = torch.device("cpu")
LOGN, LOGQ, LOGP, SEED = 5, 120, 24, 7


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _assert_ct_equal(tct, jct):
    assert (tct.logq, tct.logp, tct.n_slots) == (jct.logq, jct.logp,
                                                 jct.n_slots)
    np.testing.assert_array_equal(_np(tct.ax), np.asarray(jct.ax))
    np.testing.assert_array_equal(_np(tct.bx), np.asarray(jct.bx))


@pytest.fixture(scope="module")
def both():
    """(jax params, keys) and (port params, keys) from one seed."""
    pj = j_test_params(logN=LOGN, beta_bits=32, logQ=LOGQ, logp=LOGP)
    pt = t_test_params(logN=LOGN, beta_bits=32, logQ=LOGQ, logp=LOGP)
    return (pj, j_keygen(pj, seed=SEED)), \
        (pt, t_keygen(pt, seed=SEED, device="cpu"))


@pytest.fixture(scope="module")
def messages():
    rng = np.random.default_rng(2)
    return [rng.normal(size=8) + 1j * rng.normal(size=8) for _ in range(2)]


@pytest.fixture(scope="module")
def ciphertexts(both, messages):
    (pj, (_, jpk, _)), (pt, (_, tpk, _)) = both
    return ([JH.encrypt_message(z, jpk, pj, seed=14 + i)
             for i, z in enumerate(messages)],
            [TH.encrypt_message(z, tpk, pt, seed=14 + i)
             for i, z in enumerate(messages)])


def test_keygen_matches_reference(both):
    (_, (jsk, jpk, jevk)), (_, (tsk, tpk, tevk)) = both
    np.testing.assert_array_equal(tsk.s.numpy(), np.asarray(jsk.s))
    np.testing.assert_array_equal(_np(tpk.ax), np.asarray(jpk.ax))
    np.testing.assert_array_equal(_np(tpk.bx), np.asarray(jpk.bx))
    for name in ("ax_ev", "ax_ev_shoup", "bx_ev", "bx_ev_shoup"):
        np.testing.assert_array_equal(_np(getattr(tevk, name)),
                                      np.asarray(getattr(jevk, name)))


def test_encrypt_matches_reference(ciphertexts):
    for jct, tct in zip(*ciphertexts):
        _assert_ct_equal(tct, jct)


def test_he_mul_rescale_decrypt_matches_reference(both, ciphertexts,
                                                  messages):
    (pj, (jsk, _, jevk)), (pt, (tsk, _, tevk)) = both
    (j1, j2), (t1, t2) = ciphertexts
    jmul, tmul = JH.he_mul(j1, j2, jevk, pj), TH.he_mul(t1, t2, tevk, pt)
    _assert_ct_equal(tmul, jmul)
    jres, tres = JH.rescale(jmul, pj), TH.rescale(tmul, pt)
    _assert_ct_equal(tres, jres)
    jout = JH.decrypt_message(jres, jsk, pj)
    tout = TH.decrypt_message(tres, tsk, pt)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=0)
    assert np.abs(tout - messages[0] * messages[1]).max() < 1e-3


def test_mod_down_and_add_match_reference(both, ciphertexts, messages):
    """The last stage of the main path: align a fresh ciphertext to the
    product's level and add."""
    (pj, (jsk, _, jevk)), (pt, (tsk, _, tevk)) = both
    (j1, j2), (t1, t2) = ciphertexts
    jres = JH.rescale(JH.he_mul(j1, j2, jevk, pj), pj)
    tres = TH.rescale(TH.he_mul(t1, t2, tevk, pt), pt)
    jsum = JH.he_add(jres, JH.he_mod_down(j1, pj, jres.logq))
    tsum = TH.he_add(tres, TH.he_mod_down(t1, pt, tres.logq))
    _assert_ct_equal(tsum, jsum)
    out = TH.decrypt_message(tsum, tsk, pt)
    np.testing.assert_allclose(out, JH.decrypt_message(jsum, jsk, pj),
                               rtol=0, atol=0)
    z1, z2 = messages
    assert np.abs(out - (z1 * z2 + z1)).max() < 1e-3


def test_kernel_and_plain_configs_agree_on_cpu(both, ciphertexts):
    """On CPU tensors use_kernels=True takes the plain versions and counts
    no launch, so both configs give the same words."""
    (_, _), (pt, (_, _, tevk)) = both
    _, (t1, t2) = ciphertexts
    common.reset_launches()
    a = TH.he_mul(t1, t2, tevk, pt, PipelineConfig(use_kernels=True))
    b = TH.he_mul(t1, t2, tevk, pt, PipelineConfig(use_kernels=False))
    assert torch.equal(a.ax, b.ax) and torch.equal(a.bx, b.bx)
    assert sum(common.LAUNCHES.values()) == 0


def test_convert_carries_jax_state_into_the_port_and_back(both,
                                                          ciphertexts):
    """JAX keys and ciphertexts, carried across as numpy, give the JAX
    he_mul's output in the port; the port's state comes back unchanged."""
    (pj, (_, _, jevk)), (pt, _) = both
    (j1, j2), _ = ciphertexts

    def fields(obj):
        return {k: np.asarray(v) if hasattr(v, "shape") else v
                for k, v in vars(obj).items()}

    tevk = convert.from_numpy(EvalKey, fields(jevk), device="cpu")
    t1, t2 = (convert.from_numpy(Ciphertext, fields(c), device="cpu")
              for c in (j1, j2))
    assert t1.ax.dtype == torch.int32 and t1.ax.device == CPU
    tmul = TH.he_mul(t1, t2, tevk, pt)
    jmul = JH.he_mul(j1, j2, jevk, pj)
    _assert_ct_equal(tmul, jmul)

    back = convert.to_numpy(tmul)
    np.testing.assert_array_equal(back["ax"], np.asarray(jmul.ax))
    assert back["ax"].dtype == np.uint32 and back["logq"] == jmul.logq
    jback = JEvalKey(**convert.to_numpy(tevk))
    for name in ("ax_ev", "bx_ev_shoup"):
        np.testing.assert_array_equal(np.asarray(getattr(jback, name)),
                                      np.asarray(getattr(jevk, name)))
