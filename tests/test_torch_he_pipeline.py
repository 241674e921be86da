"""repro_torch's batched HE Mul step against the JAX package's, bit for bit.

The JAX step (``repro.dist.he_pipeline.make_he_mul_step``) runs on a (1, 1)
mesh with Auto axes; its Pallas rungs run in interpret mode on the CPU. The
port's step (``repro_torch.dist.he_pipeline``) runs on CPU tensors, where
the kernel wrappers take their plain versions. Both get the same keys and
ciphertexts and must give the same words, which must also be
``repro.core.heaan.he_mul`` of each pair. The keys and ciphertexts are
made once, by the port's keygen and encrypt (bit for bit the JAX package's,
tests/test_torch_heaan.py), and carried into JAX with
``repro_torch.convert``; the JAX package's keygen would cost the file
seconds of compilation.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.core import heaan as JH
from repro.core import make_context as j_make_context
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.dist import he_pipeline as jhp

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.core import make_context
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen as t_keygen
from repro_torch.dist import he_pipeline as thp
from repro_torch.kernels import common

LOGN, B = 5, 2
# the paper's ladder rungs the step is checked on: defaults, the Pallas
# kernels, Mod-2 CRT with modified Shoup on the kernels, and three plain
# strategy mixes
CONFIGS = {
    "defaults": {},
    "kernels": {"use_kernels": True},
    "kernels-mod2-modified": {"use_kernels": True, "crt_strategy": "mod2",
                              "modified_shoup": True},
    "mod4-naive-modified": {"crt_strategy": "mod4", "icrt_strategy": "naive",
                            "modified_shoup": True},
    "shoup-acc3": {"crt_strategy": "shoup", "icrt_strategy": "acc3"},
}


def _np(t):
    return t.numpy().view(np.uint32)


def _to_jax(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj).items()})


@pytest.fixture(scope="module")
def setup():
    """Keys, B ciphertext pairs and tables on both sides, from one seed."""
    pj = j_test_params(logN=LOGN, beta_bits=32)
    pt = t_test_params(logN=LOGN, beta_bits=32)
    _, tpk, tevk = t_keygen(pt, seed=3, device="cpu")
    rng = np.random.default_rng(5)
    tcts = [TH.encrypt_message(rng.normal(size=4) + 1j * rng.normal(size=4),
                               tpk, pt, seed=20 + i) for i in range(2 * B)]
    cts = [_to_jax(JCiphertext, c) for c in tcts]
    jevk = _to_jax(JEvalKey, tevk)
    refs = [JH.he_mul(cts[2 * i], cts[2 * i + 1], jevk, pj)
            for i in range(B)]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jctx = j_make_context(pj, pj.logQ)
    jargs = [jnp.stack([getattr(c, f) for c in cts[s::2]])
             for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
    targs = [torch.stack([getattr(c, f) for c in tcts[s::2]])
             for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
    tctx = make_context(pt, pt.logQ, "cpu")
    return {
        "jax": (jhp.he_static(pj, pj.logQ), mesh,
                jhp.runtime_tables(jctx, jevk), jargs),
        "port": (thp.he_static(pt, pt.logQ), thp.runtime_tables(tctx, tevk),
                 targs),
        "refs": refs,
    }


def test_tables_match_reference(setup):
    _, _, jtabs, _ = setup["jax"]
    _, ttabs, _ = setup["port"]
    for jt, tt in zip(jtabs, ttabs):
        shared = set(jt) & set(tt)
        assert set(tt) == shared and set(jt) - shared <= {"quot_fix"}
        for k in sorted(shared):
            got = tt[k].numpy()
            if got.dtype == np.int32:
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, np.asarray(jt[k]), err_msg=k)


def test_static_matches_reference(setup):
    jst = setup["jax"][0]
    tst = setup["port"][0]
    for f in ("logq", "qlimbs", "np1", "np2", "np2_max", "ks_limbs", "N"):
        assert getattr(tst, f) == getattr(jst, f), f


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_step_matches_reference(setup, name):
    """The port's step equals the JAX step and he_mul of each pair, bit
    for bit; CPU tensors launch no kernel."""
    kw = CONFIGS[name]
    jst, mesh, jtabs, jargs = setup["jax"]
    tst, ttabs, targs = setup["port"]
    jax3 = jax.jit(jhp.make_he_mul_step(jst, mesh, **kw))(*jtabs, *jargs)
    common.reset_launches()
    got = thp.make_he_mul_step(tst, "cpu", **kw)(*ttabs, *targs)
    assert sum(common.LAUNCHES.values()) == 0
    for t, j, f in zip(got, jax3, ("ax", "bx")):
        assert t.shape == (B, tst.N, tst.qlimbs) and t.dtype == torch.int32
        np.testing.assert_array_equal(_np(t), np.asarray(j))
        for i, ref in enumerate(setup["refs"]):
            np.testing.assert_array_equal(_np(t[i]),
                                          np.asarray(getattr(ref, f)))


def test_fold_roundtrip_and_operand_checks(setup):
    tst, ttabs, targs = setup["port"]
    x = torch.arange(2 * 3 * 8, dtype=torch.int32).reshape(2, 3, 8)
    folded = thp._fold_np(x)
    assert torch.equal(folded[:, 8:], x[1]) and torch.equal(
        thp._unfold_np(folded, 2), x)
    step = thp.make_he_mul_step(tst, "cpu")
    with pytest.raises(ValueError):
        step(*ttabs, targs[0][:, :, :-1], *targs[1:])
