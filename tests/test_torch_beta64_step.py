"""repro_torch's batched HE Mul step at β = 2^64 against the JAX package's.

At test_params(logN=5, beta_bits=64) and B = 3, the port's
``make_he_mul_step`` (plain path, CPU tensors) equals the JAX
``make_he_mul_step`` on a (1, 1) mesh with Auto axes, and he_mul of each
pair, word for word, under the default strategies and under a mix the
reference routes to acc3. ``HEStatic.dtype`` is the port's stored word
(int64 where the reference's is uint64), operands of the other word size
are refused, and ``use_kernels=True`` raises as the reference's assert
does. The keys and ciphertexts are made by the port and carried into JAX
with ``repro_torch.convert``.
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
from repro_torch.core.rns import PipelineConfig
from repro_torch.dist import he_pipeline as thp

LOGN, B = 5, 3
PLAIN = PipelineConfig(use_kernels=False)
CONFIGS = {
    "defaults": {},
    "mod4-naive-modified": {"crt_strategy": "mod4", "icrt_strategy": "naive",
                            "modified_shoup": True},
}


def _u64(t):
    return t.numpy().view(np.uint64)


def _to_jax(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj, 64).items()})


@pytest.fixture(scope="module")
def setup():
    pj = j_test_params(logN=LOGN, beta_bits=64)
    pt = t_test_params(logN=LOGN, beta_bits=64)
    _, tpk, tevk = t_keygen(pt, seed=3, cfg=PLAIN, device="cpu")
    rng = np.random.default_rng(5)
    tcts = [TH.encrypt_message(rng.normal(size=4) + 1j * rng.normal(size=4),
                               tpk, pt, seed=20 + i, cfg=PLAIN)
            for i in range(2 * B)]
    cts = [_to_jax(JCiphertext, c) for c in tcts]
    jevk = _to_jax(JEvalKey, tevk)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fields = ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))
    jargs = [jnp.stack([getattr(c, f) for c in cts[s::2]])
             for s, f in fields]
    targs = [torch.stack([getattr(c, f) for c in tcts[s::2]])
             for s, f in fields]
    return {
        "jax": (jhp.he_static(pj, pj.logQ), mesh,
                jhp.runtime_tables(j_make_context(pj, pj.logQ), jevk),
                jargs),
        "port": (thp.he_static(pt, pt.logQ),
                 thp.runtime_tables(make_context(pt, pt.logQ, "cpu"),
                                    tevk), targs),
        "pairs": [(tcts[2 * i], tcts[2 * i + 1]) for i in range(B)],
        "evk": tevk, "params": pt,
    }


def test_static_and_dtype_match_reference(setup):
    jst, tst = setup["jax"][0], setup["port"][0]
    for f in ("logq", "qlimbs", "np1", "np2", "np2_max", "ks_limbs", "N"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert jst.dtype == np.uint64 and tst.dtype == torch.int64
    assert thp.he_static(t_test_params(logN=LOGN), 120).dtype == torch.int32


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batched_step_matches_reference(setup, name):
    kw = CONFIGS[name]
    jst, mesh, jtabs, jargs = setup["jax"]
    tst, ttabs, targs = setup["port"]
    jax3 = jax.jit(jhp.make_he_mul_step(jst, mesh, **kw))(*jtabs, *jargs)
    got = thp.make_he_mul_step(tst, "cpu", **kw)(*ttabs, *targs)
    pt, evk = setup["params"], setup["evk"]
    refs = [TH.he_mul(a, b, evk, pt, PLAIN) for a, b in setup["pairs"]]
    for t, j, f in zip(got, jax3, ("ax", "bx")):
        assert t.shape == (B, tst.N, tst.qlimbs) and t.dtype == torch.int64
        np.testing.assert_array_equal(_u64(t), np.asarray(j))
        for i, ref in enumerate(refs):
            assert torch.equal(t[i], getattr(ref, f))


def test_kernels_and_other_word_sizes_are_refused(setup):
    tst, ttabs, targs = setup["port"]
    with pytest.raises(ValueError, match="use_kernels=False"):
        thp.make_he_mul_step(tst, "cpu", use_kernels=True)
    step = thp.make_he_mul_step(tst, "cpu")
    with pytest.raises(ValueError, match="int64"):
        step(*ttabs, targs[0].to(torch.int32), *targs[1:])
