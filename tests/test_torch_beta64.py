"""repro_torch at β = 2^64 against the JAX package, word for word.

The paper's second word size (qLimbs 19 at paper params; primes in
(2^57, 2^60)), run by the port on its plain torch path with int64 words,
as the reference runs it in jnp on uint64. At test_params(logN = 4 and 5,
beta_bits = 64) on the CPU: the tables, CRT under every strategy name (the
three the reference routes to acc3 included), iCRT under every strategy,
NTT/iNTT exact and modified, encrypt, he_mul, rescale, he_mod_down and
he_add, each equal to the JAX package's words; decryption within the
reference's bounds (tests/test_heaan.py); and ``use_kernels=True``
refused. The keys are made by the port and carried into JAX with
``repro_torch.convert`` (JAX's β = 2^64 keygen is mostly compile time);
the JAX results are module-scoped so each JAX op compiles once a ring.
The rotations and the plaintext and level ops are in
tests/test_torch_beta64_ops.py.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import crt as jcrt
from repro.core import heaan as JH
from repro.core import ntt as jntt
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.core.cipher import PublicKey as JPublicKey
from repro.core.cipher import SecretKey as JSecretKey
from repro.core.context import build_global_tables as j_global
from repro.core.context import build_icrt_tables as j_icrt

from repro_torch import convert
from repro_torch.core import crt as tcrt
from repro_torch.core import heaan as TH
from repro_torch.core import ntt as tntt
from repro_torch.core import rns as trns
from repro_torch.core import test_params as t_test_params
from repro_torch.core.context import (
    build_global_tables, build_icrt_tables, device_icrt_tables,
    device_tables,
)
from repro_torch.core.keys import keygen as t_keygen
from repro_torch.core.rns import PipelineConfig
from repro_torch.kernels.crt.ops import crt_op
from repro_torch.kernels.icrt.ops import icrt_op
from repro_torch.kernels.icrt.ref import icrt_inputs
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.ntt.ops import intt_op, ntt_op
from repro_torch.nt.residue import limbs_to_int

PLAIN = PipelineConfig(use_kernels=False)
SEED = 7
# 64-bit limb edges: 0, 1, 2^32−1, 2^32, 2^63−1, 2^63, 2^64−1
EDGES = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1],
                 dtype=np.uint64)


def _u64(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int64
    return t.cpu().numpy().view(np.uint64)


def _t64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64))


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
    """Both packages' params, the port's keys (and JAX's copies), two
    messages and their encryptions, at one ring."""
    logN = request.param
    pj = j_test_params(logN=logN, beta_bits=64)
    pt = t_test_params(logN=logN, beta_bits=64)
    sk, pk, evk = t_keygen(pt, seed=SEED, cfg=PLAIN, device="cpu")
    rng = np.random.default_rng(logN)
    zs = [rng.normal(size=4) + 1j * rng.normal(size=4) for _ in range(2)]
    tcts = [TH.encrypt_message(z, pk, pt, seed=20 + i, cfg=PLAIN)
            for i, z in enumerate(zs)]
    return SimpleNamespace(
        logN=logN, pj=pj, pt=pt, sk=sk, pk=pk, evk=evk, zs=zs, tcts=tcts,
        jsk=_to_jax(JSecretKey, sk), jpk=_to_jax(JPublicKey, pk),
        jevk=_to_jax(JEvalKey, evk),
        jcts=[_to_jax(JCiphertext, c) for c in tcts])


@pytest.fixture(scope="module")
def products(world):
    """he_mul then rescale of the two ciphertexts, in both packages."""
    w = world
    tmul = TH.he_mul(*w.tcts, w.evk, w.pt, PLAIN)
    jmul = JH.he_mul(*w.jcts, w.jevk, w.pj)
    return tmul, jmul, TH.rescale(tmul, w.pt), JH.rescale(jmul, w.pj)


def test_tables_match_reference(world):
    """Global and iCRT tables (the port's vectorized build) equal the
    reference's python-int build; on a device they are int64 patterns."""
    w = world
    t, j = build_global_tables(w.pt), j_global(w.pj)
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if isinstance(v, np.ndarray):
            assert v.dtype == getattr(j, f.name).dtype, f.name
            np.testing.assert_array_equal(v, getattr(j, f.name),
                                          err_msg=f.name)
    nps = {w.pt.np_region1(q) for q in (120, 96, 48)} | \
        {w.pt.np_region2(q) for q in (120, 96, 48)}
    for npn in sorted(nps):
        ti, ji = build_icrt_tables(w.pt, npn), j_icrt(w.pj, npn)
        for f in dataclasses.fields(ti):
            v = getattr(ti, f.name)
            want = getattr(ji, f.name)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, want, err_msg=f.name)
            else:
                assert v == want, f.name
    g = device_tables(w.pt, torch.device("cpu"))
    assert g.psi_rev.dtype == torch.int64
    np.testing.assert_array_equal(_u64(g.psi_rev_shoup), j.psi_rev_shoup)


def _limbs(rng, N, K):
    x = rng.integers(0, 2**64, size=(N, K), dtype=np.uint64)
    flat = x.reshape(-1)
    flat[: len(EDGES)] = EDGES
    x[-1] = 2**64 - 1                   # a coefficient of all-ones limbs
    return x


@pytest.mark.parametrize("strategy",
                         ["matmul", "shoup", "mod2", "mod4", "acc3"])
def test_crt_strategies_match_reference(world, strategy):
    """Every CRT strategy name; the reference runs matmul, mod2 and mod4
    as acc3 at uint64, and so does the port. Each residue is also the
    python-int remainder."""
    w = world
    g, jg = device_tables(w.pt, torch.device("cpu")), j_global(w.pj)
    rng = np.random.default_rng(w.logN)
    K, npn = 3, w.pt.np_region2(120)
    x = _limbs(rng, w.pt.N, K)
    got = tcrt.crt(_t64(x), g.crt_tb[:npn, :K], g.crt_tb_shoup[:npn, :K],
                   g.primes[:npn], strategy=strategy)
    want = jcrt.crt(jnp.asarray(x), jnp.asarray(jg.crt_tb[:npn, :K]),
                    jnp.asarray(jg.crt_tb_shoup[:npn, :K]),
                    jnp.asarray(jg.primes[:npn]), strategy=strategy)
    np.testing.assert_array_equal(_u64(got), np.asarray(want))
    for n in (0, 1, w.pt.N - 1):
        v = limbs_to_int(x[n], 64)
        assert [int(r) for r in _u64(got)[:, n]] == \
            [v % int(p) for p in jg.primes[:npn]]


@pytest.mark.parametrize("strategy", ["matmul", "acc3", "naive"])
def test_icrt_strategies_match_reference(world, strategy):
    """Every iCRT strategy (matmul runs as acc3 at uint64) on random
    residues and on the edge rows (all 0, all p−1)."""
    w = world
    g, jg = device_tables(w.pt, torch.device("cpu")), j_global(w.pj)
    npn = w.pt.np_region2(120)
    out_limbs = w.pt.limbs_for_bits(120 + w.pt.logQ) + 1
    tabs, jtabs = device_icrt_tables(w.pt, npn, g.primes.device), \
        j_icrt(w.pj, npn)
    p = jg.primes[:npn]
    rng = np.random.default_rng(w.logN + 1)
    r = (rng.integers(0, 2**62, size=(npn, w.pt.N), dtype=np.uint64)
         % p[:, None])
    r[:, 0], r[:, 1] = 0, p - 1
    got = tcrt.icrt(_t64(r), g.primes[:npn], tabs.inv_P, tabs.inv_P_shoup,
                    tabs.pdivp, tabs.P_limbs, tabs.P_half_limbs,
                    g.p_inv_f64[:npn], out_limbs, strategy=strategy)
    want = jcrt.icrt(jnp.asarray(r), jtabs, jnp.asarray(p),
                     jnp.asarray(jtabs.inv_P),
                     jnp.asarray(jtabs.inv_P_shoup),
                     jnp.asarray(jtabs.pdivp), jnp.asarray(jtabs.P_limbs),
                     jnp.asarray(jtabs.P_half_limbs),
                     jnp.asarray(jg.p_inv_f64[:npn]), out_limbs,
                     strategy=strategy)
    np.testing.assert_array_equal(_u64(got), np.asarray(want))


@pytest.mark.parametrize("modified", [False, True],
                         ids=["exact", "modified"])
def test_ntt_intt_match_reference(world, modified):
    w = world
    g, jg = device_tables(w.pt, torch.device("cpu")), j_global(w.pj)
    npn = w.pt.max_np
    p = jg.primes[:npn]
    rng = np.random.default_rng(w.logN + 2)
    x = rng.integers(0, 2**62, size=(npn, w.pt.N), dtype=np.uint64) \
        % p[:, None]
    x[:, 0] = p - 1
    got = tntt.ntt(_t64(x), g.psi_rev[:npn], g.psi_rev_shoup[:npn],
                   g.primes[:npn], modified=modified)
    want = jntt.ntt(jnp.asarray(x), jnp.asarray(jg.psi_rev[:npn]),
                    jnp.asarray(jg.psi_rev_shoup[:npn]), jnp.asarray(p),
                    modified=modified)
    np.testing.assert_array_equal(_u64(got), np.asarray(want))
    back = tntt.intt(got, g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn],
                     g.n_inv[:npn], g.n_inv_shoup[:npn], g.primes[:npn],
                     modified=modified)
    jback = jntt.intt(want, jnp.asarray(jg.ipsi_rev[:npn]),
                      jnp.asarray(jg.ipsi_rev_shoup[:npn]),
                      jnp.asarray(jg.n_inv[:npn]),
                      jnp.asarray(jg.n_inv_shoup[:npn]), jnp.asarray(p),
                      modified=modified)
    np.testing.assert_array_equal(_u64(back), np.asarray(jback))
    np.testing.assert_array_equal(_u64(back), x)


def test_encrypt_matches_reference(world):
    """The port's pk in JAX encrypts to the port's words; both decrypt
    within the reference's 1e-4."""
    w = world
    for i, (z, tct) in enumerate(zip(w.zs, w.tcts)):
        jct = JH.encrypt_message(z, w.jpk, w.pj, seed=20 + i)
        _assert_ct_equal(tct, jct)
        assert tct.ax.dtype == torch.int64
        out = TH.decrypt_message(tct, w.sk, w.pt, PLAIN)
        np.testing.assert_array_equal(out, JH.decrypt_message(
            jct, w.jsk, w.pj))
        assert np.abs(out - z).max() < 1e-4


def test_he_mul_rescale_decrypt_matches_reference(world, products):
    w = world
    tmul, jmul, tres, jres = products
    _assert_ct_equal(tmul, jmul)
    _assert_ct_equal(tres, jres)
    out = TH.decrypt_message(tres, w.sk, w.pt, PLAIN)
    np.testing.assert_array_equal(out, JH.decrypt_message(jres, w.jsk,
                                                          w.pj))
    assert np.abs(out - w.zs[0] * w.zs[1]).max() < 1e-3


@pytest.mark.parametrize("logq2", [72, 48])
def test_mod_down_and_add_match_reference(world, products, logq2):
    """Align a fresh ciphertext to a lower level (48 crosses to one
    64-bit limb) and add, sub and negate there."""
    w = world
    _, _, tres, jres = products
    t1 = TH.he_mod_down(w.tcts[0], w.pt, logq2)
    j1 = JH.he_mod_down(w.jcts[0], w.pj, logq2)
    _assert_ct_equal(t1, j1)
    tlow = TH.he_mod_down(tres, w.pt, logq2)
    jlow = JH.he_mod_down(jres, w.pj, logq2)
    for top, jop in ((TH.he_add, JH.he_add), (TH.he_sub, JH.he_sub)):
        _assert_ct_equal(top(tlow, t1), jop(jlow, j1))
    _assert_ct_equal(TH.he_neg(t1), JH.he_neg(j1))
    out = TH.decrypt_message(TH.he_add(tlow, t1), w.sk, w.pt, PLAIN)
    z1, z2 = w.zs
    assert np.abs(out - (z1 * z2 + z1)).max() < 5e-3


def test_use_kernels_raises_at_beta64(world):
    """The CUDA kernels take β = 2^32 words: with use_kernels=True (the
    port's default) every scheme entry raises and names the plain path,
    and each kernel wrapper refuses int64 words on any device."""
    w = world
    kernels = PipelineConfig(use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=False"):
        t_keygen(w.pt, seed=SEED, device="cpu")
    with pytest.raises(ValueError, match="use_kernels=False"):
        TH.encrypt_message(w.zs[0], w.pk, w.pt, cfg=kernels)
    with pytest.raises(ValueError, match="use_kernels=False"):
        TH.he_mul(*w.tcts, w.evk, w.pt, kernels)
    with pytest.raises(ValueError, match="use_kernels=False"):
        TH.decrypt_message(w.tcts[0], w.sk, w.pt, kernels)
    g = device_tables(w.pt, torch.device("cpu"))
    npn = w.pt.max_np
    x = g.psi_rev[:npn].contiguous()
    tw = (g.psi_rev[:npn], g.psi_rev_shoup[:npn], g.primes[:npn])
    itw = (g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn], g.n_inv[:npn],
           g.n_inv_shoup[:npn], g.primes[:npn])
    tabs = device_icrt_tables(w.pt, npn, torch.device("cpu"))
    calls = [
        lambda: crt_op(w.tcts[0].ax, g.crt_tb[:npn, :3],
                       g.crt_tb_shoup[:npn, :3], g.primes[:npn]),
        lambda: ntt_op(x, *tw), lambda: intt_op(x, *itw),
        lambda: icrt_op(x, icrt_inputs(tabs, g), 2),
        lambda: pointwise_mont_op(x, x, g.primes[:npn], g.pprime[:npn],
                                  g.r2[:npn]),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="β = 2\\^32 words"):
            call()
    assert trns.kernels_on(False, w.pt) is False
