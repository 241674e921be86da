"""repro_torch's kernel wrappers and plain versions against the JAX kernels.

Every plain version (kernels/<name>/ref.py) is held bit for bit against
both the JAX Pallas kernel, run in interpret mode on the CPU as
tests/test_kernels.py runs it, and the JAX package's ref.py. On CPU tensors
the wrappers run those plain versions; the CUDA kernels themselves are held
against them in tests/test_torch_cuda.py, which needs a card.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import make_context as j_make_context
from repro.core import test_params as j_test_params
from repro.kernels.crt.ops import crt_op as j_crt_op
from repro.kernels.crt.ref import crt_ref as j_crt_ref
from repro.kernels.icrt.ops import icrt_op as j_icrt_op
from repro.kernels.icrt.ref import icrt_ref as j_icrt_ref
from repro.kernels.modmul.ops import pointwise_mont_op as j_mont_op
from repro.kernels.modmul.ref import pointwise_mont_ref as j_mont_ref
from repro.kernels.ntt.ops import intt_op as j_intt_op
from repro.kernels.ntt.ops import ntt_op as j_ntt_op
from repro.kernels.ntt.ref import intt_ref as j_intt_ref
from repro.kernels.ntt.ref import ntt_ref as j_ntt_ref
from repro.nt.residue import ints_to_limb_array

from repro_torch.core import make_context
from repro_torch.core import test_params as t_test_params
from repro_torch.core.ntt import pointwise_shoup_scale
from repro_torch.kernels import common
from repro_torch.kernels.crt.ops import crt_op
from repro_torch.kernels.crt.ref import crt_ref
from repro_torch.kernels.icrt.ops import icrt_op
from repro_torch.kernels.icrt.ref import icrt_ref
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.modmul.ref import pointwise_mont_ref
from repro_torch.kernels.ntt.ops import intt_op, ntt_op
from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref

CPU = torch.device("cpu")


def _ctx(logN=5, logQ=120, device=CPU):
    pj = j_test_params(logN=logN, beta_bits=32, logQ=logQ, logp=24)
    pt = t_test_params(logN=logN, beta_bits=32, logQ=logQ, logp=24)
    return j_make_context(pj, logQ), make_context(pt, logQ, device)


def _t(a, device=CPU):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _rand_residues(primes, npn, N, seed=0):
    rng = np.random.default_rng(seed)
    p = np.asarray(primes[:npn]).astype(np.uint64)
    return (rng.integers(0, 1 << 62, size=(npn, N)).astype(np.uint64)
            % p[:, None]).astype(np.uint32)


def _limbs(N, K, logQ, seed):
    pr = random.Random(seed)
    return ints_to_limb_array([pr.getrandbits(logQ) for _ in range(N)], K, 32)


def _assert_all_equal(got_t, *refs):
    for ref in refs:
        np.testing.assert_array_equal(_np(got_t), np.asarray(ref))


@pytest.mark.parametrize("logN", [4, 7, 9])
def test_ntt_plain_matches_pallas_and_ref(logN):
    jc, tc = _ctx(logN=logN)
    g, tg = jc.tables, tc.tables
    npn, N = jc.np1, jc.N
    x = _rand_residues(g.primes, npn, N, seed=logN)
    jargs = (jnp.asarray(g.psi_rev[:npn]), jnp.asarray(g.psi_rev_shoup[:npn]),
             jnp.asarray(g.primes[:npn]))
    targs = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
    got = ntt_ref(_t(x), *targs)
    _assert_all_equal(got, j_ntt_op(jnp.asarray(x), *jargs),
                      j_ntt_ref(jnp.asarray(x), *jargs))
    assert torch.equal(ntt_op(_t(x), *targs), got)


@pytest.mark.parametrize("logN", [4, 9])
def test_intt_plain_matches_pallas_and_ref_and_roundtrips(logN):
    jc, tc = _ctx(logN=logN)
    g, tg = jc.tables, tc.tables
    npn, N = jc.np2, jc.N
    x = _rand_residues(g.primes, npn, N, seed=10 + logN)
    ev = ntt_ref(_t(x), tg.psi_rev[:npn], tg.psi_rev_shoup[:npn],
                 tg.primes[:npn])
    jargs = (jnp.asarray(g.ipsi_rev[:npn]),
             jnp.asarray(g.ipsi_rev_shoup[:npn]),
             jnp.asarray(g.n_inv[:npn]), jnp.asarray(g.n_inv_shoup[:npn]),
             jnp.asarray(g.primes[:npn]))
    targs = (tg.ipsi_rev[:npn], tg.ipsi_rev_shoup[:npn], tg.n_inv[:npn],
             tg.n_inv_shoup[:npn], tg.primes[:npn])
    got = intt_ref(ev, *targs)
    jev = jnp.asarray(_np(ev))
    _assert_all_equal(got, j_intt_op(jev, *jargs), j_intt_ref(jev, *jargs), x)
    assert torch.equal(intt_op(ev, *targs), got)


@pytest.mark.parametrize("logN,logQ", [(4, 96), (5, 120), (6, 240)])
def test_crt_plain_matches_pallas_and_ref(logN, logQ):
    jc, tc = _ctx(logN=logN, logQ=logQ)
    g, tg = jc.tables, tc.tables
    N = jc.N
    for npn, K in ((jc.np1, jc.qlimbs), (jc.np2, 2 * jc.qlimbs)):
        x = _limbs(N, K, 32 * K, seed=logN * 100 + logQ + K)
        x[0], x[1] = 0, 0xFFFFFFFF              # zero and all-ones rows
        jargs = (jnp.asarray(g.crt_tb[:npn, :K]),
                 jnp.asarray(g.crt_tb_shoup[:npn, :K]),
                 jnp.asarray(g.primes[:npn]))
        targs = (tg.crt_tb[:npn, :K].contiguous(),
                 tg.crt_tb_shoup[:npn, :K].contiguous(), tg.primes[:npn])
        got = crt_ref(_t(x), *targs)
        _assert_all_equal(got, j_crt_op(jnp.asarray(x), *jargs),
                          j_crt_ref(jnp.asarray(x), *jargs))
        assert torch.equal(crt_op(_t(x), *targs), got)


@pytest.mark.parametrize("logN,logQ", [(4, 96), (5, 120)])
def test_icrt_plain_matches_pallas_and_ref(logN, logQ):
    """Region 1 truncates to qlimbs; region 2 sign-extends past the
    accumulator."""
    jc, tc = _ctx(logN=logN, logQ=logQ)
    g, tg = jc.tables, tc.tables
    for npn, jt, tt, out_limbs in (
            (jc.np1, jc.icrt1, tc.icrt1, jc.qlimbs),
            (jc.np2, jc.icrt2, tc.icrt2, jc.icrt2.accum_limbs + 2)):
        r = _rand_residues(g.primes, npn, jc.N, seed=20 + logN + npn)
        got = icrt_ref(_t(r), tt, tg, out_limbs)
        _assert_all_equal(got, j_icrt_op(jnp.asarray(r), jt, g, out_limbs),
                          j_icrt_ref(jnp.asarray(r), jt, g, out_limbs))
        assert torch.equal(icrt_op(_t(r), tt, tg, out_limbs), got)


def test_icrt_plain_boundary_values():
    """Residues of 0, ±1, ±P/2-ish — the quotient and center-lift edges."""
    jc, tc = _ctx(logN=4)
    g, tabs = jc.tables, jc.icrt1
    P = tabs.P_int
    primes_py = [int(v) for v in np.asarray(g.primes[:jc.np1])]
    vals = [0, 1, -1, 2, -2, P // 2 - 1, -(P // 2) + 1, P // 2, -(P // 2),
            P - 1, 123456789, -987654321] + [0] * (jc.N - 12)
    res = np.stack([[v % pj for v in vals] for pj in primes_py]
                   ).astype(np.uint32)
    got = icrt_ref(_t(res), tc.icrt1, tc.tables, tabs.accum_limbs)
    _assert_all_equal(
        got, j_icrt_op(jnp.asarray(res), tabs, g, tabs.accum_limbs),
        j_icrt_ref(jnp.asarray(res), tabs, g, tabs.accum_limbs,
                   strategy="acc3"))


@pytest.mark.parametrize("npn,N", [(3, 64), (13, 512)])
def test_modmul_plain_matches_pallas_and_ref(npn, N):
    jc, tc = _ctx(logN=5)
    g, tg = jc.tables, tc.tables
    npn = min(npn, jc.np2)
    a = _rand_residues(g.primes, npn, N, seed=30)
    b = _rand_residues(g.primes, npn, N, seed=31)
    a[0, :2], b[0, :2] = 0, int(g.primes[0]) - 1
    jargs = (jnp.asarray(g.primes[:npn]), jnp.asarray(g.pprime[:npn]),
             jnp.asarray(g.r2[:npn]))
    targs = (tg.primes[:npn], tg.pprime[:npn], tg.r2[:npn])
    got = pointwise_mont_ref(_t(a), _t(b), *targs)
    _assert_all_equal(got, j_mont_op(jnp.asarray(a), jnp.asarray(b), *jargs),
                      j_mont_ref(jnp.asarray(a), jnp.asarray(b), *jargs))
    assert torch.equal(pointwise_mont_op(_t(a), _t(b), *targs), got)


def test_cpu_wrappers_launch_nothing():
    """A CPU tensor takes the plain version and counts no launch."""
    common.reset_launches()
    _, tc = _ctx(logN=4)
    tg = tc.tables
    x = _t(_rand_residues(tg.primes.numpy().view(np.uint32), 2, 16))
    ntt_op(x, tg.psi_rev[:2], tg.psi_rev_shoup[:2], tg.primes[:2])
    pointwise_mont_op(x, x, tg.primes[:2], tg.pprime[:2], tg.r2[:2])
    assert sum(common.LAUNCHES.values()) == 0


def test_evk_shoup_product_matches_reference():
    from repro.core.ntt import pointwise_shoup_scale as j_scale
    jc, tc = _ctx(logN=5)
    g = jc.tables
    npn, N = jc.np2, jc.N
    x = _rand_residues(g.primes, npn, N, seed=50)
    y = _rand_residues(g.primes, npn, N, seed=51)
    p = np.asarray(g.primes[:npn]).astype(np.uint64)
    ysh = ((y.astype(np.uint64) << np.uint64(32)) // p[:, None]
           ).astype(np.uint32)
    got = pointwise_shoup_scale(_t(x), _t(y), _t(ysh), tc.tables.primes[:npn])
    _assert_all_equal(got, j_scale(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(ysh),
                                   jnp.asarray(g.primes[:npn])))
