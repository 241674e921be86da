"""repro_torch's primes, parameters and tables equal the JAX package's.

Also the port's package rules: no JAX or reference import in the port or
in chip_smoke.py, and no silent CPU fallback for the default device.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (enables x64)
from repro.core import context as jctx
from repro.core import params as jparams
from repro.nt import primes as jprimes
from repro.nt import residue as jresidue

from repro_torch.core import context as tctx
from repro_torch.core import params as tparams
from repro_torch.core.keys import keygen
from repro_torch.kernels import common
from repro_torch.nt import primes as tprimes
from repro_torch.nt import residue as tresidue

REPO = pathlib.Path(__file__).resolve().parents[1]
SIZES = [(4, 96), (5, 120), (7, 120), (9, 240)]


def _params(mod, logN, logQ):
    return mod.test_params(logN=logN, beta_bits=32, logQ=logQ, logp=24)


@pytest.mark.parametrize("logN,logQ", SIZES)
def test_prime_pool_and_np_match(logN, logQ):
    pj, pt = _params(jparams, logN, logQ), _params(tparams, logN, logQ)
    assert pt.primes == pj.primes
    assert (pt.max_np, pt.np_region1(logQ), pt.np_region2(logQ)) == \
        (pj.max_np, pj.np_region1(logQ), pj.np_region2(logQ))
    for p in pt.primes[:4]:
        assert tprimes.primitive_2nth_root(p, pt.N) == \
            jprimes.primitive_2nth_root(p, pj.N)
    assert tprimes.bit_reverse_indices(64) == jprimes.bit_reverse_indices(64)


def test_paper_params_sizes():
    p = tparams.paper_params()
    assert (p.N, p.qlimbs(1200), p.np_region1(1200), p.np_region2(1200)) == \
        (65536, 38, 81, 122)
    assert p.limbs_for_bits(1200 + p.logQ) + 1 == 76


@pytest.mark.parametrize("logN,logQ", SIZES)
def test_global_tables_equal_reference(logN, logQ):
    gj = jctx.build_global_tables(_params(jparams, logN, logQ))
    gt = tctx.build_global_tables(_params(tparams, logN, logQ))
    for f in dataclasses.fields(gt):
        if f.name == "params":
            continue
        np.testing.assert_array_equal(getattr(gt, f.name),
                                      np.asarray(getattr(gj, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("logN,logQ", SIZES)
def test_icrt_tables_equal_reference(logN, logQ):
    pj, pt = _params(jparams, logN, logQ), _params(tparams, logN, logQ)
    for npn in (pt.np_region1(logQ), pt.np_region2(logQ)):
        tj = jctx.build_icrt_tables(pj, npn)
        tt = tctx.build_icrt_tables(pt, npn)
        for f in dataclasses.fields(tt):
            np.testing.assert_array_equal(np.asarray(getattr(tt, f.name)),
                                          np.asarray(getattr(tj, f.name)),
                                          err_msg=f.name)


def test_device_tables_hold_the_host_bits():
    p = _params(tparams, 5, 120)
    g = tctx.device_tables(p, torch.device("cpu"))
    host = tctx.build_global_tables(p)
    assert g.psi_rev.dtype == torch.int32
    np.testing.assert_array_equal(g.psi_rev.numpy().view(np.uint32),
                                  host.psi_rev)
    assert g.p_inv_f64.dtype == torch.float64


def test_limb_conversions_match_reference():
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=8)]
    vals += [0, 1, (1 << 160) - 1, 3 ** 90]
    got = tresidue.ints_to_limb_array(vals, 6, 32)
    np.testing.assert_array_equal(got,
                                  jresidue.ints_to_limb_array(vals, 6, 32))
    assert tresidue.limb_array_to_ints(got, 32) == vals
    with pytest.raises(OverflowError):
        tresidue.int_to_limbs(1 << 192, 6, 32)


def test_python_int_oracles_match_reference():
    """shoup_precompute, signed_to_mod_q and mod_q_to_signed on random
    ints, both word sizes, the center's edges included."""
    rng = np.random.default_rng(7)
    primes = _params(tparams, 5, 120).primes[:6]
    for bits in (32, 64):
        for p in primes:
            for y in [0, 1, p - 1] + [int(v) for v in
                                      rng.integers(0, p, size=16)]:
                assert tprimes.shoup_precompute(y, p, bits) == \
                    jprimes.shoup_precompute(y, p, bits)
    for logq in (1, 24, 120, 1200):
        q = 1 << logq
        xs = [0, 1, q // 2 - 1, q // 2, q - 1, -1, -(q // 2), q, 3 * q + 5]
        xs += [int.from_bytes(rng.bytes(logq // 8 + 2), "little")
               - (1 << (logq + 1)) for _ in range(16)]
        for x in xs:
            r = tresidue.signed_to_mod_q(x, q)
            assert r == jresidue.signed_to_mod_q(x, q) and 0 <= r < q
            assert tresidue.mod_q_to_signed(r, q) == \
                jresidue.mod_q_to_signed(r, q)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|"
                     r"from\s+(jax|repro)\b(?!_torch))", re.M)
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert len(files) > 20 and not offenders, offenders
    for f in files:
        assert "repro." not in f.read_text().replace("repro_torch.", ""), f


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = _params(tparams, 4, 96)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tctx.make_context(p, p.logQ)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        keygen(p, seed=0)
    assert tctx.resolve_device("cpu") == torch.device("cpu")


def test_kernel_check_refuses_cpu_tensors():
    """Only a wrapper's CPU dispatch runs the plain version; the launch
    path never accepts a CPU tensor."""
    t = torch.zeros(4, 4, dtype=torch.int32)
    assert common.plain(t)
    with pytest.raises(ValueError, match="expected a tensor on"):
        common.check("t", t, (4, 4), t.device)
