"""repro_torch's CUDA kernels against their plain versions, on a card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test skips. The plain versions themselves are held
against the JAX package in the other tests/test_torch_*.py files.
"""

import ctypes
import os
import random

import numpy as np
import pytest
import torch

from repro_torch.core import heaan as H
from repro_torch.core import make_context
from repro_torch.core import test_params as small_params
from repro_torch.core.keys import keygen
from repro_torch.core.params import paper_params
from repro_torch.core.rns import PipelineConfig
from repro_torch.kernels import common
from repro_torch.kernels.crt.ops import BLOCK as CRT_BLOCK
from repro_torch.kernels.crt.ops import crt_op
from repro_torch.kernels.crt.ref import crt_ref
from repro_torch.kernels.icrt.ops import BLOCK, icrt_op
from repro_torch.kernels.icrt.ref import icrt_inputs, icrt_ref
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.modmul.ref import pointwise_mont_ref
from repro_torch.kernels.ntt.ops import intt_op, ntt_geometry, ntt_op
from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref
from repro_torch.nt.residue import ints_to_limb_array

pytestmark = pytest.mark.cuda

# the trainer's deterministic mode on a card: cuBLAS reads this when torch
# first sizes its workspace, so it is set before any test runs a matmul
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _t(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32)
                            .view(np.int32)).to(device)


def _residues(primes, npn, N, seed):
    rng = np.random.default_rng(seed)
    p = primes[:npn].astype(np.uint64)
    return (rng.integers(0, 1 << 62, size=(npn, N)).astype(np.uint64)
            % p[:, None]).astype(np.uint32)


@pytest.mark.parametrize("logN,logQ", [(4, 96), (5, 120), (10, 120),
                                       (12, 240), (14, 120), (16, 240)])
def test_cuda_kernels_match_plain_versions(dev, logN, logQ):
    """Every kernel equals its plain version bit for bit, and each wrapper
    call counts one launch."""
    p = small_params(logN=logN, beta_bits=32, logQ=logQ, logp=24)
    tc = make_context(p, logQ, dev)
    tg = tc.tables
    npn, N, K = tc.np1, tc.N, tc.qlimbs
    primes = tg.primes.cpu().numpy().view(np.uint32)
    common.reset_launches()
    x = _t(_residues(primes, npn, N, 1), dev)
    b = _t(_residues(primes, npn, N, 2), dev)
    fwd = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
    inv = (tg.ipsi_rev[:npn], tg.ipsi_rev_shoup[:npn], tg.n_inv[:npn],
           tg.n_inv_shoup[:npn], tg.primes[:npn])
    ev = ntt_op(x, *fwd)
    assert torch.equal(ev, ntt_ref(x, *fwd))
    back = intt_op(ev, *inv)
    assert torch.equal(back, intt_ref(ev, *inv)) and torch.equal(back, x)
    mm = (tg.primes[:npn], tg.pprime[:npn], tg.r2[:npn])
    assert torch.equal(pointwise_mont_op(x, b, *mm),
                       pointwise_mont_ref(x, b, *mm))
    pr = random.Random(logN)
    limbs = _t(ints_to_limb_array([pr.getrandbits(64 * K) for _ in range(N)],
                                  2 * K, 32), dev)
    tb = tg.crt_tb[:npn, :2 * K].contiguous()
    tbs = tg.crt_tb_shoup[:npn, :2 * K].contiguous()
    assert torch.equal(crt_op(limbs, tb, tbs, tg.primes[:npn]),
                       crt_ref(limbs, tb, tbs, tg.primes[:npn]))
    for ol in (K, tc.icrt1.accum_limbs + 2):
        t = icrt_inputs(tc.icrt1, tg)
        assert torch.equal(icrt_op(x, t, ol), icrt_ref(x, t, ol))
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "modmul": 1, "ntt": 1, "intt": 1, "crt": 1, "icrt": 2}


@pytest.mark.parametrize("region", [1, 2])
def test_cuda_icrt_edge_inputs_and_block_rule(dev, region):
    """The iCRT kernel equals its plain version on the largest column sums
    (every residue p_j − 1), on random residues, at N below one block of
    the kernel, and at sign-extended widths; an N above one block that is
    not a multiple of it runs zero-padded in one launch."""
    p = small_params(logN=10, beta_bits=32, logQ=240, logp=24)
    tc = make_context(p, p.logQ, dev)
    tg = tc.tables
    npn, tabs = (tc.np1, tc.icrt1) if region == 1 else (tc.np2, tc.icrt2)
    t = icrt_inputs(tabs, tg)
    primes = tg.primes.cpu().numpy().view(np.uint32)
    pm1 = _t(np.repeat(primes[:npn, None] - 1, tc.N, 1), dev)
    rand = _t(_residues(primes, npn, tc.N, 30 + region), dev)
    common.reset_launches()
    for ol in (tc.qlimbs, tabs.accum_limbs + 2):
        for r in (pm1, rand, rand[:, :BLOCK // 2 + 16].contiguous()):
            assert torch.equal(icrt_op(r, t, ol), icrt_ref(r, t, ol))
    odd = rand[:, :BLOCK + BLOCK // 2].contiguous()
    assert torch.equal(icrt_op(odd, t, tc.qlimbs),
                       icrt_ref(odd, t, tc.qlimbs))
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {"icrt": 7}


@pytest.mark.parametrize("K", [1, 2, 3, 5, 38, 76])
def test_cuda_crt_edge_inputs_and_tails(dev, K):
    """The CRT kernel and its Mod-2/Mod-4 variants equal their plain
    versions on every limb 0xFFFFFFFF (the largest three-word sum, and the
    largest two-word sum of Mod-4, below 2^64), every limb 0 and random
    limbs, for K that ends on a partial group of 4 limbs or none, np that
    ends on a partial group of 8 primes or none, and N below one block,
    over several, and of 1.5 blocks (run zero-padded to 2); the tables, of
    the paper's primes, are built with Python ints."""
    primes = [int(v) for v in paper_params().primes[:122]]
    rng = np.random.default_rng(K)
    common.reset_launches()
    for npn in (1, 3, 81, 122):
        kt = max(K, 3)
        tb = [[pow(2, 32 * k, p) for k in range(kt)] for p in primes[:npn]]
        tabs = (_t(np.array(tb, np.uint64), dev),
                _t([[(v << 32) // p for v in row]
                    for row, p in zip(tb, primes)], dev),
                _t(primes[:npn], dev))
        for N in (CRT_BLOCK // 2 - 16, CRT_BLOCK + CRT_BLOCK // 2,
                  3 * CRT_BLOCK):
            for x in (np.full((N, K), 0xFFFFFFFF, np.uint64),
                      np.zeros((N, K), np.uint64),
                      rng.integers(0, 1 << 32, size=(N, K), dtype=np.uint64)):
                xt = _t(x, dev)
                for strategy in ("acc3", "mod2", "mod4"):
                    assert torch.equal(
                        crt_op(xt, *tabs, strategy=strategy),
                        crt_ref(xt, *tabs, strategy=strategy))
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "crt": 36, "crt_mod2": 36, "crt_mod4": 36}


def test_cuda_he_mul_equals_plain_path(dev):
    """HE Mul through the kernels gives the plain path's words, launches
    each kernel as Fig. 2 says, and decrypts to the product."""
    p = small_params(logN=10, beta_bits=32, logQ=240, logp=24)
    sk, pk, evk = keygen(p, seed=3, device=dev)
    rng = np.random.default_rng(4)
    z1, z2 = (rng.normal(size=64) + 1j * rng.normal(size=64)
              for _ in range(2))
    c1 = H.encrypt_message(z1, pk, p, seed=5)
    c2 = H.encrypt_message(z2, pk, p, seed=6)
    common.reset_launches()
    got = H.he_mul(c1, c2, evk, p)
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "modmul": 3, "ntt": 5, "intt": 5, "crt": 5, "icrt": 5}
    want = H.he_mul(c1, c2, evk, p, PipelineConfig(use_kernels=False))
    assert torch.equal(got.ax, want.ax) and torch.equal(got.bx, want.bx)
    out = H.decrypt_message(H.rescale(got, p), sk, p)
    assert np.abs(out - z1 * z2).max() < 1e-3


@pytest.mark.parametrize("logN,logQ", [(4, 96), (5, 120), (10, 120),
                                       (12, 240), (14, 120), (16, 120)])
def test_cuda_kernel_variants_match_plain_versions(dev, logN, logQ):
    """CRT Mod-2/Mod-4 and the modified-Shoup transforms equal their plain
    versions, on one ciphertext and on batches of three and four (rows
    taking twiddle row r mod np, B·N coefficients), equal the exact
    transforms, and count apart; NTT → iNTT gives x back either way."""
    p = small_params(logN=logN, beta_bits=32, logQ=logQ, logp=24)
    tc = make_context(p, logQ, dev)
    tg = tc.tables
    npn, N, K = tc.np1, tc.N, tc.qlimbs
    primes = tg.primes.cpu().numpy().view(np.uint32)
    fwd = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
    inv = (tg.ipsi_rev[:npn], tg.ipsi_rev_shoup[:npn], tg.n_inv[:npn],
           tg.n_inv_shoup[:npn], tg.primes[:npn])
    tb = tg.crt_tb[:npn, :2 * K].contiguous()
    tbs = tg.crt_tb_shoup[:npn, :2 * K].contiguous()
    common.reset_launches()
    for B in (1, 3, 4):
        x = _t(np.concatenate([_residues(primes, npn, N, 10 + b)
                               for b in range(B)]), dev)
        ev = ntt_op(x, *fwd, modified=True)
        assert torch.equal(ev, ntt_ref(x, *fwd, modified=True))
        assert torch.equal(ev, ntt_op(x, *fwd))
        back = intt_op(ev, *inv, modified=True)
        assert torch.equal(back, intt_ref(ev, *inv, modified=True))
        assert torch.equal(back, x)
        assert torch.equal(intt_op(ev, *inv), back)
        pr = random.Random(logN + B)
        limbs = _t(ints_to_limb_array(
            [pr.getrandbits(64 * K) for _ in range(B * N)], 2 * K, 32), dev)
        want = crt_ref(limbs, tb, tbs, tg.primes[:npn])
        for strategy in ("mod2", "mod4"):
            got = crt_op(limbs, tb, tbs, tg.primes[:npn], strategy=strategy)
            assert torch.equal(got, crt_ref(limbs, tb, tbs, tg.primes[:npn],
                                            strategy=strategy))
            assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "ntt": 3, "intt": 3, "crt_mod2": 3, "crt_mod4": 3,
        "ntt_modified": 3, "intt_modified": 3}


@pytest.mark.parametrize("B", [2, 3])
def test_cuda_batched_step_equals_per_item_he_mul(dev, B):
    """The batched step through the kernels, on three rungs of the paper's
    ladder, gives he_mul's words for every pair; the default rung also
    equals the plain batched step."""
    _check_batched_step(dev, small_params(logN=10, beta_bits=32, logQ=240,
                                          logp=24), B)


@pytest.mark.parametrize("B", [3, 5, 9])
def test_cuda_batched_step_takes_widths_the_launch_cannot_tile(dev, B):
    """At test_params() (N = 32) the folded widths B·N = 96, 160 and 288
    are above one iCRT block and not a multiple of it, and 288 is so for
    CRT's block too: the step runs them zero-padded and still gives
    he_mul's words for every pair."""
    _check_batched_step(dev, small_params(), B)


def test_cuda_ntt_beyond_65535_rows(dev):
    """NTT → iNTT of 70000 rows of 16 words (4.5 MB, more rows than
    gridDim.y takes) equals the plain versions bit for bit."""
    p = small_params(logN=4, beta_bits=32, logQ=96, logp=24)
    tg = make_context(p, p.logQ, dev).tables
    npn, rows = 2, 70000
    p_rows = np.tile(tg.primes[:npn].cpu().numpy().view(np.uint32),
                     rows // npn).astype(np.uint64)
    x = _t(np.random.default_rng(7).integers(0, 1 << 62, size=(rows, 16),
                                             dtype=np.uint64)
           % p_rows[:, None], dev)
    fwd = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
    inv = (tg.ipsi_rev[:npn], tg.ipsi_rev_shoup[:npn], tg.n_inv[:npn],
           tg.n_inv_shoup[:npn], tg.primes[:npn])
    ev = ntt_op(x, *fwd)
    assert torch.equal(ev, ntt_ref(x, *fwd))
    back = intt_op(ev, *inv)
    assert torch.equal(back, intt_ref(ev, *inv)) and torch.equal(back, x)


def test_cuda_ntt_launch_refuses_a_geometry_it_cannot_run(dev):
    """The NTT launch runs the passes ntt_geometry gives it, and refuses
    before any launch a geometry whose blocks do not cover the rows, whose
    shared memory does not hold a tile and its twiddles, whose stages do
    not add up to log2 N, that puts several rows in a column pass's block,
    or that names other threads a block."""
    p = small_params(logN=12, beta_bits=32, logQ=240, logp=24)
    tg = make_context(p, p.logQ, dev).tables
    npn, B, logn = 3, 5, 12
    rows = B * npn
    primes = tg.primes.cpu().numpy().view(np.uint32)
    x = _t(np.concatenate([_residues(primes, npn, 1 << logn, 40 + b)
                           for b in range(B)]), dev)
    fwd = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
    out = torch.zeros_like(x)
    lib = common.library()
    stream = torch.cuda.current_stream().cuda_stream

    def run(geom):
        flat = [v for g in geom for v in g]
        return lib.ntt_forward_launch(
            *[t.data_ptr() for t in (x, *fwd, out)], rows, npn, logn, 0,
            len(geom), (ctypes.c_int * len(flat))(*flat), stream)

    good = ntt_geometry(rows, logn, npn)
    (L0, t0, r0, b0, th0, s0), (L1, t1, r1, b1, th1, s1) = good
    assert (L0, L1, r1) == (4, 8, 4)
    for bad in ([(L0, t0, r0, b0 - 1, th0, s0), good[1]],
                [good[0], (L1, t1, r1, b1 + 1, th1, s1)],
                [good[0], (L1, t1, r1, b1, th1, s1 - 4)],
                [(L0 - 1, t0 - 1, r0, b0 << 1, th0, s0), good[1]],
                [(L0, t0, 2, -(-b0 // 2), th0, s0), good[1]],
                [good[0], (L1, t1, r1, b1, th1 // 2, s1)],
                [good[1]]):
        assert run(bad) != 0
    torch.cuda.synchronize()
    assert not out.any()
    assert run(good) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, ntt_ref(x, *fwd))


def _check_batched_step(dev, p, B):
    from repro_torch.dist import he_pipeline as hp
    sk, pk, evk = keygen(p, seed=3, device=dev)
    rng = np.random.default_rng(4)
    cts = [H.encrypt_message(rng.normal(size=8) + 1j * rng.normal(size=8),
                             pk, p, seed=10 + i) for i in range(2 * B)]
    refs = [H.he_mul(cts[2 * i], cts[2 * i + 1], evk, p) for i in range(B)]
    st = hp.he_static(p, p.logQ)
    tabs = hp.runtime_tables(make_context(p, p.logQ, dev), evk)
    args = [torch.stack([getattr(c, f) for c in cts[s::2]])
            for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
    rungs = {"default": ({}, "crt", "ntt", "intt"),
             "mod2+modified": ({"crt_strategy": "mod2",
                                "modified_shoup": True},
                               "crt_mod2", "ntt_modified", "intt_modified"),
             "mod4": ({"crt_strategy": "mod4"}, "crt_mod4", "ntt", "intt")}
    for kw, crt_name, ntt_name, intt_name in rungs.values():
        common.reset_launches()
        ax3, bx3 = hp.make_he_mul_step(st, dev, use_kernels=True,
                                       **kw)(*tabs, *args)
        torch.cuda.synchronize()
        assert {k: v for k, v in common.LAUNCHES.items() if v} == {
            crt_name: 5, ntt_name: 5, intt_name: 5, "icrt": 5, "modmul": 3,
            "carry_shift": 2, "carry_add": 2}
        for i, ref in enumerate(refs):
            assert torch.equal(ax3[i], ref.ax) and torch.equal(bx3[i], ref.bx)
        if not kw:
            pax, pbx = hp.make_he_mul_step(
                st, dev, crt_strategy="acc3", icrt_strategy="acc3")(*tabs,
                                                                    *args)
            assert torch.equal(pax, ax3) and torch.equal(pbx, bx3)


@pytest.mark.parametrize("name", ["A", "B"])
def test_cuda_circuits_equal_plain_path(dev, name):
    """Circuit A (the degree-4 demo circuit) and circuit B (the affine
    layer: mul_plain, rescale, add_plain, rotate, sub, slot_sum) at
    test_params() through the kernels give the plain path's words and
    decrypt within tests/test_hserve.py's 0.3 and test_rotate.py's 1e-2."""
    from repro_torch.core.rotate import conj_keygen, rot_keygen
    from repro_torch.hserve import circuit as C
    p = small_params()
    sk, pk, evk = keygen(p, seed=3, device=dev)
    keys = {"evk": evk, "conj_key": conj_keygen(p, sk, device=dev),
            "rot_keys": {r: rot_keygen(p, sk, r, device=dev)
                         for r in (1, 2, 4)}}
    rng = np.random.default_rng(5)
    z, w, b = (rng.random(8) + 1j * rng.random(8) for _ in range(3))
    x = H.encrypt_message(z, pk, p, seed=6)
    if name == "A":
        ops, want, limit = (C.degree4_demo_circuit(p)[0],
                            np.conj(z ** 4) + z, 0.3)
    else:
        ops, want, limit = (C.affine_demo_circuit(p, w, b, device=dev),
                            (np.roll(w * z + b, -1) - z).sum(), 1e-2)
    got = C.execute_circuit_reference(ops, {"x": x}, p, **keys)
    ref = C.execute_circuit_reference(ops, {"x": x}, p, **keys,
                                      cfg=PipelineConfig(use_kernels=False))
    assert torch.equal(got.ax, ref.ax) and torch.equal(got.bx, ref.bx)
    assert np.abs(H.decrypt_message(got, sk, p) - want).max() < limit


def _limb_rows(n, L, seed):
    """(n, L) int32 limb rows: random, then (where n allows) all ones, the
    largest positive value, a negative value with zero limbs below, and
    zero: the rows that run a carry through every limb or overflow."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(n, L), dtype=np.uint64)
    edges = [np.full(L, 0xFFFFFFFF), np.r_[np.full(L - 1, 0xFFFFFFFF),
                                           0x7FFFFFFF],
             np.r_[np.zeros(L - 1), 0x80000000], np.zeros(L)]
    for i, e in enumerate(edges[:max(n - 1, 0)]):
        x[i + 1] = e
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


# (L, s, out_limbs) of the ÷Q shift, and (L, bits) of the add and mask:
# the cells' shapes and the edges of tests/test_torch_carry.py
CARRY_SHIFTS = [(76, 1200, 38), (76, 1200, 37), (75, 1200, 36), (8, 64, 4),
                (8, 70, 10), (5, 0, 5), (5, 0, 7), (3, 200, 4), (4, 33, 4),
                (2, 31, 1), (3, 96, 2), (1, 17, 1), (4, 1, 4), (76, 0, 76)]
CARRY_ADDS = [(38, 1200), (37, 1170), (36, 1140), (6, 128), (6, 192),
              (6, 300), (6, 5), (3, 0)]


def test_cuda_carry_kernels_match_plain_versions(dev):
    """The carry kernels equal the BigInt functions bit for bit on rows
    that carry through every limb, at one row, an odd count and a ragged
    last block (129 and 300 rows, blocks of 128), each call one launch."""
    from repro_torch.kernels.carry.ops import add_mask_op, shift_round_op
    from repro_torch.kernels.carry.ref import add_mask_ref, shift_round_ref
    common.reset_launches()
    for n in (1, 7, 129, 300):
        for L, s, out_limbs in CARRY_SHIFTS:
            x = _limb_rows(n, L, L + s + n)
            got = shift_round_op(x.to(dev), s, out_limbs)
            assert torch.equal(got.cpu(), shift_round_ref(x, s, out_limbs))
        for L, bits in CARRY_ADDS:
            a = _limb_rows(n, L, bits + n)
            b = _limb_rows(n, L, bits + n + 1).flip(0).contiguous()
            got = add_mask_op(a.to(dev), b.to(dev), bits)
            assert torch.equal(got.cpu(), add_mask_ref(a, b, bits))
    torch.cuda.synchronize()
    assert {k: v for k, v in common.LAUNCHES.items() if v} == {
        "carry_shift": 4 * len(CARRY_SHIFTS),
        "carry_add": 4 * len(CARRY_ADDS)}


@pytest.mark.parametrize("level", [0, 1, 2])
def test_cuda_carry_kernels_at_the_cells_shapes(dev, level):
    """At a B 16 step's rows (16·2^16) of the serve cell's three levels
    (logq 1200, 1170, 1140): ÷Q from ks_limbs 76 / 76 / 75 to qlimbs
    38 / 37 / 36, and the combine's add and mask at qlimbs, equal the
    plain BigInt functions run on the card."""
    from repro_torch.core import bigint
    from repro_torch.dist.he_pipeline import he_static
    from repro_torch.kernels.carry.ops import add_mask_op, shift_round_op
    p = paper_params()
    logq = (1200, 1170, 1140)[level]
    st = he_static(p, logq)
    K, ks = st.qlimbs, st.ks_limbs
    assert (K, ks) == ((38, 76), (37, 76), (36, 75))[level]
    g = torch.Generator(device=dev).manual_seed(level)

    def words(L):
        return torch.randint(-2**31, 2**31 - 1, (16, p.N, L), device=dev,
                             dtype=torch.int32, generator=g)

    x = words(ks)
    assert torch.equal(shift_round_op(x, p.logQ, K),
                       bigint.shift_right_round(x, p.logQ, out_limbs=K))
    a, b = words(K), words(K)
    assert torch.equal(add_mask_op(a, b, logq),
                       bigint.mask_bits(bigint.add(a, b), logq))


def test_cuda_b16_step_launches_each_carry_kernel_twice(dev, monkeypatch):
    """A B 16 step through the kernels launches the ÷Q shift twice (ax,
    bx) and the combine twice, and gives the words of the same step with
    both carried by the plain BigInt functions."""
    from repro_torch.core import bigint
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.kernels.carry import ref
    p = small_params()
    _, _, evk = keygen(p, seed=3, device=dev)
    st = hp.he_static(p, p.logQ)
    tabs = hp.runtime_tables(make_context(p, p.logQ, dev), evk)
    g = torch.Generator(device=dev).manual_seed(16)
    args = [bigint.mask_bits(torch.randint(
        -2**31, 2**31 - 1, (16, p.N, st.qlimbs), device=dev,
        dtype=torch.int32, generator=g), p.logQ) for _ in range(4)]
    common.reset_launches()
    got = hp.make_he_mul_step(st, dev, use_kernels=True)(*tabs, *args)
    torch.cuda.synchronize()
    assert common.LAUNCHES["carry_shift"] == 2
    assert common.LAUNCHES["carry_add"] == 2
    monkeypatch.setattr(hp, "shift_round_op", ref.shift_round_ref)
    monkeypatch.setattr(hp, "add_mask_op", ref.add_mask_ref)
    common.reset_launches()
    want = hp.make_he_mul_step(st, dev, use_kernels=True)(*tabs, *args)
    torch.cuda.synchronize()
    assert common.LAUNCHES["carry_shift"] == common.LAUNCHES["carry_add"] == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", ["rotate", "rotate mod2+modified",
                                  "conjugate", "conjugate at 2 limbs",
                                  "slot_sum", "mul_plain", "rescale",
                                  "mod_down", "mod_raise", "add", "sub",
                                  "add_plain"])
def test_cuda_per_op_steps_equal_plain_runs(dev, case):
    """Each batched step of hserve.engine at B = 3 and test_params()
    through the kernels gives its plain run's words and the single op's on
    every item; the conjugate at 2 limbs takes CRT below 3 limbs."""
    from repro_torch.core import rotate as R
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.hserve import engine as E
    p = small_params()
    B, low = 3, p.logQ - 3 * p.logp
    sk, pk, evk = keygen(p, seed=3, device=dev)
    rks = {r: R.rot_keygen(p, sk, r, device=dev) for r in (1, 2)}
    ck = R.conj_keygen(p, sk, device=dev)
    rng = np.random.default_rng(7)
    logq = {"conjugate at 2 limbs": low,
            "mod_raise": p.logQ - p.logp}.get(case, p.logQ)
    cts = [H.he_mod_down(H.encrypt_message(rng.random(4) + 0j, pk, p,
                                           seed=20 + i), p, logq)
           for i in range(2 * B)]
    pts = [H.encode_plain(rng.random(4), p, logq, device=dev)
           for _ in range(B)]
    st = hp.he_static(p, logq)
    t1, t2, _ = hp.runtime_tables(make_context(p, logq, dev), evk)
    ax, bx, ax2, bx2 = (torch.stack([getattr(c, f) for c in part])
                        for part in (cts[:B], cts[B:]) for f in ("ax", "bx"))
    pt = torch.stack(pts)
    rot = R.rotation_k(p, 1)

    def slot_sum(c):
        for r in (1, 2):
            c = H.he_add(c, R.he_rotate(c, r, rks[r], p))
        return c

    cases = {
        "rotate": (lambda kw: E.make_he_rotate_step(st, dev, rot, **kw),
                   (t2, hp.evk_tables(rks[1]), ax, bx),
                   lambda i: R.he_rotate(cts[i], 1, rks[1], p)),
        "conjugate": (lambda kw: E.make_he_rotate_step(
            st, dev, R.conjugation_k(p), **kw),
            (t2, hp.evk_tables(ck), ax, bx),
            lambda i: R.he_conjugate(cts[i], ck, p)),
        "slot_sum": (lambda kw: E.make_slot_sum_step(st, dev, 4, **kw),
                     (t2, (hp.evk_tables(rks[1]), hp.evk_tables(rks[2])),
                      ax, bx),
                     lambda i: slot_sum(cts[i])),
        "mul_plain": (lambda kw: E.make_mul_plain_step(st, dev, **kw),
                      (t1, ax, bx, pt),
                      lambda i: H.he_mul_plain(cts[i], pts[i], p)),
        "rescale": (lambda kw: E.make_rescale_step(st, dev, p.logp, **kw),
                    (ax, bx), lambda i: H.rescale(cts[i], p)),
        "mod_down": (lambda kw: E.make_mod_down_step(st, dev, 76, **kw),
                     (ax, bx), lambda i: H.he_mod_down(cts[i], p, 76)),
        "mod_raise": (lambda kw: E.make_mod_raise_step(st, dev, p.logQ,
                                                       **kw),
                      (ax, bx), lambda i: H.he_mod_raise(cts[i], p, p.logQ)),
        "add": (lambda kw: E.make_addsub_step(st, dev, "add", **kw),
                (ax, bx, ax2, bx2), lambda i: H.he_add(cts[i], cts[B + i])),
        "sub": (lambda kw: E.make_addsub_step(st, dev, "sub", **kw),
                (ax, bx, ax2, bx2), lambda i: H.he_sub(cts[i], cts[B + i])),
        "add_plain": (lambda kw: E.make_add_plain_step(st, dev, **kw),
                      (ax, bx, pt),
                      lambda i: H.he_add_plain(cts[i], pts[i], p)),
    }
    make, args, ref = cases[case.split(" ")[0]]
    knobs = ({"crt_strategy": "mod2", "modified_shoup": True}
             if "mod2" in case else {})
    got = make({"use_kernels": True, **knobs})(*args)
    plain = make({"use_kernels": False, **knobs})(*args)
    for i in range(B):
        r = ref(i)
        assert torch.equal(got[0][i], r.ax) and torch.equal(got[1][i], r.bx)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])


@pytest.mark.parametrize("logq", [1170, 1140, 1110, "keygen"])
def test_cuda_crt_icrt_at_lower_level_paper_shapes(dev, logq):
    """CRT (every strategy) and iCRT at the paper-param shapes of the
    levels a circuit descends to, and of Galois keygen, equal their plain
    versions on 2.5 blocks of coefficients (CRT K 37–35 into np₁ 79–75
    and np₂ 121–119, iCRT back to K and to 76–74 limbs; keygen: K 75 into
    np 81 and 122, iCRT np 81 → 75)."""
    from repro_torch.core.context import device_icrt_tables, device_tables
    p = paper_params()
    g = device_tables(p, dev)
    if logq == "keygen":
        q2 = p.limbs_for_bits(2 * p.logQ)
        np_kk = p.np_for_bits(p.primes, 2 * p.logQ + p.logN + 3)
        crt_shapes = [(q2, np_kk), (q2, p.np_region2(p.logQ))]
        icrt_shapes = [(np_kk, q2)]
    else:
        K, np1, np2 = p.qlimbs(logq), p.np_region1(logq), p.np_region2(logq)
        ks = p.limbs_for_bits(logq + p.logQ) + 1
        crt_shapes, icrt_shapes = [(K, np1), (K, np2)], [(np1, K), (np2, ks)]
    rng = np.random.default_rng(int(np.sum([k * n for k, n in crt_shapes])))
    n = 5 * CRT_BLOCK // 2
    primes = g.primes.cpu().numpy().view(np.uint32)
    for K, npn in crt_shapes:
        x = _t(rng.integers(0, 1 << 32, size=(n, K), dtype=np.uint64), dev)
        tabs = (g.crt_tb[:npn, :K].contiguous(),
                g.crt_tb_shoup[:npn, :K].contiguous(), g.primes[:npn])
        for strategy in ("acc3", "mod2", "mod4"):
            assert torch.equal(crt_op(x, *tabs, strategy=strategy),
                               crt_ref(x, *tabs, strategy=strategy))
    for npn, out in icrt_shapes:
        t = icrt_inputs(device_icrt_tables(p, npn, dev), g)
        r = _t(_residues(primes, npn, 5 * BLOCK // 2, npn), dev)
        assert torch.equal(icrt_op(r, t, out), icrt_ref(r, t, out))


@pytest.mark.parametrize("s", [1, 31, 32, 1200])
def test_cuda_bigint_shift_never_syncs_the_host(dev, s):
    """shift_right_round (the key switch's ÷Q and rescale's ÷p) issues no
    synchronizing operation: its rounding word is filled on the card, not
    assigned from a Python int (a blocking host-to-device copy)."""
    from repro_torch.core import bigint
    a = torch.randint(-2**31, 2**31 - 1, (4, 64, 76), dtype=torch.int32,
                      device=dev)
    want = bigint.shift_right_round(a.cpu(), s, out_limbs=38)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bigint.shift_right_round(a, s, out_limbs=38)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got.cpu(), want)


def _serve_stream(dev, p, keys, pk, **kw):
    """A mixed stream through an HEServer on `dev` at batch 4: three muls
    at logQ (a padded batch: 3 requests into 4), a mul one level down,
    rotate, conjugate, slot_sum, rescale, mod_down, add, mul_plain
    registered by hash and reused, and two staggered degree-4 circuits
    under the scheduler. Returns (outputs in submit order, server)."""
    from repro_torch.core.encoding import message_hash
    from repro_torch.hserve import HEServer, degree4_demo_circuit
    evk, rks, ck = keys
    server = HEServer(p, evk, rks, ck, device=dev, batch=4, schedule=True,
                      **kw)
    rng = np.random.default_rng(11)
    cts = [H.encrypt_message(rng.random(4) + 1j * rng.random(4), pk, p,
                             seed=30 + i) for i in range(8)]
    low = [H.he_mod_down(c, p, p.logQ - p.logp) for c in cts[:2]]
    w = rng.random(4)
    pt = H.encode_plain(w, p, p.logQ, device=dev)
    h = message_hash(w, p.log_delta)
    ops, _ = degree4_demo_circuit(p)
    s = server
    rids = [s.submit_mul(cts[0], cts[1]), s.submit_mul(cts[2], cts[3]),
            s.submit_mul(cts[4], cts[5]), s.submit_mul(low[0], low[1]),
            s.submit_rotate(cts[6], 1), s.submit_conjugate(cts[6]),
            s.submit_slot_sum(cts[7]), s.submit_rescale(cts[7]),
            s.submit_mod_down(cts[7], p.logQ - 2 * p.logp),
            s.submit_add(cts[6], cts[7]),
            s.submit_mul_plain(cts[6], pt, pt_hash=h),
            s.submit_mul_plain(cts[7], pt_hash=h),
            s.submit_circuit(ops, {"x": cts[0]})]
    res = dict(s.poll(flush=True))             # desync the two circuits
    rids.append(s.submit_circuit(ops, {"x": cts[1]}))
    res.update(s.drain())
    assert s._inflight is None and not s._circuits and not s.queue.depth
    return [res[r] for r in rids], server


@pytest.mark.parametrize("overlap", [False, True])
def test_cuda_served_stream_equals_plain_path_server(dev, overlap):
    """HEServer on the card at test_params() through the kernels gives the
    words of the same server on the plain path (use_kernels=False), with
    and without overlap, including a padded batch (3 muls into batch 4);
    every kernel launches; and once warm, dispatch never synchronizes the
    host with the card (set_sync_debug_mode("error") around it)."""
    from repro_torch.core.rotate import conj_keygen, rot_keygen
    p = small_params()
    sk, pk, evk = keygen(p, seed=3, device=dev)
    keys = (evk, {r: rot_keygen(p, sk, r, device=dev) for r in (1, 2)},
            conj_keygen(p, sk, device=dev))
    common.reset_launches()
    got, server = _serve_stream(dev, p, keys, pk, overlap=overlap)
    torch.cuda.synchronize()
    assert all(common.LAUNCHES[k] > 0
               for k in ("crt", "ntt", "intt", "icrt", "modmul"))
    assert server.stats()["per_op"]["mul"]["pad_frac"] > 0
    want, _ = _serve_stream(dev, p, keys, pk, overlap=overlap,
                            use_kernels=False)
    for a, b in zip(got, want):
        assert (a.logq, a.logp) == (b.logq, b.logp)
        assert torch.equal(a.ax, b.ax) and torch.equal(a.bx, b.bx)
    # the same signatures again on the warm server: dispatch must not sync
    dispatch = server.engine.dispatch

    def strict(batch):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    server.engine.dispatch = strict
    rng = np.random.default_rng(12)
    c = [H.encrypt_message(rng.random(4) + 0j, pk, p, seed=60 + i)
         for i in range(2)]
    rids = [server.submit_mul(c[0], c[1]), server.submit_rotate(c[0], 1),
            server.submit_conjugate(c[1]), server.submit_add(c[0], c[1])]
    res = server.drain()
    ref = H.he_mul(c[0], c[1], evk, p)
    assert torch.equal(res[rids[0]].ax, ref.ax)


@pytest.mark.parametrize("transport", ["inproc", "subprocess"])
def test_cuda_frontend_equals_heserver(dev, transport):
    """An HEFrontend on the host with two workers on the card (in this
    process, or worker processes that count their own launches) serves
    muls at two levels, a rotate, a conjugate and the degree-4 circuit
    word for word as HEServer on the card, also with worker 0 killed
    mid-batch; every kernel launches inside the workers."""
    from repro_torch.core.rotate import conj_keygen, rot_keygen
    from repro_torch.hserve import HEFrontend, HEServer, degree4_demo_circuit
    from repro_torch.runtime import FailureInjector
    p = small_params()
    sk, pk, evk = keygen(p, seed=3, device=dev)
    rks, ck = {1: rot_keygen(p, sk, 1, device=dev)}, \
        conj_keygen(p, sk, device=dev)
    rng = np.random.default_rng(13)
    cts = [H.encrypt_message(rng.random(4) + 1j * rng.random(4), pk, p,
                             seed=70 + i) for i in range(4)]
    low = [H.he_mod_down(c, p, p.logQ - p.logp) for c in cts]
    ops, _ = degree4_demo_circuit(p)

    def stream(s, on):
        rids = [s.submit_mul(on(a), on(b)) for a, b in
                zip(cts + low, cts[1:] + cts[:1] + low[1:] + low[:1])]
        rids += [s.submit_rotate(on(cts[0]), 1),
                 s.submit_conjugate(on(cts[1])),
                 s.submit_circuit(ops, {"x": on(cts[2])})]
        res = s.drain()
        return [res[r] for r in rids]

    want = stream(HEServer(p, evk, rks, ck, device=dev, batch=2),
                  lambda c: c)
    for inj in (None, FailureInjector(kill_worker_at={0: 1})):
        fe = HEFrontend(p, evk, rks, ck, workers=2, transport=transport,
                        batch=2, injector=inj)
        try:
            fe.worker_stats(reset_launches=True)
            got = stream(fe, lambda c: c.to("cpu"))
            for a, b in zip(got, want):
                assert (a.logq, a.logp) == (b.logq, b.logp)
                assert torch.equal(a.ax, b.ax.cpu())
                assert torch.equal(a.bx, b.bx.cpu())
            assert fe.stats()["frontend"]["deaths"] == (inj is not None)
            launched = {}
            for snap in fe.worker_stats().values():
                for k, v in snap["kernels"].items():
                    launched[k] = launched.get(k, 0) + v
            assert all(launched[k] > 0
                       for k in ("crt", "ntt", "intt", "icrt", "modmul"))
        finally:
            fe.close()


def test_cuda_worker_process_on_its_own_grid_equals_heserver(dev):
    """A worker process that is rank 0 of its own 2-rank grid on the card
    (its follower beside it, gloo): the stream equals HEServer's, and the
    split iCRT kernels launch inside the worker in place of the fused
    one."""
    from repro_torch.hserve import HEFrontend, HEServer
    p = small_params()
    sk, pk, evk = keygen(p, seed=3, device=dev)
    rng = np.random.default_rng(14)
    cts = [H.encrypt_message(rng.random(4) + 1j * rng.random(4), pk, p,
                             seed=80 + i) for i in range(4)]

    def stream(s, on):
        rids = [s.submit_mul(on(a), on(b))
                for a, b in zip(cts, cts[1:] + cts[:1])]
        res = s.drain()
        return [res[r] for r in rids]

    want = stream(HEServer(p, evk, device=dev, batch=2), lambda c: c)
    fe = HEFrontend(p, evk, workers=1, transport="subprocess",
                    worker_devices=2, batch=2)
    try:
        assert len(fe.workers[0].followers) == 1
        fe.worker_stats(reset_launches=True)
        got = stream(fe, lambda c: c.to("cpu"))
        for a, b in zip(got, want):
            assert torch.equal(a.ax, b.ax.cpu())
            assert torch.equal(a.bx, b.bx.cpu())
        snap = fe.worker_stats()[0]
        assert snap["kernels"]["icrt_partial"] > 0
        assert snap["kernels"]["icrt_finish"] > 0
        assert snap["kernels"]["icrt"] == 0
        assert snap["grid"]["step"]["counts"]["all-reduce"] > 0
    finally:
        fe.close()


def test_cuda_worker_init_raises_without_its_card(dev):
    """A worker asked for a card the machine does not have fails its
    init — in a worker process at the ack, in this process at the
    engine's construction. Nothing carries on on the CPU."""
    from repro_torch.hserve import HEFrontend, WorkerDied, WorkerEngine
    p = small_params()
    _, _, evk = keygen(p, seed=3, device=dev)
    missing = f"cuda:{torch.cuda.device_count()}"
    with pytest.raises(WorkerDied, match="failed init"):
        HEFrontend(p, evk, workers=1, transport="subprocess",
                   worker_device=missing)
    with pytest.raises(RuntimeError):
        WorkerEngine(p, evk, device=missing)


# ---------------------------------------------------------- bootstrapping

def _boot_env(dev):
    """boot_params() on the card: keys, the plan, its Galois keys, two
    exhausted ciphertexts of messages within the plan's bound."""
    from repro_torch.boot import boot_params, bootstrap_circuit
    from repro_torch.core.rotate import conj_keygen, rot_keygen
    p = boot_params()
    sk, pk, evk = keygen(p, seed=0, device=dev)
    plan = bootstrap_circuit(p, logq_in=p.logp, device=dev)
    rks = {req[1]: rot_keygen(p, sk, req[1], device=dev)
           for req in plan.requires if req[0] == "rot"}
    ck = conj_keygen(p, sk, device=dev)
    rng = np.random.default_rng(23)
    msgs, cts = [], []
    for i in range(2):
        z = rng.uniform(-1, 1, 8) + 1j * rng.uniform(-1, 1, 8)
        z *= plan.msg_bound / np.abs(z).max()
        msgs.append(z)
        cts.append(H.he_mod_down(H.encrypt_message(z, pk, p, seed=80 + i),
                                 p, p.logp))
    return p, sk, evk, rks, ck, plan, msgs, cts


def test_cuda_served_bootstrap_equals_plain_path(dev):
    """Two concurrent bootstraps through HEServer on the card, through the
    kernels, give the words of execute_circuit_reference on the plain
    path; every kernel launches; each decrypts within the plan's bound;
    they co-batch across circuits."""
    from repro_torch.hserve import HEServer
    from repro_torch.hserve.circuit import execute_circuit_reference
    p, sk, evk, rks, ck, plan, msgs, cts = _boot_env(dev)
    server = HEServer(p, evk, rks, ck, device=dev, batch=2, schedule=True)
    common.reset_launches()
    cids = [server.submit_bootstrap(ct, plan=plan) for ct in cts]
    res = server.drain()
    torch.cuda.synchronize()
    assert all(common.LAUNCHES[k] > 0
               for k in ("crt", "ntt", "intt", "icrt", "modmul"))
    assert server.stats()["cobatch"]["cross_circuit_batches"] > 0
    plain = PipelineConfig(use_kernels=False)
    for z, ct, cid in zip(msgs, cts, cids):
        want = execute_circuit_reference(plan.resolved_ops(), {"x": ct}, p,
                                         evk=evk, rot_keys=rks, conj_key=ck,
                                         cfg=plain)
        got = res[cid]
        assert (got.logq, got.logp) == (want.logq, want.logp)
        assert torch.equal(got.ax, want.ax) and torch.equal(got.bx, want.bx)
        err = np.abs(H.decrypt_message(got, sk, p) - z).max()
        assert err <= plan.error_bound()


def test_cuda_served_bootstrap_dispatch_never_syncs(dev):
    """Once the server is warm, a bootstrap's every dispatch — mod_raise,
    the BSGS rotations and plaintext products, EvalMod's muls and
    conjugations, the level ops — runs without synchronizing the host
    (set_sync_debug_mode("error") around each) and gives the cold run's
    words."""
    from repro_torch.hserve import HEServer
    p, sk, evk, rks, ck, plan, msgs, cts = _boot_env(dev)
    server = HEServer(p, evk, rks, ck, device=dev, batch=2, schedule=True)
    cid = server.submit_bootstrap(cts[0], plan=plan)
    cold = server.drain()[cid]
    dispatch, checked = server.engine.dispatch, []

    def strict(batch):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            checked.append(batch.op)

    server.engine.dispatch = strict
    cid = server.submit_bootstrap(cts[0], plan=plan)
    warm = server.drain()[cid]
    assert torch.equal(warm.ax, cold.ax) and torch.equal(warm.bx, cold.bx)
    assert {"mod_raise", "rotate", "conjugate", "mul", "mul_plain",
            "rescale", "add"} <= set(checked)


@pytest.mark.parametrize("logN", [4, 10])
def test_cuda_kernels_at_bootstrap_shapes(dev, logN):
    """Every kernel and variant equals its plain version at each level a
    bootstrap plan visits (logq 24..336, N = 16 and 1024), on one
    ciphertext and on a batch of four."""
    from repro_torch.boot import boot_params
    p = boot_params(logN=logN)
    N = p.N
    common.reset_launches()
    for logq in range(p.logp, p.logQ + 1, p.logp):
        tc = make_context(p, logq, dev)
        tg = tc.tables
        primes = tg.primes.cpu().numpy().view(np.uint32)
        for npn in (tc.np1, tc.np2):
            fwd = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
            inv = (tg.ipsi_rev[:npn], tg.ipsi_rev_shoup[:npn],
                   tg.n_inv[:npn], tg.n_inv_shoup[:npn], tg.primes[:npn])
            mm = (tg.primes[:npn], tg.pprime[:npn], tg.r2[:npn])
            tb = tg.crt_tb[:npn, :max(tc.qlimbs, 3)].contiguous()
            tbs = tg.crt_tb_shoup[:npn, :max(tc.qlimbs, 3)].contiguous()
            for B in (1, 4):
                x = _t(np.concatenate([_residues(primes, npn, N, logq + b)
                                       for b in range(B)]), dev)
                y = _t(np.concatenate([_residues(primes, npn, N, 7 + b)
                                       for b in range(B)]), dev)
                m4 = tuple(v.repeat(B) for v in mm)
                assert torch.equal(pointwise_mont_op(x, y, *m4),
                                   pointwise_mont_ref(x, y, *m4))
                for mod in (False, True):
                    ev = ntt_op(x, *fwd, modified=mod)
                    assert torch.equal(ev, ntt_ref(x, *fwd, modified=mod))
                    back = intt_op(ev, *inv, modified=mod)
                    assert torch.equal(back, intt_ref(ev, *inv,
                                                      modified=mod))
                    assert torch.equal(back, x)
                pr = random.Random(logq * 8 + B)
                limbs = _t(ints_to_limb_array(
                    [pr.getrandbits(32 * tc.qlimbs) for _ in range(B * N)],
                    tc.qlimbs, 32), dev)
                for strategy in ("acc3", "mod2", "mod4"):
                    assert torch.equal(
                        crt_op(limbs, tb, tbs, tg.primes[:npn],
                               strategy=strategy),
                        crt_ref(limbs, tb, tbs, tg.primes[:npn],
                                strategy=strategy))
                t = icrt_inputs(tc.icrt1 if npn == tc.np1 else tc.icrt2, tg)
                r = _t(np.concatenate([_residues(primes, npn, N, 3 + b)
                                       for b in range(B)], axis=1), dev)
                out = tc.qlimbs if npn == tc.np1 else \
                    p.limbs_for_bits(logq + p.logQ) + 1
                assert torch.equal(icrt_op(r, t, out), icrt_ref(r, t, out))
    torch.cuda.synchronize()
    assert all(common.LAUNCHES[k] > 0 for k in (
        "crt", "ntt", "intt", "icrt", "modmul", "crt_mod2", "crt_mod4",
        "ntt_modified", "intt_modified"))


def test_cuda_beta64_he_mul_equals_cpu(dev):
    """At β = 2^64 the card runs the plain path (the kernels take 32-bit
    words): keygen, two encryptions, he_mul and rescale at logN 5 give
    the CPU's words bit for bit, and launch no port kernel."""
    params = small_params(logN=5, beta_bits=64)
    plain = PipelineConfig(use_kernels=False)
    rng = np.random.default_rng(64)
    z = [rng.normal(size=8) + 1j * rng.normal(size=8) for _ in range(2)]
    out = {}
    for where in ("cpu", dev):
        common.reset_launches()
        sk, pk, evk = keygen(params, seed=5, cfg=plain, device=where)
        c1, c2 = (H.encrypt_message(zz, pk, params, seed=30 + i, cfg=plain)
                  for i, zz in enumerate(z))
        out[str(where)] = H.rescale(H.he_mul(c1, c2, evk, params, plain),
                                    params)
        assert sum(common.LAUNCHES.values()) == 0
    cpu, card = out["cpu"], out[str(dev)]
    assert card.ax.dtype == torch.int64 and card.ax.is_cuda
    assert torch.equal(cpu.ax, card.ax.cpu())
    assert torch.equal(cpu.bx, card.bx.cpu())
    got = H.decrypt_message(card, sk, params, plain)
    assert np.abs(got - z[0] * z[1]).max() < 1e-3
    with pytest.raises(ValueError, match="use_kernels=False"):
        H.he_mul(c1, c2, evk, params)


# --------------------------------------------------------------------------
# iCRT split at the cross-prime sum, and the step across ranks
# --------------------------------------------------------------------------

def _shard(t, s):
    return {k: (v[s].clone() if k not in ("P_limbs", "P_half_limbs") else v)
            for k, v in t.items()}


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("region", [1, 2])
@pytest.mark.parametrize("shape", ["paper", "boot-4", "boot-10"])
def test_cuda_icrt_partial_and_finish_match_twins(dev, shape, region, B):
    """icrt_partial equals its plain twin bit for bit (lo, hi and the f64
    qsum) on every shard of the region's np into 2 and 4 ranks
    (paper_params(): 41/40, 61/61, 21/21/21/18, 31/31/31/29;
    boot_params(logN=4) and boot_params(logN=10): 12/11, 17/17, 18/17 and
    their quarters), on one prime and on an empty shard (which launches
    nothing); the partials of each split, summed, finish (icrt_finish ==
    its twin) to the fused icrt_op's words, on random residues and on
    every residue p − 1. The bootstrap shapes run at B·N and at B·N + 17
    coefficients too: below a tile of either kernel, a ragged last tile
    and an odd count of words in the partial's last span."""
    from repro_torch.boot import boot_params
    from repro_torch.core.context import device_icrt_tables, device_tables
    from repro_torch.dist.sharding import prime_rows
    from repro_torch.kernels.icrt.ops import icrt_finish_op, icrt_partial_op
    from repro_torch.kernels.icrt.ref import (
        icrt_finish_ref, icrt_partial_ref,
    )
    p = paper_params() if shape == "paper" else \
        boot_params(logN=int(shape.split("-")[1]))
    logq = p.logQ
    npn = p.np_region1(logq) if region == 1 else p.np_region2(logq)
    out_limbs = p.qlimbs(logq) if region == 1 else \
        p.limbs_for_bits(logq + p.logQ) + 1
    g = device_tables(p, dev)
    t = icrt_inputs(device_icrt_tables(p, npn, dev), g)
    primes = g.primes.cpu().numpy().view(np.uint32)
    widths = (B * p.N,) if shape == "paper" else (B * p.N, B * p.N + 17)
    for n in widths:
        for r in (_t(_residues(primes, npn, n, 40 + region + B), dev),
                  _t(np.repeat(primes[:npn, None] - 1, n, 1), dev)):
            whole = icrt_op(r, t, out_limbs)
            common.reset_launches()
            for s in (slice(0, 1), slice(0, 0)):
                got = icrt_partial_op(r[s], _shard(t, s))
                want = icrt_partial_ref(r[s], _shard(t, s))
                assert all(torch.equal(a, b) for a, b in zip(got, want))
            assert common.LAUNCHES["icrt_partial"] == 1
            for g_ in (2, 4):
                parts = []
                for k in range(g_):
                    s = prime_rows(npn, g_, k)
                    got = icrt_partial_op(r[s], _shard(t, s))
                    want = icrt_partial_ref(r[s], _shard(t, s))
                    assert all(torch.equal(a, b) for a, b in zip(got, want))
                    parts.append(got)
                summed = [sum(x[i] for x in parts) for i in range(3)]
                fin = icrt_finish_op(*summed, t, out_limbs)
                assert torch.equal(fin, icrt_finish_ref(*summed, t,
                                                        out_limbs))
                assert torch.equal(fin, whole)
            torch.cuda.synchronize()
            assert common.LAUNCHES["icrt_partial"] == 7
            assert common.LAUNCHES["icrt_finish"] == 2


def _cuda_grid_step_rank(grid):
    """One rank of a 2-rank grid on the card: the sharded kernel step at
    test_params(logN=10) against the one-rank kernel step."""
    from repro_torch.dist import comm
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.hserve.tables import TableCache
    p = small_params(logN=10, beta_bits=32, logQ=240, logp=24)
    dev = grid.device
    _, pk, evk = keygen(p, seed=4, device=dev)
    rng = np.random.default_rng(6)
    cts = [H.encrypt_message(rng.normal(size=8) + 1j * rng.normal(size=8),
                             pk, p, seed=60 + i) for i in range(8)]
    xs = [torch.stack([getattr(c, f) for c in cts[s::2]])
          for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
    st = hp.he_static(p, p.logQ)
    tabs = hp.runtime_tables(make_context(p, p.logQ, dev), evk)
    want = hp.make_he_mul_step(st, dev, use_kernels=True)(*tabs, *xs)
    cache = TableCache(p, evk, device=dev, grid=grid)
    t1, t2 = cache.level_tables(p.logQ)
    common.reset_launches()
    got = hp.make_he_mul_step(st, dev, grid=grid, use_kernels=True)(
        t1, t2, cache.evk(), *xs)
    torch.cuda.synchronize()
    return {"bitwise": all(torch.equal(a, b) for a, b in zip(got, want)),
            "launches": {k: v for k, v in common.LAUNCHES.items() if v},
            "schedule": comm.summary(grid, "step")["counts"]}


def test_cuda_grid_step_equals_one_rank_kernel_step(dev):
    """Two ranks on this card (gloo): the sharded step through the
    kernels (the split iCRT among them) equals the one-rank kernel step
    bit for bit, with 15 all-reduces a step."""
    from repro_torch.launch.mesh import spawn_grid
    for res in spawn_grid(_cuda_grid_step_rank, model=2, device="cuda",
                          timeout_s=120):
        assert res["bitwise"]
        assert res["schedule"] == {"all-reduce": 15}
        assert res["launches"]["icrt_partial"] == 5
        assert res["launches"]["icrt_finish"] == 5
        assert "icrt" not in res["launches"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base"])
def test_cuda_lm_reduced_matches_the_cpu(dev, arch, monkeypatch):
    """A reduced() LM on the card against the same weights on the CPU,
    TF32 off: prefill's logits and cache, two decode steps, and generate's
    tokens (equal wherever the CPU's top-2 gap exceeds 1e-3), within 1e-4;
    no kernel of the port launches on the LM path."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_params, prefill
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_arch(arch).reduced()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    twin = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    twin.load_state_dict(model.state_dict())
    batch = SyntheticLM(cfg, 2, 16, seed=1, device=dev).batch_at(0)
    batch.pop("labels")
    host = {k: v.cpu() for k, v in batch.items()}

    def close(a, b):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)

    common.reset_launches()
    logits, cache = prefill(model, batch, cfg, 24)
    want, wcache = prefill(twin, host, cfg, 24)
    close(logits, want)
    for a, b in zip(cache_leaves(cache), cache_leaves(wcache)):
        close(a, b)
    for i in range(2):
        tok = batch["tokens"][:, i: i + 1]
        logits, cache = decode_step(model, cache, tok, 16 + i, cfg)
        want, wcache = decode_step(twin, wcache, tok.cpu(), 16 + i, cfg)
        close(logits, want)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    toks = generate(model, cfg, batch["tokens"], 4, 24, batch_extra=extra)
    # the CPU's logits along the card's tokens
    want, wcache = prefill(twin, host, cfg, 24)
    for i in range(4):
        top2 = want[:, -1].topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-3
        assert torch.equal(toks[:, i].cpu()[clear],
                           want[:, -1].argmax(-1).to(torch.int32)[clear])
        want, wcache = decode_step(twin, wcache, toks[:, i: i + 1].cpu(),
                                   16 + i, cfg)
    torch.cuda.synchronize()
    assert not any(common.LAUNCHES.values())


TRAIN_KW = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                head_dim=32, d_ff=128, vocab_size=256)


def _train_config(**kw):
    from repro_torch.launch.train import TrainConfig
    base = dict(batch=2, seq_len=16, steps=8, ckpt_every=2, warmup_steps=2)
    base.update(kw)
    return TrainConfig(**base)


def test_cuda_train_replay_is_bitwise(dev, tmp_path):
    """tests/test_fault_tolerance.py's crash/restart replay on the card:
    parameters and moments equal bit for bit; no kernel of the port
    launches on the training path."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import Trainer, run_with_restarts
    from repro_torch.runtime import FailureInjector
    cfg = get_arch("llama3.2-1b").reduced(**TRAIN_KW)
    common.reset_launches()
    ref = Trainer(cfg, _train_config(), ckpt_dir=str(tmp_path / "ref"),
                  device=dev)
    ref.run()
    inj = FailureInjector(fail_at_steps=[3, 6])
    trainer, _, restarts = run_with_restarts(
        lambda: Trainer(cfg, _train_config(), ckpt_dir=str(tmp_path / "c"),
                        injector=inj, device=dev), total_steps=8)
    assert restarts == 2
    for k, v in ref.params.state_dict().items():
        assert torch.equal(v, trainer.params.state_dict()[k]), k
    for k, m in ref.opt.mu.items():
        assert torch.equal(m, trainer.opt.mu[k])
        assert torch.equal(ref.opt.nu[k], trainer.opt.nu[k])
    torch.cuda.synchronize()
    assert not any(common.LAUNCHES.values())


def test_cuda_trainer_matches_the_cpu(dev, monkeypatch):
    """The same Trainer on the card and on the CPU from the card's
    initial weights, TF32 off: loss histories within 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import Trainer
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = get_arch("llama3.2-1b").reduced(**TRAIN_KW)
    card = Trainer(cfg, _train_config(), device=dev)
    cpu = Trainer(cfg, _train_config(), device="cpu")
    cpu.params.load_state_dict(card.params.state_dict())
    want = [h["loss"] for h in cpu.run()["history"]]
    got = [h["loss"] for h in card.run()["history"]]
    assert len(got) == 8
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-4


def cache_leaves(tree) -> list:
    """The tensors of a nested dict/list cache, in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in cache_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in cache_leaves(v)]
    return [tree]
