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

from repro.core import crt as j_core_crt
from repro.core import make_context as j_make_context
from repro.core import test_params as j_test_params
from repro.kernels.crt.crt import crt_pallas as j_crt_pallas
from repro.kernels.crt.ops import crt_op as j_crt_op
from repro.kernels.crt.ref import crt_ref as j_crt_ref
from repro.kernels.icrt.ops import icrt_op as j_icrt_op
from repro.kernels.icrt.ref import icrt_ref as j_icrt_ref
from repro.kernels.modmul.ops import pointwise_mont_op as j_mont_op
from repro.kernels.modmul.ref import pointwise_mont_ref as j_mont_ref
from repro.kernels.ntt.ntt import intt_pallas as j_intt_pallas
from repro.kernels.ntt.ntt import ntt_pallas as j_ntt_pallas
from repro.kernels.ntt.ops import intt_op as j_intt_op
from repro.kernels.ntt.ops import ntt_op as j_ntt_op
from repro.kernels.ntt.ref import intt_ref as j_intt_ref
from repro.kernels.ntt.ref import ntt_ref as j_ntt_ref
from repro.nt.residue import ints_to_limb_array

from repro_torch.core import crt as t_core_crt
from repro_torch.core import make_context
from repro_torch.core import test_params as t_test_params
from repro_torch.core.context import build_icrt_tables
from repro_torch.core.params import paper_params
from repro_torch.core.ntt import pointwise_shoup_scale
from repro_torch.kernels import common
from repro_torch.kernels.crt.ops import BLOCK as CRT_BLOCK
from repro_torch.kernels.crt.ops import crt_geometry, crt_op
from repro_torch.kernels.crt.ref import crt_ref
from repro_torch.kernels.icrt.ops import (BLOCK, SMEM_LIMIT, icrt_geometry,
                                          icrt_op)
from repro_torch.kernels.icrt.ref import icrt_inputs, icrt_ref
from repro_torch.kernels.icrt.variants import SPLIT_VARIANTS as \
    ICRT_SPLIT_VARIANTS
from repro_torch.kernels.icrt.variants import VARIANTS as ICRT_VARIANTS
from repro_torch.kernels.icrt.variants import \
    variant_source as icrt_variant_source
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.modmul.ref import pointwise_mont_ref
from repro_torch.kernels.ntt.ops import (intt_op, ntt_args, ntt_geometry,
                                        ntt_op)
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
        got = icrt_ref(_t(r), icrt_inputs(tt, tg), out_limbs)
        _assert_all_equal(got, j_icrt_op(jnp.asarray(r), jt, g, out_limbs),
                          j_icrt_ref(jnp.asarray(r), jt, g, out_limbs))
        assert torch.equal(icrt_op(_t(r), icrt_inputs(tt, tg), out_limbs),
                           got)


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
    got = icrt_ref(_t(res), icrt_inputs(tc.icrt1, tc.tables),
                   tabs.accum_limbs)
    _assert_all_equal(
        got, j_icrt_op(jnp.asarray(res), tabs, g, tabs.accum_limbs),
        j_icrt_ref(jnp.asarray(res), tabs, g, tabs.accum_limbs,
                   strategy="acc3"))


@pytest.mark.parametrize("params,B", [
    ("test-4-96", 1), ("test-5-120", 1), ("test-10-240", 3), ("paper", 1),
    ("paper", 4)])
def test_icrt_launch_geometry_fits_hopper(params, B):
    """Every iCRT launch of these params (the test params above, the batched
    step's of tests/test_torch_cuda.py, and paper_params() with np 81/122
    for HE Mul and the B = 4 batched step) fits a Hopper block's shared
    memory and covers its N coefficients; an N above one block that is not
    a multiple of it raises."""
    if params == "paper":
        p = paper_params()
    else:
        _, logN, logQ = params.split("-")
        p = t_test_params(logN=int(logN), beta_bits=32, logQ=int(logQ),
                          logp=24)
    q, N = p.logQ, B * p.N
    for npn, out_limbs in ((p.np_region1(q), p.qlimbs(q)),
                           (p.np_region2(q), p.limbs_for_bits(2 * q) + 1)):
        A = build_icrt_tables(p, npn).accum_limbs
        for ol in (out_limbs, A + 2):
            blocks, threads, smem = icrt_geometry(N, npn, A, ol)
            assert smem <= SMEM_LIMIT and threads == 128
            assert blocks * BLOCK >= N > (blocks - 1) * BLOCK
            assert N <= BLOCK or N % BLOCK == 0
        with pytest.raises(ValueError, match="multiple of"):
            icrt_geometry(max(N, BLOCK) + BLOCK // 2, npn, A, out_limbs)


def _split_params(name):
    from repro_torch.boot import boot_params
    return paper_params() if name == "paper" else \
        boot_params(logN=int(name.split("-")[1]))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("params", ["paper", "boot-4", "boot-10"])
def test_icrt_partial_geometry_covers_every_shard(params, B):
    """icrt_partial_geometry for every shard of 1, 2 and 4 ranks of each
    region's primes (paper_params(): np 81 and 122; boot_params(logN=4)
    and boot_params(logN=10): 23/34 and 23/35): its tiles of ROWS cover
    the B·N coefficients, a warp per 16 staged columns, the shared memory
    within SMEM_LIMIT; an empty shard is refused (it launches
    nothing)."""
    from repro_torch.dist.sharding import prime_rows
    from repro_torch.kernels.icrt.ops import ROWS, icrt_partial_geometry
    p = _split_params(params)
    q, N = p.logQ, B * p.N
    for npn in (p.np_region1(q), p.np_region2(q)):
        PL = build_icrt_tables(p, npn).pdivp.shape[1]
        for ranks in (1, 2, 4):
            for k in range(ranks):
                s = prime_rows(npn, ranks, k)
                blocks, threads, smem = icrt_partial_geometry(
                    N, s.stop - s.start, PL)
                assert blocks * ROWS >= N > (blocks - 1) * ROWS
                assert threads % 32 == 0 and 2 * PL <= threads <= 256
                assert 0 < smem <= SMEM_LIMIT
        with pytest.raises(ValueError, match="empty shard"):
            icrt_partial_geometry(N, 0, PL)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("params", ["paper", "boot-4", "boot-10"])
def test_icrt_finish_geometry_covers_every_width(params, B):
    """icrt_finish_geometry at each region's accumulator, output limbs
    (and one limb past the accumulator) and PL: its blocks of one warp,
    FINISH_ROWS coefficients each, cover B·N and B·N + 17 coefficients (a
    ragged last tile), the shared memory within SMEM_LIMIT."""
    from repro_torch.kernels.icrt.ops import (
        FINISH_ROWS, icrt_finish_geometry,
    )
    p = _split_params(params)
    q = p.logQ
    for npn, out_limbs in ((p.np_region1(q), p.qlimbs(q)),
                           (p.np_region2(q), p.limbs_for_bits(2 * q) + 1)):
        tabs = build_icrt_tables(p, npn)
        A, PL = tabs.accum_limbs, tabs.pdivp.shape[1]
        for N in (B * p.N, B * p.N + 17):
            for ol in (out_limbs, A + 1):
                blocks, threads, smem = icrt_finish_geometry(N, A, ol, PL)
                assert blocks * FINISH_ROWS >= N > (blocks - 1) * FINISH_ROWS
                assert threads == 32
                assert 0 < smem <= SMEM_LIMIT


@pytest.mark.parametrize("name", sorted(ICRT_VARIANTS) +
                         sorted(ICRT_SPLIT_VARIANTS))
def test_icrt_variant_edits_apply_once(name):
    """Every timed variant of csrc/icrt.cu (python -m
    repro_torch.kernels.icrt.variants), of the fused kernel and of the
    split pair, finds each piece of text it replaces exactly once."""
    text = (common.CSRC / "icrt.cu").read_text()
    edits = (ICRT_VARIANTS.get(name) or ICRT_SPLIT_VARIANTS[name])[-1]
    assert icrt_variant_source(text, edits) != text


@pytest.mark.parametrize("params,B", [
    ("test-4-96", 1), ("test-5-120", 1), ("test-10-240", 3), ("paper", 1),
    ("paper", 4)])
def test_crt_launch_geometry_fits_hopper(params, B):
    """Every CRT launch of these params (their limbs and the double-width
    limbs of the tests, and K = 38; paper_params() with np 81/122 for HE
    Mul and the B = 4 batched step) fits a Hopper block's shared memory
    and covers its N coefficients; an N above one block that is not a
    multiple of it raises."""
    if params == "paper":
        p = paper_params()
    else:
        _, logN, logQ = params.split("-")
        p = t_test_params(logN=int(logN), beta_bits=32, logQ=int(logQ),
                          logp=24)
    q, N = p.logQ, B * p.N
    for npn in (p.np_region1(q), p.np_region2(q)):
        for K in (p.qlimbs(q), 2 * p.qlimbs(q), 38):
            blocks, threads, smem = crt_geometry(N, K, npn)
            assert smem <= SMEM_LIMIT and threads == 256
            assert blocks * CRT_BLOCK >= N > (blocks - 1) * CRT_BLOCK
            assert N <= CRT_BLOCK or N % CRT_BLOCK == 0
        with pytest.raises(ValueError, match="multiple of"):
            crt_geometry(max(N, CRT_BLOCK) + CRT_BLOCK // 2, 38, npn)


@pytest.mark.parametrize("params,B", [
    ("test-5-120", 3), ("test-5-120", 5), ("test-5-120", 9),
    ("test-7-120", 3), ("test-10-240", 3), ("paper", 1), ("paper", 4)])
def test_batched_widths_pad_to_a_width_the_launch_takes(params, B):
    """crt_op and icrt_op run a folded width B·N that their launch cannot
    tile (above one block, not a multiple of it) zero-padded to the next
    multiple of the block, which the launch takes; a width it can tile,
    such as every paper shape, is not padded."""
    if params == "paper":
        p = paper_params()
    else:
        _, logN, logQ = params.split("-")
        p = t_test_params(logN=int(logN), beta_bits=32, logQ=int(logQ),
                          logp=24)
    q, N = p.logQ, B * p.N
    K = p.qlimbs(q)
    for npn, out_limbs in ((p.np_region1(q), K),
                           (p.np_region2(q), p.limbs_for_bits(2 * q) + 1)):
        A = build_icrt_tables(p, npn).accum_limbs
        for block, launch in (
                (CRT_BLOCK, lambda n: crt_geometry(n, K, npn)),
                (BLOCK, lambda n: icrt_geometry(n, npn, A, out_limbs))):
            n = common.padded(N, block)
            assert N <= n < N + block
            tiles = N <= block or N % block == 0
            assert (n == N) == tiles
            if not tiles:
                assert n % block == 0
                with pytest.raises(ValueError, match="multiple of"):
                    launch(N)
            blocks, _, _ = launch(n)
            assert blocks * block >= n > (blocks - 1) * block
            if params == "paper":
                assert n == N
    if params == "test-5-120":   # N = 32: iCRT pads B = 3, 5, 9; CRT B = 9
        assert common.padded(N, BLOCK) != N
        assert (common.padded(N, CRT_BLOCK) != N) == (B == 9)


@pytest.mark.parametrize("logn", [1, 4, 5, 9, 10, 12, 14, 16])
def test_ntt_launch_geometry_fits_cuda_grid(logn):
    """Every NTT/iNTT pass, for up to 122 × 600 rows (beyond gridDim.y's
    65535), is one flat grid within CUDA's 2^31 − 1 blocks, of at most
    1024 threads and SMEM_LIMIT bytes, whose blocks cover every row's
    tiles; the passes run every stage once, at most 8 a pass, and
    N = 2^16 takes two passes of 8, the chunk pass 4 rows a block. This
    is the geometry the launcher takes (ntt_args)."""
    for npn, rows in ((1, 1), (3, 3), (81, 81), (122, 122), (122, 4 * 122),
                      (1, 65535), (2, 65536), (122, 122 * 600)):
        passes = ntt_geometry(rows, logn, npn)
        assert sum(L for L, *_ in passes) == logn
        assert len(passes) == 1 + max(0, -(-(logn - 8) // 8))
        for i, (L, logT, rpb, blocks, threads, smem) in enumerate(passes):
            assert 1 <= L <= 8 and L <= logT <= max(logn, L + 5)
            assert rpb == 1 or i == len(passes) - 1
            assert blocks == npn * -(-(rows // npn) // rpb) << (logn - logT)
            assert rows // 4 <= blocks <= 2 ** 31 - 1
            assert threads <= 1024 and smem <= SMEM_LIMIT
        n, geom = ntt_args(rows, logn, npn)
        assert n == len(passes)
        assert list(geom) == [v for g in passes for v in g]
    if logn == 16:
        assert [(L, rpb) for L, _, rpb, *_ in ntt_geometry(4 * 122, 16, 122)
                ] == [(8, 1), (8, 4)]
    with pytest.raises(ValueError):
        ntt_geometry(2 ** 31, logn, 1)
    with pytest.raises(ValueError):
        ntt_geometry(1, 31, 1)
    with pytest.raises(ValueError):
        ntt_geometry(5, logn, 2)


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


@pytest.mark.parametrize("logN", [4, 7])
def test_modified_ntt_intt_plain_match_pallas(logN):
    """modified=True: the plain transforms equal the Pallas kernels, and
    equal the exact transforms; a batch of rows takes twiddle row r mod np.
    """
    jc, tc = _ctx(logN=logN)
    g, tg = jc.tables, tc.tables
    npn, N = jc.np1, jc.N
    x = _rand_residues(g.primes, npn, N, seed=40 + logN)
    jfwd = (jnp.asarray(g.psi_rev[:npn]), jnp.asarray(g.psi_rev_shoup[:npn]),
            jnp.asarray(g.primes[:npn]))
    jinv = (jnp.asarray(g.ipsi_rev[:npn]),
            jnp.asarray(g.ipsi_rev_shoup[:npn]), jnp.asarray(g.n_inv[:npn]),
            jnp.asarray(g.n_inv_shoup[:npn]), jnp.asarray(g.primes[:npn]))
    fwd = (tg.psi_rev[:npn], tg.psi_rev_shoup[:npn], tg.primes[:npn])
    inv = (tg.ipsi_rev[:npn], tg.ipsi_rev_shoup[:npn], tg.n_inv[:npn],
           tg.n_inv_shoup[:npn], tg.primes[:npn])
    ev = ntt_ref(_t(x), *fwd, modified=True)
    _assert_all_equal(ev, j_ntt_pallas(jnp.asarray(x), *jfwd, modified=True,
                                       interpret=True))
    assert torch.equal(ev, ntt_ref(_t(x), *fwd))
    back = intt_ref(ev, *inv, modified=True)
    _assert_all_equal(back, j_intt_pallas(jnp.asarray(_np(ev)), *jinv,
                                          modified=True, interpret=True), x)
    y = _rand_residues(g.primes, npn, N, seed=50 + logN)
    rows = _t(np.concatenate([x, y]))
    for mod in (False, True):
        got = ntt_op(rows, *fwd, modified=mod)
        assert torch.equal(got[:npn], ev)
        assert torch.equal(got[npn:], ntt_ref(_t(y), *fwd))
        assert torch.equal(intt_op(got, *inv, modified=mod), rows)


@pytest.mark.parametrize("strategy", ["mod2", "mod4"])
def test_crt_modx_plain_matches_pallas(strategy):
    """The Mod-x plain version equals _crt_kernel_modx (interpret mode) and
    the JAX core CRT, on random limbs and on all-(2^32−1) limbs against
    tables of p−1 past the fold columns, where four products pass 2^63."""
    jc, tc = _ctx(logN=5, logQ=120)
    g, tg = jc.tables, tc.tables
    N = jc.N
    for npn, K in ((jc.np1, jc.qlimbs), (jc.np2, 2 * jc.qlimbs)):
        tb = np.array(g.crt_tb[:npn, :K])
        primes = np.asarray(g.primes[:npn]).astype(np.uint64)
        x = _limbs(N, K, 32 * K, seed=60 + K)
        for edge in (False, True):
            if edge:
                x = np.full((N, K), 0xFFFFFFFF, np.uint32)
                tb[:, 3:] = (primes - 1)[:, None]
            tbs = ((tb.astype(np.uint64) << np.uint64(32))
                   // primes[:, None]).astype(np.uint32)
            jargs = (jnp.asarray(x), jnp.asarray(tb), jnp.asarray(tbs),
                     jnp.asarray(g.primes[:npn]))
            got = crt_ref(_t(x), _t(tb), _t(tbs), tg.primes[:npn],
                          strategy=strategy)
            _assert_all_equal(
                got, j_crt_pallas(*jargs, strategy=strategy, interpret=True),
                j_core_crt.crt(*jargs, strategy=strategy))
            assert torch.equal(crt_op(_t(x), _t(tb), _t(tbs),
                                      tg.primes[:npn], strategy=strategy),
                               got)


def test_core_crt_and_icrt_strategies_match_reference():
    """Every CRT and iCRT strategy of the port's core equals the JAX
    package's; the kernels' formulations (acc3, columns) equal them too,
    and "columns" is not a strategy of the port's iCRT."""
    jc, tc = _ctx(logN=5, logQ=120)
    g, tg = jc.tables, tc.tables
    npn, K, N = jc.np2, 2 * jc.qlimbs, jc.N
    x = _limbs(N, K, 32 * K, seed=70)
    x[0], x[1] = 0, 0xFFFFFFFF
    jargs = (jnp.asarray(x), jnp.asarray(g.crt_tb[:npn, :K]),
             jnp.asarray(g.crt_tb_shoup[:npn, :K]),
             jnp.asarray(g.primes[:npn]))
    targs = (_t(x), tg.crt_tb[:npn, :K].contiguous(),
             tg.crt_tb_shoup[:npn, :K].contiguous(), tg.primes[:npn])
    for strategy in ("matmul", "shoup", "mod2", "mod4", "acc3"):
        _assert_all_equal(t_core_crt.crt(*targs, strategy=strategy),
                          j_core_crt.crt(*jargs, strategy=strategy))
    with pytest.raises(ValueError):
        t_core_crt.crt(*targs, strategy="mod3")

    jt, tt = jc.icrt2, tc.icrt2
    r = _rand_residues(g.primes, npn, N, seed=71)
    out_limbs = jt.accum_limbs + 2
    want = j_core_crt.icrt(
        jnp.asarray(r), jt, jnp.asarray(g.primes[:npn]),
        jnp.asarray(jt.inv_P), jnp.asarray(jt.inv_P_shoup),
        jnp.asarray(jt.pdivp), jnp.asarray(jt.P_limbs),
        jnp.asarray(jt.P_half_limbs), jnp.asarray(g.p_inv_f64[:npn]),
        out_limbs, strategy="matmul")
    targs = (_t(r), tg.primes[:npn], tt.inv_P, tt.inv_P_shoup, tt.pdivp,
             tt.P_limbs, tt.P_half_limbs, tg.p_inv_f64[:npn], out_limbs)
    for strategy in ("matmul", "acc3", "naive"):
        got = t_core_crt.icrt(*targs, strategy=strategy)
        _assert_all_equal(got, want)
        _assert_all_equal(got, j_core_crt.icrt(
            jnp.asarray(r), jt, jnp.asarray(g.primes[:npn]),
            jnp.asarray(jt.inv_P), jnp.asarray(jt.inv_P_shoup),
            jnp.asarray(jt.pdivp), jnp.asarray(jt.P_limbs),
            jnp.asarray(jt.P_half_limbs),
            jnp.asarray(g.p_inv_f64[:npn]), out_limbs,
            strategy=strategy))
    _assert_all_equal(icrt_ref(_t(r), icrt_inputs(tt, tg), out_limbs), want)
    with pytest.raises(ValueError):
        t_core_crt.icrt(*targs, strategy="columns")


_NVCC_STUB = """
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
link = "-shared" in args
with open({log!r}, "a") as f:
    f.write(("link " if link else "compile ") + out + "\\n")
time.sleep(0.5)
with open(out, "wb") as f:
    f.write(b"".join(open(a, "rb").read() for a in args if a.endswith(".o"))
            if link else b"object of " + out.encode())
"""

_BUILD_PROBE = """
import json, sys
from pathlib import Path
from repro_torch.kernels import common
common.BUILD_ROOT = Path(sys.argv[1])
print(json.dumps(str(common.build())))
"""


def test_build_is_safe_when_processes_start_cold_together(tmp_path):
    """Two processes run build() on a cold cache at once, against a stub
    nvcc found through CUDA_HOME (common._nvcc): one compiles each source
    and links once, the other waits on the build lock and returns the
    same library."""
    import json
    import os
    import subprocess
    import sys
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f"#!{sys.executable}\n" + _NVCC_STUB.format(log=str(log)))
    nvcc.chmod(0o755)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=os.path.join(repo, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _BUILD_PROBE, str(tmp_path / "build")],
        stdout=subprocess.PIPE, text=True, env=env) for _ in range(2)]
    libs = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert libs[0] == libs[1] and os.path.isfile(libs[0])
    sources = sorted(common.CSRC.glob("*.cu"))
    calls = log.read_text().splitlines()
    assert sorted(c.split()[0] for c in calls) == \
        ["compile"] * len(sources) + ["link"]
    with open(libs[0], "rb") as f:        # the link of every object
        assert f.read().count(b"object of ") == len(sources)
