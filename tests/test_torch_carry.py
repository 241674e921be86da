"""The carry kernels' wrappers (kernels/carry) on the CPU.

On CPU tensors ``shift_round_op`` and ``add_mask_op`` run their plain
versions, the BigInt functions they replace; here both are held against
those functions and against Python's integers on the rows that stress a
carry chain (negative values, a rounding carry through every limb, the
largest positive value overflowing), and the steps that route the ÷Q shift
and the combines through them with ``use_kernels`` give the plain path's
words. The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py, on a card.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bigint
from repro_torch.core import heaan as H
from repro_torch.core import make_context
from repro_torch.core import rotate as R
from repro_torch.core import test_params as small_params
from repro_torch.core.keys import keygen
from repro_torch.dist import he_pipeline as hp
from repro_torch.hserve import engine as E
from repro_torch.kernels import common
from repro_torch.kernels.carry.ops import add_mask_op, shift_round_op


def _rows(n: int, L: int, seed: int) -> torch.Tensor:
    """(n, L) int32 limb rows: random, then (where n allows) all ones
    (−1: a rounding carry runs through every limb), the largest positive
    value (it overflows to negative), a negative value with zero limbs
    below, and zero."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(n, L), dtype=np.uint64)
    edges = [np.full(L, 0xFFFFFFFF), np.r_[np.full(L - 1, 0xFFFFFFFF),
                                           0x7FFFFFFF],
             np.r_[np.zeros(L - 1), 0x80000000], np.zeros(L)]
    for i, e in enumerate(edges[:max(n - 1, 0)]):
        x[i + 1] = e
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _value(row: torch.Tensor) -> int:
    return sum(int(v) << (32 * k)
               for k, v in enumerate(row.numpy().view(np.uint32)))


def _limbs(v: int, L: int) -> list:
    return [(v >> (32 * k)) & 0xFFFFFFFF for k in range(L)]


# (L, s, out_limbs): ÷Q at the cells' levels (s = 32·37 + 16), r = 0,
# out_limbs above L, no rounding term (s = 0), a shift past the width, a
# rounding bit at the bottom of a limb (s − 1 = 32) and at the top of the
# top limb (s − 1 = 95), one limb, a one-bit shift
SHIFTS = [(76, 1200, 38), (76, 1200, 37), (75, 1200, 36), (8, 64, 4),
          (8, 70, 10), (5, 0, 5), (5, 0, 7), (3, 200, 4), (4, 33, 4),
          (2, 31, 1), (3, 96, 2), (1, 17, 1), (4, 1, 4)]


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("L,s,out_limbs", SHIFTS)
def test_shift_round_op_is_shift_right_round(L, s, out_limbs, n):
    x = _rows(n, L, seed=L * 1000 + s + n)
    got = shift_round_op(x, s, out_limbs)
    assert torch.equal(got, bigint.shift_right_round(
        x, s, arithmetic=True, out_limbs=out_limbs))
    W = 32 * L
    want = []
    for r in x:
        y = (_value(r) + ((1 << (s - 1)) if s else 0)) % (1 << W)
        y -= (1 << W) if y >> (W - 1) else 0            # two's complement
        want.append(_limbs((y >> s) % (1 << (32 * out_limbs)), out_limbs))
    assert got.numpy().view(np.uint32).tolist() == want


# (L, bits): the combine at the cells' three levels, bits a multiple of
# 32 below and at the width, bits past it, below one limb, no bits
ADDS = [(38, 1200), (37, 1170), (36, 1140), (6, 128), (6, 192), (6, 300),
        (6, 5), (3, 0)]


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("L,bits", ADDS)
def test_add_mask_op_is_mask_of_add(L, bits, n):
    a, b = _rows(n, L, seed=bits + n), _rows(n, L, seed=bits + n + 1)
    b = b.flip(0).contiguous()          # edge rows meet random ones
    got = add_mask_op(a, b, bits)
    assert torch.equal(got, bigint.mask_bits(bigint.add(a, b), bits))
    m = 1 << min(bits, 32 * L)
    want = [_limbs((_value(ra) + _value(rb)) % m, L)
            for ra, rb in zip(a, b)]
    assert got.numpy().view(np.uint32).tolist() == want


def test_ops_take_leading_batch_axes():
    """(B, N, L) rows give the (B·N, L) result, reshaped."""
    x = _rows(12, 9, seed=3)
    assert torch.equal(shift_round_op(x.reshape(3, 4, 9), 40, 5),
                       shift_round_op(x, 40, 5).reshape(3, 4, 5))
    y = _rows(12, 9, seed=4)
    assert torch.equal(add_mask_op(x.reshape(2, 6, 9), y.reshape(2, 6, 9),
                                   250),
                       add_mask_op(x, y, 250).reshape(2, 6, 9))


@pytest.mark.parametrize("case", ["int64 words", "non-contiguous rows",
                                  "mismatched L", "other rows",
                                  "negative bits", "no limbs"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    x = _rows(6, 8, seed=5)
    calls = {
        "int64 words": [lambda: shift_round_op(x.long(), 40),
                        lambda: add_mask_op(x.long(), x.long(), 40)],
        "non-contiguous rows": [
            lambda: shift_round_op(x[:, ::2], 40),
            lambda: add_mask_op(x.t(), x.t(), 40),
            lambda: add_mask_op(x, x.t().contiguous().t(), 40)],
        "mismatched L": [lambda: add_mask_op(x, x[:, :7].contiguous(), 40)],
        "other rows": [lambda: add_mask_op(x, x[:5], 40)],
        "negative bits": [lambda: add_mask_op(x, x, -1),
                          lambda: shift_round_op(x, -1)],
        "no limbs": [lambda: shift_round_op(x[:, :0], 40)],
    }[case]
    for call in calls:
        with pytest.raises(ValueError):
            call()


@pytest.fixture(scope="module")
def small():
    p = small_params(logN=8)
    sk, pk, evk = keygen(p, seed=21, device="cpu")
    rk = R.rot_keygen(p, sk, 1, device="cpu")
    rng = np.random.default_rng(22)
    cts = [H.encrypt_message(rng.normal(size=8) + 1j * rng.normal(size=8),
                             pk, p, seed=30 + i) for i in range(4)]
    st = hp.he_static(p, p.logQ)
    tabs = hp.runtime_tables(make_context(p, p.logQ, "cpu"), evk)
    ops = [torch.stack([getattr(c, f) for c in cts[s::2]])
           for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
    return p, st, tabs, hp.evk_tables(rk), ops


@pytest.mark.parametrize("step", ["mul", "rotate", "slot_sum"])
def test_steps_through_the_carry_ops_equal_the_plain_path(small, step):
    """With use_kernels the ÷Q shift and the combines go through the carry
    ops (their plain versions on the CPU): the words equal the plain
    path's, and nothing launches."""
    p, st, (t1, t2, ek), rk, (ax1, bx1, ax2, bx2) = small
    build = {
        "mul": lambda kw: (hp.make_he_mul_step(st, "cpu", **kw),
                           (t1, t2, ek, ax1, bx1, ax2, bx2)),
        "rotate": lambda kw: (E.make_he_rotate_step(
            st, "cpu", R.rotation_k(p, 1), **kw), (t2, rk, ax1, bx1)),
        "slot_sum": lambda kw: (E.make_slot_sum_step(st, "cpu", 2, **kw),
                                (t2, (rk,), ax1, bx1)),
    }[step]
    common.reset_launches()
    fn, args = build({"use_kernels": True})
    got = fn(*args)
    assert sum(common.LAUNCHES.values()) == 0
    fn, args = build({})
    want = fn(*args)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32 and torch.equal(g, w)

