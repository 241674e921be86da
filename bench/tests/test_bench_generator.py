"""The arrival generator and the inputs repeat by seed."""

import collections

import torch
from conftest import tiny_serve_mix

from hebench import arrivals, inputs

LARGE_SEED = 2**31 + 12345


def test_schedule_repeats_by_seed_and_keeps_its_work_across_seeds():
    mix = tiny_serve_mix()
    a = arrivals.schedule(mix, LARGE_SEED, 5.0)
    assert a == arrivals.schedule(mix, LARGE_SEED, 5.0)
    b = arrivals.schedule(mix, LARGE_SEED + 1, 5.0)
    assert a != b

    def gaps(reqs):
        return sorted(round(q.due_s - p, 12) for p, q in
                      zip([0.0] + [r.due_s for r in reqs], reqs))

    def kinds(reqs):
        return collections.Counter((q.op, q.logq) for q in reqs)

    # the same gaps and the same (op, level) counts, in another order
    assert gaps(a) == gaps(b)
    assert kinds(a) == kinds(b)


def test_schedule_keeps_the_mix_shares_and_rate():
    mix = tiny_serve_mix()
    reqs = arrivals.schedule(mix, 7, 20.0)
    n = len(reqs)
    assert n == 200 * 20 + 1
    c = collections.Counter(q.op for q in reqs)
    assert abs(c["mul"] - 0.75 * n) <= 1 and abs(c["rotate"] - 0.25 * n) <= 1
    lv = collections.Counter(q.logq for q in reqs)
    assert abs(lv[120] - 0.5 * n) <= 2 and abs(lv[96] - 0.25 * n) <= 2
    assert all(len(q.operands) == (2 if q.op == "mul" else 1)
               and all(0 <= j < 4 for j in q.operands) for q in reqs)
    assert all(p.due_s < q.due_s for p, q in zip(reqs, reqs[1:]))
    # exponential gaps of mean 1/rate: the mean of the quantiles
    assert abs(reqs[-1].due_s / n - 1 / 200) < 0.05 / 200


def test_inputs_repeat_by_seed_and_hold_their_bits():
    dev = torch.device("cpu")
    for beta in (32, 64):
        a = inputs.ciphertexts(inputs.generator(LARGE_SEED, dev), 3, 16, 70,
                               beta, dev)
        b = inputs.ciphertexts(inputs.generator(LARGE_SEED, dev), 3, 16, 70,
                               beta, dev)
        c = inputs.ciphertexts(inputs.generator(LARGE_SEED + 1, dev), 3, 16,
                               70, beta, dev)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert not torch.equal(a[0], c[0])
        K = -(-70 // beta)
        assert a[0].shape == (3, 16, K)
        top = a[0][..., 70 // beta].long() & ((1 << beta) - 1
                                              if beta == 32 else -1)
        assert int(top.max()) < 1 << (70 % beta)
        key = inputs.key(inputs.generator(5, dev), 16, 40, beta, dev)
        assert key[0].shape == (16, -(-80 // beta))
