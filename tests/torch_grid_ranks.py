"""Rank functions of the grid tests (tests/test_torch_dist*.py).

A test spawns a grid with ``repro_torch.launch.mesh.spawn_grid``, whose
ranks import the function they run by name; these live here, in a module
that imports neither JAX nor the JAX package, so that a rank starts in the
time torch takes to import. Everything runs on the CPU at
``test_params(logN=5)``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from repro_torch.core import bigint
from repro_torch.core import heaan as H
from repro_torch.core.context import make_context
from repro_torch.core.keys import keygen
from repro_torch.core.params import test_params
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.dist import comm
from repro_torch.dist import he_pipeline as hp
from repro_torch.dist.sharding import (
    he_eval_sharding, he_expected_collectives, he_limb_sharding,
)
from repro_torch.hserve.engine import OpEngine, slot_sum_rotations
from repro_torch.hserve.tables import TableCache

LOGN, B = 5, 2
# make_he_mul_step keywords the grid step is held at
MUL_CONFIGS = {
    "default": {},
    "kernels-mod2-modified": {"use_kernels": True, "crt_strategy": "mod2",
                              "modified_shoup": True},
    "reduce_scatter_icrt": {"reduce_scatter_icrt": True},
}


def params():
    return test_params(logN=LOGN, beta_bits=32)


def keys(p):
    """The keys every rank makes from the same seeds (and the tests'
    parent too): sk, pk, evk, rotation keys, conjugation key."""
    sk, pk, evk = keygen(p, seed=3, device="cpu")
    rks = {r: rot_keygen(p, sk, r, device="cpu")
           for r in sorted({1, *slot_sum_rotations(p.n_slots_max)})}
    return sk, pk, evk, rks, conj_keygen(p, sk, device="cpu")


def ciphertexts(p, pk, n, seed0=20):
    rng = np.random.default_rng(5)
    return [H.encrypt_message(rng.normal(size=4) + 1j * rng.normal(size=4),
                              pk, p, seed=seed0 + i) for i in range(n)]


def stacked(cts):
    """(ax1, bx1, ax2, bx2) batches of the pairs (cts[0], cts[1]), …"""
    return [torch.stack([getattr(c, f) for c in cts[s::2]])
            for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _engine_cases(p, logq):
    """(op, logq, extra, operand names) of every engine step."""
    return [("mul", logq, None, ("ax1", "bx1", "ax2", "bx2")),
            ("rotate", logq, 1, ("ax1", "bx1")),
            ("conjugate", logq, None, ("ax1", "bx1")),
            ("slot_sum", logq, p.n_slots_max, ("ax1", "bx1")),
            ("rescale", logq, p.logp, ("ax1", "bx1")),
            ("mod_down", logq, logq - p.logp, ("ax1", "bx1")),
            ("mod_raise", logq - p.logp, p.logQ, ("ax1", "bx1")),
            ("add", logq, None, ("ax1", "bx1", "ax2", "bx2")),
            ("sub", logq, None, ("ax1", "bx1", "ax2", "bx2")),
            ("mul_plain", logq, None, ("ax1", "bx1", "pt")),
            ("add_plain", logq, None, ("ax1", "bx1", "pt"))]


def step_rank(grid) -> dict:
    """The sharded make_he_mul_step on each config and level, and every
    engine step on a TableCache(grid), each against the one-rank step in
    this process; the rank's key rows against the whole keys."""
    p = params()
    sk, pk, evk, rks, ck = keys(p)
    cts = ciphertexts(p, pk, 2 * B)
    rows = he_limb_sharding(grid, B)
    out = {"rank": grid.rank, "mul": {}, "engine": {}}
    for logq in (p.logQ, p.logQ - 2 * p.logp):
        full = stacked([H.he_mod_down(c, p, logq) if logq < p.logQ else c
                        for c in cts])
        mine = hp.scatter_batch(grid, *full)
        t1, t2, ek = hp.runtime_tables(make_context(p, logq, "cpu"), evk)
        s1, s2, sek = hp.shard_tables(t1, t2, ek, grid, p)
        st = hp.he_static(p, logq)
        for name, kw in MUL_CONFIGS.items():
            one = {k: v for k, v in kw.items()
                   if k != "reduce_scatter_icrt"}
            want = hp.make_he_mul_step(st, "cpu", **one)(t1, t2, ek, *full)
            comm.reset(grid)
            got = hp.make_he_mul_step(st, "cpu", grid=grid, **kw)(
                s1, s2, sek, *mine)
            back = hp.gather_batch(grid, *got, batch=B)
            out["mul"][(name, logq)] = {
                "bitwise": all(torch.equal(a, b[rows])
                               for a, b in zip(got, want)),
                "gathered": all(torch.equal(a, b)
                                for a, b in zip(back, want)),
                "rows": [g.clone() for g in got],
                "schedule": comm.summary(grid, "step"),
                "expected": he_expected_collectives(
                    "mul", grid, p, logq, batch=B)["counts"],
                "shard": (s1["primes"].numel(), s2["primes"].numel())}
    # every engine step, against the one-rank engine
    sharded = TableCache(p, evk, rks, ck, device="cpu", grid=grid)
    whole = TableCache(p, evk, rks, ck, device="cpu")
    eng = OpEngine(p, "cpu", sharded, grid=grid, use_kernels=True)
    eng1 = OpEngine(p, "cpu", whole, use_kernels=True)
    rng = np.random.default_rng(11)
    for op, logq, extra, names in _engine_cases(p, p.logQ):
        st = hp.he_static(p, logq)
        full = {k: bigint.mask_bits(torch.from_numpy(rng.integers(
            0, 1 << 32, size=(B, p.N, st.qlimbs), dtype=np.uint64).astype(
            np.uint32).view(np.int32)), logq) for k in names}
        mine = dict(zip(names, hp.scatter_batch(grid, *full.values())))
        comm.reset(grid, "step")
        got = eng.run_step((op, logq, extra), mine)
        want = eng1.run_step((op, logq, extra), full)
        out["engine"][op] = {
            "bitwise": all(torch.equal(a, b[rows])
                           for a, b in zip(got, want)),
            "collectives": comm.summary(grid, "step")["counts"]}
    krows = he_eval_sharding(grid, p.np_region2(p.logQ))
    held = [sharded.evk()] + [sharded.rot_key(r) for r in rks] \
        + [sharded.conj_key()]
    made = [evk, *rks.values(), ck]
    out["keys"] = {
        "digest": digest(v for d in held for v in d.values()),
        "rows_of_whole": all(torch.equal(d[k], getattr(m, k)[krows])
                             for d, m in zip(held, made) for k in d),
        "stats": sharded.stats()}
    out["feed"] = comm.summary(grid, "feed")["counts"]
    return out


def serve_stream(server, session):
    """One stream through `server` (an HEServer on one device or on rank 0
    of a grid) and `session` over it: muls, rotations, a conjugation,
    mul_plain/add_plain, a slot sum and a rescale over two levels, a
    degree-4 circuit and a traced expression. Returns every result's words
    in submit order."""
    from repro_torch.hserve import degree4_demo_circuit
    p = server.params
    rng = np.random.default_rng(9)
    n = p.n_slots_max
    cts = [session.encrypt(rng.normal(size=n) + 1j * rng.normal(size=n),
                           seed=40 + i).ciphertext for i in range(6)]
    low = [H.he_mod_down(c, p, p.logQ - p.logp) for c in cts[:2]]
    pt = H.encode_plain(rng.normal(size=n), p, p.logQ, device="cpu")
    rids = [server.submit_mul(cts[0], cts[1]), server.submit_mul(cts[2],
                                                                 cts[3]),
            server.submit_mul(low[0], low[1]), server.submit_rotate(cts[4], 1),
            server.submit_conjugate(cts[5]), server.submit_slot_sum(cts[0]),
            server.submit_mul_plain(cts[1], pt),
            server.submit_add_plain(cts[2], pt),
            server.submit_rescale(cts[3]), server.submit_add(cts[4], cts[5])]
    ops, _ = degree4_demo_circuit(p)
    rids.append(server.submit_circuit(ops, inputs={"x": cts[0]}))
    x = session.encrypt(rng.normal(size=n) * 0.5, seed=77)
    fut = session.run([((x * x) + x).rotate(1).conj()])[0]
    res = session.drain()
    outs = [res[r] for r in rids] + [fut.result()]
    return [(c.ax.clone(), c.bx.clone(), c.logq, c.logp) for c in outs]


def serve_rank(grid, kill_after=None) -> object:
    """Rank 0: an HESession over HEServer(grid=) serving serve_stream;
    the others: serve_follower (which, with `kill_after`, exits the
    process in the middle of its `kill_after`-th step)."""
    from repro_torch.client import HESession
    from repro_torch.hserve import serve_follower
    p = params()
    if grid.model_rank:
        if kill_after is not None:
            run = OpEngine.run_step
            count = [0]

            def dying(self, key, arrays):
                count[0] += 1
                if count[0] == kill_after:
                    os._exit(3)
                return run(self, key, arrays)

            OpEngine.run_step = dying
        return serve_follower(grid, p)
    sk, pk, evk, rks, ck = keys(p)
    session = HESession(p, sk, pk, evk, rot_keys=rks, conj_key=ck,
                        device="cpu", batch=2, schedule=True, grid=grid)
    try:
        outs = serve_stream(session.server, session)
        stats = session.server.stats()
    finally:
        session.server.close()
    return {"outs": outs, "grid": stats["grid"],
            "requests": {op: d["requests"]
                         for op, d in stats["per_op"].items()}}
