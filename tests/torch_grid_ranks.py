"""Rank functions of the grid tests (tests/test_torch_dist*.py,
test_torch_train_dist.py, test_torch_lm_tp.py).

A test spawns a grid with ``repro_torch.launch.mesh.spawn_grid``, whose
ranks import the function they run by name; these live here, in a module
that imports neither JAX nor the JAX package, so that a rank starts in the
time torch takes to import. Everything runs on the CPU: the HE side at
``test_params(logN=5)``, the LM side at ``reduced()`` sizes.
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


# ---- every iCRT form across ranks (tests/test_torch_dist_forms.py) --------

# (iCRT strategy, β bits) of the grid step besides the default: the column
# forms of core.crt.icrt_partial, and β = 2^64, where "matmul" runs as acc3
FORMS = [("acc3", 32), ("naive", 32), ("matmul", 64), ("acc3", 64),
         ("naive", 64)]


def params4(bits):
    return test_params(logN=4, beta_bits=bits)


def plain_keys(p, seed=3):
    """keys(p) on the plain path (the only one at β = 2^64)."""
    from repro_torch.core.rns import PipelineConfig
    cfg = PipelineConfig(use_kernels=False)
    sk, pk, evk = keygen(p, seed=seed, cfg=cfg, device="cpu")
    rks = {r: rot_keygen(p, sk, r, cfg=cfg, device="cpu")
           for r in sorted({1, *slot_sum_rotations(p.n_slots_max)})}
    return sk, pk, evk, rks, conj_keygen(p, sk, cfg=cfg, device="cpu")


def plain_ciphertexts(p, pk, n, seed0=20):
    from repro_torch.core.rns import PipelineConfig
    cfg = PipelineConfig(use_kernels=False)
    rng = np.random.default_rng(5)
    return [H.encrypt_message(rng.normal(size=4) + 1j * rng.normal(size=4),
                              pk, p, seed=seed0 + i, cfg=cfg)
            for i in range(n)]


def _random_words(rng, st, batch):
    shape = (batch, st.N, st.qlimbs)
    if st.dtype == torch.int32:
        w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(
            np.uint32).view(np.int32)
    else:
        w = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64).view(
            np.int64)
    return bigint.mask_bits(torch.from_numpy(w), st.logq)


def forms_rank(grid) -> dict:
    """The sharded make_he_mul_step in every form of FORMS at logN 4 (at
    logQ and two levels down), and every engine step at β = 2^64 and with
    iCRT acc3 at β = 2^32, each against the one-rank step in this
    process, with the recorded schedule beside he_expected_collectives."""
    rows = he_limb_sharding(grid, B)
    out = {"rank": grid.rank, "mul": {}, "engine": {}}
    worlds = {}
    for bits in (32, 64):
        p = params4(bits)
        worlds[bits] = (p, plain_keys(p))
    for strategy, bits in FORMS:
        p, (sk, pk, evk, rks, ck) = worlds[bits]
        cts = plain_ciphertexts(p, pk, 2 * B)
        for logq in (p.logQ, p.logQ - 2 * p.logp):
            full = stacked([H.he_mod_down(c, p, logq) if logq < p.logQ
                            else c for c in cts])
            mine = hp.scatter_batch(grid, *full)
            t1, t2, ek = hp.runtime_tables(make_context(p, logq, "cpu"), evk)
            s1, s2, sek = hp.shard_tables(t1, t2, ek, grid, p)
            st = hp.he_static(p, logq)
            want = hp.make_he_mul_step(st, "cpu", icrt_strategy=strategy)(
                t1, t2, ek, *full)
            comm.reset(grid)
            got = hp.make_he_mul_step(st, "cpu", grid=grid,
                                      icrt_strategy=strategy)(
                s1, s2, sek, *mine)
            exp = he_expected_collectives("mul", grid, p, logq, batch=B,
                                          icrt_strategy=strategy)
            sched = comm.summary(grid, "step")
            out["mul"][(strategy, bits, logq)] = {
                "bitwise": all(torch.equal(a, b[rows])
                               for a, b in zip(got, want)),
                "rows": [g.clone() for g in got],
                "counts": sched["counts"], "bytes": sched["total_bytes"],
                "expected": (exp["counts"], exp["wire_bytes"])}
    rng = np.random.default_rng(11)
    for strategy, bits in (("matmul", 64), ("acc3", 32)):
        p, (sk, pk, evk, rks, ck) = worlds[bits]
        knobs = dict(use_kernels=False, icrt_strategy=strategy)
        eng = OpEngine(p, "cpu", TableCache(p, evk, rks, ck, device="cpu",
                                            grid=grid), grid=grid, **knobs)
        eng1 = OpEngine(p, "cpu", TableCache(p, evk, rks, ck, device="cpu"),
                        **knobs)
        for op, logq, extra, names in _engine_cases(p, p.logQ):
            st = hp.he_static(p, logq)
            full = {k: _random_words(rng, st, B) for k in names}
            mine = dict(zip(names, hp.scatter_batch(grid, *full.values())))
            comm.reset(grid, "step")
            got = eng.run_step((op, logq, extra), mine)
            want = eng1.run_step((op, logq, extra), full)
            n_slots = extra if op == "slot_sum" else None
            exp = he_expected_collectives(op, grid, p, logq, batch=B,
                                          n_slots=n_slots,
                                          icrt_strategy=strategy)
            sched = comm.summary(grid, "step")
            out["engine"][(strategy, bits, op)] = {
                "bitwise": all(torch.equal(a, b[rows])
                               for a, b in zip(got, want)),
                "counts": sched["counts"], "bytes": sched["total_bytes"],
                "expected": (exp["counts"], exp["wire_bytes"])}
    return out


# ---- HEFrontend's workers on a model grid (test_torch_frontend_grid.py) ---

def mul_stream(server, top, lo, n_each=4):
    """The reference's canonical two-level mul stream (tests/
    test_multihost.py) and a rotation; returns the rids."""
    rids = []
    for i in range(n_each):
        rids.append(server.submit_mul(top[i % len(top)],
                                      top[(i + 1) % len(top)]))
        rids.append(server.submit_mul(lo[i % len(lo)],
                                      lo[(i + 1) % len(lo)]))
    rids.append(server.submit_rotate(top[0], 1))
    return rids


def pool4(p, pk):
    top = plain_ciphertexts(p, pk, 4, seed0=1)
    return top, [H.he_mod_down(c, p, p.logQ - p.logp) for c in top]


def same_outs(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        (x.logq, x.logp) == (y.logq, y.logp) and x.ax.dtype == y.ax.dtype
        and torch.equal(x.ax, y.ax) and torch.equal(x.bx, y.bx)
        for x, y in zip(a, b))


def frontend_rank(grid) -> object:
    """Rank 0, at β = 2^32 and then 2^64: HEFrontend(grid=) with 2
    in-process workers, worker 0 killed after its first dispatch, the
    stream drained (requeued), the workers revived and the stream served
    again; then, at β = 2^64, HEServer(grid=) (its keys reach the
    followers in int64). Every result against HEServer on one device.
    The other ranks: serve_follower, once for each of the three."""
    from repro_torch.hserve import HEFrontend, HEServer, serve_follower
    from repro_torch.runtime import FailureInjector
    if grid.model_rank:
        return [serve_follower(grid, params4(bits)) for bits in (32, 64, 64)]
    out = {}
    for bits in (32, 64):
        p = params4(bits)
        sk, pk, evk, rks, ck = plain_keys(p)
        top, lo = pool4(p, pk)
        one = HEServer(p, evk, {1: rks[1]}, device="cpu", batch=2,
                       use_kernels=False)
        rids = mul_stream(one, top, lo)
        res = one.drain()
        want = [res[r] for r in rids]
        fe = HEFrontend(p, evk, {1: rks[1]}, workers=2, worker_device="cpu",
                        grid=grid, batch=2, use_kernels=False,
                        injector=FailureInjector(kill_worker_at={0: 1}))
        try:
            rids = mul_stream(fe, top, lo)
            res = fe.drain()
            first = [res[r] for r in rids]
            killed = dict(fe.stats()["frontend"])
            fe.revive_workers()
            rids = mul_stream(fe, top, lo)
            res = fe.drain()
            again = [res[r] for r in rids]
            revived = dict(fe.stats()["frontend"])
            served = [w["served_requests"] for w in fe.stats()["workers"]]
        finally:
            fe.close()
        out[bits] = {"killed": same_outs(first, want), "frontend": killed,
                     "revived": same_outs(again, want),
                     "alive": revived["alive"], "served": served,
                     "dtype": str(first[0].ax.dtype),
                     "shape": tuple(first[0].ax.shape)}
    # β = 2^64 through HEServer(grid=): keys and operands are int64 words
    p = params4(64)
    sk, pk, evk, rks, ck = plain_keys(p)
    top, lo = pool4(p, pk)
    one = HEServer(p, evk, rks, ck, device="cpu", batch=2, use_kernels=False)
    srv = HEServer(p, evk, rks, ck, device="cpu", batch=2, use_kernels=False,
                   grid=grid)
    try:
        got = []
        for s in (one, srv):
            rids = mul_stream(s, top, lo, n_each=2) + [
                s.submit_conjugate(top[1]), s.submit_slot_sum(lo[0])]
            res = s.drain()
            got.append([res[r] for r in rids])
        grid_stats = srv.stats()["grid"]
    finally:
        srv.close()
    out["server64"] = {"same": same_outs(*got),
                       "all_reduces": grid_stats["step"]["counts"].get(
                           "all-reduce", 0)}
    return out


# ---- the training side (tests/test_torch_train_dist.py) ---------------------

TRAIN_KW = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                head_dim=32, d_ff=128, vocab_size=256)


def compressed_psum_rank(grid, grads_by_rank, noise) -> dict:
    """compressed_psum_grads of this rank's leaves, fed `noise`."""
    from repro_torch.dist.collectives import compressed_psum_grads
    grads = {k: torch.from_numpy(v) for k, v in grads_by_rank[grid.rank]
             .items()}
    out = compressed_psum_grads(grads, grid, 0,
                                noise=[torch.from_numpy(n) for n in noise])
    return {"out": {k: v.numpy() for k, v in out.items()},
            "log": comm.summary(grid)}


def compress_dp_rank(grid, steps) -> dict:
    """A compress_dp Trainer on the grid: step 0's compressed gradient
    beside the exact mean of the ranks' gradients, then `steps` steps."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.train import TrainConfig, Trainer, deterministic
    from repro_torch.models import loss_fn
    cfg = get_arch("llama3.2-1b").reduced(**TRAIN_KW)
    tr = Trainer(cfg, TrainConfig(batch=4, seq_len=16, steps=8,
                                  warmup_steps=2), grid=grid,
                 compress_dp=True)
    batch = tr.data.batch_at(0)
    with deterministic():
        compressed, _ = tr._grads(batch)
        tr.params.zero_grad(set_to_none=True)
        total, _ = loss_fn(tr.params, tr.data.shard_slice(
            batch, grid.data_rank, grid.data), cfg)
        total.backward()
    exact, local_max = {}, 0.0
    for k, p in tr.params.named_parameters():
        local_max = max(local_max, float(p.grad.abs().max()))
        exact[k] = comm.all_reduce(grid, p.grad.clone(), axis="data") \
            / grid.data
    tr.params.zero_grad(set_to_none=True)
    g_max = comm.all_gather(grid, torch.tensor([local_max]), axis="data")
    err = max(float((compressed[k] - exact[k]).abs().max()) for k in exact)
    comm.reset(grid)
    hist = tr.run(steps)["history"]
    return {"params": {k: v.numpy().copy()
                       for k, v in tr.params.state_dict().items()},
            "losses": [h["loss"] for h in hist],
            "err": err, "g_max": float(g_max.max()),
            "log": comm.summary(grid)}


# ---- the LM across model ranks (tests/test_torch_lm_tp.py) ------------------

LM_PROMPT, LM_GEN = 12, 7          # prefill, then 6 decode steps


def lm_config(case):
    """The reduced() config of an (arch, overrides) case."""
    from repro_torch.configs.registry import get_arch
    arch, kw = case
    return get_arch(arch).reduced(**dict(kw))


def lm_inputs(cfg, batch: int, seed: int = 0) -> dict:
    """A numpy-seeded prompt batch (and whisper's frames) on the CPU."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(batch, LM_PROMPT)).astype(np.int32))}
    if cfg.enc_dec:
        out["frames"] = torch.from_numpy(rng.normal(
            size=(batch, 2 * LM_PROMPT, cfg.d_model)).astype(np.float32))
    return out


def lm_forced(model, cfg, batch: dict, toks, grid=None) -> dict:
    """generate's logits along `toks` (prefill, then a decode step fed each
    token but the last), the cache's shapes after prefill and the
    collectives of the first decode step."""
    from repro_torch.models import decode_step, prefill
    max_len = LM_PROMPT + LM_GEN + 4
    logits, cache = prefill(model, batch, cfg, max_len, grid=grid)
    shapes = {f"{k}.{i}.{leaf}": tuple(t.shape)
              for k, layers in cache.items() for i, c in enumerate(layers)
              for leaf, t in c.items()}
    out, step_log = [logits], None
    for i in range(toks.shape[1] - 1):
        if grid is not None and i == 0:
            comm.reset(grid, "decode")
        logits, cache = decode_step(model, cache, toks[:, i: i + 1],
                                    LM_PROMPT + i, cfg, grid=grid)
        if grid is not None and i == 0:
            step_log = comm.summary(grid, "decode")
        out.append(logits)
    return {"logits": [t.numpy() for t in out], "step": step_log,
            "cache_shapes": shapes}


def lm_run(model, cfg, batch: dict, grid=None) -> dict:
    """generate(grid=) of `batch`, then its logits along its tokens (this
    data rank's rows of them)."""
    from repro_torch.dist.sharding import batch_rows
    from repro_torch.launch.serve import generate
    B = batch["tokens"].shape[0]
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    toks = generate(model, cfg, batch["tokens"], LM_GEN,
                    LM_PROMPT + LM_GEN + 4, batch_extra=extra, grid=grid)
    rows = batch_rows(grid, B) if grid is not None else slice(0, B)
    forced = lm_forced(model, cfg, {k: v[rows] for k, v in batch.items()},
                       toks[rows], grid)
    return {"tokens": toks.numpy(), **forced}


def lm_rank(grid, jobs) -> list:
    """Each job on this rank: ("seed", case, batch) builds the case's model
    from seed 0 and shards it (``shard_lm``); ("load", case, tree) loads
    the JAX package's parameters as this rank's shard
    (``load_lm_shard``). Then generate(grid=) and its logits; with what
    the rank holds."""
    from repro_torch.dist.sharding import load_lm_shard, shard_lm
    from repro_torch.models import init_params
    out = []
    for kind, case, arg in jobs:
        cfg = lm_config(case)
        if kind == "seed":
            model = shard_lm(init_params(
                cfg, torch.Generator().manual_seed(0), "cpu"), cfg, grid)
            batch = lm_inputs(cfg, arg)
        else:
            model = load_lm_shard(arg, cfg, grid)
            batch = lm_inputs(cfg, 2, seed=3)
        res = lm_run(model, cfg, batch, grid)
        res["held"] = {n: (tuple(p.shape), p.element_size(),
                           getattr(p, "model_dim", None))
                       for n, p in model.named_parameters()}
        out.append(res)
    return out
