"""repro_torch.hserve's host side: queue, assembler, table cache, scheduler,
metrics and the server's flush policy, on the CPU.

The tests of the JAX package's ``tests/test_hserve.py`` that need no JAX
step, ported to the port's server (``HEServer(device="cpu")``: CPU tensors
take the kernels' plain versions), and the TableCache's level views held
against ``region_tables(make_context(...))`` at ``paper_params()`` and
against the JAX package's TableCache at test params. The served results
themselves are held against the JAX server in
``tests/test_torch_hserve_server.py``.
"""

import dataclasses
import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

from repro.hserve.tables import TableCache as JTableCache
from repro.core import test_params as j_test_params

from repro_torch.core import heaan as H
from repro_torch.core import make_context
from repro_torch.core import test_params as small_params
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.keys import keygen
from repro_torch.core.params import paper_params
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.dist import he_pipeline as hp
from repro_torch.hserve import (
    BatchAssembler, CircuitOp, CircuitScheduler, HEServer, RequestQueue,
    ServeMetrics, TableCache, circuit_schedule, validate_circuit,
)

PARAMS = small_params(logN=5, beta_bits=32)   # N=32, logQ 120, logp 24
CPU = torch.device("cpu")
LOW = PARAMS.logQ - PARAMS.logp


@pytest.fixture(scope="module")
def keys():
    sk, pk, evk = keygen(PARAMS, seed=0, device="cpu")
    rks = {r: rot_keygen(PARAMS, sk, r, device="cpu") for r in (1, 2)}
    return sk, pk, evk, rks


@pytest.fixture(scope="module")
def ck(keys):
    return conj_keygen(PARAMS, keys[0], device="cpu")


def _enc(pk, seed, n=4):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=n) + 1j * rng.normal(size=n)
    return z, H.encrypt_message(z, pk, PARAMS, seed=seed)


def _plain(seed, logq, n=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=n) + 1j * rng.normal(size=n)
    return w, H.encode_plain(w, PARAMS, logq, device="cpu")


def _server(keys, conj_key=None, **kw):
    _, _, evk, rks = keys
    return HEServer(PARAMS, evk, rks, conj_key, device="cpu", batch=2, **kw)


def _meta(ct):
    """The same ciphertext on another device (the meta device: shapes, no
    data)."""
    return ct.to("meta")


# --------------------------------------------------------------------------
# queue: bucketing, validation and padding
# --------------------------------------------------------------------------

def test_queue_buckets_by_op_level_and_extra(keys):
    _, pk, _, _ = keys
    q = RequestQueue()
    _, c1 = _enc(pk, 1)
    _, c2 = _enc(pk, 2)
    low, low2 = (H.he_mod_down(c, PARAMS, LOW) for c in (c1, c2))
    r0 = q.submit("mul", (c1, c2))
    r1 = q.submit("mul", (c1, c2))
    q.submit("mul", (low, low2))            # different level, new bucket
    q.submit("rotate", (c1,), r=1)
    q.submit("rotate", (c1,), r=2)          # different r, new bucket
    q.submit("slot_sum", (c1,))
    q.submit("rescale", (c1,), dlogp=PARAMS.logp)
    q.submit("rescale", (c1,), dlogp=2 * PARAMS.logp)
    q.submit("mod_down", (c1,), logq2=LOW)
    q.submit("conjugate", (c1,))
    q.submit("add", (c1, c1))
    q.submit("sub", (c1, c1))
    _, pt = _plain(3, PARAMS.logQ)
    q.submit("mul_plain", (c1,), pt=pt, pt_logp=PARAMS.log_delta)
    q.submit("add_plain", (c1,), pt=pt)     # pt_logp 0 → ct.logp
    assert q.depth == 14
    assert len(q.bucket_depths()) == 13
    # oldest bucket with >= 2 requests is the top-level mul bucket
    key = q.ready_key(2)
    assert key == ("mul", PARAMS.logQ, None)
    got = q.pop_bucket(key, 2)
    assert [r.rid for r in got] == [r0, r1]   # FIFO within the bucket
    assert q.ready_key(2) is None             # no other bucket is full
    assert q.any_key() is not None            # but work remains for flush


def _bad_request(case, pk):
    _, c1 = _enc(pk, 1)
    low = H.he_mod_down(c1, PARAMS, LOW)
    resc = H.rescale(c1, PARAMS)              # another logp than low's
    _, pt = _plain(2, PARAMS.logQ)
    return {
        "unknown op": (("frobnicate", (c1,)), {}, "unknown op"),
        "arity": (("mul", (c1,)), {}, "takes 2"),
        "level mismatch": (("mul", (c1, low)), {}, "share a modulus"),
        "rotate r=0": (("rotate", (c1,)), {"r": 0}, "rotation amount"),
        "rescale dlogp 0": (("rescale", (c1,)), {"dlogp": 0},
                            "positive dlogp"),
        "rescale exhausts": (("rescale", (c1,)), {"dlogp": PARAMS.logQ},
                             "exhausts"),
        "mod_down to 0": (("mod_down", (c1,)), {"logq2": 0}, "outside"),
        "mod_down up": (("mod_down", (c1,)), {"logq2": PARAMS.logQ + 1},
                        "outside"),
        "mod_raise down": (("mod_raise", (low,)), {"logq2": LOW},
                           "must exceed"),
        "add scales": (("add", (low, resc)), {}, "share a scale"),
        "mul_plain no operand": (("mul_plain", (c1,)), {}, "plaintext"),
        "mul_plain no scale": (("mul_plain", (c1,)), {"pt": pt},
                               "pt_logp"),
        "add_plain scales": (("add_plain", (c1,)),
                             {"pt": pt, "pt_logp": c1.logp + 1},
                             "scales differ"),
        "pt too few limbs": (("mul_plain", (c1,)),
                             {"pt": pt[:, :1], "pt_logp": 24},
                             "does not cover"),
        "pt not a tensor": (("add_plain", (c1,)),
                            {"pt": pt.numpy().view(np.uint32)},
                            "must be a tensor"),
        "ciphertext elsewhere": (("mul", (c1, _meta(c1))), {},
                                 "lies on meta"),
        "plaintext elsewhere": (("add_plain", (c1,)),
                                {"pt": pt.to("meta")}, "lies on meta"),
    }[case]


BAD = ["unknown op", "arity", "level mismatch", "rotate r=0",
       "rescale dlogp 0", "rescale exhausts", "mod_down to 0", "mod_down up",
       "mod_raise down", "add scales", "mul_plain no operand",
       "mul_plain no scale", "add_plain scales", "pt too few limbs",
       "pt not a tensor", "ciphertext elsewhere", "plaintext elsewhere"]


@pytest.mark.parametrize("case", BAD)
def test_queue_rejects_bad_requests_at_submit(keys, case):
    """Every malformed request is refused before it enters a bucket (and
    the operands on another device than the queue's with it)."""
    args, kw, match = _bad_request(case, keys[1])
    q = RequestQueue(device=CPU)
    with pytest.raises(ValueError, match=match):
        q.submit(*args, **kw)
    assert q.depth == 0 and q.submitted == 0


def test_queue_copies_the_callers_plaintext(keys):
    """The queued operand must not alias the caller's buffer; a cache
    resident (pt_owned) is aliased."""
    _, pk, _, _ = keys
    _, c1 = _enc(pk, 1)
    _, pt = _plain(2, PARAMS.logQ)
    q = RequestQueue()
    q.submit("add_plain", (c1,), pt=pt)
    q.submit("mul_plain", (c1,), pt=pt, pt_logp=24, pt_owned=True)
    (copied,) = q.pop_bucket(("add_plain", PARAMS.logQ, None), 1)
    (aliased,) = q.pop_bucket(("mul_plain", PARAMS.logQ, None), 1)
    assert torch.equal(copied.pt, pt)
    assert copied.pt.data_ptr() != pt.data_ptr()
    assert aliased.pt.data_ptr() == pt.data_ptr()


def test_assembler_pads_to_fixed_shape(keys):
    _, pk, _, _ = keys
    q = RequestQueue()
    _, c1 = _enc(pk, 1)
    _, c2 = _enc(pk, 2)
    for _ in range(3):
        q.submit("mul", (c1, c2))
    asm = BatchAssembler(batch=4)
    b = asm.assemble(q.pop_bucket(("mul", PARAMS.logQ, None), 4))
    assert b.size == 4 and b.n_valid == 3 and b.n_pad == 1
    assert set(b.arrays) == {"ax1", "bx1", "ax2", "bx2"}
    for v in b.arrays.values():
        assert v.shape == (4, PARAMS.N, PARAMS.qlimbs(PARAMS.logQ))
        assert v.device == c1.ax.device and v.is_contiguous()
        assert not v[3].any()                 # padded lane is zeros
    # valid lanes carry the submitted operands, in request order
    assert torch.equal(b.arrays["ax1"][0], c1.ax)
    assert torch.equal(b.arrays["bx2"][2], c2.bx)
    # rotate batches carry one operand only; plaintext ops their pt
    q.submit("rotate", (c1,), r=1)
    b = asm.assemble(q.pop_bucket(("rotate", PARAMS.logQ, 1), 4))
    assert set(b.arrays) == {"ax1", "bx1"}
    assert b.n_valid == 1 and b.n_pad == 3
    _, pt = _plain(5, PARAMS.logQ)
    q.submit("add_plain", (c1,), pt=pt)
    b = asm.assemble(q.pop_bucket(("add_plain", PARAMS.logQ, None), 4))
    assert set(b.arrays) == {"ax1", "bx1", "pt"}
    assert torch.equal(b.arrays["pt"][0], pt) and not b.arrays["pt"][1:].any()


@pytest.mark.parametrize("case", ["mixed buckets", "oversize", "empty",
                                  "batch 0"])
def test_assembler_rejects_mixed_oversize_and_empty(keys, case):
    _, pk, _, _ = keys
    q = RequestQueue()
    _, c1 = _enc(pk, 1)
    low = H.he_mod_down(c1, PARAMS, LOW)
    q.submit("mul", (c1, c1))
    q.submit("mul", (low, low))
    reqs = (q.pop_bucket(("mul", PARAMS.logQ, None), 4)
            + q.pop_bucket(("mul", LOW, None), 4))
    with pytest.raises(ValueError):
        if case == "mixed buckets":
            BatchAssembler(batch=4).assemble(reqs)
        elif case == "oversize":
            BatchAssembler(batch=1).assemble(reqs[:1] * 2)
        elif case == "empty":
            BatchAssembler(batch=4).assemble([])
        else:
            BatchAssembler(batch=0)


# --------------------------------------------------------------------------
# tables: level views == fresh per-level tables
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paper_cache():
    return TableCache(paper_params(), device="cpu")


PAPER_LEVELS = list(range(1200, 59, -30))       # 38 limbs down to 2


@pytest.mark.parametrize("logq", PAPER_LEVELS)
def test_table_cache_level_views_match_fresh_tables_at_paper_params(
        paper_cache, logq):
    """At every level of paper_params() down to 2 limbs, the cached views
    equal region_tables of a fresh context, and every one is a contiguous,
    16-byte-aligned operand the kernels take, with max(K, 3) CRT
    columns."""
    t1, t2 = paper_cache.level_tables(logq)
    ctx = make_context(paper_params(), logq, "cpu")
    for region, cached in ((1, t1), (2, t2)):
        fresh = hp.region_tables(ctx, region)
        assert tuple(cached) == hp.REGION_TABLE_KEYS
        for k, v in fresh.items():
            assert torch.equal(cached[k], v), (logq, region, k)
            assert cached[k].is_contiguous() and \
                cached[k].data_ptr() % 16 == 0, (logq, region, k)
        assert cached["crt_tb"].shape[1] == max(ctx.qlimbs, 3)
    assert paper_cache.has_level(logq)
    before = paper_cache.hits
    assert paper_cache.level_tables(logq) == (t1, t2)   # served cached
    assert paper_cache.hits == before + 1


@pytest.mark.parametrize("logq", [120, 96, 72, 48, 24])
def test_table_cache_level_views_match_the_reference_cache(keys, logq):
    """Against the JAX package's TableCache at every level of test params
    (4 limbs down to 1): the same words in every table, the reference's K
    CRT columns first; the port's extra columns below 3 limbs are β^k mod
    p, and it has no quot_fix (its iCRT takes an f64 quotient)."""
    port = TableCache(PARAMS, device="cpu").level_tables(logq)
    ref = JTableCache(j_test_params(logN=5, beta_bits=32)).level_tables(
        logq)
    K = PARAMS.qlimbs(logq)
    for t, j in zip(port, ref):
        assert set(j) - set(t) == {"quot_fix"}
        for k, v in t.items():
            want = np.asarray(j[k])
            got = v.numpy().view(want.dtype) if v.dtype == torch.int32 \
                else v.numpy()
            if k in ("crt_tb", "crt_tb_shoup"):
                assert got.shape[1] == max(K, 3)
                np.testing.assert_array_equal(got[:, :K], want)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)
        p = t["primes"].numpy().view(np.uint32).astype(object)
        beta = [[pow(2, 32 * k, int(pj)) for k in range(max(K, 3))]
                for pj in p]
        np.testing.assert_array_equal(
            t["crt_tb"].numpy().view(np.uint32), np.array(beta, np.uint32))


def test_table_cache_keys_and_stats(keys, ck):
    _, _, evk, rks = keys
    cache = TableCache(PARAMS, evk, {1: rks[1]}, device="cpu")
    assert set(cache.evk()) == set(hp.EVK_TABLE_KEYS)
    assert set(cache.rot_key(1)) == set(hp.EVK_TABLE_KEYS)
    with pytest.raises(KeyError):
        cache.rot_key(2)
    cache.add_rot_key(2, rks[2])
    assert cache.rotation_amounts == [1, 2]
    assert not cache.has_conj_key
    with pytest.raises(ValueError):
        cache.conj_key()
    cache.add_conj_key(ck)
    assert cache.has_conj_key
    st = cache.stats()
    assert st["resident_mib"] > 0 and st["keys_mib"] > 0
    with pytest.raises(ValueError):
        TableCache(PARAMS, device="cpu").evk()


def test_plain_cache_hits_misses_and_lru_eviction(keys):
    _, pt = _plain(1, PARAMS.logQ)
    # two entries fit in the cap, the third evicts the least recent
    cap = 2.5 * pt.numel() * pt.element_size() / 2**20
    cache = TableCache(PARAMS, device="cpu", plain_cache_mib=cap)
    first = cache.put_plain("a", PARAMS.logQ, pt)
    assert torch.equal(first, pt) and first.data_ptr() != pt.data_ptr()
    assert cache.put_plain("a", PARAMS.logQ, pt) is first   # a hit
    cache.put_plain("b", PARAMS.logQ, pt)
    cache.get_plain("a", PARAMS.logQ)          # a is the most recent now
    cache.put_plain("c", PARAMS.logQ, pt)
    assert not cache.has_plain("b", PARAMS.logQ)
    assert cache.has_plain("a", PARAMS.logQ)
    with pytest.raises(KeyError, match="send the encoded operand"):
        cache.get_plain("b", PARAMS.logQ)
    st = cache.stats()
    assert (st["plain_hits"], st["plain_misses"], st["plain_evictions"],
            st["plain_entries"]) == (2, 3, 1, 2)
    with pytest.raises(ValueError, match="lies on meta"):
        cache.put_plain("d", PARAMS.logQ, pt.to("meta"))


def test_plain_cache_counters_match_the_reference_cache(keys):
    """The same encode sequence through the port's and the JAX package's
    TableCache: plain_hits, plain_misses and plain_evictions agree after
    every step."""
    _, pt = _plain(1, PARAMS.logQ)
    jpt = pt.numpy().view(np.uint32)
    cap = 2.5 * pt.numel() * pt.element_size() / 2**20
    port = TableCache(PARAMS, device="cpu", plain_cache_mib=cap)
    ref = JTableCache(j_test_params(logN=5, beta_bits=32),
                      plain_cache_mib=cap)
    steps = [("put", "a"), ("put", "a"), ("put", "b"), ("get", "a"),
             ("put", "c"), ("get", "b"), ("has", "b"), ("put", "b"),
             ("get", "c"), ("put", "d"), ("get", "a")]
    for op, h in steps:
        for cache, operand in ((port, pt), (ref, jpt)):
            if op == "put":
                cache.put_plain(h, PARAMS.logQ, operand)
            elif op == "has":
                cache.has_plain(h, PARAMS.logQ)
            else:
                try:
                    cache.get_plain(h, PARAMS.logQ)
                except KeyError:
                    pass
        counts = [(c.plain_hits, c.plain_misses, c.plain_evictions)
                  for c in (port, ref)]
        assert counts[0] == counts[1], (op, h, counts)
    assert port.plain_evictions > 0 and port.plain_hits > 0
    st = port.stats()
    assert (st["plain_hits"], st["plain_misses"], st["plain_evictions"]) \
        == (port.plain_hits, port.plain_misses, port.plain_evictions)


# Public names of a reference class that its port may lack, each with the
# reason. A14's names (the LM side) are module functions and flags outside
# these packages, so no class here lacks one.
ALLOWED_GAPS = {
    ("dist.he_pipeline", "HEStatic"): {
        "icrt1": "the port's HEStatic holds no iCRT tables: the "
                 "accumulator width is read from the region table",
        "icrt2": "as icrt1"},
    ("dist.he_pipeline", "StageFns"): {
        "ev": "a with_sharding_constraint placement: a rank computes on "
              "the rows it is given",
        "out": "as ev",
        "modified_shoup": "bound into the stage closures; read nowhere "
                          "in the reference"},
    ("core.context", "IcrtTables"): {
        "quot_fix": "TPU-only: the Pallas iCRT's fixed-point quotient "
                    "(no f64 on the TPU); the CUDA iCRT takes p_inv_f64"},
    # instance attributes, not in a class's dir(): listed for the reader
    ("hserve.frontend", "HEFrontend"): {
        "mesh": "grid= (in-process workers share the frontend's HostGrid) "
                "and worker_devices= (each worker process's own (1, R) "
                "grid) take the model mesh's two roles; the port runs one "
                "process per rank"},
    ("core.context", "GlobalTables"): {
        "betak": "built but read nowhere in the reference: the CRT fold "
                 "reads crt_tb[:, :3]",
        "betak_shoup": "as betak"},
}


# Modules of the port with no module of the reference to hold them to:
# the collectives the reference leaves to XLA's partitioner, and the
# schedule record the reference measures from compiled HLO (shardlint).
PORT_ONLY_MODULES = {"dist.comm", "dist.record"}


def _public_names(cls) -> set:
    names = {n for n in dir(cls) if not n.startswith("_")}
    if dataclasses.is_dataclass(cls):
        names |= {f.name for f in dataclasses.fields(cls)
                  if not f.name.startswith("_")}
    return names


def test_ported_classes_have_the_reference_public_names():
    """Every class the port defines in core, hserve, client, boot, dist,
    optim, ckpt and launch.train (the classes given a grid among them:
    HEServer, OpEngine, TableCache, HESession, StageFns, Trainer) has each
    public name (attributes, methods, properties, dataclass fields) of the
    reference class it ports, except the gaps listed above."""
    compared, gaps, seen = 0, {}, set()
    for pkg in ("core", "hserve", "client", "boot", "dist", "optim", "ckpt",
                "launch.train"):
        package = importlib.import_module(f"repro_torch.{pkg}")
        names = [pkg] + [f"{pkg}.{m.name}" for m in
                         pkgutil.iter_modules(getattr(package, "__path__",
                                                      []))
                         if m.name != "__main__"
                         and f"{pkg}.{m.name}" not in PORT_ONLY_MODULES]
        for name in names:
            port = importlib.import_module(f"repro_torch.{name}")
            ref = importlib.import_module(f"repro.{name}")
            for cname, cls in vars(port).items():
                if not inspect.isclass(cls) or \
                        cls.__module__ != port.__name__:
                    continue
                rcls = getattr(ref, cname, None)
                assert inspect.isclass(rcls), (name, cname)
                compared += 1
                missing = _public_names(rcls) - _public_names(cls)
                missing -= set(ALLOWED_GAPS.get((name, cname), ()))
                if missing:
                    gaps[f"{name}.{cname}"] = sorted(missing)
                seen.add(f"{name}.{cname}")
    assert compared > 30
    assert {"optim.adamw.OptState", "ckpt.manager.CheckpointManager",
            "launch.train.TrainConfig", "launch.train.Trainer"} <= seen
    assert not gaps, gaps


# --------------------------------------------------------------------------
# the server refuses at submit what it could not serve
# --------------------------------------------------------------------------

UNSERVEABLE = ["rotate without key", "slot_sum without keys",
               "mul without evk", "conjugate without key",
               "ciphertext elsewhere", "plaintext elsewhere",
               "unknown plaintext hash", "circuit input elsewhere",
               "circuit plaintext not a tensor", "circuit without key",
               "circuit unknown hash", "circuit scale mismatch"]


@pytest.mark.parametrize("case", UNSERVEABLE)
def test_server_rejects_unserveable_requests_at_submit(keys, case):
    """A request the engine cannot serve never enters the queue —
    otherwise it fails mid-drain after being popped, taking the batch's
    other requests down with it."""
    _, pk, evk, rks = keys
    _, c1 = _enc(pk, 1)
    _, pt = _plain(2, PARAMS.logQ)
    server = HEServer(PARAMS, evk, {1: rks[1]}, device="cpu", batch=2)
    no_evk = HEServer(PARAMS, rot_keys=rks, device="cpu", batch=2)
    calls = {
        "rotate without key": (server, lambda s: s.submit_rotate(c1, 3),
                               KeyError),
        "slot_sum without keys": (server, lambda s: s.submit_slot_sum(c1),
                                  KeyError),
        "mul without evk": (no_evk, lambda s: s.submit_mul(c1, c1),
                            ValueError),
        "conjugate without key": (server, lambda s: s.submit_conjugate(c1),
                                  ValueError),
        "ciphertext elsewhere": (server,
                                 lambda s: s.submit_mul(c1, _meta(c1)),
                                 ValueError),
        "plaintext elsewhere": (server, lambda s: s.submit_mul_plain(
            c1, pt.to("meta"), pt_hash="h"), ValueError),
        "unknown plaintext hash": (server, lambda s: s.submit_add_plain(
            c1, pt_hash="never-sent"), KeyError),
        "circuit input elsewhere": (server, lambda s: s.submit_circuit(
            [CircuitOp("rotate", ("x",), r=1)], {"x": _meta(c1)}),
            ValueError),
        "circuit plaintext not a tensor": (server, lambda s: s.submit_circuit(
            [CircuitOp("rotate", ("x",), r=1),
             CircuitOp("add_plain", (0,),
                       pt=pt.numpy().view(np.uint32))], {"x": c1}),
            ValueError),
        "circuit without key": (server, lambda s: s.submit_circuit(
            [CircuitOp("rotate", ("x",), r=1),
             CircuitOp("rotate", (0,), r=3)], {"x": c1}), KeyError),
        "circuit unknown hash": (server, lambda s: s.submit_circuit(
            [CircuitOp("rotate", ("x",), r=1),
             CircuitOp("add_plain", (0,), pt_hash="never-sent")],
            {"x": c1}), ValueError),
        "circuit scale mismatch": (server, lambda s: s.submit_circuit(
            [CircuitOp("mul", ("x", "x")), CircuitOp("add", (0, "x"))],
            {"x": c1}), ValueError),
    }
    srv, call, exc = calls[case]
    with pytest.raises(exc):
        call(srv)
    assert srv.queue.depth == 0 and not srv._circuits
    assert srv.cache.stats()["plain_entries"] == 0   # nothing registered
    assert no_evk.submit_slot_sum(c1) == 0           # fully keyed: serves


def test_server_defaults_to_the_card():
    """No silent fallback: without CUDA, a server (and so serve_he) that
    is not told device="cpu" raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device serves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HEServer(PARAMS)
    from repro_torch.launch.serve import serve_he
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_he(2)


# --------------------------------------------------------------------------
# circuit-aware scheduler
# --------------------------------------------------------------------------

def test_circuit_schedule_predicts_actual_bucket_keys(keys):
    """The schedule the scheduler looks ahead at must be EXACTLY the
    bucket keys the nodes' requests land in."""
    _, pk, _, _ = keys
    _, x = _enc(pk, 1)
    _, pt = _plain(2, LOW)
    lq = PARAMS.logQ - 2 * PARAMS.logp
    ops = [
        CircuitOp("mul", ("x", "x")),
        CircuitOp("rescale", (0,)),
        CircuitOp("mul_plain", (1,), pt=pt, pt_logp=x.logp),
        CircuitOp("rescale", (2,)),
        CircuitOp("mod_down", ("x",), logq2=lq),
        CircuitOp("rotate", (4,), r=1),
        CircuitOp("slot_sum", (5,)),
        CircuitOp("conjugate", (6,)),
        CircuitOp("add", (3, 7)),
    ]
    meta = {"x": (x.logq, x.logp)}
    _, predicted, nslots = circuit_schedule(ops, meta, {"x": x.n_slots},
                                            PARAMS)
    assert nslots == [4] * 9
    node_meta = validate_circuit(ops, meta, PARAMS)
    values = {"x": x}
    q = RequestQueue()
    for i, node in enumerate(ops):
        cts = tuple(values[a] for a in node.args)
        dlogp = node.dlogp or (PARAMS.logp if node.op == "rescale" else 0)
        rid = q.submit(node.op, cts, r=node.r, dlogp=dlogp,
                       logq2=node.logq2, pt=node.pt,
                       pt_logp=node.pt_logp
                       or (PARAMS.log_delta
                           if node.op == "mul_plain" else 0))
        (key,) = (k for k, d in q._buckets.items()
                  if any(r.rid == rid for r in d))
        assert key == predicted[i], (i, node.op, key, predicted[i])
        q.pop_bucket(key, 8)
        lq_i, lp_i = node_meta[i]
        z = torch.zeros(PARAMS.N, PARAMS.qlimbs(lq_i), dtype=torch.int32)
        values[i] = Ciphertext(ax=z, bx=z, logq=lq_i, logp=lp_i, n_slots=4)


def test_scheduler_lookahead_expectations():
    """Expectations count pending same-key nodes within the horizon,
    shrink as nodes enqueue/complete, and vanish when the circuit
    finishes (dangling nodes must not defer buckets forever)."""
    s = CircuitScheduler(lookahead=2)
    K0, K1 = ("mul", 120, None), ("rescale", 120, 30)
    # chain: n0 -> n1 -> n2 (n0/n2 share K0), n3 dangling on n0
    s.register(7, [K0, K1, K0, K1], [(), (0,), (1,), (0,)])
    assert s.expected_within(K0) == 1      # n2 is 3 away (> 2)
    s.on_enqueued(7, 0)
    assert s.expected_within(K0) == 1      # n2 is 2 batches away
    assert s.expected_within(K0, horizon=1) == 0
    assert s.expected_within(K1) == 2      # n1 (1 away) + n3 (1 away)
    s.on_completed(7, 0)
    s.on_enqueued(7, 1)
    assert s.expected_within(K0, horizon=1) == 1   # n2 now 1 away
    s.on_completed(7, 1)
    s.on_enqueued(7, 2)
    assert s.expected_within(K0) == 0
    s.on_completed(7, 2)
    s.on_finished(7)                        # n3 never ran (dangling)
    assert s.expected_within(K1) == 0
    assert s.stats()["circuits_tracked"] == 0
    with pytest.raises(ValueError, match="lookahead"):
        CircuitScheduler(lookahead=-1)
    # a cost model rides along (the deferral gate reads it); its stats say so
    assert CircuitScheduler(cost_model=object()).stats()["cost_model"]


@pytest.mark.parametrize("overlap", [False, True])
def test_drain_completes_2deep_samekey_circuit_regression(keys, overlap):
    """The drain-vs-circuit deadlock: in [mul(x,x), mul(0,0)] both nodes
    share one bucket key, so the only non-empty bucket 'expects a
    sibling' whose parent is the bucket itself. Submitted right before
    drain(), under the scheduler, it must complete (and stay bitwise)."""
    _, pk, evk, _ = keys
    server = _server(keys, schedule=True, overlap=overlap)
    _, x = _enc(pk, 31)
    cid = server.submit_circuit(
        [CircuitOp("mul", ("x", "x")), CircuitOp("mul", (0, 0))], {"x": x})
    res = server.drain()
    assert server._inflight is None and not server._circuits
    r0 = H.he_mul(x, x, evk, PARAMS)
    ref = H.he_mul(r0, r0, evk, PARAMS)
    assert torch.equal(res[cid].ax, ref.ax) and torch.equal(res[cid].bx,
                                                             ref.bx)
    assert server.scheduler.deferrals >= 1   # it DID defer, once, then
    # the progress guarantee flushed the bucket anyway


def test_scheduler_prefetches_next_levels(keys, ck):
    """Dispatching a level-dropping batch prefetches the successor
    levels' table views while the batch is in flight."""
    _, pk, _, _ = keys
    server = _server(keys, ck, schedule=True)
    _, x = _enc(pk, 62)
    cid = server.submit_circuit(
        [CircuitOp("mul", ("x", "x")), CircuitOp("rescale", (0,)),
         CircuitOp("conjugate", (1,))], {"x": x})
    assert not server.cache.has_level(LOW)
    server.poll(flush=True)                   # runs the mul; prefetches
    assert server.cache.has_level(LOW)        # before rescale/conj run
    assert server.scheduler.prefetches >= 1
    assert LOW in server.scheduler.prefetched_levels
    assert cid in server.drain()


# --------------------------------------------------------------------------
# continuous batching under a fake clock
# --------------------------------------------------------------------------

def test_poll_trickle_regression_without_age_policy(keys):
    """With drain-only flushing, a sub-batch trickle sits in the queue
    under poll()."""
    _, pk, _, _ = keys
    server = _server(keys)                    # max_age_s=None
    _, c1 = _enc(pk, 5)
    server.submit_mul(c1, c1)
    for _ in range(5):
        assert server.poll() == []            # never served
    assert server.queue.depth == 1


def test_trickle_served_within_age_deadline_fake_clock(keys):
    """With max_age_s set, a lone request is flushed (padded) the moment
    its age crosses the deadline."""
    _, pk, _, _ = keys
    now = [0.0]
    server = _server(keys, max_age_s=5.0, adaptive_target=False,
                     clock=lambda: now[0])
    _, c1 = _enc(pk, 5)
    rid = server.submit_mul(c1, c1)           # t_submit = 0.0
    assert server.poll() == []                # age 0 < 5: keep waiting
    now[0] = 4.9
    assert server.poll() == []                # still under the deadline
    now[0] = 5.0
    done = server.poll()                      # deadline hit: padded flush
    assert [r for r, _ in done] == [rid]
    s = server.stats()
    assert s["flushes"] == {"full": 0, "age": 1, "drain": 0}
    assert s["per_op"]["mul"]["pad_frac"] == 0.5
    assert s["per_op"]["mul"]["latency_ms"]["p50"] == pytest.approx(5000.0)


def test_queue_submit_stamps_with_injected_clock(keys):
    _, pk, _, _ = keys
    now = [123.0]
    server = _server(keys, clock=lambda: now[0])
    _, c1 = _enc(pk, 5)
    server.queue.submit("mul", (c1, c1))      # direct, no t_submit
    rid2 = server.submit_mul(c1, c1)          # via the server
    reqs = server.queue.pop_bucket(("mul", PARAMS.logQ, None), 4)
    assert [r.t_submit for r in reqs] == [123.0, 123.0]
    assert reqs[1].rid == rid2
    q = RequestQueue(clock=lambda: 7.0)
    q.submit("mul", (c1, c1))
    assert q.pop_bucket(("mul", PARAMS.logQ, None), 1)[0].t_submit == 7.0


def test_arrival_rate_decays_after_idle_gap():
    q = RequestQueue()
    for i in range(64):
        q._arrivals.append(i * 0.5)           # 2/s burst ending at 31.5
    assert q.arrival_rate() == pytest.approx(2.0)
    assert q.arrival_rate(now=50.0, window_s=16.0) is None
    assert len(q._arrivals) == 0              # window physically decayed
    q._arrivals.append(50.0)
    assert q.arrival_rate(now=50.0, window_s=16.0) \
        == pytest.approx(1 / 16.0)            # sparse-traffic floor
    q._arrivals.append(50.0)
    assert q.arrival_rate(now=50.0, window_s=16.0) \
        == pytest.approx(2 / 16.0)
    q._arrivals.append(54.0)
    assert q.arrival_rate(now=54.0, window_s=16.0) == pytest.approx(0.5)


def test_post_idle_trickle_flushes_at_adapted_target(keys):
    """After a burst and an idle gap, a trickle request flushes at the
    adapted target immediately, not after max_age_s."""
    _, pk, evk, rks = keys
    now = [0.0]
    server = HEServer(PARAMS, evk, rks, device="cpu", batch=4,
                      max_age_s=2.0, clock=lambda: now[0])
    _, c1 = _enc(pk, 5)
    for i in range(64):
        now[0] = i * 0.5
        server.submit_add(c1, c1)
    server.drain()
    server.reset_metrics()
    now[0] = 50.0
    rid = server.submit_add(c1, c1)
    assert server._bucket_target() == 1
    done = server.poll()
    assert [r for r, _ in done] == [rid]
    s = server.stats()
    assert s["flushes"]["age"] == 0
    assert s["per_op"]["add"]["latency_ms"]["max"] < 2000.0


def test_adaptive_bucket_target_flushes_below_batch(keys):
    _, pk, evk, rks = keys
    now = [0.0]
    server = HEServer(PARAMS, evk, rks, device="cpu", batch=4,
                      max_age_s=2.0, clock=lambda: now[0])
    _, c1 = _enc(pk, 5)
    server.submit_mul(c1, c1)                 # t = 0
    now[0] = 1.0
    server.submit_mul(c1, c1)                 # t = 1 → rate 1/s
    # target = ceil(1/s × 2s) = 2 < batch=4: the 2-deep bucket is "full"
    assert server._bucket_target() == 2
    assert len(server.poll()) == 2
    assert server.stats()["flushes"]["full"] == 1


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------

def test_metrics_roundtrip():
    m = ServeMetrics()
    m.record_depth(3)
    m.record_depth(1)
    m.record_batch("mul", 120, n_valid=3, n_pad=1, wall_s=0.5,
                   latencies_s=[0.1, 0.2, 0.3])
    m.record_batch("mul", 96, n_valid=4, n_pad=0, wall_s=0.5,
                   latencies_s=[0.4] * 4)
    m.record_batch("rotate", 120, n_valid=1, n_pad=3, wall_s=0.25,
                   latencies_s=[0.9])
    m.record_circuit_batch(2, 2)
    m.record_circuit_batch(1, 1)
    m.record_flush("age")
    with pytest.raises(ValueError):
        m.record_flush("whim")
    s = m.summary()
    mul = s["per_op"]["mul"]
    assert mul["batches"] == 2 and mul["requests"] == 7
    assert mul["ops_per_s"] == pytest.approx(7.0)
    assert mul["pad_frac"] == pytest.approx(1 / 8)
    assert mul["latency_ms"]["p50"] == pytest.approx(400.0)
    assert mul["latency_ms"]["p99"] <= mul["latency_ms"]["max"] == 400.0
    assert s["per_op"]["rotate"]["pad_frac"] == pytest.approx(0.75)
    assert s["levels_served"] == [96, 120]
    assert s["queue_depth"]["max"] == 3
    assert s["queue_depth"]["samples"] == 2
    assert s["flushes"] == {"full": 0, "age": 1, "drain": 0}
    assert s["cobatch"]["cross_circuit_rate"] == 0.5


def test_server_stats_shape(keys):
    _, pk, _, _ = keys
    server = _server(keys)
    _, c1 = _enc(pk, 5)
    server.submit_mul(c1, c1)
    assert server.poll() == []                # batch=2 not yet full
    server.submit_mul(c1, c1)
    assert len(server.poll()) == 2            # full bucket runs
    st = server.stats()
    assert st["submitted"] == 2
    assert st["engine"]["steps_compiled"] == 1
    assert st["per_op"]["mul"]["pad_frac"] == 0.0
    assert st["device"] == "cpu" and st["batch"] == 2
    snap = server.registry.snapshot()
    assert snap["counters"]["serve.requests"] == 2
    assert snap["engine"]["steps_compiled"] == 1
