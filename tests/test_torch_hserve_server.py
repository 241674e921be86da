"""repro_torch's HEServer against the JAX package's, bit for bit, on the CPU.

The same request streams, from the same fake clock, go through the port's
``HEServer(device="cpu")`` (CPU tensors take the kernels' plain versions)
and the JAX ``HEServer`` on a (1, 1) mesh with Auto axes (the default
mesh's Explicit axes make its steps raise under this jax), at
``test_params(logN=5, beta_bits=32)`` and batch 2. Keys are made by the
port and carried into JAX with ``repro_torch.convert``. Every result must
equal the reference's word for word, and the port's single-ciphertext op;
``stats()`` must agree on every deterministic field.

The two servers live for the whole module, so each JAX step compiles
once; the streams run in order: two staggered degree-4 circuits under
``schedule=True`` on cold servers (so the table prefetch has levels to
warm), then every op at its levels, then that stream again under
``overlap=True``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.hserve import HEServer as JHEServer

from repro_torch import convert
from repro_torch.core import heaan as H
from repro_torch.core import rotate as R
from repro_torch.core import test_params as t_test_params
from repro_torch.core.encoding import message_hash
from repro_torch.core.keys import keygen
from repro_torch.hserve import HEServer, degree4_demo_circuit
from repro_torch.hserve.circuit import execute_circuit_reference
from repro_torch.hserve.engine import slot_sum_rotations

PJ = j_test_params(logN=5, beta_bits=32)      # logQ 120, logp 24
PT = t_test_params(logN=5, beta_bits=32)
N_SLOTS = 4
LOGQS = (PT.logQ, PT.logQ - PT.logp, PT.logQ - 2 * PT.logp)


def _jkey(key):
    return JEvalKey(**{k: jnp.asarray(v)
                       for k, v in convert.to_numpy(key).items()})


def _jct(ct):
    f = convert.to_numpy(ct)
    return JCiphertext(ax=jnp.asarray(f["ax"]), bx=jnp.asarray(f["bx"]),
                       logq=f["logq"], logp=f["logp"], n_slots=f["n_slots"])


def _jpt(pt):
    return pt.numpy().view(np.uint32)


def _words(ct):
    """(ax, bx, logq, logp) of either side's ciphertext, words as uint32."""
    if isinstance(ct.ax, torch.Tensor):
        return (ct.ax.numpy().view(np.uint32), ct.bx.numpy().view(np.uint32),
                ct.logq, ct.logp)
    return np.asarray(ct.ax), np.asarray(ct.bx), ct.logq, ct.logp


def _same(a, b) -> bool:
    (a0, a1, aq, ap), (b0, b1, bq, bp) = _words(a), _words(b)
    return (aq, ap) == (bq, bp) and np.array_equal(a0, b0) \
        and np.array_equal(a1, b1)


class _Side:
    """One server plus the conversion of the port's operands to its
    types."""

    def __init__(self, server, ct, pt):
        self.server, self.ct, self.pt = server, ct, pt


@pytest.fixture(scope="module")
def world():
    sk, pk, evk = keygen(PT, seed=0, device="cpu")
    rks = {r: R.rot_keygen(PT, sk, r, device="cpu") for r in (1, 2)}
    ck = R.conj_keygen(PT, sk, device="cpu")
    now = [0.0]

    def clock():
        return now[0]

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jserver = JHEServer(PJ, _jkey(evk), {r: _jkey(k) for r, k in rks.items()},
                        _jkey(ck), mesh=mesh, batch=2, clock=clock,
                        schedule=True)
    tserver = HEServer(PT, evk, rks, ck, device="cpu", batch=2, clock=clock,
                       schedule=True)
    sides = {"jax": _Side(jserver, _jct, _jpt),
             "port": _Side(tserver, lambda c: c, lambda p: p)}
    rng = np.random.default_rng(5)

    def enc(seed, logq=PT.logQ):
        z = rng.normal(size=N_SLOTS) + 1j * rng.normal(size=N_SLOTS)
        ct = H.encrypt_message(z, pk, PT, seed=seed)
        return z, (H.he_mod_down(ct, PT, logq) if logq < PT.logQ else ct)

    w = {"sk": sk, "evk": evk, "rks": rks, "ck": ck, "now": now,
         "sides": sides}

    # ---- stream 1: two staggered degree-4 circuits, scheduled ------------
    ops, _ = degree4_demo_circuit(PT)
    xs = [enc(900 + j)[1] for j in range(2)]
    out = {}
    for name, s in sides.items():
        c1 = s.server.submit_circuit(ops, {"x": s.ct(xs[0])})
        res = dict(s.server.poll(flush=True))       # desync the pair
        c2 = s.server.submit_circuit(ops, {"x": s.ct(xs[1])})
        res.update(s.server.drain())
        out[name] = ({0: res[c1], 1: res[c2]}, s.server.stats())
    w["circuits"] = (ops, xs, out)

    # ---- stream 2: every op at its levels, unscheduled -------------------
    cases = []          # (label, submit(side) -> rid, port single op)
    for i, logq in enumerate(LOGQS[:2]):
        _, a = enc(10 + 2 * i, logq)
        _, b = enc(11 + 2 * i, logq)
        cases.append((f"mul@{logq}",
                      lambda s, a=a, b=b: s.server.submit_mul(s.ct(a),
                                                              s.ct(b)),
                      H.he_mul(a, b, evk, PT)))
    _, c = enc(20)
    _, d = enc(21)
    _, low = enc(22, LOGQS[1])
    acc = c
    for r in slot_sum_rotations(N_SLOTS):
        acc = H.he_add(acc, R.he_rotate(acc, r, rks[r], PT))
    cases += [
        ("rotate 1", lambda s: s.server.submit_rotate(s.ct(c), 1),
         R.he_rotate(c, 1, rks[1], PT)),
        (f"rotate 2@{LOGQS[1]}", lambda s: s.server.submit_rotate(s.ct(low),
                                                                  2),
         R.he_rotate(low, 2, rks[2], PT)),
        ("conjugate", lambda s: s.server.submit_conjugate(s.ct(c)),
         R.he_conjugate(c, ck, PT)),
        ("slot_sum", lambda s: s.server.submit_slot_sum(s.ct(c)), acc),
        ("rescale", lambda s: s.server.submit_rescale(s.ct(c)),
         H.rescale(c, PT)),
        ("mod_down", lambda s: s.server.submit_mod_down(s.ct(c), LOGQS[2]),
         H.he_mod_down(c, PT, LOGQS[2])),
        ("mod_raise", lambda s: s.server.submit_mod_raise(s.ct(low),
                                                          PT.logQ),
         H.he_mod_raise(low, PT, PT.logQ)),
        ("add", lambda s: s.server.submit_add(s.ct(c), s.ct(d)),
         H.he_add(c, d)),
        ("sub", lambda s: s.server.submit_sub(s.ct(c), s.ct(d)),
         H.he_sub(c, d)),
    ]
    for i, logq in enumerate(LOGQS):
        _, x = enc(30 + i, logq)
        wz = rng.normal(size=N_SLOTS) + 1j * rng.normal(size=N_SLOTS)
        pt = H.encode_plain(wz, PT, logq, device="cpu")
        h = message_hash(wz, PT.log_delta)
        mp, ap = H.he_mul_plain(x, pt, PT), H.he_add_plain(x, pt, PT)
        cases += [
            (f"mul_plain@{logq}",
             lambda s, x=x, pt=pt: s.server.submit_mul_plain(s.ct(x),
                                                             s.pt(pt)), mp),
            (f"add_plain@{logq}",
             lambda s, x=x, pt=pt: s.server.submit_add_plain(s.ct(x),
                                                             s.pt(pt)), ap),
            # registered by hash, then served from the cache by hash alone
            (f"mul_plain hash@{logq}",
             lambda s, x=x, pt=pt, h=h: s.server.submit_mul_plain(
                 s.ct(x), s.pt(pt), pt_hash=h), mp),
            (f"mul_plain hash reuse@{logq}",
             lambda s, x=x, h=h: s.server.submit_mul_plain(s.ct(x),
                                                           pt_hash=h), mp),
            (f"add_plain hash reuse@{logq}",
             lambda s, x=x, h=h: s.server.submit_add_plain(s.ct(x),
                                                           pt_hash=h), ap),
        ]
    _, xc = enc(40)
    cases.append(("degree-4 circuit",
                  lambda s: s.server.submit_circuit(ops, {"x": s.ct(xc)}),
                  execute_circuit_reference(ops, {"x": xc}, PT, evk=evk,
                                            rot_keys=rks, conj_key=ck)))
    w["cases"] = cases
    w["streams"] = {}
    for overlap in (False, True):
        got = {}
        for name, s in sides.items():
            s.server.schedule = False
            s.server.overlap = overlap
            s.server.reset_metrics()
            rids = [submit(s) for _, submit, _ in cases]
            now[0] += 1.0
            res = s.server.drain()
            assert s.server._inflight is None and not s.server._circuits
            got[name] = ([res[r] for r in rids], s.server.stats())
        w["streams"][overlap] = got
    return w


def _labels():
    return ["mul@120", "mul@96", "rotate 1", "rotate 2@96", "conjugate",
            "slot_sum", "rescale", "mod_down", "mod_raise", "add", "sub"] + [
        f"{op}@{lq}" for lq in LOGQS for op in (
            "mul_plain", "add_plain", "mul_plain hash",
            "mul_plain hash reuse", "add_plain hash reuse")] + [
        "degree-4 circuit"]


@pytest.mark.parametrize("label", _labels())
def test_served_op_equals_reference_server_and_single_op(world, label):
    """Each op, served without overlap, equals the JAX server's output
    word for word and the port's single-ciphertext op."""
    i = [c[0] for c in world["cases"]].index(label)
    got = world["streams"][False]
    port, ref = got["port"][0][i], got["jax"][0][i]
    assert _same(port, ref), label
    assert _same(port, world["cases"][i][2]), label


def test_overlap_equals_no_overlap_and_the_reference(world):
    """overlap=True returns results one poll late but drain() retires
    everything; every output is the same words as without overlap, on
    both sides."""
    off, on = world["streams"][False], world["streams"][True]
    for a, b, j in zip(off["port"][0], on["port"][0], on["jax"][0]):
        assert _same(a, b) and _same(b, j)


def test_staggered_circuits_under_the_scheduler(world):
    """Two degree-4 circuits one batch out of phase, scheduled: equal to
    the reference server's and to execute_circuit_reference, with the
    same cross-circuit co-batching, deferrals and prefetched levels."""
    ops, xs, out = world["circuits"]
    for j, x in enumerate(xs):
        ref = execute_circuit_reference(
            ops, {"x": x}, PT, evk=world["evk"], rot_keys=world["rks"],
            conj_key=world["ck"])
        assert _same(out["port"][0][j], ref)
        assert _same(out["port"][0][j], out["jax"][0][j])
    tst, jst = out["port"][1], out["jax"][1]
    assert tst["cobatch"] == jst["cobatch"]
    assert tst["cobatch"]["cross_circuit_batches"] > 0
    for k in ("deferrals", "prefetches", "prefetched_levels",
              "circuits_tracked", "enabled", "lookahead"):
        assert tst["scheduler"][k] == jst["scheduler"][k], k
    assert tst["scheduler"]["prefetched_levels"]
    # one request each: the decrypted result is the circuit's value
    got = H.decrypt_message(out["port"][0][0], world["sk"], PT)
    assert got.shape == (N_SLOTS,)


def _deterministic(stats):
    """The fields of stats() that do not depend on wall time or on the
    tables' layout."""
    per_op = {op: {k: v for k, v in d.items()
                   if k in ("batches", "requests", "pad_frac")}
              for op, d in stats["per_op"].items()}
    cache = {k: v for k, v in stats["cache"].items()
             if not k.endswith("_mib")}
    return {"per_op": per_op, "cache": cache,
            **{k: stats[k] for k in ("levels_served", "flushes", "cobatch",
                                     "queue_depth", "batch", "submitted",
                                     "scheduler", "flush_policy")},
            "steps_compiled": stats["engine"]["steps_compiled"]}


@pytest.mark.parametrize("stream", ["circuits", "ops", "ops overlapped"])
def test_stats_agree_on_every_deterministic_field(world, stream):
    if stream == "circuits":
        tst, jst = world["circuits"][2]["port"][1], \
            world["circuits"][2]["jax"][1]
    else:
        got = world["streams"][stream == "ops overlapped"]
        tst, jst = got["port"][1], got["jax"][1]
    t, j = _deterministic(tst), _deterministic(jst)
    assert t == j
    # latencies come from the shared fake clock: equal too
    for op in tst["per_op"]:
        assert tst["per_op"][op]["latency_ms"] == \
            jst["per_op"][op]["latency_ms"]


def test_plain_cache_hits_on_reuse(world):
    st = world["streams"][False]["port"][1]["cache"]
    # each level: one registration (miss), two hash-only reuses (hits)
    assert st["plain_entries"] == len(LOGQS)
    assert st["plain_misses"] == len(LOGQS)
    assert st["plain_hits"] >= 2 * len(LOGQS)
