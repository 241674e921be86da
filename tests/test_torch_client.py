"""repro_torch's client (handles, compile pass, HESession) against the JAX
package's, on the CPU.

The same traces — random expressions grown by ``client.testing`` from the
same seed over the same input ciphertexts — must lower to the same
``CircuitOp`` lists on both sides: the same nodes, the level-management
nodes the pass inserts, the same plaintext hashes, the same encoded words
where an operand is materialized and none where it ships hash-only. An
``HESession`` running serve_he's traced expression over the port's
``HEServer`` and over its ``HEFrontend`` must give, word for word, what
the JAX session gives over the JAX ``HEServer`` (a (1, 1) mesh with Auto
axes), with the same analyzer reports; a session missing Galois keys
provisions them through the frontend's broadcast; the bootstrap entries
reach the ported pipeline (tests/test_torch_boot.py serves it). Keys are
made by the port and carried into JAX with ``repro_torch.convert``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.client import HESession as JHESession
from repro.client import compile_handle as j_compile_handle
from repro.client.handles import CipherHandle as JCipherHandle
from repro.client.testing import random_expr as j_random_expr
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.core.cipher import PublicKey as JPublicKey
from repro.core.cipher import SecretKey as JSecretKey
from repro.hserve import HEServer as JHEServer

from repro_torch import convert
from repro_torch.analysis.dataflow import CircuitError
from repro_torch.client import CipherHandle, HESession, compile_handle
from repro_torch.client.testing import random_expr
from repro_torch.core import heaan as H
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.hserve import HEFrontend

# logp=24 over logQ=120 leaves L=5: depth-2 traces keep two spare levels
PJ = j_test_params(logN=4, beta_bits=32, logQ=120, logp=24)
PT = t_test_params(logN=4, beta_bits=32, logQ=120, logp=24)
ROTS = (1, 2, 4)                          # slot_sum over 8 slots, rotate 1


def _jkey(cls, key):
    return cls(**{k: jnp.asarray(v) for k, v in convert.to_numpy(key).items()})


def _jct(ct):
    f = convert.to_numpy(ct)
    return JCiphertext(ax=jnp.asarray(f["ax"]), bx=jnp.asarray(f["bx"]),
                       logq=f["logq"], logp=f["logp"], n_slots=f["n_slots"])


def _words(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x)


def _same(a, b) -> bool:
    return (a.logq, a.logp) == (b.logq, b.logp) and np.array_equal(
        _words(a.ax), _words(b.ax)) and np.array_equal(_words(a.bx),
                                                       _words(b.bx))


def _msg(seed, n=8, scale=0.5):
    rng = np.random.default_rng(seed)
    return scale * (rng.normal(size=n) + 1j * rng.normal(size=n))


@pytest.fixture(scope="module")
def keys():
    sk, pk, evk = keygen(PT, seed=0, device="cpu")
    rks = {r: rot_keygen(PT, sk, r, device="cpu") for r in ROTS}
    return sk, pk, evk, rks, conj_keygen(PT, sk, device="cpu")


@pytest.fixture(scope="module")
def leaves(keys):
    _, pk, _, _, _ = keys
    return [(H.encrypt_message(_msg(s), pk, PT, seed=s), _msg(s))
            for s in (1, 2, 3)]


def _same_circuit(cc, jcc):
    """Node for node, operand for operand, and every other field."""
    assert len(cc.ops) == len(jcc.ops)
    for a, b in zip(cc.ops, jcc.ops):
        assert (a.op, a.args, a.r, a.dlogp, a.logq2, a.pt_logp,
                a.pt_hash) == (b.op, b.args, b.r, b.dlogp, b.logq2,
                               b.pt_logp, b.pt_hash)
        assert (a.pt is None) == (b.pt is None)
        if a.pt is not None:
            assert np.array_equal(_words(a.pt), _words(b.pt))
    assert (cc.out_logq, cc.out_logp, cc.n_slots) == \
        (jcc.out_logq, jcc.out_logp, jcc.n_slots)
    assert cc.requires == jcc.requires
    assert cc.plain_registers == jcc.plain_registers
    assert cc.pt_bounds == jcc.pt_bounds
    assert sorted(cc.inputs) == sorted(jcc.inputs)
    for k in cc.inputs:
        assert _same(cc.inputs[k], jcc.inputs[k])


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_compile_equals_the_reference_on_random_traces(leaves, seed,
                                                       cached):
    """client.testing grows the same expression on both sides from one
    seed; the two compile passes lower it to the same circuit (with
    every plaintext cached server-side: every plain node hash-only)."""
    session, jsession = object(), object()
    ours = [(CipherHandle(session, "input", ct=c), z) for c, z in leaves]
    theirs = [(JCipherHandle(jsession, "input", ct=_jct(c)), z)
              for c, z in leaves]
    h, shadow = random_expr(np.random.default_rng(seed), ours, n_ops=6)
    jh, jshadow = j_random_expr(np.random.default_rng(seed), theirs,
                                n_ops=6)
    np.testing.assert_array_equal(shadow, jshadow)
    lookup = (lambda hs, q: True) if cached else None
    cc = compile_handle(h, PT, plain_lookup=lookup)
    _same_circuit(cc, j_compile_handle(jh, PJ, plain_lookup=lookup))
    if cached:
        assert all(o.pt is None for o in cc.ops)
    elif cc.plain_registers:
        assert any(o.pt is not None and o.pt.device.type == "cpu"
                   for o in cc.ops)


def _expr(x, w):
    """serve_he's traced expression: every traced op, no explicit level
    management."""
    return ((x * x) * w + x).rotate(1).conj().slot_sum()


@pytest.fixture(scope="module")
def reference_run(keys, leaves):
    """The JAX session over the JAX HEServer: serve_he's expression on
    two inputs sharing one weight vector (the second ships hash-only),
    checked with check="warn"."""
    sk, pk, evk, rks, ck = keys
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    server = JHEServer(PJ, _jkey(JEvalKey, evk),
                       {r: _jkey(JEvalKey, k) for r, k in rks.items()},
                       _jkey(JEvalKey, ck), mesh=mesh, batch=2)
    s = JHESession(PJ, _jkey(JSecretKey, sk), _jkey(JPublicKey, pk),
                   _jkey(JEvalKey, evk), server=server)
    w = _msg(9)
    with pytest.warns(UserWarning, match="HS002"):
        futs = s.run([_expr(s.input(_jct(c)), w) for c, _ in leaves[:2]],
                     check="warn")
    return [f.result() for f in futs], [r.to_dict()
                                        for r in s.last_reports], \
        server.stats()["cache"]


def _port_run(session, leaves):
    w = _msg(9)
    # the whp noise bound puts the 8 slots' sum just under the 8-bit
    # waterline at these params: "warn" reports it and serves
    with pytest.warns(UserWarning, match="HS002"):
        futs = session.run([_expr(session.input(c), w)
                            for c, _ in leaves[:2]], check="warn")
    return [f.result() for f in futs]


@pytest.mark.parametrize("server", ["HEServer", "HEFrontend"])
def test_session_run_equals_the_reference_session(keys, leaves,
                                                  reference_run, server):
    sk, pk, evk, rks, ck = keys
    if server == "HEServer":
        s = HESession(PT, sk, pk, evk, rks, ck, device="cpu", batch=2)
    else:
        fe = HEFrontend(PT, evk, rks, ck, workers=2, batch=2,
                        worker_device="cpu")
        s = HESession(PT, sk, pk, evk, server=fe, device="cpu")
    got = _port_run(s, leaves)
    ref, reports, cache = reference_run
    assert all(_same(a, b) for a, b in zip(got, ref))
    assert [r.to_dict() for r in s.last_reports] == reports
    st = s.stats()["cache"]
    for k in ("plain_entries", "plain_hits", "plain_misses"):
        assert st[k] == cache[k], k
    for (_, z), out in zip(leaves, got):
        want = np.full(8, np.conj(np.roll(z * z * _msg(9) + z, -1)).sum())
        np.testing.assert_allclose(s.decrypt(out), want, atol=1e-3)
    if server == "HEFrontend":
        fe.close()


def test_session_provisions_missing_keys_through_the_frontend(
        keys, leaves, reference_run):
    """A session holding the secret key mints the rotation and
    conjugation keys the trace needs; the frontend broadcasts them to
    every worker; the result is the reference's word for word."""
    sk, pk, evk, _, _ = keys
    fe = HEFrontend(PT, evk, workers=2, batch=2, worker_device="cpu")
    s = HESession(PT, sk, pk, evk, server=fe, device="cpu")
    got = _port_run(s, leaves)
    assert all(_same(a, b) for a, b in zip(got, reference_run[0]))
    assert fe.cache.rotation_amounts == list(ROTS) and fe.cache.has_conj_key
    for w in fe.workers:
        assert w.transport.worker.cache.rotation_amounts == list(ROTS)
        assert w.transport.worker.cache.has_conj_key
    fe.close()


def test_session_moves_operands_to_its_server_explicitly(keys, leaves):
    """A raw submit of a ciphertext lying elsewhere is refused by the
    queue; ``to_server`` moves it."""
    sk, pk, evk, _, _ = keys
    s = HESession(PT, sk, pk, evk, device="cpu", batch=2)
    c = leaves[0][0]
    meta = c.to("meta")
    with pytest.raises(ValueError, match="lies on meta"):
        s.server.submit_mul(meta, meta)
    assert s.to_server(c) is c


@pytest.mark.parametrize("call", ["compile_handle", "session.compile",
                                  "session.run", "session.bootstrap"])
def test_bootstrap_raises_not_implemented(keys, leaves, call):
    """None of the four bootstrap entries is a stub any more
    (NotImplementedError is gone): each reaches the ported pipeline,
    which at these params (L = 5) refuses with its own CircuitError — the
    chain is too short for the pipeline's levels — before anything is
    enqueued. The served bootstrap is tests/test_torch_boot.py's."""
    sk, pk, evk, _, _ = keys
    s = HESession(PT, sk, pk, evk, device="cpu", batch=2)
    ct = H.he_mod_down(leaves[0][0], PT, PT.logp)       # exhausted
    x = s.input(ct)
    y = x * x
    with pytest.raises(CircuitError, match="needs bootstrapping") as e:
        if call == "compile_handle":
            compile_handle(y, PT, bootstrap="auto", device="cpu")
        elif call == "session.compile":
            s.compile(y, bootstrap=True)
        elif call == "session.run":
            s.run([y], bootstrap="auto")
        else:
            s.bootstrap(x)
    assert not isinstance(e.value, NotImplementedError)
    # the refusal comes from inside the pipeline's trace, not from the
    # mul it was spliced in front of
    assert e.value.node is None
    assert s.server.queue.submitted == 0
