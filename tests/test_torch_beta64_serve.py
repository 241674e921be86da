"""The served tiers at β = 2^64 against the JAX package, on the CPU.

At ``test_params(logN=4, beta_bits=64)`` (words are int64 bit patterns in
the port, uint64 in the reference) one request of every op kind goes
through the JAX ``HEServer`` on a (1, 1) mesh with Auto axes and through
the port's ``HEServer(device="cpu", use_kernels=False)``, its
``HEFrontend`` with in-process workers and with a worker process: every
result equals the reference's word for word, and the frontend's come back
as int64 ``(N, qlimbs)`` tensors. An ``HESession`` builds at β = 2^64 on
the plain path and its traced expression gives the reference session's
words; ``use_kernels=True`` is refused when a server, a frontend or a
session is built (there is no kernel for 64-bit words, as there is no
Pallas kernel in the reference). At ``boot_params(beta_bits=64)`` the
bootstrap plan equals the reference's node for node with its plaintext
words, and a served bootstrap equals the plain ``execute_circuit_
reference`` and decrypts within ``error_bound()``. Keys are made by the
port and carried into JAX with ``repro_torch.convert``; both servers live
for the module, so each JAX step compiles once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.boot import boot_params as j_boot_params
from repro.boot import bootstrap_circuit as j_bootstrap_circuit
from repro.client import HESession as JHESession
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.core.cipher import PublicKey as JPublicKey
from repro.core.cipher import SecretKey as JSecretKey
from repro.hserve import HEServer as JHEServer

from repro_torch import convert
from repro_torch.boot import boot_params, bootstrap_circuit
from repro_torch.client import HESession
from repro_torch.core import heaan as H
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen
from repro_torch.core.rns import PipelineConfig
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.hserve import HEFrontend, HEServer
from repro_torch.hserve.circuit import execute_circuit_reference

PJ = j_test_params(logN=4, beta_bits=64)
PT = t_test_params(logN=4, beta_bits=64)
PLAIN = PipelineConfig(use_kernels=False)
ROTS = (1, 2, 4)
OPS = ["mul", "mul@low", "rotate", "conjugate", "slot_sum", "rescale",
       "mod_down", "mod_raise", "add", "sub", "mul_plain", "add_plain"]


def _j(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj, 64).items()})


def _u64(x):
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int64
        return x.numpy().view(np.uint64)
    return np.asarray(x)


def _same(a, b) -> bool:
    return (a.logq, a.logp, a.n_slots) == (b.logq, b.logp, b.n_slots) \
        and np.array_equal(_u64(a.ax), _u64(b.ax)) \
        and np.array_equal(_u64(a.bx), _u64(b.bx))


@pytest.fixture(scope="module")
def world():
    sk, pk, evk = keygen(PT, seed=0, cfg=PLAIN, device="cpu")
    rks = {r: rot_keygen(PT, sk, r, cfg=PLAIN, device="cpu") for r in ROTS}
    ck = conj_keygen(PT, sk, cfg=PLAIN, device="cpu")
    rng = np.random.default_rng(3)
    low = PT.logQ - PT.logp
    cts = [H.encrypt_message(rng.normal(size=4) + 1j * rng.normal(size=4),
                             pk, PT, seed=10 + i, cfg=PLAIN)
           for i in range(4)]
    lows = [H.he_mod_down(c, PT, low) for c in cts[:2]]
    pt = H.encode_plain(rng.normal(size=4), PT, PT.logQ, device="cpu")
    requests = {
        "mul": ("submit_mul", (cts[0], cts[1]), {}),
        "mul@low": ("submit_mul", (lows[0], lows[1]), {}),
        "rotate": ("submit_rotate", (cts[2], 2), {}),
        "conjugate": ("submit_conjugate", (cts[3],), {}),
        "slot_sum": ("submit_slot_sum", (cts[0],), {}),
        "rescale": ("submit_rescale", (cts[1],), {}),
        "mod_down": ("submit_mod_down", (cts[2], low), {}),
        "mod_raise": ("submit_mod_raise", (lows[1], PT.logQ), {}),
        "add": ("submit_add", (cts[0], cts[3]), {}),
        "sub": ("submit_sub", (cts[1], cts[2]), {}),
        "mul_plain": ("submit_mul_plain", (cts[3], pt), {}),
        "add_plain": ("submit_add_plain", (cts[0], pt), {}),
    }
    return {"keys": (sk, pk, evk, rks, ck), "requests": requests}


def _serve(server, requests, conv=lambda x: x):
    rids = {}
    for name in OPS:
        method, args, kw = requests[name]
        args = tuple(conv(a) if not isinstance(a, int) else a for a in args)
        rids[name] = getattr(server, method)(*args, **kw)
    res = server.drain()
    return {name: res[rid] for name, rid in rids.items()}


def _to_j(x):
    if isinstance(x, torch.Tensor):            # an encoded plaintext
        return x.numpy().view(np.uint64)
    return _j(JCiphertext, x)


@pytest.fixture(scope="module")
def reference(world):
    sk, pk, evk, rks, ck = world["keys"]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    srv = JHEServer(PJ, _j(JEvalKey, evk),
                    {r: _j(JEvalKey, k) for r, k in rks.items()},
                    _j(JEvalKey, ck), mesh=mesh, batch=2)
    return _serve(srv, world["requests"], _to_j)


def _port_server(kind, world):
    sk, pk, evk, rks, ck = world["keys"]
    if kind == "HEServer":
        return HEServer(PT, evk, rks, ck, device="cpu", batch=2,
                        use_kernels=False)
    return HEFrontend(PT, evk, rks, ck, workers=2 if kind == "inproc" else 1,
                      transport="inproc" if kind == "inproc"
                      else "subprocess", worker_device="cpu", batch=2,
                      use_kernels=False)


@pytest.mark.parametrize("kind", ["HEServer", "inproc", "subprocess"])
def test_every_op_served_equals_the_reference(world, reference, kind):
    server = _port_server(kind, world)
    try:
        got = _serve(server, world["requests"])
    finally:
        if kind != "HEServer":
            server.close()
    for name in OPS:
        ct = got[name]
        # the params' stored words at their width (a frontend's too)
        assert ct.ax.dtype == torch.int64 and ct.ax.shape == (
            PT.N, PT.qlimbs(ct.logq)), name
        assert _same(ct, reference[name]), name


def test_use_kernels_is_refused_when_built():
    sk, pk, evk = keygen(PT, seed=0, cfg=PLAIN, device="cpu")
    for build in (lambda: HEServer(PT, evk, device="cpu"),
                  lambda: HEFrontend(PT, evk, worker_device="cpu"),
                  lambda: HEFrontend(PT, evk, worker_device="cpu",
                                     transport="subprocess"),
                  lambda: HESession(PT, device="cpu"),
                  lambda: HESession(PT, sk, pk, evk, device="cpu",
                                    server=_Kernels())):
        with pytest.raises(ValueError, match="use_kernels=False"):
            build()


class _Kernels:
    """A server that says it runs the kernels (never reached: the session
    refuses first)."""

    use_kernels = True


def test_session_builds_and_runs_a_traced_expression_as_the_reference():
    """A session at β = 2^64 with use_kernels=False (keygen, encryption,
    the Galois keygens and decryption on the plain path) against the
    reference's session on the same keys and the same encryption."""
    session = HESession(PT, seed=0, device="cpu", batch=2,
                        use_kernels=False)
    assert session.cfg.use_kernels is False
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jsession = JHESession(PJ, sk=_j(JSecretKey, session.sk),
                          pk=_j(JPublicKey, session.pk),
                          evk=_j(JEvalKey, session.evk), mesh=mesh, batch=2)
    rng = np.random.default_rng(4)
    z = 0.5 * (rng.normal(size=4) + 1j * rng.normal(size=4))
    w = 0.5 * (rng.normal(size=4) + 1j * rng.normal(size=4))
    x = session.encrypt(z, seed=77)
    jx = jsession.input(_j(JCiphertext, x.ciphertext))
    out = session.run([((x * x) * w + x).rotate(1).conj()])[0].result()
    jout = jsession.run([((jx * jx) * w + jx).rotate(1).conj()])[0].result()
    assert out.ax.dtype == torch.int64
    assert _same(out, jout)
    want = np.conj(np.roll(z * z * w + z, -1))
    assert np.abs(session.decrypt(out) - want).max() < 1e-2


@pytest.fixture(scope="module")
def boot():
    p = boot_params(beta_bits=64)
    sk, pk, evk = keygen(p, seed=0, cfg=PLAIN, device="cpu")
    plan = bootstrap_circuit(p, logq_in=p.logp, device="cpu")
    return p, (sk, pk, evk), plan


def test_bootstrap_plan_equals_the_reference_node_for_node(boot):
    p, _, plan = boot
    jplan = j_bootstrap_circuit(j_boot_params(beta_bits=64),
                                logq_in=p.logp)
    assert len(plan.ops) == len(jplan.ops) > 0
    n_pt = 0
    for i, (a, b) in enumerate(zip(plan.ops, jplan.ops)):
        assert (a.op, a.args, a.r, a.dlogp, a.logq2, a.pt_logp,
                a.pt_hash) == (b.op, b.args, b.r, b.dlogp, b.logq2,
                               b.pt_logp, b.pt_hash), i
        assert (a.pt is None) == (b.pt is None), i
        if a.pt is not None:
            n_pt += 1
            assert a.pt.dtype == torch.int64, i
            assert np.array_equal(_u64(a.pt), np.asarray(b.pt)), i
    assert n_pt > 0
    assert plan.requires == jplan.requires
    assert (plan.out_logq, plan.error_bound()) == (jplan.out_logq,
                                                   jplan.error_bound())


def test_served_bootstrap_equals_the_plain_reference_within_its_bound(boot):
    p, (sk, pk, evk), plan = boot
    session = HESession(p, sk, pk, evk, device="cpu", batch=2,
                        use_kernels=False)
    rng = np.random.default_rng(6)
    z = rng.uniform(-1, 1, p.n_slots_max) + 1j * rng.uniform(
        -1, 1, p.n_slots_max)
    z *= 2.0 ** -5 / np.max(np.abs(z))
    ct = H.he_mod_down(H.encrypt_message(z, pk, p, seed=9, cfg=PLAIN), p,
                       p.logp)
    out = session.bootstrap(ct).result()
    # the Galois keys the session minted for the plan, from their seeds
    rot = {req[1]: rot_keygen(p, sk, req[1], cfg=PLAIN, device="cpu")
           for req in plan.requires if req[0] == "rot"}
    conj = conj_keygen(p, sk, cfg=PLAIN, device="cpu") \
        if ("conj",) in plan.requires else None
    want = execute_circuit_reference(plan.resolved_ops(), {"x": ct}, p,
                                     evk=evk, rot_keys=rot, conj_key=conj,
                                     cfg=PLAIN)
    assert out.ax.dtype == torch.int64 and _same(out, want)
    assert np.abs(session.decrypt(out) - z).max() <= plan.error_bound()
