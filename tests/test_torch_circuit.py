"""repro_torch's circuits against the JAX package's.

validate_circuit / propagate / circuit_schedule of the port give the JAX
package's level schedules and raise CircuitError, with the same message
and location, on the ill-formed circuits of tests/test_analysis.py.
execute_circuit_reference of the port, on CPU tensors, gives the JAX
package's words on circuit A (the degree-4 demo circuit), circuit B (an
affine layer: mul_plain, rescale, add_plain, rotate, sub, slot_sum) and a
circuit that ends in mod_raise; A and B decrypt within the limits of
tests/test_hserve.py and tests/test_rotate.py. Keys and inputs are made by
the port and carried into JAX with ``repro_torch.convert``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.analysis.dataflow import CircuitError as JCircuitError
from repro.analysis.dataflow import propagate as j_propagate
from repro.analysis.dataflow import transfer as j_transfer
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.hserve import circuit as jcirc

from repro_torch import convert
from repro_torch.analysis.dataflow import CircuitError, propagate, transfer
from repro_torch.core import heaan as TH
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen as t_keygen
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.hserve import circuit as tcirc

N_SLOTS = 8
PJ = j_test_params(logN=5, beta_bits=32)         # logQ 120, logp 24
PT = t_test_params(logN=5, beta_bits=32)
TOP = (PT.logQ, PT.logp)


def _np(t):
    return t.cpu().numpy().view(np.uint32)


def _to_jax(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj).items()})


def _jax_ops(ops):
    """The port's CircuitOp list as the JAX package's, pt as numpy."""
    return [jcirc.CircuitOp(op.op, op.args, r=op.r, dlogp=op.dlogp,
                            logq2=op.logq2, pt_logp=op.pt_logp,
                            pt_hash=op.pt_hash,
                            pt=None if op.pt is None else _np(op.pt))
            for op in ops]


def _circuits():
    """name -> (port ops, expected slots of input z or None)."""
    rng = np.random.default_rng(11)
    w = rng.random(N_SLOTS) - 0.5 + 1j * (rng.random(N_SLOTS) - 0.5)
    b = rng.random(N_SLOTS) + 0.25j
    logq1 = PT.logQ - PT.logp
    return {
        "A": (tcirc.degree4_demo_circuit(PT)[0],
              lambda z: np.conj(z ** 4) + z, 0.3),
        "B": (tcirc.affine_demo_circuit(PT, w, b, device="cpu"),
              lambda z: np.full(N_SLOTS, (np.roll(w * z + b, -1) - z).sum()),
              1e-2),
        "mod_raise": ([tcirc.CircuitOp("mul", ("x", "x")),
                       tcirc.CircuitOp("rescale", (0,)),
                       tcirc.CircuitOp("mod_down", (1,), logq2=logq1 - 20),
                       tcirc.CircuitOp("mod_raise", (2,), logq2=PT.logQ)],
                      None, None),
    }


@pytest.fixture(scope="module")
def setup():
    sk, pk, evk = t_keygen(PT, seed=5, device="cpu")
    rks = {r: rot_keygen(PT, sk, r, device="cpu") for r in (1, 2, 4)}
    ck = conj_keygen(PT, sk, device="cpu")
    rng = np.random.default_rng(12)
    z = rng.random(N_SLOTS) + 1j * rng.random(N_SLOTS)
    x = TH.encrypt_message(z, pk, PT, seed=13)
    jkeys = {"evk": _to_jax(JEvalKey, evk), "conj_key": _to_jax(JEvalKey, ck),
             "rot_keys": {r: _to_jax(JEvalKey, k) for r, k in rks.items()}}
    return sk, z, x, {"evk": evk, "conj_key": ck, "rot_keys": rks}, jkeys


@pytest.mark.parametrize("name", ["A", "B", "mod_raise"])
def test_schedule_matches_reference(name):
    ops = _circuits()[name][0]
    meta = {"x": TOP}
    want = jcirc.circuit_schedule(_jax_ops(ops), meta, {"x": N_SLOTS}, PJ)
    assert tcirc.circuit_schedule(ops, meta, {"x": N_SLOTS}, PT) == want
    assert tcirc.validate_circuit(ops, meta, PT) == want[0]
    assert propagate(ops, meta, PT) == j_propagate(_jax_ops(ops), meta, PJ)


# the ill-formed circuits of tests/test_analysis.py:42-61
BAD = {
    "modulus exhausted": lambda m, C, p: m.transfer(
        "rescale", [(24, 48)], p, dlogp=24, node=7),
    "levels differ": lambda m, C, p: m.transfer(
        "add", [TOP, (96, 24)], p),
    "scales differ": lambda m, C, p: m.transfer(
        "add", [(120, 48), TOP], p),
    "unknown input": lambda m, C, p: m.propagate(
        [C("rotate", ("nope",), r=1)], {"x": TOP}, p),
    "forward reference": lambda m, C, p: m.propagate(
        [C("add", (1, "x")), C("add", (0, "x"))], {"x": TOP}, p),
}


class _Port:
    transfer = staticmethod(transfer)
    propagate = staticmethod(propagate)


class _Jax:
    transfer = staticmethod(j_transfer)
    propagate = staticmethod(j_propagate)


@pytest.mark.parametrize("case", list(BAD))
def test_ill_formed_circuits_raise_as_reference(case):
    with pytest.raises(JCircuitError) as want:
        BAD[case](_Jax, jcirc.CircuitOp, PJ)
    with pytest.raises(CircuitError) as got:
        BAD[case](_Port, tcirc.CircuitOp, PT)
    assert isinstance(got.value, ValueError)
    assert str(got.value) == str(want.value)
    for attr in ("node", "op", "logq", "logp"):
        assert getattr(got.value, attr) == getattr(want.value, attr)


@pytest.mark.parametrize("name", ["A", "B", "mod_raise"])
def test_execute_circuit_reference_matches_reference(setup, name):
    sk, z, x, keys, jkeys = setup
    ops, expect, limit = _circuits()[name]
    got = tcirc.execute_circuit_reference(ops, {"x": x}, PT, **keys)
    want = jcirc.execute_circuit_reference(
        _jax_ops(ops), {"x": _to_jax(JCiphertext, x)}, PJ, **jkeys)
    assert (got.logq, got.logp, got.n_slots) == (want.logq, want.logp,
                                                 want.n_slots)
    np.testing.assert_array_equal(_np(got.ax), np.asarray(want.ax))
    np.testing.assert_array_equal(_np(got.bx), np.asarray(want.bx))
    if expect is not None:
        out = TH.decrypt_message(got, sk, PT)
        assert np.abs(out - expect(z)).max() < limit
