"""repro_torch's batched per-op steps against the JAX package's, bit for bit.

Each step of ``repro_torch.hserve.engine`` runs at B = 3 on CPU tensors
(the kernels' plain versions) and must equal the JAX step
(``repro.hserve.engine``, jitted on a (1, 1) mesh with Auto axes) and the
port's single-ciphertext op on each item. Keys and ciphertexts are made by
the port and carried into JAX with ``repro_torch.convert``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.core import make_context as j_make_context
from repro.core import test_params as j_test_params
from repro.core.cipher import EvalKey as JEvalKey
from repro.dist import he_pipeline as jhp
from repro.hserve import engine as jeng

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.core import make_context
from repro_torch.core import rotate as trot
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen as t_keygen
from repro_torch.dist import he_pipeline as thp
from repro_torch.hserve import engine as teng
from repro_torch.kernels import common

B, N_SLOTS = 3, 4
PJ = j_test_params(logN=5, beta_bits=32)         # logQ 120, logp 24
PT = t_test_params(logN=5, beta_bits=32)
LOW = PT.logQ - 3 * PT.logp                      # 48: two limbs


def _np(t):
    return t.numpy().view(np.uint32)


def _jax_key(key):
    return JEvalKey(**{k: jnp.asarray(v)
                       for k, v in convert.to_numpy(key).items()})


@pytest.fixture(scope="module")
def setup():
    sk, pk, evk = t_keygen(PT, seed=9, device="cpu")
    keys = {r: trot.rot_keygen(PT, sk, r, device="cpu") for r in (1, 2)}
    keys["conj"] = trot.conj_keygen(PT, sk, device="cpu")
    rng = np.random.default_rng(10)
    cts = [TH.encrypt_message(rng.random(N_SLOTS) + 1j * rng.random(N_SLOTS),
                              pk, PT, seed=40 + i) for i in range(2 * B)]
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    return {"evk": evk, "jevk": _jax_key(evk), "keys": keys, "cts": cts,
            "mesh": mesh,
            "tkeys": {k: thp.evk_tables(v) for k, v in keys.items()},
            "jkeys": {k: jhp.evk_tables(_jax_key(v))
                      for k, v in keys.items()}}


def _level(S, logq):
    """(port items, plaintexts, port tables, JAX tables, port batches, JAX
    batches) at logq: B first operands, B second operands and B
    plaintexts."""
    items = [TH.he_mod_down(c, PT, logq) if logq < PT.logQ else c
             for c in S["cts"]]
    rng = np.random.default_rng(logq)
    pts = [TH.encode_plain(rng.random(N_SLOTS) - 0.5, PT, logq,
                           device="cpu") for _ in range(B)]
    t_tabs = thp.runtime_tables(make_context(PT, logq, "cpu"), S["evk"])
    j_tabs = jhp.runtime_tables(j_make_context(PJ, logq), S["jevk"])
    batches = {"ax1": [c.ax for c in items[:B]], "bx1": [c.bx for c in
                                                         items[:B]],
               "ax2": [c.ax for c in items[B:]], "bx2": [c.bx for c in
                                                         items[B:]],
               "pt": pts}
    tb = {k: torch.stack(v) for k, v in batches.items()}
    jb = {k: jnp.asarray(_np(v)) for k, v in tb.items()}
    return items, pts, t_tabs, j_tabs, tb, jb


# case -> (input level, make(eng, st, where, knobs), call(step, tables,
# keys, batches), the port's op on item i (items, pts, keys, i))
def _rotate_ref(r):
    return lambda it, pts, K, i: trot.he_rotate(it[i], r, K[r], PT)


def _slot_sum_ref(it, pts, K, i):
    out = it[i]
    for r in teng.slot_sum_rotations(N_SLOTS):
        out = TH.he_add(out, trot.he_rotate(out, r, K[r], PT))
    return out


CASES = {
    "rotate": (PT.logQ,
               lambda e, st, w, kw: e.make_he_rotate_step(
                   st, w, trot.rotation_k(PT, 1), **kw),
               lambda s, T, K, b: s(T[1], K[1], b["ax1"], b["bx1"]),
               _rotate_ref(1), {}),
    "rotate mod2+modified": (PT.logQ,
                             lambda e, st, w, kw: e.make_he_rotate_step(
                                 st, w, trot.rotation_k(PT, 2), **kw),
                             lambda s, T, K, b: s(T[1], K[2], b["ax1"],
                                                  b["bx1"]),
                             _rotate_ref(2),
                             {"crt_strategy": "mod2",
                              "modified_shoup": True}),
    "conjugate": (PT.logQ,
                  lambda e, st, w, kw: e.make_he_rotate_step(
                      st, w, trot.conjugation_k(PT), **kw),
                  lambda s, T, K, b: s(T[1], K["conj"], b["ax1"], b["bx1"]),
                  lambda it, pts, K, i: trot.he_conjugate(it[i], K["conj"],
                                                          PT), {}),
    "conjugate at 2 limbs": (LOW,
                             lambda e, st, w, kw: e.make_he_rotate_step(
                                 st, w, trot.conjugation_k(PT), **kw),
                             lambda s, T, K, b: s(T[1], K["conj"], b["ax1"],
                                                  b["bx1"]),
                             lambda it, pts, K, i: trot.he_conjugate(
                                 it[i], K["conj"], PT), {}),
    "slot_sum": (PT.logQ,
                 lambda e, st, w, kw: e.make_slot_sum_step(st, w, N_SLOTS,
                                                           **kw),
                 lambda s, T, K, b: s(T[1], (K[1], K[2]), b["ax1"],
                                      b["bx1"]),
                 _slot_sum_ref, {}),
    "rescale": (PT.logQ,
                lambda e, st, w, kw: e.make_rescale_step(st, w, PT.logp,
                                                         **kw),
                lambda s, T, K, b: s(b["ax1"], b["bx1"]),
                lambda it, pts, K, i: TH.rescale(it[i], PT), {}),
    "mod_down": (PT.logQ,
                 lambda e, st, w, kw: e.make_mod_down_step(st, w, 76, **kw),
                 lambda s, T, K, b: s(b["ax1"], b["bx1"]),
                 lambda it, pts, K, i: TH.he_mod_down(it[i], PT, 76), {}),
    "mod_raise": (PT.logQ - PT.logp,
                  lambda e, st, w, kw: e.make_mod_raise_step(
                      st, w, PT.logQ, **kw),
                  lambda s, T, K, b: s(b["ax1"], b["bx1"]),
                  lambda it, pts, K, i: TH.he_mod_raise(it[i], PT, PT.logQ),
                  {}),
    "mod_raise r != 0": (76,
                         lambda e, st, w, kw: e.make_mod_raise_step(
                             st, w, 100, **kw),
                         lambda s, T, K, b: s(b["ax1"], b["bx1"]),
                         lambda it, pts, K, i: TH.he_mod_raise(it[i], PT,
                                                               100), {}),
    "add": (PT.logQ,
            lambda e, st, w, kw: e.make_addsub_step(st, w, "add", **kw),
            lambda s, T, K, b: s(b["ax1"], b["bx1"], b["ax2"], b["bx2"]),
            lambda it, pts, K, i: TH.he_add(it[i], it[B + i]), {}),
    "sub": (PT.logQ,
            lambda e, st, w, kw: e.make_addsub_step(st, w, "sub", **kw),
            lambda s, T, K, b: s(b["ax1"], b["bx1"], b["ax2"], b["bx2"]),
            lambda it, pts, K, i: TH.he_sub(it[i], it[B + i]), {}),
    "mul_plain": (PT.logQ,
                  lambda e, st, w, kw: e.make_mul_plain_step(st, w, **kw),
                  lambda s, T, K, b: s(T[0], b["ax1"], b["bx1"], b["pt"]),
                  lambda it, pts, K, i: TH.he_mul_plain(it[i], pts[i], PT),
                  {}),
    "add_plain": (PT.logQ,
                  lambda e, st, w, kw: e.make_add_plain_step(st, w, **kw),
                  lambda s, T, K, b: s(b["ax1"], b["bx1"], b["pt"]),
                  lambda it, pts, K, i: TH.he_add_plain(it[i], pts[i], PT),
                  {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_reference_step_and_per_item_op(setup, case):
    logq, make, call, per_item, knobs = CASES[case]
    items, pts, t_tabs, j_tabs, tb, jb = _level(setup, logq)
    jstep = jax.jit(make(jeng, jhp.he_static(PJ, logq), setup["mesh"],
                         knobs))
    want = call(jstep, j_tabs, setup["jkeys"], jb)
    common.reset_launches()
    got = call(make(teng, thp.he_static(PT, logq), "cpu", knobs), t_tabs,
               setup["tkeys"], tb)
    assert sum(common.LAUNCHES.values()) == 0
    for i in range(B):
        ref = per_item(items, pts, setup["keys"], i)
        for t, j, field in zip(got, want, ("ax", "bx")):
            np.testing.assert_array_equal(_np(t), np.asarray(j))
            np.testing.assert_array_equal(
                _np(t[i]), _np(getattr(ref, field)))


def test_steps_refuse_operands_of_another_level(setup):
    _, _, t_tabs, _, tb, _ = _level(setup, PT.logQ)
    st = thp.he_static(PT, PT.logQ - PT.logp)
    with pytest.raises(ValueError, match="operands must be"):
        teng.make_rescale_step(st, "cpu", PT.logp)(tb["ax1"], tb["bx1"])
    with pytest.raises(ValueError, match="operands must be"):
        teng.make_he_rotate_step(st, "cpu", 5)(t_tabs[1], setup["tkeys"][1],
                                               tb["ax1"], tb["bx1"])
    with pytest.raises(ValueError, match="op 'add' or 'sub'"):
        teng.make_addsub_step(st, "cpu", "mul")
