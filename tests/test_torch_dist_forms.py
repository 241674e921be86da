"""The HE pipeline across ranks in every iCRT form, on grids of CPU
processes.

Each grid — (1,2), (1,4) and (2,2), gloo on the CPU — is spawned once for
the module; every rank runs ``torch_grid_ranks.forms_rank`` at
``test_params(logN=4)``: the sharded ``make_he_mul_step`` with iCRT
"acc3" and "naive" at β = 2^32 and with every strategy at β = 2^64 (where
"matmul" runs as acc3), at logQ and two levels down, and every
``hserve.engine`` step at β = 2^64 and with acc3 at β = 2^32, each against
the one-rank step on the same words. Their partial sums cross the ranks in
``core.crt.icrt_partial``'s column form, two all-reduces a reduction, and
the recorded schedule must equal ``he_expected_collectives`` for that form
(counts and wire bytes). Here the ranks' rows are put together and held
against the JAX ``he_mul`` too. On 4 model ranks region 1 (9 primes at
β = 2^32, 5 at 2^64) leaves a rank without a prime: the empty shard still
joins every all-reduce.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import heaan as JH
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey

from repro_torch import convert
from repro_torch.core import heaan as TH
from repro_torch.launch.mesh import spawn_grid

import torch_grid_ranks as R

SHAPES = [(1, 2), (1, 4), (2, 2)]
ENGINE_OPS = ["mul", "rotate", "conjugate", "slot_sum", "rescale",
              "mod_down", "mod_raise", "add", "sub", "mul_plain",
              "add_plain"]
_RUNS: dict = {}


def _ids(shape):
    return f"{shape[0]}x{shape[1]}"


@pytest.fixture
def run():
    """shape -> every rank's results (each grid spawned once a module)."""
    def get(shape):
        if shape not in _RUNS:
            _RUNS[shape] = spawn_grid(R.forms_rank, data=shape[0],
                                      model=shape[1], device="cpu",
                                      timeout_s=120)
        return _RUNS[shape]
    return get


def _to_jax(cls, obj, bits):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj, bits).items()})


_JAX: dict = {}


def _jax_he_mul(bits, logq):
    """The JAX he_mul of each pair of the ranks' batch."""
    if (bits, logq) not in _JAX:
        p = R.params4(bits)
        _, pk, evk, _, _ = R.plain_keys(p)
        cts = [TH.he_mod_down(c, p, logq) if logq < p.logQ else c
               for c in R.plain_ciphertexts(p, pk, 2 * R.B)]
        jp = j_test_params(logN=4, beta_bits=bits)
        jevk = _to_jax(JEvalKey, evk, bits)
        jc = [_to_jax(JCiphertext, c, bits) for c in cts]
        _JAX[(bits, logq)] = [JH.he_mul(jc[2 * i], jc[2 * i + 1], jevk, jp)
                              for i in range(R.B)]
    return _JAX[(bits, logq)]


def _words(t, bits):
    return t.numpy().view(np.uint32 if bits == 32 else np.uint64)


@pytest.mark.parametrize("form", R.FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_step_in_every_form_equals_one_rank_and_jax(run, shape,
                                                           form):
    strategy, bits = form
    ranks = run(shape)
    p = R.params4(bits)
    for logq in (p.logQ, p.logQ - 2 * p.logp):
        key = (strategy, bits, logq)
        for res in ranks:
            assert res["mul"][key]["bitwise"], (res["rank"], logq)
        # the rows of data rank d come from model rank 0 of its row
        ax, bx = (torch.cat([ranks[d * shape[1]]["mul"][key]["rows"][i]
                             for d in range(shape[0])]) for i in (0, 1))
        for i, ref in enumerate(_jax_he_mul(bits, logq)):
            assert np.array_equal(_words(ax[i], bits), np.asarray(ref.ax))
            assert np.array_equal(_words(bx[i], bits), np.asarray(ref.bx))


@pytest.mark.parametrize("form", R.FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_schedule_of_every_form_equals_the_prediction(run, shape, form):
    """Two all-reduces a reduction (the 32-bit columns and qsum), with
    the predicted wire bytes, on every rank; an empty shard joins them."""
    strategy, bits = form
    for res in run(shape):
        for key, m in res["mul"].items():
            if key[:2] != form:
                continue
            counts, wire = m["expected"]
            assert m["counts"] == counts and m["bytes"] == wire, key
            assert counts["all-reduce"] == 2 * 5        # mul: 5 reductions


@pytest.mark.parametrize("case", [("matmul", 64), ("acc3", 32)],
                         ids=["beta64", "acc3"])
@pytest.mark.parametrize("op", ENGINE_OPS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_engine_step_in_every_form_equals_one_rank(run, shape, op, case):
    for res in run(shape):
        got = res["engine"][(*case, op)]
        assert got["bitwise"], res["rank"]
        counts, wire = got["expected"]
        assert got["counts"] == counts and got["bytes"] == wire
        if op in ("mul", "rotate", "conjugate", "slot_sum", "mul_plain"):
            assert counts.get("all-reduce", 0) > 0
        else:       # the limb steps run on the rank's rows, no collective
            assert counts == {}
