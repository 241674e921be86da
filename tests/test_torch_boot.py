"""repro_torch.boot against the JAX package's repro.boot, on the CPU.

At the reference bootstrap config (``boot_params()``: logN 4, logQ 336,
logp 24, h 2) the port's plans must equal the reference's node for node
— op, args, r, dlogp, logq2, pt_logp, pt_hash, the level schedule, the
stage labels, the key and plaintext requirements, the noise bounds — and
every materialized diagonal word for word; so must the CoeffToSlot and
SlotToCoeff matrices, and the lowering of an auto-inserted bootstrap.
The port's ``execute_circuit_reference`` on one exhausted ciphertext
gives the words JAX's gives on the same plan and keys (≈ 80 s of eager
JAX ops on the CPU, run once).

The served half holds the port to itself and to the contract, as
``tests/test_boot.py`` holds the reference (no JAX ``HEServer``: the
reference's default mesh is the fault of ROADMAP queue C): two
concurrent bootstraps through ``HEServer(device="cpu")`` equal the
plain reference bit for bit, decrypt within ``error_bound()``,
co-batch across circuits and fill the ``boot.*`` lane; the session's
``bootstrap="auto"`` insertion and ``HESession.bootstrap``; the
50-random-plan noise contract with the port's ``estimate_noise``; one
bootstrap through ``HEFrontend`` (in-process workers, and a worker
process killed and respawned, which must re-learn the bootstrap's keys
from the catalog). Keys are made by the port and carried into JAX with
``repro_torch.convert``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis.noise import estimate_noise as j_estimate_noise
from repro.boot import BootConfig as JBootConfig
from repro.boot import boot_params as j_boot_params
from repro.boot import bootstrap_circuit as j_bootstrap_circuit
from repro.boot import coeff_to_slot_matrix as j_coeff_to_slot_matrix
from repro.boot import slot_to_coeff_matrix as j_slot_to_coeff_matrix
from repro.client import compile_handle as j_compile_handle
from repro.client.handles import CipherHandle as JCipherHandle
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.hserve.circuit import \
    execute_circuit_reference as j_execute_circuit_reference

from repro_torch import convert
from repro_torch.analysis.dataflow import CircuitError
from repro_torch.analysis.noise import estimate_noise
from repro_torch.boot import (BOOT_STAGES, BootConfig, boot_params,
                              bootstrap_circuit, coeff_to_slot_matrix,
                              raise_target, slot_to_coeff_matrix)
from repro_torch.boot.modraise import interval_bound
from repro_torch.boot.pipeline import DEFAULT_MSG_BOUND, _auto_r
from repro_torch.client import CipherHandle, HESession, compile_handle
from repro_torch.core import heaan as H
from repro_torch.core.keys import keygen
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.hserve import HEFrontend, HEServer
from repro_torch.hserve.circuit import execute_circuit_reference
from repro_torch.hserve.scheduler import CircuitScheduler
from repro_torch.obs import Tracer
from repro_torch.runtime import FailureInjector

PARAMS = boot_params()              # logN=4, logQ=336, logp=24, h=2
PJ = j_boot_params()
CPU = torch.device("cpu")
ROTS = (1, 2, 3, 4)                 # the BSGS strides at 8 slots


def _words(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x)


def _same(a, b) -> bool:
    return (a.logq, a.logp, a.n_slots) == (b.logq, b.logp, b.n_slots) \
        and np.array_equal(_words(a.ax), _words(b.ax)) \
        and np.array_equal(_words(a.bx), _words(b.bx))


def _to_jax(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj).items()})


def _msg(rng, bound, n=None):
    n = n or PARAMS.n_slots_max
    z = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    return z * (bound / np.max(np.abs(z)))


def _exhausted(z, pk, seed):
    """Encrypt z and walk it down to logq == logp — the level-exhausted
    position auto-insertion targets (q_s = 1)."""
    ct = H.encrypt_message(z, pk, PARAMS, seed=seed)
    return H.he_mod_down(ct, PARAMS, PARAMS.logp)


def _plan(**kw):
    return bootstrap_circuit(PARAMS, logq_in=PARAMS.logp, device="cpu", **kw)


def _same_ops(ops, jops):
    assert len(ops) == len(jops)
    for i, (a, b) in enumerate(zip(ops, jops)):
        assert (a.op, a.args, a.r, a.dlogp, a.logq2, a.pt_logp,
                a.pt_hash) == (b.op, b.args, b.r, b.dlogp, b.logq2,
                               b.pt_logp, b.pt_hash), i
        assert (a.pt is None) == (b.pt is None), i
        if a.pt is not None:
            assert a.pt.device == CPU and a.pt.dtype == torch.int32
            assert np.array_equal(_words(a.pt), _words(b.pt)), i


@pytest.fixture(scope="module")
def keys():
    sk, pk, evk = keygen(PARAMS, seed=0, device="cpu")
    rot = {r: rot_keygen(PARAMS, sk, r, device="cpu") for r in ROTS}
    return sk, pk, evk, rot, conj_keygen(PARAMS, sk, device="cpu")


# ------------------------------------------------ plans == the reference

PLAN_CASES = {
    "default": ({}, {}),
    "r + 1": ({"config": BootConfig(r=_auto_r(PARAMS, DEFAULT_MSG_BOUND)
                                     + 1)},
              {"config": JBootConfig(r=_auto_r(PARAMS, DEFAULT_MSG_BOUND)
                                     + 1)}),
    "msg_bound 2^-6": ({"msg_bound": 2.0 ** -6}, {"msg_bound": 2.0 ** -6}),
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_equals_the_reference_node_for_node(case):
    kw, jkw = PLAN_CASES[case]
    plan = _plan(**kw)
    jplan = j_bootstrap_circuit(PJ, logq_in=PJ.logp, **jkw)
    _same_ops(plan.ops, jplan.ops)
    assert plan.meta == jplan.meta
    assert plan.stages == jplan.stages
    assert plan.requires == jplan.requires
    assert plan.plain_registers == jplan.plain_registers
    assert plan.pt_bounds == jplan.pt_bounds
    assert dataclasses.asdict(plan.config) == \
        dataclasses.asdict(jplan.config)
    for attr in ("logq_in", "logp", "n_slots", "msg_bound", "in_name",
                 "out_logq", "out_logp", "levels_gained", "r"):
        assert getattr(plan, attr) == getattr(jplan, attr), attr
    assert plan.error_bound() == jplan.error_bound()
    assert plan.error_bound(2.0 ** -4) == jplan.error_bound(2.0 ** -4)
    _same_ops(plan.resolved_ops(), jplan.resolved_ops())


@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("which", ["coeff_to_slot", "slot_to_coeff"])
def test_dft_matrices_equal_the_reference(which, n):
    port, ref = {"coeff_to_slot": (coeff_to_slot_matrix,
                                   j_coeff_to_slot_matrix),
                 "slot_to_coeff": (slot_to_coeff_matrix,
                                   j_slot_to_coeff_matrix)}[which]
    got, want = port(n, 2 * n), ref(n, 2 * n)
    assert got.dtype == want.dtype == np.complex128
    assert np.array_equal(got, want)


def test_plan_encodes_on_the_card_by_default():
    """An entry point runs on the card unless asked for the CPU: here it
    raises, as every entry point of the port does without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap_circuit(PARAMS, logq_in=PARAMS.logp)


# --------------------- the reference's unit tests (tests/test_boot.py)

def test_plan_stages_levels_and_requirements():
    plan = _plan()
    assert len(plan.ops) == len(plan.meta) == len(plan.stages)
    assert plan.ops[0].op == "mod_raise"
    assert plan.ops[0].logq2 == PARAMS.logQ
    assert tuple(dict.fromkeys(plan.stages)) == BOOT_STAGES
    # the refreshed ciphertext gains whole levels at the plan's scale
    assert plan.out_logp == PARAMS.logp
    assert plan.levels_gained >= 2
    assert plan.out_logq == PARAMS.logp \
        + plan.levels_gained * PARAMS.logp
    # Galois requirements: conjugation (Re/Im split) + the BSGS strides
    assert ("conj",) in plan.requires
    assert {t[1] for t in plan.requires if t[0] == "rot"} == set(ROTS)
    # the error contract is meaningful: bounded, and well above the
    # fixed-point floor
    b = plan.error_bound()
    assert 0 < b < 2.0 ** -6
    assert b >= 4.0 * PARAMS.N * 2.0 ** -PARAMS.logp


def test_auto_r_covers_interval_and_config_overrides():
    plan = _plan()
    theta = 2 * math.pi * interval_bound(PARAMS, plan.msg_bound)
    assert plan.r == _auto_r(PARAMS, plan.msg_bound)
    assert theta / 2.0 ** plan.r <= 1.1
    deeper = _plan(config=BootConfig(r=plan.r + 1))
    assert deeper.r == plan.r + 1
    # one more squaring costs one more level
    assert deeper.out_logq == plan.out_logq - PARAMS.logp
    # the bound is monotone in the message contract
    assert plan.error_bound(2.0 ** -4) > plan.error_bound(2.0 ** -6)


def test_full_slots_required():
    with pytest.raises(ValueError, match="full slots"):
        _plan(n_slots=PARAMS.n_slots_max // 2)


def test_chain_too_short_is_a_circuit_error():
    small = dataclasses.replace(PARAMS, logQ=8 * PARAMS.logp)
    with pytest.raises(CircuitError):
        bootstrap_circuit(small, logq_in=small.logp, device="cpu")


def test_raise_target_validates_range():
    with pytest.raises(ValueError, match="cannot mod-raise"):
        raise_target(PARAMS, PARAMS.logQ)


def test_resolved_ops_backfills_hash_only_diagonals():
    plan = _plan()
    hashed = [n for n in plan.ops if n.pt_hash is not None]
    assert hashed, "no cached plaintext operands in the plan?"
    # cross-stage dedup ships repeats hash-only (pt=None)...
    assert any(n.pt is None for n in hashed)
    # ...and resolved_ops() materializes every one of them for the
    # cacheless reference path
    assert all(n.pt is not None for n in plan.resolved_ops()
               if n.pt_hash is not None)


def test_repeat_plan_against_cache_ships_fully_hash_only():
    plan = _plan()
    regs = set(plan.plain_registers)
    again = _plan(plain_lookup=lambda h, lq: (h, lq) in regs)
    assert all(n.pt is None for n in again.ops if n.pt_hash is not None)


def test_scheduler_prefetch_walks_up_through_mod_raise():
    lv = CircuitScheduler.levels_for_key(("mod_raise", PARAMS.logp,
                                          PARAMS.logQ))
    assert lv == {PARAMS.logp, PARAMS.logQ}
    # descending ops still walk down
    assert CircuitScheduler.levels_for_key(("rescale", 72, 24)) \
        == {72, 48}


# ------------------------------------ the whole pipeline == JAX's words

def test_bootstrap_equals_the_jax_reference_word_for_word(keys):
    """One exhausted ciphertext through every node of the plan: the
    port's execute_circuit_reference == JAX's, on the same keys."""
    sk, pk, evk, rot, conj = keys
    rng = np.random.default_rng(5)
    z = _msg(rng, DEFAULT_MSG_BOUND)
    ct = _exhausted(z, pk, seed=17)
    plan = _plan()
    got = execute_circuit_reference(plan.resolved_ops(), {"x": ct}, PARAMS,
                                    evk=evk, rot_keys=rot, conj_key=conj)
    jplan = j_bootstrap_circuit(PJ, logq_in=PJ.logp)
    want = j_execute_circuit_reference(
        jplan.resolved_ops(), {"x": _to_jax(JCiphertext, ct)}, PJ,
        evk=_to_jax(JEvalKey, evk),
        rot_keys={r: _to_jax(JEvalKey, k) for r, k in rot.items()},
        conj_key=_to_jax(JEvalKey, conj))
    assert _same(got, want)
    assert (got.logq, got.logp) == (plan.out_logq, plan.out_logp)
    err = float(np.max(np.abs(H.decrypt_message(got, sk, PARAMS) - z)))
    assert err <= plan.error_bound()


@pytest.mark.parametrize("expr", ["x*x", "x*x + x*0.5"])
def test_auto_insertion_lowers_as_the_reference(keys, expr):
    """compile_handle(bootstrap="auto") splices the same pipeline at the
    same place as the reference's compile pass (one bootstrap for a
    shared operand)."""
    _, pk, _, _, _ = keys
    ct = _exhausted(_msg(np.random.default_rng(3), DEFAULT_MSG_BOUND),
                    pk, seed=19)
    x = CipherHandle(object(), "input", ct=ct)
    jx = JCipherHandle(object(), "input", ct=_to_jax(JCiphertext, ct))
    build = {"x*x": lambda v: v * v,
             "x*x + x*0.5": lambda v: (v * v) + (v * 0.5)}[expr]
    cc = compile_handle(build(x), PARAMS, bootstrap="auto", device="cpu")
    jcc = j_compile_handle(build(jx), PJ, bootstrap="auto")
    _same_ops(cc.ops, jcc.ops)
    assert cc.bootstraps == jcc.bootstraps and len(cc.bootstraps) == 1
    assert (cc.out_logq, cc.out_logp) == (jcc.out_logq, jcc.out_logp)
    assert cc.requires == jcc.requires
    assert cc.plain_registers == jcc.plain_registers
    assert cc.pt_bounds == jcc.pt_bounds


# ----------------------------------- the served pipeline (module server)

class BootEnv:
    def __init__(self, keys):
        self.sk, self.pk, self.evk, self.rot, self.conj = keys
        self.tracer = Tracer()
        self.server = HEServer(PARAMS, self.evk, self.rot, self.conj,
                               device="cpu", batch=2, schedule=True,
                               tracer=self.tracer)
        self.plan = bootstrap_circuit(
            PARAMS, logq_in=PARAMS.logp,
            plain_lookup=self.server.cache.has_plain, device="cpu")
        # the canonical concurrent run: two seeded bootstraps, one drain
        rng = np.random.default_rng(7)
        self.msgs = [_msg(rng, self.plan.msg_bound) for _ in range(2)]
        self.inputs = [_exhausted(z, self.pk, seed=11 + i)
                       for i, z in enumerate(self.msgs)]
        cids = [self.server.submit_bootstrap(ct, plan=self.plan)
                for ct in self.inputs]
        res = self.server.drain()
        self.refreshed = [res[c] for c in cids]
        self.stats = self.server.stats()

    def decrypt(self, ct):
        return H.decrypt_message(ct, self.sk, PARAMS)


@pytest.fixture(scope="module")
def env(keys):
    return BootEnv(keys)


def test_served_bootstraps_equal_the_plain_reference(env):
    ops = env.plan.resolved_ops()
    for ct, out in zip(env.inputs, env.refreshed):
        ref = execute_circuit_reference(ops, {"x": ct}, PARAMS,
                                        evk=env.evk, rot_keys=env.rot,
                                        conj_key=env.conj)
        assert _same(out, ref)


def test_served_error_contract_and_raised_level(env):
    bound = env.plan.error_bound()
    for z, out in zip(env.msgs, env.refreshed):
        assert (out.logq, out.logp) \
            == (env.plan.out_logq, env.plan.out_logp)
        err = float(np.max(np.abs(env.decrypt(out) - z)))
        assert err <= bound, f"{err:.3e} > bound {bound:.3e}"


def test_concurrent_bootstraps_cobatch_across_circuits(env):
    cb = env.stats["cobatch"]
    assert cb["circuit_nodes"] >= 2 * len(env.plan.ops)
    assert cb["cross_circuit_batches"] > 0
    assert cb["cross_circuit_rate"] > 0.0


def test_scheduler_prefetched_the_raised_level_tail(env):
    # the bootstrap's post-raise nodes live ABOVE logq_in: without the
    # mod_raise-aware prefetch they would all cold-miss the TableCache
    warmed = env.server.scheduler.prefetched_levels
    assert any(lv > env.plan.logq_in for lv in warmed), warmed


def test_boot_spans_attribute_all_four_stages(env):
    ev = [e for e in env.tracer.events if e.get("cat") == "boot"]
    assert {e["name"] for e in ev} == {f"boot.{s}" for s in BOOT_STAGES}
    assert all(e["args"]["nodes"] >= 1 for e in ev)
    # every node of both circuits is attributed exactly once
    assert sum(e["args"]["nodes"] for e in ev) == 2 * len(env.plan.ops)
    assert not env.server._boot_stages      # popped as each finished


def test_served_mod_raise_is_bitwise_vs_core(env):
    ct = _exhausted(env.msgs[0], env.pk, seed=60)
    rid = env.server.submit_mod_raise(ct, PARAMS.logQ)
    got = env.server.drain()[rid]
    assert _same(got, H.he_mod_raise(ct, PARAMS, PARAMS.logQ))
    assert got.logq == PARAMS.logQ


def test_queue_rejects_non_raising_mod_raise(env):
    ct = _exhausted(env.msgs[0], env.pk, seed=50)
    with pytest.raises(ValueError, match="must exceed"):
        env.server.submit_mod_raise(ct, ct.logq)


def test_submit_bootstrap_refuses_a_plan_of_another_shape(env):
    ct = H.encrypt_message(env.msgs[0], env.pk, PARAMS, seed=51)
    ct = H.he_mod_down(ct, PARAMS, 2 * PARAMS.logp)
    before = env.server.queue.submitted
    with pytest.raises(ValueError, match="plan was built for"):
        env.server.submit_bootstrap(ct, plan=env.plan)
    assert env.server.queue.submitted == before


def test_repeat_bootstrap_builds_its_plan_hash_only_on_the_server_device(
        env):
    """submit_bootstrap without a plan builds one on the server's device
    against its plaintext cache: every diagonal ships hash-only, and the
    same ciphertext refreshes to the same words."""
    hits = env.server.stats()["cache"]["plain_hits"]
    cid = env.server.submit_bootstrap(env.inputs[0])
    assert env.server.stats()["cache"]["plain_hits"] > hits
    assert _same(env.server.drain()[cid], env.refreshed[0])


def test_refreshed_ciphertext_runs_two_muls_bitwise_vs_core(env):
    """The error contract covers the bootstrap itself; AFTER it the
    refreshed ciphertext is an ordinary ciphertext — two further served
    muls (with rescales) must equal the core ops bit for bit at the
    raised levels."""
    out = env.refreshed[0]
    srv = env.server
    r1 = srv.submit_mul(out, out)
    sq = srv.drain()[r1]
    ref_sq = H.he_mul(out, out, env.evk, PARAMS)
    assert _same(sq, ref_sq)
    r2 = srv.submit_rescale(sq)
    sq = srv.drain()[r2]
    ref_sq = H.rescale(ref_sq, PARAMS)
    assert _same(sq, ref_sq)
    r3 = srv.submit_mul(sq, sq)
    q4 = srv.drain()[r3]
    ref_q4 = H.he_mul(ref_sq, ref_sq, env.evk, PARAMS)
    assert _same(q4, ref_q4)
    # the refreshed level really affords both muls
    assert ref_q4.logq - PARAMS.logp >= PARAMS.logp
    # the squared message is still the squared message
    z2 = env.msgs[0] ** 2
    err = float(np.max(np.abs(H.decrypt_message(
        H.rescale(q4, PARAMS), env.sk, PARAMS) - z2 * z2)))
    assert err < 1e-3


# ------------------------------------------------- session and compile

def test_session_auto_insertion_serves_past_native_depth(env):
    """run(bootstrap="auto"): a mul on a level-exhausted input compiles
    with the pipeline spliced in front and the served result is the
    product — depth beyond the native budget, within the bound."""
    s = HESession(PARAMS, env.sk, env.pk, env.evk, server=env.server,
                  device="cpu")
    rng = np.random.default_rng(21)
    z = _msg(rng, env.plan.msg_bound)
    x = s.input(_exhausted(z, env.pk, seed=70))

    with pytest.raises(CircuitError, match="needs bootstrapping"):
        s.compile(x * x)
    cc = s.compile(x * x, bootstrap="auto")
    assert len(cc.bootstraps) == 1
    assert any(n.op == "mod_raise" for n in cc.ops)

    fut = s.run([x * x], bootstrap="auto")[0]
    got = s.decrypt(fut)
    # one bootstrap (≤ bound on the message) then an exact mul: the
    # product error is ~2·|z|·bound at first order
    tol = 4.0 * env.plan.msg_bound * env.plan.error_bound()
    assert float(np.max(np.abs(got - z * z))) <= tol


def test_auto_insertion_bootstraps_shared_operand_once(env):
    s = HESession(PARAMS, env.sk, env.pk, env.evk, server=env.server,
                  device="cpu")
    rng = np.random.default_rng(22)
    x = s.input(_exhausted(_msg(rng, env.plan.msg_bound),
                           env.pk, seed=71))
    cc = s.compile((x * x) + (x * 0.5), bootstrap="auto")
    assert len(cc.bootstraps) == 1          # x refreshed once, shared
    assert sum(n.op == "mod_raise" for n in cc.ops) == 1


@pytest.mark.parametrize("call", ["compile_handle", "session.compile",
                                  "session.run"])
def test_bootstrap_off_still_raises_needs_bootstrapping(env, call):
    s = HESession(PARAMS, env.sk, env.pk, env.evk, server=env.server,
                  device="cpu")
    x = s.input(_exhausted(env.msgs[0], env.pk, seed=72))
    before = env.server.queue.submitted
    with pytest.raises(CircuitError, match="needs bootstrapping"):
        if call == "compile_handle":
            compile_handle(x * x, PARAMS, bootstrap="off", device="cpu")
        elif call == "session.compile":
            s.compile(x * x, bootstrap=False)
        else:
            s.run([x * x], bootstrap="off")
    assert env.server.queue.submitted == before


def test_session_bootstrap_caches_its_plan_and_provisions_keys(env):
    """HESession.bootstrap over a server holding only the evk: the
    rotation and conjugation keys are minted on demand, the plan is
    built once per input shape, and each result is the module server's
    words."""
    s = HESession(PARAMS, env.sk, env.pk, env.evk, device="cpu", batch=2,
                  schedule=True)
    assert s.server.cache.rotation_amounts == []
    futs = [s.bootstrap(ct) for ct in env.inputs]
    assert len(s._boot_plans) == 1
    assert sorted(s.server.cache.rotation_amounts) == list(ROTS)
    assert s.server.cache.has_conj_key
    assert s.server.registry.counter("client.bootstraps").value == 2
    plan = next(iter(s._boot_plans.values()))
    # Galois keys are seeded per amount, so the minted keys are the
    # module's and each result is the module server's, word for word
    for fut, want, z in zip(futs, env.refreshed, env.msgs):
        out = fut.result()
        assert _same(out, want)
        assert float(np.max(np.abs(s.decrypt(out) - z))) \
            <= plan.error_bound()


# ------------------------- the noise estimator's upper-bound contract

N_RANDOM_PLANS = 50
SERVED_EVERY = 10       # every 10th plan also runs served


def test_noise_upper_bound_contract_on_50_random_boot_circuits(env):
    """50 seeded random circuits containing a bootstrap (random message
    bound / squaring count → different plan DAGs). The port's noise
    propagation must equal the reference's on the reference's plan, stay
    finite, and the TOTAL contract — arithmetic noise bound + the plan's
    approximation bound — must promise usable precision. Every
    SERVED_EVERY-th plan is also served, and the measured error must
    respect that total bound."""
    rng = np.random.default_rng(1234)
    served = []
    for k in range(N_RANDOM_PLANS):
        mb = 2.0 ** -int(rng.integers(5, 8))
        r = int(_auto_r(PARAMS, mb) + rng.integers(0, 2))
        plan = bootstrap_circuit(PARAMS, logq_in=PARAMS.logp,
                                 msg_bound=mb, config=BootConfig(r=r),
                                 plain_lookup=env.server.cache.has_plain,
                                 device="cpu")
        kw = dict(input_bounds=mb, pt_bounds=plan.pt_bounds,
                  input_nslots={plan.in_name: plan.n_slots})
        noise = estimate_noise(
            plan.ops, {plan.in_name: (plan.logq_in, plan.logp)}, PARAMS,
            meta=plan.meta, **kw)
        jplan = j_bootstrap_circuit(PJ, logq_in=PJ.logp, msg_bound=mb,
                                    config=JBootConfig(r=r))
        jnoise = j_estimate_noise(
            jplan.ops, {jplan.in_name: (jplan.logq_in, jplan.logp)}, PJ,
            meta=jplan.meta, **kw)
        assert [dataclasses.astuple(a) for a in noise] == \
            [dataclasses.astuple(b) for b in jnoise]
        assert all(np.isfinite(nn.nu) and nn.nu > 0 for nn in noise)
        total = 2.0 ** noise[-1].error_bits + plan.error_bound()
        assert total < 2.0 ** -6, (
            f"plan {k}: contract {total:.3e} promises no precision")
        if k % SERVED_EVERY == 0:
            z = _msg(rng, mb)
            ct = _exhausted(z, env.pk, seed=300 + k)
            cid = env.server.submit_bootstrap(ct, plan=plan)
            served.append((k, z, cid, total))
    res = env.server.drain()
    for k, z, cid, total in served:
        err = float(np.max(np.abs(env.decrypt(res[cid]) - z)))
        assert err <= total, (
            f"plan {k}: measured {err:.3e} > contract {total:.3e}")


# --------------------------------------------- the multi-host tier

def test_bootstrap_through_the_frontend_equals_heserver(env):
    """HEFrontend subclasses HEServer: one bootstrap through two
    in-process workers is HEServer's result word for word, and the
    frontend's tracer gets the boot.* lane too."""
    tracer = Tracer()
    fe = HEFrontend(PARAMS, env.evk, env.rot, env.conj, workers=2, batch=2,
                    worker_device="cpu", schedule=True, tracer=tracer)
    try:
        cid = fe.submit_bootstrap(env.inputs[0], plan=env.plan)
        assert _same(fe.drain()[cid], env.refreshed[0])
        assert {e["name"] for e in tracer.events if e.get("cat") == "boot"} \
            == {f"boot.{s}" for s in BOOT_STAGES}
    finally:
        fe.close()


def test_respawned_worker_relearns_the_bootstrap_keys(env):
    """Two worker processes holding only the evk: the session provisions
    the bootstrap's Galois keys through the broadcast; worker 0 dies at
    its first batch (the bootstrap finishes on worker 1) and is
    respawned, its init frame read from the catalog; with worker 1 then
    killed, a second bootstrap runs wholly on the respawned worker — so
    it re-learned the keys — and still serves word for word."""
    fe = HEFrontend(PARAMS, env.evk, workers=2, batch=2,
                    transport="subprocess", worker_device="cpu",
                    injector=FailureInjector(kill_worker_at={0: 1}))
    try:
        s = HESession(PARAMS, env.sk, env.pk, env.evk, server=fe,
                      device="cpu")
        assert _same(s.bootstrap(env.inputs[0]).result(), env.refreshed[0])
        assert fe.stats()["frontend"]["deaths"] == 1
        fe.revive_workers()
        fe.workers[1].transport.kill()
        assert _same(s.bootstrap(env.inputs[1]).result(), env.refreshed[1])
        fr = fe.stats()["frontend"]
        assert fr["deaths"] == 2 and fr["alive"] == 1
        assert fe.workers[0].alive and fe.workers[0].keys_warm
    finally:
        fe.close()
