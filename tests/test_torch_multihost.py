"""repro_torch's multi-host tier against the JAX package's, on the CPU.

The cases of the reference's ``tests/test_multihost.py``, on the port:
the port's ``HEFrontend`` (workers on ``device="cpu"``, which run the
kernels' plain versions) serves the reference's canonical stream — muls
at two levels — with worker 0 killed mid-batch, and every result must
equal, word for word, the JAX ``HEFrontend``'s (in-process workers on a
(1, 1) mesh with Auto axes: the default mesh's Explicit axes make the JAX
steps raise under this jax) under the same kill, and the port's own
``HEServer``. Then: a warm slice's death reroutes cold, all workers dead
raises ``NoLiveWorkersError``, a stale heartbeat on a fake clock is a
death, ``requeue`` keeps rids and FIFO order, worker processes (at most two
a test) serve bit for bit and a respawn restores full strength, a worker
asked for a card that is missing fails its init, and the telemetry
(snapshot merge, per-worker StepMonitor, multi-publisher heartbeat)
matches the reference's. Keys are made by the port and carried into JAX
with ``repro_torch.convert``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.hserve import HEFrontend as JHEFrontend
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import merge_snapshots as j_merge_snapshots
from repro.runtime.failures import FailureInjector as JFailureInjector
from repro.runtime.monitor import StepMonitor as JStepMonitor

from repro_torch import convert
from repro_torch.core import heaan as H
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen
from repro_torch.core.rotate import rot_keygen
from repro_torch.hserve import (
    HEFrontend, HEServer, NoLiveWorkersError, RequestQueue, WorkerDied,
    WorkerEngine,
)
from repro_torch.obs import MetricsRegistry, merge_snapshots
from repro_torch.runtime import FailureInjector, Heartbeat, StepMonitor

PJ = j_test_params(logN=4, beta_bits=32)      # N=16, n_slots=8, L=5
PT = t_test_params(logN=4, beta_bits=32)


def _jkey(key):
    return JEvalKey(**{k: jnp.asarray(v)
                       for k, v in convert.to_numpy(key).items()})


def _jct(ct):
    f = convert.to_numpy(ct)
    return JCiphertext(ax=jnp.asarray(f["ax"]), bx=jnp.asarray(f["bx"]),
                       logq=f["logq"], logp=f["logp"], n_slots=f["n_slots"])


def _words(ct):
    if isinstance(ct.ax, torch.Tensor):
        return (ct.ax.numpy().view(np.uint32), ct.bx.numpy().view(np.uint32),
                ct.logq, ct.logp)
    return np.asarray(ct.ax), np.asarray(ct.bx), ct.logq, ct.logp


def _same(a, b) -> bool:
    (a0, a1, aq, ap), (b0, b1, bq, bp) = _words(a), _words(b)
    return (aq, ap) == (bq, bp) and np.array_equal(a0, b0) \
        and np.array_equal(a1, b1)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture(scope="module")
def keys():
    sk, pk, evk = keygen(PT, seed=0, device="cpu")
    return sk, pk, evk, {1: rot_keygen(PT, sk, 1, device="cpu")}


@pytest.fixture(scope="module")
def pool(keys):
    """Pre-encrypted operands at the top level and one level down."""
    _, pk, _, _ = keys
    rng = np.random.default_rng(0)
    n = PT.n_slots_max
    top = [H.encrypt_message(rng.normal(size=n) + 1j * rng.normal(size=n),
                             pk, PT, seed=i + 1) for i in range(4)]
    lo = [H.he_mod_down(c, PT, PT.logQ - PT.logp) for c in top]
    return top, lo


def _submit_stream(srv, top, lo, n_each: int = 4, conv=lambda c: c):
    """The reference's canonical two-level mul stream; returns the rids."""
    rids = []
    for i in range(n_each):
        rids.append(srv.submit_mul(conv(top[i % len(top)]),
                                   conv(top[(i + 1) % len(top)])))
        rids.append(srv.submit_mul(conv(lo[i % len(lo)]),
                                   conv(lo[(i + 1) % len(lo)])))
    return rids


@pytest.fixture(scope="module")
def reference(keys, pool):
    """The JAX HEFrontend's results for the canonical stream, worker 0
    killed after its first dispatch (and its frontend stats)."""
    _, _, evk, _ = keys
    top, lo = pool
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    fe = JHEFrontend(PJ, _jkey(evk), mesh=mesh, batch=2, workers=2,
                     injector=JFailureInjector(kill_worker_at={0: 1}))
    rids = _submit_stream(fe, top, lo, conv=_jct)
    res = fe.drain()
    stats = fe.stats()
    fe.close()
    return [res[r] for r in rids], stats


@pytest.fixture(scope="module")
def monolith(keys, pool):
    """The port's HEServer on the canonical stream plus a rotate."""
    _, _, evk, rk = keys
    top, lo = pool
    srv = HEServer(PT, evk, rk, device="cpu", batch=2)
    rids = _submit_stream(srv, top, lo)
    rot = srv.submit_rotate(top[0], 1)
    res = srv.drain()
    return [res[r] for r in rids], res[rot]


def _frontend(keys, **kw):
    _, _, evk, rk = keys
    kw = {"workers": 2, "batch": 2, "worker_device": "cpu", **kw}
    return HEFrontend(PT, evk, rk, **kw)


# --------------------------------------------------------------------------
# fault injection (in-process, fake clocks — no real sleeps)
# --------------------------------------------------------------------------

def test_worker_killed_mid_batch_requeues_and_reserves_bitwise(
        keys, pool, reference, monolith):
    """Worker 0 dies right after its first dispatch: the batch was
    computed but never delivered. The frontend requeues the exact
    in-flight requests; the stream comes back word for word the JAX
    frontend's under the same kill, and the port's HEServer's."""
    top, lo = pool
    fe = _frontend(keys, injector=FailureInjector(kill_worker_at={0: 1}))
    rids = _submit_stream(fe, top, lo)
    res = fe.drain()
    ref, ref_stats = reference
    assert all(_same(res[r], j) for r, j in zip(rids, ref))
    assert all(_same(res[r], m) for r, m in zip(rids, monolith[0]))
    fr = fe.stats()["frontend"]
    for k in ("deaths", "requeued_requests", "alive", "workers"):
        assert fr[k] == ref_stats["frontend"][k], k
    assert (fr["deaths"], fr["requeued_requests"], fr["alive"]) == (1, 2, 1)
    ws = fe.stats()["workers"]
    for w, jw in zip(ws, ref_stats["workers"]):
        for k in ("alive", "batches", "served_requests", "keys_warm"):
            assert w[k] == jw[k], k
    fe.close()


def test_kill_worker_with_only_warm_slice_reroutes_cold_bitwise(
        keys, pool, reference):
    """After a warm-up that pins the low level's only warm slices on
    worker 0, killing it forces the re-route onto worker 1 — a cold step
    build + table-slice load — and results stay word for word."""
    top, lo = pool
    fe = _frontend(keys)
    fe.submit_mul(lo[0], lo[1])
    fe.submit_mul(lo[1], lo[2])
    fe.drain()
    assert [w.wid for w in fe.workers if w.keys_warm] == [0]
    built_before = fe.workers[1].transport.worker.engine.n_compiled
    fe.workers[0].transport.kill()

    rids = _submit_stream(fe, top, lo)
    res = fe.drain()
    assert all(_same(res[r], j) for r, j in zip(rids, reference[0]))
    fr = fe.stats()["frontend"]
    assert fr["deaths"] == 1 and fr["alive"] == 1
    assert fe.workers[1].transport.worker.engine.n_compiled > built_before
    assert all(k in fe.workers[1].keys_warm
               for k in fe.workers[0].keys_warm)
    fe.close()


def test_drain_with_all_workers_dead_raises_typed_error(keys, pool):
    top, lo = pool
    fe = _frontend(keys)
    for w in fe.workers:
        w.transport.kill()
    _submit_stream(fe, top, lo, n_each=1)
    with pytest.raises(NoLiveWorkersError, match="no live workers"):
        fe.drain()
    fe.close()


def test_heartbeat_timeout_declares_death_and_requeues(
        keys, pool, reference, tmp_path):
    """A worker whose heartbeat goes stale past the timeout is dead to
    the frontend: its in-flight batch requeues, and after the revival
    the stream still serves word for word. Pure fake clock."""
    top, lo = pool
    clock = FakeClock()
    fe = _frontend(keys, clock=clock, heartbeat_dir=str(tmp_path),
                   heartbeat_timeout=5.0)
    rids = _submit_stream(fe, top, lo)
    got = dict(fe.poll(flush=True))       # one batch lands on worker 0
    assert fe.workers[0].pending is not None
    clock.advance(6.0)                    # both beats now stale
    fe.check_workers()
    fr = fe.stats()["frontend"]
    assert fr["alive"] == 0 and fr["deaths"] == 2
    assert fr["requeued_requests"] == 2   # worker 0's in-flight batch
    fe.revive_workers()
    for w in fe.workers:
        w.transport.worker._beat()
    res = fe.drain()
    res.update(got)
    assert all(_same(res[r], j) for r, j in zip(rids, reference[0]))
    doc = json.loads((tmp_path / "worker0.heartbeat.json").read_text())
    assert doc["wid"] == 0 and doc["time"] == 6.0
    assert "worker.batches" in doc["metrics"]["counters"]
    assert "kernels" in doc["metrics"]
    fe.close()


def test_transport_kill_mid_batch_drops_computed_reply(keys, pool):
    top, _ = pool
    fe = _frontend(keys, workers=1)
    fe.submit_mul(top[0], top[1])
    fe.submit_mul(top[1], top[2])
    fe.poll(flush=True)                   # dispatch (reply buffered)
    w = fe.workers[0]
    assert w.pending is not None
    w.transport.kill()
    with pytest.raises(WorkerDied):
        w.transport.recv()
    fe.close()


def test_late_key_broadcast_and_worker_stats(keys, pool, monolith):
    """A rotation key added after the fleet came up reaches every worker
    (each quiesced first); worker_stats carries each worker's counters
    and the kernel launch counts."""
    _, _, evk, rk = keys
    top, _ = pool
    fe = HEFrontend(PT, evk, workers=2, batch=2, worker_device="cpu")
    fe.submit_mul(top[0], top[1])
    fe.poll(flush=True)                   # worker 0 holds a pending batch
    fe.cache.add_rot_key(1, rk[1])
    assert all(w.pending is None for w in fe.workers)
    assert all(w.transport.worker.cache.rotation_amounts == [1]
               for w in fe.workers)
    rid = fe.submit_rotate(top[0], 1)
    res = fe.drain()
    assert _same(res[rid], monolith[1])
    snaps = fe.worker_stats()
    assert sorted(snaps) == [0, 1]
    assert snaps[0]["counters"]["worker.batches"] >= 1
    assert set(snaps[0]["kernels"]) >= {"crt", "ntt", "intt", "icrt",
                                        "modmul"}
    fe.close()


def test_requeue_preserves_rids_and_fifo_order(pool):
    top, _ = pool
    q = RequestQueue()
    rids = [q.submit("mul", (top[i % 2], top[(i + 1) % 2]))
            for i in range(3)]
    key = ("mul", PT.logQ, None)
    popped = q.pop_bucket(key, 3)
    assert [r.rid for r in popped] == rids
    submitted_before = q.submitted
    q.requeue(popped)
    assert q.submitted == submitted_before    # not re-counted
    again = q.pop_bucket(key, 3)
    assert [r.rid for r in again] == rids
    assert again[0] is popped[0]              # same objects, not copies


# --------------------------------------------------------------------------
# worker processes (a real process boundary; at most two a test)
# --------------------------------------------------------------------------

def test_subprocess_workers_serve_bitwise(keys, pool, reference, monolith):
    """One worker process, frames over its pipes: the stream (muls at
    two levels + a rotate through an init-shipped key) serves word for
    word the JAX frontend's and the port's HEServer's."""
    top, lo = pool
    fe = _frontend(keys, transport="subprocess", workers=1)
    try:
        rids = _submit_stream(fe, top, lo)
        rot = fe.submit_rotate(top[0], 1)
        res = fe.drain()
        assert all(_same(res[r], j) for r, j in zip(rids, reference[0]))
        assert _same(res[rot], monolith[1])
        st = fe.stats()
        assert st["frontend"]["transport"] == "subprocess"
        assert st["device"] == "cpu"
        w = fe.workers[0]
        assert w.init_bytes > 0 and w.init_s > 0
        assert [f["op"] for f in w.frame_log].count("mul") == 4
        f = w.frame_log[0]
        assert f["send"]["bytes"] > 0 and f["recv"]["bytes"] > 0
        assert set(f["worker"]) == {"wall", "d2h_s", "read_s"}
    finally:
        fe.close()
    assert fe.workers[0].transport.proc.poll() is not None


def test_subprocess_worker_respawn_restores_full_strength(
        keys, pool, reference, monolith):
    """A worker process killed mid-drain (after its first dispatch): the
    stream completes on the survivor via requeue; ``revive_workers()``
    respawns the dead process, replays the init frame and returns the
    fleet to full strength, the respawned worker really serving."""
    top, lo = pool
    fe = _frontend(keys, transport="subprocess",
                   injector=FailureInjector(kill_worker_at={0: 1}))
    try:
        dead = fe.workers[0].transport.proc
        rids = _submit_stream(fe, top, lo)
        res = fe.drain()
        assert dead.poll() is not None, "process still alive"
        fr = fe.stats()["frontend"]
        assert fr["deaths"] == 1 and fr["alive"] == 1
        assert fr["requeued_requests"] == 2
        assert all(_same(res[r], j) for r, j in zip(rids, reference[0]))

        fe.revive_workers()
        assert fe.stats()["frontend"]["alive"] == 2
        w0 = fe.workers[0]
        assert w0.transport.proc is not dead and w0.transport.alive
        assert w0.keys_warm == set()          # blank interpreter again

        rids = _submit_stream(fe, top, lo)
        rot = fe.submit_rotate(top[0], 1)     # init replay shipped rk
        res = fe.drain()
        assert all(_same(res[r], j) for r, j in zip(rids, reference[0]))
        assert _same(res[rot], monolith[1])
        assert w0.keys_warm, "respawned worker never took a batch"
    finally:
        fe.close()


def test_worker_asked_for_a_missing_card_fails_its_init(keys):
    """No fallback: a worker on "cuda" with no card raises — in a worker
    process at its init ack (and the frontend leaves no process behind),
    in this process at the engine's construction. (On a card,
    tests/test_torch_cuda.py asks for a card the machine lacks.)"""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    _, _, evk, _ = keys
    with pytest.raises(WorkerDied, match="failed init.*CUDA"):
        HEFrontend(PT, evk, workers=1, transport="subprocess")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HEFrontend(PT, evk, workers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerEngine(PT, evk)


# --------------------------------------------------------------------------
# telemetry: the same documents as the reference's
# --------------------------------------------------------------------------

def _fill(reg, n_batches: int, depth: float, engine_steps: int):
    reg.counter("worker.batches").inc(n_batches)
    reg.gauge("depth").set(depth)
    reg.histogram("wall_s").add(0.1)
    reg.add_source("engine", lambda: {"steps_compiled": engine_steps})
    return reg


def test_merge_snapshots_namespaces_colliding_labels():
    ours = merge_snapshots({
        "worker0": _fill(MetricsRegistry(), 3, 1.0, 1).snapshot(),
        "worker1": _fill(MetricsRegistry(), 5, 2.0, 7).snapshot()})
    theirs = j_merge_snapshots({
        "worker0": _fill(JMetricsRegistry(), 3, 1.0, 1).snapshot(),
        "worker1": _fill(JMetricsRegistry(), 5, 2.0, 7).snapshot()})
    assert ours == theirs
    assert ours["counters"]["worker1.worker.batches"] == 5
    assert ours["worker1.engine"]["steps_compiled"] == 7


def test_step_monitor_per_worker_children_are_independent():
    """One shared StepMonitor fed by two workers keeps their baselines
    apart, as the reference's does sample for sample."""
    samples = [(s, 0.010, 0) for s in range(8)] + \
        [(s, 1.0, 1) for s in range(8)] + [(99, 0.1, 0), (99, 1.1, 1)] + \
        [(100 + s, 0.5, 0) for s in range(10)]
    ours, theirs = StepMonitor(warmup_steps=1), \
        JStepMonitor(warmup_steps=1)
    for step, sec, wid in samples:
        assert ours.record(step, sec, worker=wid) == \
            theirs.record(step, sec, worker=wid)
    for wid in (0, 1):
        a, b = ours.for_worker(wid), theirs.for_worker(wid)
        assert (a.ema, a.breaches, a.reanchors) == \
            (b.ema, b.breaches, b.reanchors)
    assert ours.for_worker(0).reanchors      # the breach streak re-anchored
    assert ours.ema is None and ours.count == 0


def test_heartbeat_merges_multi_publisher_metrics(tmp_path):
    r0, r1 = MetricsRegistry(), MetricsRegistry()
    r0.counter("worker.batches").inc(2)
    r1.counter("worker.batches").inc(9)
    clock = FakeClock(100.0)
    hb = Heartbeat(str(tmp_path / "hb.json"), interval=10.0,
                   metrics={"worker0": r0, "worker1": r1}, clock=clock)
    hb.beat(step=0)                       # first beat always fires
    assert Heartbeat.is_alive(hb.path, timeout=5.0, now=100.1)
    assert not Heartbeat.is_alive(hb.path, timeout=5.0, now=200.0)
    doc = json.loads((tmp_path / "hb.json").read_text())
    assert doc["metrics"]["counters"]["worker0.worker.batches"] == 2
    assert doc["metrics"]["counters"]["worker1.worker.batches"] == 9
    clock.advance(1.0)
    hb.beat(step=1)                       # gated: too soon
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 0
    clock.advance(10.0)
    hb.beat(step=2)
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 2


def test_failure_injector_kills_each_worker_once():
    inj = FailureInjector(kill_worker_at={0: 2, 1: 1})
    fired = [(w, n) for n in range(1, 5) for w in (0, 1)
             if inj.maybe_kill_worker(w, n)]
    assert fired == [(1, 1), (0, 2)]
    assert inj.killed_workers == {0, 1}
