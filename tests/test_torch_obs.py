"""repro_torch.obs against the JAX package's repro.obs, on the CPU.

The reservoir, the metrics registry and the tracer are fed the same calls
on both sides and must give the same summaries, snapshots and trace-event
JSON (timestamps included: both run on one fake clock). The StageTimer
books a served stream's stages as the JAX engine's does (the same calls
per op and stage), and a timed HE Mul step gives the same words as an
untimed one. The offline report reads a port trace through
``python -m repro_torch.obs report``, and ``serve_he`` runs its smoke
stream on the CPU.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro import obs as jobs
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.hserve import HEServer as JHEServer
from repro.hserve import ServeMetrics as JServeMetrics

from repro_torch import convert, obs
from repro_torch.core import heaan as H
from repro_torch.core import make_context
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen
from repro_torch.core.rotate import rot_keygen
from repro_torch.dist import he_pipeline as hp
from repro_torch.hserve import HEServer, ServeMetrics
from torch.profiler import ProfilerActivity, profile
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.report import analyze, format_report, load_events
from repro_torch.obs.trace import _NULL_SPAN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PJ = j_test_params(logN=5, beta_bits=32)
PT = t_test_params(logN=5, beta_bits=32)
EVENT_KEYS = ("pid", "tid", "ts", "dur", "name", "cat")
LIFECYCLE = {"submit", "enqueue", "bucket_wait", "flush",
             "batch_assemble", "dispatch", "device_wall", "complete"}


class _FakeClock:
    """Deterministic clock: advances by `tick` on every read."""

    def __init__(self, tick=1.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        t, self.t = self.t, self.t + self.tick
        return t


# --------------------------------------------------------------------------
# the same calls on both sides give the same numbers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,capacity", [(5, 16), (1000, 8), (50_000, 4096)])
def test_reservoir_matches_the_reference(n, capacity):
    """Seeded Algorithm R: the same stream gives the same summary, sample
    for sample, under and past capacity."""
    xs = list(np.random.default_rng(n).lognormal(0.0, 0.75, size=n))
    a, b = obs.Reservoir(capacity=capacity), jobs.Reservoir(
        capacity=capacity)
    a.extend(xs)
    b.extend(xs)
    assert a.summary() == b.summary()
    assert a._sample == b._sample
    assert a.sample_size == min(n, capacity) and a.count == n
    for q in (1, 50, 99):
        assert a.percentile(q) == b.percentile(q)
    with pytest.raises(ValueError):
        obs.Reservoir(capacity=0)


def _feed_registry(mod):
    reg = mod.MetricsRegistry(histogram_capacity=8)
    reg.counter("serve.polls").inc()
    reg.counter("serve.polls").inc(4)            # same name → same handle
    reg.gauge("serve.queue.depth").set(7)
    reg.histogram("serve.batch.wall_s").extend([0.3, 0.1, 0.2] * 5)
    reg.add_source("cache", lambda: {"hits": 3})

    def bad():
        raise RuntimeError("stats exploded")

    reg.add_source("bad", bad)
    reg.add_source("gone", lambda: {})
    reg.remove_source("gone")
    return reg.snapshot()


def test_registry_snapshot_matches_the_reference():
    snap = _feed_registry(obs)
    assert snap == _feed_registry(jobs)
    assert snap["counters"] == {"serve.polls": 5}
    assert snap["bad"] == {"error": "RuntimeError: stats exploded"}
    merged = obs.merge_snapshots({"w0": snap, "w1": snap})
    assert merged == jobs.merge_snapshots({"w0": snap, "w1": snap})
    assert merged["counters"] == {"w0.serve.polls": 5, "w1.serve.polls": 5}


def _feed_metrics(cls):
    m = cls()
    for i in range(300):
        m.record_batch("mul" if i % 3 else "rotate", 120 - 24 * (i % 2),
                       n_valid=1 + i % 4, n_pad=3 - i % 4, wall_s=0.01 * i,
                       latencies_s=[0.001 * ((i * 7) % 13)] * (1 + i % 4))
        m.record_depth(i % 17)
        m.record_flush(("full", "age", "drain")[i % 3])
        m.record_circuit_batch(1 + i % 2, i % 3)
    return m.summary()


def test_serve_metrics_summary_matches_the_reference():
    assert _feed_metrics(ServeMetrics) == _feed_metrics(JServeMetrics)


def _feed_tracer(mod):
    tr = mod.Tracer(clock=_FakeClock(tick=0.25), pid=3)
    with tr.span("outer", cat="test", lane="a"):
        with tr.span("inner", cat="test", lane="a", args={"k": 1}) as sp:
            sp.end(extra=2)
    tr.instant("i", cat="test", lane="b")
    tr.event("e", cat="lifecycle", lane="requests", ts=0.5, dur=0.25,
             args={"op": "mul"})
    st = mod.StageTimer(tracer=tr, clock=tr.clock)
    with st.op("mul"):
        st.timed("crt", lambda: 7)
        with st.region("region1"):
            st.timed("modmul", lambda: None)
    capped = mod.Tracer(clock=_FakeClock(), max_events=3)
    for i in range(5):
        capped.instant(f"e{i}", cat="c", lane="l")
    return tr.to_chrome(), st.summary(), (len(capped), capped.dropped)


def test_tracer_and_stage_timer_match_the_reference():
    """The same spans give the same Chrome trace-event JSON (Perfetto
    loads a port trace as it loads the reference's) and the same stage
    summary."""
    got, want = _feed_tracer(obs), _feed_tracer(jobs)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    for e in got[0]["traceEvents"]:
        assert all(k in e for k in EVENT_KEYS), e
    assert got[1]["stages"]["mul"] == {"crt": 0.25, "ntt": 0.0,
                                       "modmul": 0.25, "icrt": 0.0}


def test_disabled_tracer_allocates_nothing():
    tr = obs.Tracer(enabled=False)
    spans = [tr.span(f"s{i}", cat="c", lane="l") for i in range(100)]
    assert all(s is _NULL_SPAN for s in spans)   # identity, not equality
    for s in spans:
        with s:
            pass
    tr.instant("i", cat="c", lane="l")
    assert len(tr) == 0 and tr.events == []


def test_stage_timer_pause_scoping_and_errors():
    st = obs.StageTimer(clock=_FakeClock())
    with st.op("mul"), st.pause():               # warm-up runs book nothing
        assert st.timed("crt", lambda: 3) == 3
        with st.region("region1"):
            pass
    assert st.stage_total("mul") == 0.0
    assert st.summary()["regions"] == {}
    with pytest.raises(ValueError, match="unknown stage"):
        st.timed("keyswitch", lambda: None)
    with st.op("rotate"):
        st.timed("ntt", lambda: torch.zeros(2))  # a CPU tensor: no fence
    assert st.stage_total("rotate") == 1.0
    st.reset()
    assert st.summary() == {"stages": {}, "calls": {}, "regions": {}}


# --------------------------------------------------------------------------
# served streams: stage calls, lifecycle, report
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def keys():
    sk, pk, evk = keygen(PT, seed=0, device="cpu")
    return sk, pk, evk, {1: rot_keygen(PT, sk, 1, device="cpu")}


def _jkey(key):
    return JEvalKey(**{k: jnp.asarray(v)
                       for k, v in convert.to_numpy(key).items()})


def _stream(pk):
    rng = np.random.default_rng(3)
    cts = [H.encrypt_message(rng.random(4) + 1j * rng.random(4), pk, PT,
                             seed=s) for s in range(1, 6)]
    low = H.he_mod_down(cts[4], PT, PT.logQ - PT.logp)
    return [("mul", (cts[0], cts[1])), ("mul", (cts[2], cts[3])),
            ("mul", (low, low)), ("rotate", (cts[0],)),
            ("mul_plain", (cts[1],))]


def _drive(server, stream, ct, pt):
    rids = []
    for op, cts in stream:
        if op == "rotate":
            rids.append(server.submit_rotate(ct(cts[0]), 1))
        elif op == "mul_plain":
            rids.append(server.submit_mul_plain(ct(cts[0]), pt))
        else:
            rids.append(server.submit(op, tuple(ct(c) for c in cts)))
    res = server.drain()
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def profiled(keys):
    """The same stream through the port's and the JAX package's profiled
    servers, and through an unprofiled port server."""
    _, pk, evk, rks = keys
    stream = _stream(pk)
    pt = H.encode_plain(np.full(4, 0.5), PT, PT.logQ, device="cpu")
    tr = obs.Tracer()
    srv = HEServer(PT, evk, rks, device="cpu", batch=2, tracer=tr,
                   profile_stages=True)
    outs = _drive(srv, stream, lambda c: c, pt)
    plain = HEServer(PT, evk, rks, device="cpu", batch=2)
    outs0 = _drive(plain, stream, lambda c: c, pt)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    jsrv = JHEServer(PJ, _jkey(evk), {1: _jkey(rks[1])}, mesh=mesh, batch=2,
                     profile_stages=True)

    def jct(c):
        f = convert.to_numpy(c)
        return JCiphertext(ax=jnp.asarray(f["ax"]), bx=jnp.asarray(f["bx"]),
                           logq=f["logq"], logp=f["logp"],
                           n_slots=f["n_slots"])

    jouts = _drive(jsrv, stream, jct, pt.numpy().view(np.uint32))
    return {"srv": srv, "tr": tr, "outs": outs, "outs0": outs0,
            "jsrv": jsrv, "jouts": jouts}


def test_stage_calls_of_a_served_stream_equal_the_reference(profiled):
    """The port books every stage call where the JAX engine does: the
    same calls per op and stage (regions too), and the same words out."""
    got = profiled["srv"].engine.stage_timer.summary()
    want = profiled["jsrv"].engine.stage_timer.summary()
    assert got["calls"] == want["calls"]
    assert got["calls"]["mul"] == {"crt": 10, "ntt": 20, "modmul": 10,
                                   "icrt": 10}     # 2 batches of Fig. 2
    assert {op: set(r) for op, r in got["regions"].items()} == \
        {op: set(r) for op, r in want["regions"].items()}
    for a, b in zip(profiled["outs"], profiled["jouts"]):
        assert np.array_equal(a.ax.numpy().view(np.uint32),
                              np.asarray(b.ax))
        assert np.array_equal(a.bx.numpy().view(np.uint32),
                              np.asarray(b.bx))


def test_profiled_traced_serving_is_bitwise_with_full_lifecycle(profiled):
    """Profiled, traced serving gives the same words as plain serving,
    records every lifecycle phase with schema-valid events, books stage
    time for every staged op within its wall, and publishes through one
    registry."""
    srv, tr = profiled["srv"], profiled["tr"]
    for a, b in zip(profiled["outs"], profiled["outs0"]):
        assert torch.equal(a.ax, b.ax) and torch.equal(a.bx, b.bx)
    xs = [e for e in tr.events if e["ph"] == "X"]
    assert LIFECYCLE <= {e["name"] for e in xs}
    assert all(all(k in e for k in EVENT_KEYS) for e in tr.events)
    st = srv.engine.stage_timer
    per_op = srv.metrics.summary()["per_op"]
    for op in ("mul", "rotate", "mul_plain"):
        assert 0.0 < st.stage_total(op) <= per_op[op]["wall_s"]
    summ = st.summary()
    assert set(summ["regions"]["mul"]) == {"region1", "region2"}
    assert set(summ["regions"]["rotate"]) == {"region2"}
    snap = srv.registry.snapshot()
    for key in ("counters", "gauges", "histograms", "serve", "cache",
                "scheduler", "engine"):
        assert key in snap, key
    assert snap["counters"]["serve.requests"] == 5
    assert srv.stats()["stages"]["calls"] == summ["calls"]


def test_timed_he_mul_step_equals_untimed(keys):
    """he_mul with a StageTimer gives the same words as he_mul without
    one, and books every Fig. 2 stage call once."""
    _, pk, evk, _ = keys
    rng = np.random.default_rng(8)
    cts = [H.encrypt_message(rng.random(4) + 0j, pk, PT, seed=s)
           for s in range(4)]
    st = hp.he_static(PT, PT.logQ)
    t1, t2, ek = hp.runtime_tables(make_context(PT, PT.logQ, "cpu"), evk)
    a = [torch.stack([getattr(c, f) for c in cts[i::2]])
         for i in (0, 1) for f in ("ax", "bx")]
    args = (t1, t2, ek, a[0], a[1], a[2], a[3])
    timer = obs.StageTimer()
    with timer.op("mul"):
        timed = hp.make_he_mul_step(st, "cpu", use_kernels=True,
                                    stage_timer=timer)(*args)
    plain = hp.make_he_mul_step(st, "cpu", use_kernels=True)(*args)
    assert all(torch.equal(x, y) for x, y in zip(timed, plain))
    assert timer.summary()["calls"]["mul"] == {"crt": 5, "ntt": 10,
                                               "modmul": 5, "icrt": 5}
    for i in range(2):                           # item i: pair 2i, 2i+1
        ref = H.he_mul(cts[2 * i], cts[2 * i + 1], evk, PT)
        assert torch.equal(timed[0][i], ref.ax)
        assert torch.equal(timed[1][i], ref.bx)


def test_report_cli_reads_a_port_trace(profiled, tmp_path):
    path = str(tmp_path / "trace.json")
    n = profiled["tr"].write(path)
    assert n == len(profiled["tr"].events)
    a = analyze(load_events(path))
    assert a["stages"]["mul"]["ntt"] > 0.0
    assert a["complete"]["mul"]["n"] == 3
    assert a["queue_wait"]["mul"]["n"] == 3
    assert "Fig. 3 stage attribution" in format_report(a)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", path, "--json"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert json.loads(out.stdout) == json.loads(json.dumps(a))


def test_serve_he_smoke_on_the_cpu(tmp_path):
    """The entry point's smoke stream — two levels, a rotation, a
    conjugation, plaintext ops and two scheduled circuits — decrypts
    within 1e-2, traced, with a metrics snapshot."""
    from repro_torch.launch.serve import main, serve_he
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    st = serve_he(4, levels=2, rotations=1, conjugations=1, plain_frac=0.25,
                  circuit=True, schedule=True, device="cpu", trace=trace,
                  metrics=metrics)
    assert st["max_err"] < 1e-2
    assert st["cobatch"]["cross_circuit_batches"] > 0
    assert st["levels_served"][-1] == PT.logQ
    assert {"mul", "mul_plain", "add_plain", "rotate",
            "conjugate"} <= set(st["per_op"])
    assert st["trace_events"] > 0
    with open(metrics) as f:
        assert json.load(f)["counters"]["serve.requests"] > 0
    # without --he the LM path runs, on the card unless --device says
    # otherwise: it raises where there is none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--batch", "2"])


# --------------------------------------------------------------------------
# profiler ranges: none without a profiler; under one, the stages inside
# their step and the server's spans
# --------------------------------------------------------------------------

def _mul_step_args(pk, evk):
    rng = np.random.default_rng(8)
    cts = [H.encrypt_message(rng.random(4) + 0j, pk, PT, seed=s)
           for s in range(4)]
    st = hp.he_static(PT, PT.logQ)
    t1, t2, ek = hp.runtime_tables(make_context(PT, PT.logQ, "cpu"), evk)
    a = [torch.stack([getattr(c, f) for c in cts[i::2]])
         for i in (0, 1) for f in ("ax", "bx")]
    return st, (t1, t2, ek, a[0], a[1], a[2], a[3])


def _ranges(prof):
    """The program's ranges of a CPU profile: (name, start, end)."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.name.startswith(obs.RANGE_PREFIX)]


def _inside(r, outer):
    return any(o[1] <= r[1] and r[2] <= o[2] for o in outer)


def test_no_range_is_entered_without_a_profiler(keys, monkeypatch):
    """With no profiler recording, no range is made: not by a step's
    stages, nor by a traced server's spans; the tracer's JSON stays the
    reference's, with a profiler recording or not."""
    _, pk, evk, rks = keys
    made = []
    real = obs_trace._RANGE
    monkeypatch.setattr(obs_trace, "_RANGE",
                        lambda name: made.append(name) or real(name))
    st, args = _mul_step_args(pk, evk)
    hp.make_he_mul_step(st, "cpu", use_kernels=True)(*args)
    srv = HEServer(PT, evk, rks, device="cpu", batch=2, tracer=obs.Tracer())
    _drive(srv, _stream(pk)[:2], lambda c: c, None)
    assert made == []
    want = json.dumps(_feed_tracer(jobs), sort_keys=True)
    assert json.dumps(_feed_tracer(obs), sort_keys=True) == want
    with profile(activities=[ProfilerActivity.CPU]):
        got = _feed_tracer(obs)
    assert json.dumps(got, sort_keys=True) == want
    assert made == ["repro_torch/test/outer", "repro_torch/test/inner"]


def test_stage_ranges_of_a_profiled_step_equal_the_stage_timer(keys):
    """Under a CPU profiler an HE Mul step opens every stage's range
    inside its region's and ``step/mul``, as often as a StageTimer books
    the stage, and gives the words of the step run without a profiler."""
    _, pk, evk, _ = keys
    st, args = _mul_step_args(pk, evk)
    step = hp.make_he_mul_step(st, "cpu", use_kernels=True)
    plain = step(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(*args)
    assert all(torch.equal(x, y) for x, y in zip(out, plain))
    timer = obs.StageTimer()
    with timer.op("mul"):
        hp.make_he_mul_step(st, "cpu", use_kernels=True,
                            stage_timer=timer)(*args)
    rs = _ranges(prof)
    names = [r[0].removeprefix("repro_torch/") for r in rs]
    assert {s: names.count(f"stage/{s}") for s in obs.STAGES} == \
        timer.summary()["calls"]["mul"]
    assert names.count("step/mul") == 1
    assert names.count("stage/region1") == names.count("stage/region2") == 1
    steps = [r for r in rs if r[0].endswith("step/mul")]
    regions = [r for r in rs if "/region" in r[0]]
    assert all(_inside(r, regions) for r in rs
               if r[0].split("/")[-1] in obs.STAGES)
    assert all(_inside(r, steps) for r in rs if r not in steps)


def test_traced_serving_opens_the_server_ranges(keys, profiled):
    """Under a CPU profiler a traced server's poll, submit, batch_assemble
    and dispatch spans are ranges (each dispatch inside a poll, each step
    inside a dispatch), the tracer's events hold the whole lifecycle, and
    the words are plain serving's."""
    _, pk, evk, rks = keys
    tr = obs.Tracer()
    srv = HEServer(PT, evk, rks, device="cpu", batch=2, tracer=tr)
    pt = H.encode_plain(np.full(4, 0.5), PT, PT.logQ, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        outs = _drive(srv, _stream(pk), lambda c: c, pt)
    for a, b in zip(outs, profiled["outs0"]):
        assert torch.equal(a.ax, b.ax) and torch.equal(a.bx, b.bx)
    rs = _ranges(prof)
    by = {n: [r for r in rs if r[0] == "repro_torch/" + n]
          for n in ("server/poll", "server/submit",
                    "lifecycle/batch_assemble", "lifecycle/dispatch")}
    assert all(by.values()), {n: len(v) for n, v in by.items()}
    assert len(by["server/submit"]) == 5
    xs = [e for e in tr.events if e["ph"] == "X"]
    assert LIFECYCLE <= {e["name"] for e in xs}
    for n, v in by.items():           # one range a tracer span
        cat, name = n.split("/")
        assert len(v) == sum(1 for e in xs
                             if (e["cat"], e["name"]) == (cat, name)), n
    assert all(_inside(r, by["server/poll"])
               for r in by["lifecycle/dispatch"])
    steps = [r for r in rs if "/step/" in r[0]]
    assert {r[0] for r in steps} == {"repro_torch/step/mul",
                                     "repro_torch/step/rotate"}
    assert all(_inside(r, by["lifecycle/dispatch"]
                       + [w for w in rs if w[0].endswith("warm_compile")])
               for r in steps)
