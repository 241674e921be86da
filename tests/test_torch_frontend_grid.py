"""HEFrontend's workers on a model grid, on the CPU, against HEServer.

The reference gives its workers a model mesh in two ways (``tests/
test_multihost.py``'s sharded fleet): in-process workers share the
frontend's mesh, and each subprocess worker builds its own
``(1, worker_devices)`` mesh. The port's counterparts:

- ``HEFrontend(grid=)`` on rank 0 of a (1,2) grid of CPU processes
  (``torch_grid_ranks.frontend_rank``), with 2 in-process workers whose
  steps run across both ranks (rank 1 runs ``serve_follower``, keeping
  each worker's cache and engine apart by its ``wid``): worker 0 dies
  right after its first dispatch, its batch is requeued, the workers are
  revived and the stream served again; at β = 2^32 and at β = 2^64, where
  ``HEServer(grid=)`` also serves and its int64 keys reach the follower.
- ``HEFrontend(transport="subprocess", worker_devices=2)`` with 2
  workers: each worker process is rank 0 of its own 2-rank grid and spawns
  its follower; worker 0 is killed after its first dispatch (its follower
  must end with it; the batch is requeued to worker 1), revived (a new
  group) and the stream served again, and no follower outlives the test.
- ``serve_he(workers=2, model_shards=2)`` (in-process workers on a spawned
  grid) and with ``transport="subprocess"`` equal the one-device run's
  ``max_err``.

Every result equals ``HEServer(device="cpu")``'s word for word.
"""

import time

import pytest
import torch

from repro_torch.hserve import HEFrontend, HEServer
from repro_torch.launch.mesh import spawn_grid
from repro_torch.launch.serve import serve_he
from repro_torch.runtime import FailureInjector

import torch_grid_ranks as R

_RUNS: dict = {}


@pytest.fixture
def ranks():
    if not _RUNS:
        _RUNS["grid"] = spawn_grid(R.frontend_rank, model=2, device="cpu",
                                   timeout_s=120)
    return _RUNS["grid"]


@pytest.mark.parametrize("bits", [32, 64])
def test_inproc_workers_on_a_grid_equal_heserver_through_kill_and_revival(
        ranks, bits):
    got = ranks[0][bits]
    assert got["killed"] and got["revived"]
    fr = got["frontend"]
    assert (fr["grid"], fr["workers"], fr["deaths"],
            fr["requeued_requests"], fr["alive"]) == ("1x2", 2, 1, 2, 1)
    assert got["alive"] == 2 and all(n > 0 for n in got["served"])
    # the params' stored words, at their width
    p = R.params4(bits)
    assert got["dtype"] == ("torch.int32" if bits == 32 else "torch.int64")
    assert got["shape"] == (p.N, p.qlimbs(p.logQ))


def test_followers_keep_each_workers_cache_and_stay_in_step(ranks):
    """The follower built one cache and engine per worker of each
    frontend (and one for HEServer) and ran every step the leader ran."""
    runs = ranks[1]
    assert [sorted(r["caches"]) for r in runs] == [[0, 1], [0, 1], [0]]
    for r in runs:
        assert r["steps"] > 0
        assert all(c["grid"] == "1x2" and c["model_rank"] == 1
                   for c in r["caches"].values())
    # the last run: HEServer(grid=) at β = 2^64 — every all-reduce of
    # rank 0 was joined by the follower
    assert ranks[0]["server64"]["same"]
    assert runs[2]["step"]["counts"]["all-reduce"] == \
        ranks[0]["server64"]["all_reduces"] > 0


def _ended(pid: int) -> bool:
    """No such process, or a zombie waiting for its reaper."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _wait_ended(pids, timeout_s=20.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(_ended(p) for p in pids):
            return True
        time.sleep(0.2)
    return False


def test_worker_processes_with_their_own_grids_through_kill_and_revival():
    p = R.params4(32)
    sk, pk, evk, rks, _ = R.plain_keys(p)
    top, lo = R.pool4(p, pk)
    one = HEServer(p, evk, {1: rks[1]}, device="cpu", batch=2,
                   use_kernels=False)
    rids = R.mul_stream(one, top, lo)
    res = one.drain()
    want = [res[r] for r in rids]
    fe = HEFrontend(p, evk, {1: rks[1]}, workers=2, transport="subprocess",
                    worker_device="cpu", worker_devices=2, batch=2,
                    use_kernels=False,
                    injector=FailureInjector(kill_worker_at={0: 1}))
    seen = []
    try:
        w0 = fe.workers[0]
        first = list(w0.followers)
        assert all(len(w.followers) == 1 for w in fe.workers)
        assert not any(_ended(f) for w in fe.workers for f in w.followers)
        seen += [f for w in fe.workers for f in w.followers]
        rids = R.mul_stream(fe, top, lo)
        res = fe.drain()
        assert R.same_outs([res[r] for r in rids], want)
        fr = fe.stats()["frontend"]
        assert (fr["worker_devices"], fr["deaths"], fr["alive"],
                fr["requeued_requests"]) == (2, 1, 1, 2)
        assert _wait_ended(first), "a follower outlived its killed worker"
        fe.revive_workers()
        assert fe.stats()["frontend"]["alive"] == 2
        assert w0.followers and w0.followers != first
        seen += w0.followers
        rids = R.mul_stream(fe, top, lo)
        res = fe.drain()
        assert R.same_outs([res[r] for r in rids], want)
        assert all(n > 0 for n in (w["served_requests"]
                                   for w in fe.stats()["workers"]))
        assert all(s["engine"]["steps_compiled"] > 0
                   for s in fe.worker_stats().values())
    finally:
        fe.close()
    assert _wait_ended(seen), "a follower outlived the frontend"


def test_the_only_worker_killed_and_revived_loses_no_request():
    """With every worker dead a poll raises NoLiveWorkersError and leaves
    the batch it had popped queued, with the dead worker's requeued one:
    polling on after revive_workers() serves the whole stream, equal to
    HEServer's."""
    from repro_torch.hserve import NoLiveWorkersError
    p = R.params4(32)
    sk, pk, evk, rks, _ = R.plain_keys(p)
    top, lo = R.pool4(p, pk)
    one = HEServer(p, evk, {1: rks[1]}, device="cpu", batch=2,
                   use_kernels=False)
    rids = R.mul_stream(one, top, lo)
    res = one.drain()
    want = [res[r] for r in rids]
    fe = HEFrontend(p, evk, {1: rks[1]}, workers=1, worker_device="cpu",
                    batch=2, use_kernels=False,
                    injector=FailureInjector(kill_worker_at={0: 2}))
    rids = R.mul_stream(fe, top, lo)
    res, raised = {}, 0
    while fe.queue.depth or fe._work_pending():
        try:
            res.update(fe.poll(flush=True))
        except NoLiveWorkersError:
            raised += 1
            assert fe.queue.depth > 0
            fe.revive_workers()
    assert raised == 1 and R.same_outs([res[r] for r in rids], want)
    fr = fe.stats()["frontend"]
    assert (fr["deaths"], fr["alive"], fr["requeued_requests"]) == (1, 1, 2)


@pytest.mark.parametrize("transport", ["inproc", "subprocess"])
def test_serve_he_workers_on_model_grids_equal_one_device(transport):
    kw = dict(levels=2, rotations=1, conjugations=1, plain_frac=0.25,
              circuit=True, schedule=True, device="cpu")
    one = serve_he(2, **kw)
    two = serve_he(2, workers=2, model_shards=2, transport=transport, **kw)
    assert two["max_err"] == one["max_err"] < 1e-2
    assert {op: d["requests"] for op, d in two["per_op"].items()} == \
        {op: d["requests"] for op, d in one["per_op"].items()}
    fr = two["frontend"]
    assert (fr["grid"], fr["worker_devices"]) == (
        ("1x2", 1) if transport == "inproc" else (None, 2))
    assert all(len(w["followers"]) == (transport == "subprocess")
               for w in two["workers"])
    assert all(_wait_ended(w["followers"]) for w in two["workers"])


def test_grid_and_worker_devices_refuse_what_has_no_meaning():
    from repro_torch.launch.mesh import HostGrid
    p = R.params4(32)
    cpu = torch.device("cpu")
    grid = HostGrid(1, 2, 0, cpu, "gloo")
    with pytest.raises(ValueError, match="worker_devices"):
        HEFrontend(p, transport="subprocess", grid=grid, worker_device="cpu")
    with pytest.raises(ValueError, match="transport='subprocess'"):
        HEFrontend(p, worker_devices=2, worker_device="cpu")
    with pytest.raises(ValueError, match="rank 0"):
        HEFrontend(p, worker_device="cpu",
                   grid=HostGrid(1, 2, 1, cpu, "gloo"))
