"""Serving across ranks: HEServer(grid=) with serve_follower, the session
over it and ``serve_he --model-shards``, against one device.

A (1,2) grid of CPU processes (gloo) serves one stream — muls over two
levels, a rotation, a conjugation, mul_plain/add_plain, a slot sum, a
rescale, an add, a degree-4 circuit and a traced expression — through an
``HESession(grid=)`` on rank 0 while rank 1 runs ``serve_follower``; every
result equals ``HEServer(device="cpu")``'s word for word. A follower that
dies in the middle of a step makes rank 0 raise within the grid's time
limit.
"""

import time

import pytest
import torch

from repro_torch.client import HESession
from repro_torch.core.params import test_params
from repro_torch.launch.mesh import spawn_grid
from repro_torch.launch.serve import serve_he

import torch_grid_ranks as R

_RUNS: dict = {}


@pytest.fixture
def served():
    """(rank 0 on the grid, the same stream on one device), once."""
    if not _RUNS:
        p = R.params()
        sk, pk, evk, rks, ck = R.keys(p)
        session = HESession(p, sk, pk, evk, rot_keys=rks, conj_key=ck,
                            device="cpu", batch=2, schedule=True)
        _RUNS["one"] = R.serve_stream(session.server, session)
        _RUNS["grid"] = spawn_grid(R.serve_rank, model=2, device="cpu",
                                   timeout_s=120)
    return _RUNS


def test_grid_session_equals_one_device_word_for_word(served):
    grid, one = served["grid"][0], served["one"]
    assert len(grid["outs"]) == len(one) == 12
    for (ax, bx, logq, logp), (ax1, bx1, logq1, logp1) in zip(grid["outs"],
                                                              one):
        assert (logq, logp) == (logq1, logp1)
        assert torch.equal(ax, ax1) and torch.equal(bx, bx1)


def test_grid_stats_name_the_grid_and_count_its_traffic(served):
    grid, follower = served["grid"]
    g = grid["grid"]
    assert (g["data"], g["model"], g["rank"], g["backend"]) == \
        (1, 2, 0, "gloo")
    # the leader's steps reduce across the ranks; its feed is the relay
    assert g["step"]["counts"]["all-reduce"] > 0
    assert g["feed"]["counts"]["broadcast"] > 0
    # the follower ran the leader's steps (each signature's warm run too)
    assert follower["steps"] > 0
    assert follower["step"]["counts"] == g["step"]["counts"]
    assert follower["cache"]["grid"] == "1x2"
    assert follower["cache"]["model_rank"] == 1


def test_serve_he_model_shards_equals_one_device():
    kw = dict(levels=2, rotations=1, conjugations=1, plain_frac=0.25,
              circuit=True, schedule=True, device="cpu")
    one = serve_he(2, **kw)
    two = serve_he(2, model_shards=2, **kw)
    assert two["max_err"] == one["max_err"] < 1e-2
    assert {op: d["requests"] for op, d in two["per_op"].items()} == \
        {op: d["requests"] for op, d in one["per_op"].items()}
    assert (two["grid"]["model"], two["grid"]["backend"]) == (2, "gloo")
    assert "grid" not in one


def test_killed_follower_makes_rank_0_raise_in_its_time_limit():
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 0 of a 1x2 grid failed"):
        spawn_grid(R.serve_rank, model=2, device="cpu", args=(3,),
                   timeout_s=20)
    assert time.perf_counter() - t0 < 60


def test_model_shards_refuses_workers_and_follower_rules():
    """What a grid server still refuses: a frontend asked for both a grid
    and worker processes (``serve_he`` builds each worker's own grid
    then), a server off rank 0 or on a grid of data size > 1, a follower
    on rank 0, and the kernels at β = 2^64 (on a grid as on one device;
    the word size itself now runs across ranks)."""
    from repro_torch.hserve import HEFrontend, HEServer, serve_follower
    from repro_torch.launch.mesh import HostGrid
    p = R.params()
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="worker_devices"):
        HEFrontend(p, transport="subprocess", worker_device="cpu",
                   grid=HostGrid(1, 2, 0, cpu, "gloo"))
    with pytest.raises(ValueError, match="rank 0"):
        HEServer(p, device="cpu", grid=HostGrid(1, 2, 1, cpu, "gloo"))
    with pytest.raises(ValueError, match="data size 1"):
        HEServer(p, device="cpu", grid=HostGrid(2, 2, 0, cpu, "gloo"))
    with pytest.raises(ValueError, match="serve_follower runs"):
        serve_follower(HostGrid(1, 2, 0, cpu, "gloo"), p)
    with pytest.raises(ValueError, match="use_kernels=False"):     # β = 2^64
        HEServer(test_params(logN=4, beta_bits=64), device="cpu",
                 grid=HostGrid(1, 2, 0, cpu, "gloo"))
