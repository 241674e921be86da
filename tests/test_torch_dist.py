"""repro_torch's HE pipeline across ranks, on grids of CPU processes.

Each grid — (1,2), (1,4) and (2,2), gloo on the CPU — is spawned once for
the module (``launch.mesh.spawn_grid``); every rank runs
``torch_grid_ranks.step_rank``: the sharded ``make_he_mul_step`` (default,
kernels with Mod-2 and modified Shoup, ``reduce_scatter_icrt``) at logQ
and two levels down, and every ``hserve.engine`` step on a
``TableCache(grid=)``, each against the one-rank step on the same words.
Here the ranks' rows are put together and held against the JAX
``he_mul`` too. At ``test_params(logN=5)`` region 1 has 9 primes and
region 2 13, so on 4 model ranks the last holds no region-1 prime: the
empty shard still joins every all-reduce.
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
            _RUNS[shape] = spawn_grid(R.step_rank, data=shape[0],
                                      model=shape[1], device="cpu",
                                      timeout_s=120)
        return _RUNS[shape]
    return get


def _to_jax(cls, obj):
    return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                  for k, v in convert.to_numpy(obj).items()})


_JAX: dict = {}


def _jax_he_mul(logq):
    """The JAX he_mul of each pair of the ranks' batch, at logq."""
    if logq not in _JAX:
        p = R.params()
        _, pk, evk, _, _ = R.keys(p)
        cts = [TH.he_mod_down(c, p, logq) if logq < p.logQ else c
               for c in R.ciphertexts(p, pk, 2 * R.B)]
        jp = j_test_params(logN=R.LOGN, beta_bits=32)
        jevk = _to_jax(JEvalKey, evk)
        jc = [_to_jax(JCiphertext, c) for c in cts]
        _JAX[logq] = [JH.he_mul(jc[2 * i], jc[2 * i + 1], jevk, jp)
                      for i in range(R.B)]
    return _JAX[logq]


@pytest.mark.parametrize("config", list(R.MUL_CONFIGS))
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_sharded_mul_step_equals_one_rank_and_jax(run, shape, config):
    ranks = run(shape)
    p = R.params()
    for logq in (p.logQ, p.logQ - 2 * p.logp):
        for res in ranks:
            assert res["mul"][(config, logq)]["bitwise"], (res["rank"], logq)
            # gather_batch puts the data ranks' rows back together
            assert res["mul"][(config, logq)]["gathered"]
        # the rows of data rank d come from model rank 0 of its row
        ax = torch.cat([ranks[d * shape[1]]["mul"][(config, logq)]["rows"][0]
                        for d in range(shape[0])])
        bx = torch.cat([ranks[d * shape[1]]["mul"][(config, logq)]["rows"][1]
                        for d in range(shape[0])])
        for i, ref in enumerate(_jax_he_mul(logq)):
            assert np.array_equal(ax[i].numpy().view(np.uint32),
                                  np.asarray(ref.ax))
            assert np.array_equal(bx[i].numpy().view(np.uint32),
                                  np.asarray(ref.bx))


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_schedule_is_three_all_reduces_a_reduction(run, shape):
    """Per step: the reference's expected counts on the default rungs
    (an empty shard joins them), lo/hi as reduce-scatter + all-gather
    under reduce_scatter_icrt; never a collective-permute."""
    p = R.params()
    for res in run(shape):
        for (config, logq), m in res["mul"].items():
            counts = m["schedule"]["counts"]
            n_red = m["expected"]["all-reduce"] // 3
            if config == "reduce_scatter_icrt":
                assert counts == {"reduce-scatter": 2 * n_red,
                                  "all-gather": 2 * n_red,
                                  "all-reduce": n_red}
            else:
                assert counts == m["expected"]
            assert m["schedule"]["group_axes"] == ["model"]
    if shape == (1, 4):
        shards = [r["mul"][("default", p.logQ)]["shard"] for r in run(shape)]
        assert shards[3][0] == 0 and shards[0][0] > 0


@pytest.mark.parametrize("op", ENGINE_OPS)
@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_engine_step_on_the_grid_equals_one_rank(run, shape, op):
    for res in run(shape):
        got = res["engine"][op]
        assert got["bitwise"], res["rank"]
        if op in ("mul", "rotate", "conjugate", "slot_sum", "mul_plain"):
            assert got["collectives"].get("all-reduce", 0) > 0
        else:       # the limb steps run on the rank's rows, no collective
            assert got["collectives"] == {}


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_ranks_hold_the_same_keys_and_their_own_rows(run, shape):
    """Keys made from one seed on every rank are the same words; each
    rank's TableCache holds its rows of them, and ranks of one model
    index (across the data axis) hold the same rows."""
    ranks = run(shape)
    for res in ranks:
        assert res["keys"]["rows_of_whole"]
        st = res["keys"]["stats"]
        assert st["grid"] == _ids(shape)
    by_model = {}
    for res in ranks:
        by_model.setdefault(res["rank"] % shape[1], set()).add(
            res["keys"]["digest"])
    assert all(len(v) == 1 for v in by_model.values())
    if shape[1] > 1:
        assert len({next(iter(v)) for v in by_model.values()}) == shape[1]
    # the batch reached the data ranks by broadcast, booked as feed
    if shape[0] > 1:
        assert ranks[0]["feed"].get("broadcast", 0) > 0


@pytest.mark.parametrize("g", [2, 4])
def test_grid_cache_keeps_each_regions_icrt_rows_at_one_np(g):
    """Region 1 at logQ and region 2 at a level below one prime's width
    both have np = 9 at test_params(logN=5), but the two regions split
    their primes at different widths (c = ⌈9/g⌉ and ⌈13/g⌉). A grid
    TableCache that has served the first must still give the second its
    own rows: every prime-row table == the one-rank table's rows, the
    iCRT rows == build_icrt_tables' rows."""
    from repro_torch.core.context import build_icrt_tables
    from repro_torch.dist.he_pipeline import PRIME_ROW_KEYS
    from repro_torch.dist.sharding import he_eval_sharding
    from repro_torch.hserve.tables import TableCache
    from repro_torch.launch.mesh import HostGrid
    p = R.params()
    low = next(lq for lq in range(1, p.logQ)
               if p.np_region2(lq) == p.np_region1(p.logQ))
    npn = p.np_region1(p.logQ)
    one = TableCache(p, device="cpu")
    for r in range(g):
        grid = HostGrid(1, g, r, torch.device("cpu"), "gloo")
        cache = TableCache(p, device="cpu", grid=grid)
        for logq, region in ((p.logQ, 1), (low, 2)):
            got = cache.level_tables(logq)[region - 1]
            want = one.level_tables(logq)[region - 1]
            rows = he_eval_sharding(grid, p.np_region2(p.logQ)
                                    if region == 2 else npn, npn)
            tabs = build_icrt_tables(p, npn)
            for k in ("inv_P", "inv_P_shoup", "pdivp"):
                ref = getattr(tabs, k)[rows]
                assert np.array_equal(
                    got[k].numpy().view(ref.dtype), ref), (r, region, k)
            for k in PRIME_ROW_KEYS:
                assert torch.equal(got[k], want[k][rows]), (r, region, k)
