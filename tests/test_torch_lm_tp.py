"""repro_torch's LM served tensor-parallel across model ranks, on the CPU.

Each grid — (1,2), (1,4) and (2,2), gloo on the CPU — is spawned once for
the module (``launch.mesh.spawn_grid``); every rank runs
``torch_grid_ranks.lm_rank``: a model built from seed 0 and sharded
(``dist.sharding.shard_lm``), or the JAX package's parameters loaded as the
rank's shard (``load_lm_shard``), through ``generate(grid=)`` and then
prefill + 6 decode steps along its tokens. Here each is held against one
rank on the same weights: f32 logits within 1e-4 and the tokens equal.
The cases: every arch's ``reduced()`` (one KV head, so attention runs
gathered, except whisper's), llama/qwen/kimi at ``n_kv_heads=2`` (the
Megatron attention), and the stacked and grouped layouts of the full
configs at reduced widths (``scan_layers=True``: the split norm scales and
SSM/RG-LRU leaves). Also what each rank holds, the decode step's
collectives, where the caches sit against ``cache_sharding_rules``, and the
JAX package's ``generate`` fed the port's tokens.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
import repro.models as RM

import repro_torch.configs.registry as TR
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import GridShape, spawn_grid
from repro_torch.models import init_params
from repro_torch.models.layers import TensorParallel

import torch_grid_ranks as R

TOL = dict(rtol=1e-4, atol=1e-4)
KV2 = (("n_kv_heads", 2),)
STACKED = (("scan_layers", True),)
TWO = ([(a, ()) for a in TR.ARCHS]
       + [(a, KV2) for a in ("llama3.2-1b", "qwen2.5-32b",
                             "kimi-k2-1t-a32b")]
       + [("llama3.2-1b", KV2 + STACKED), ("recurrentgemma-2b", STACKED),
          ("falcon-mamba-7b", STACKED)])
FOUR = [("llama3.2-1b", (("n_kv_heads", 4),)), ("whisper-base", ())]
DATA = [("llama3.2-1b", KV2)]
LOADED = [("llama3.2-1b", KV2), ("recurrentgemma-2b", ())]
SHAPE_CASES = {(1, 2): TWO, (1, 4): FOUR, (2, 2): DATA}
BATCH = {(1, 2): 2, (1, 4): 2, (2, 2): 4}
_RUNS: dict = {}


def ids(case) -> str:
    arch, kw = case
    return arch + "".join(f"-{k}={v}" for k, v in kw)


@functools.lru_cache(maxsize=None)
def jax_params(case):
    """The JAX package's init of `case`'s config (numpy leaves)."""
    arch, kw = case
    P = RM.init_params(RR.get_arch(arch).reduced(**dict(kw)),
                       jax.random.key(1))
    return jax.tree.map(np.asarray, P)


@pytest.fixture
def run():
    """shape -> every rank's results (each grid spawned once a module)."""
    def get(shape):
        if shape not in _RUNS:
            jobs = [("seed", c, BATCH[shape]) for c in SHAPE_CASES[shape]]
            if shape == (1, 2):
                jobs += [("load", c, jax_params(c)) for c in LOADED]
            _RUNS[shape] = spawn_grid(R.lm_rank, data=shape[0],
                                      model=shape[1], device="cpu",
                                      args=(jobs,), timeout_s=240)
        return _RUNS[shape]
    return get


@functools.lru_cache(maxsize=None)
def one_rank(case, batch: int):
    """The one-device run of `case` on the weights every rank draws."""
    cfg = R.lm_config(case)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    res = R.lm_run(model, cfg, R.lm_inputs(cfg, batch))
    res["held"] = {n: (tuple(p.shape), p.element_size(), None)
                   for n, p in model.named_parameters()}
    return res


def check_against_one_rank(ranks, shape, index, case):
    want = one_rank(case, BATCH[shape])
    n = BATCH[shape] // shape[0]
    for r, got in enumerate(ranks):
        res = got[index]
        np.testing.assert_array_equal(res["tokens"], want["tokens"])
        rows = slice((r // shape[1]) * n, (r // shape[1] + 1) * n)
        assert len(res["logits"]) == R.LM_GEN
        for i, (a, b) in enumerate(zip(res["logits"], want["logits"])):
            np.testing.assert_allclose(a, b[rows], err_msg=f"rank {r} "
                                       f"step {i}", **TOL)


@pytest.mark.parametrize("case", TWO, ids=ids)
def test_two_model_ranks_equal_one_rank(run, case):
    check_against_one_rank(run((1, 2)), (1, 2), TWO.index(case), case)


@pytest.mark.parametrize("case", FOUR, ids=ids)
def test_four_model_ranks_equal_one_rank(run, case):
    check_against_one_rank(run((1, 4)), (1, 4), FOUR.index(case), case)


def test_a_2x2_grid_splits_the_batch_over_data(run):
    """batch_spec: each data rank runs its 2 of the 4 rows on its model
    pair, and every rank ends with all 4 rows' tokens."""
    ranks = run((2, 2))
    check_against_one_rank(ranks, (2, 2), 0, DATA[0])
    for r in ranks:
        assert r[0]["logits"][0].shape[0] == 2


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_only_its_shard(run, shape):
    """Summed over the model ranks, the held bytes are the whole model's
    with each whole (replicated) leaf counted R times; each split leaf is
    its whole shape cut by R along its marked dim."""
    ranks, size = run(shape), shape[1]
    for i, case in enumerate(SHAPE_CASES[shape]):
        whole = one_rank(case, BATCH[shape])["held"]
        total = sum(np.prod(s) * e for r in ranks
                    for s, e, _ in r[i]["held"].values())
        want = 0
        for name, (full, elem, _) in whole.items():
            held, _, dim = ranks[0][i]["held"][name]
            cut = list(full)
            if dim is not None:
                cut[dim] //= size
            assert held == tuple(cut), (case, name)
            want += np.prod(full) * elem * (1 if dim is not None else size)
        assert total == want, case
        split = sum(np.prod(full) * e for n, (full, e, _) in whole.items()
                    if ranks[0][i]["held"][n][2] is not None)
        assert split > 0.8 * sum(np.prod(f) * e for f, e, _ in
                                 whole.values()), case


def test_the_decode_step_issues_the_predicted_collectives(run):
    """llama at n_kv_heads=2 on two model ranks: a layer's attention and
    MLP each sum their rows once (all-reduce of (B, 1, D) f32), the
    embedding sums its vocab rows once, the logits are gathered once
    ((B, 1, V) f32); in the stacked layout each split norm scale is
    gathered where it is used (2 a layer; ln_f is whole)."""
    B = BATCH[(1, 2)]
    for case, norms in ((("llama3.2-1b", KV2), 0),
                        (("llama3.2-1b", KV2 + STACKED), 2)):
        cfg = R.lm_config(case)
        L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
        step = run((1, 2))[0][TWO.index(case)]["step"]
        assert step["counts"] == {"all-reduce": 2 * L + 1,
                                  "all-gather": 1 + norms * L}, case
        ring = (2 - 1) / 2
        want = (2 * (2 * L + 1) * B * D * 4 * ring
                + (B * V * 4 + norms * L * D * 4) * ring)
        assert step["total_bytes"] == pytest.approx(want), case
        assert step["group_axes"] == ["model"]


# where the port keeps a cache against cache_sharding_rules' placement, on
# the (1,2) cases: (case, cache leaf kind, rule's spec, the port's)
_CACHE_DIFFERS = {
    # one KV head: attention runs gathered, its cache whole on each rank
    **{(a, "k"): ("data", None, None, "model") for a in
       ("llama3.2-1b", "h2o-danube-1.8b", "phi4-mini-3.8b", "qwen2.5-32b",
        "kimi-k2-1t-a32b", "arctic-480b", "recurrentgemma-2b",
        "llava-next-mistral-7b")},
    # recurrent states run gathered too
    ("recurrentgemma-2b", "hr"): ("data", "model"),
    ("recurrentgemma-2b", "conv_tail"): ("data", None, "model"),
    ("falcon-mamba-7b", "h"): ("data", "model", None),
    ("falcon-mamba-7b", "conv_tail"): ("data", None, "model"),
}


def test_caches_sit_where_the_rules_say_but_in_gathered_blocks(run):
    ranks = run((1, 2))
    found = {}
    for i, case in enumerate(TWO):
        if case[1]:
            continue
        whole = one_rank(case, BATCH[(1, 2)])["cache_shapes"]
        mine = ranks[0][i]["cache_shapes"]
        tree = {}
        for name, shape in whole.items():
            head, layer, leaf = name.split(".")
            tree.setdefault(head, {}).setdefault(int(layer), {})[leaf] = \
                torch.empty(shape, device="meta")
        rules = S.cache_sharding_rules(
            {h: [v[k] for k in sorted(v)] for h, v in tree.items()},
            GridShape(1, 2))
        for name, shape in whole.items():
            head, layer, leaf = name.split(".")
            spec = rules[head][int(layer)][leaf]
            split = tuple(d for d in range(len(shape))
                          if mine[name][d] != shape[d])
            placed = tuple("model" if d in split else None
                           for d in range(len(shape)))
            rule_model = tuple(s if s == "model" else None for s in spec)
            if placed != rule_model:
                assert placed == (None,) * len(shape), name
                found[(case[0], leaf)] = spec
    pinned = dict(_CACHE_DIFFERS)
    for (arch, leaf), spec in list(pinned.items()):
        if leaf == "k":
            pinned[(arch, "v")] = spec
    assert found == pinned


def test_full_configs_gather_attention_only_where_heads_do_not_divide():
    """At full size the heads divide over 2 and 4 ranks in every arch but
    recurrentgemma-2b (one KV head), whose attention runs gathered, as do
    its RG-LRU blocks and falcon-mamba's SSM blocks."""
    gathered = set()
    for arch in TR.ARCHS:
        cfg = TR.get_arch(arch)
        for size in (2, 4):
            tp = TensorParallel(SimpleNamespace(model=size, model_rank=0),
                                "decode")
            for kind in set(cfg.layer_kinds):
                if kind in ("ssm", "rglru") or (
                        kind == "attn" and tp.local_heads(cfg) is None):
                    gathered.add((arch, kind, size))
    assert gathered == {(a, k, s) for s in (2, 4) for a, k in (
        ("recurrentgemma-2b", "attn"), ("recurrentgemma-2b", "rglru"),
        ("falcon-mamba-7b", "ssm"))}


# ---- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("case", LOADED, ids=ids)
def test_sharded_generate_equals_the_jax_package(run, case):
    """The JAX package's weights loaded as each rank's shard: the
    reference's decode_step fed the ranks' tokens gives every rank's
    logits within 1e-4, with the tokens equal wherever its top-2 gap
    exceeds 1e-3 (the criterion tests/test_torch_lm_serve.py holds the
    one-device port to)."""
    index = len(TWO) + LOADED.index(case)
    arch, kw = case
    rcfg = RR.get_arch(arch).reduced(**dict(kw))
    P = jax.tree.map(jnp.asarray, jax_params(case))
    batch = R.lm_inputs(R.lm_config(case), 2, seed=3)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    max_len = R.LM_PROMPT + R.LM_GEN + 4
    want, jcache = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, max_len))(
        P, jb)
    step = jax.jit(lambda p, c, tok, t: RM.decode_step(p, c, tok, t, rcfg))
    ranks = [got[index] for got in run((1, 2))]
    toks = ranks[0]["tokens"]
    wants = [np.asarray(want)]
    for i in range(R.LM_GEN - 1):
        w, jcache = step(P, jcache, jnp.asarray(toks[:, i: i + 1]),
                         R.LM_PROMPT + i)
        wants.append(np.asarray(w))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["tokens"], toks)
        for i, (m, w) in enumerate(zip(res["logits"], wants)):
            np.testing.assert_allclose(m, w, err_msg=f"rank {r} step {i}",
                                       **TOL)
    for i, w in enumerate(wants):
        top2 = np.sort(w[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(toks[:, i][clear],
                                      w[:, -1].argmax(-1)[clear])
