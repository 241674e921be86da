"""repro_torch's LM placement rules against the JAX package's, on the CPU.

``dist.sharding``'s ``batch_spec``, ``param_sharding_rules`` (FSDP on and
off), ``cache_sharding_rules`` and ``zero1_opt_sharding`` are held leaf for
leaf against the reference's ``NamedSharding.spec`` for every arch's
``reduced()`` and full config on (1,2), (2,2) and (2,4) grids. The port
reads meta tensors (``init_params(cfg, device="meta")``, ``init_cache(...,
device="meta")``) in the reference's layout (``convert.lm_tree``,
``convert.lm_cache_tree``) over a ``GridShape``; the reference's specs come
from ``jax.eval_shape`` trees on Auto meshes of 8 forced host devices, all
in one subprocess. Also the reference's unit tests of the rules, the meta
init's shapes, and ``lm_param_specs``' per-layer specs of llama3.2-1b.
"""

import functools
import textwrap

import pytest
import torch

import repro_torch.configs.registry as TR
from repro_torch import convert
from repro_torch.dist import sharding as S
from repro_torch.launch.mesh import GridShape
from repro_torch.models import init_cache, init_params

GRIDS = [(1, 2), (2, 2), (2, 4)]
SIZES = ["reduced", "full"]
BATCH, MAX_LEN, ENC_LEN = 4, 168, 256

_REFERENCE = """
    from jax.sharding import AxisType, NamedSharding
    from repro.configs.registry import ARCHS, get_arch
    from repro.dist.sharding import (
        batch_spec, cache_sharding_rules, param_sharding_rules,
        zero1_opt_sharding,
    )
    from repro.models import init_cache, init_params

    def names(path):
        out = []
        for k in path:
            for a in ("key", "name", "idx"):
                if hasattr(k, a):
                    out.append(str(getattr(k, a)))
                    break
            else:
                out.append(str(k))
        return "/".join(out)

    def specs(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        return {names(p): [list(e) if isinstance(e, tuple) else e
                           for e in s.spec] for p, s in leaves}

    def mesh(shape):
        return jax.make_mesh(shape, ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    out = {}
    for shape in GRIDS:
        out[f"batch/{shape[0]}x{shape[1]}"] = list(
            batch_spec(mesh(shape)).spec)
    for arch in ARCHS:
        for size in ("reduced", "full"):
            cfg = get_arch(arch)
            cfg = cfg.reduced() if size == "reduced" else cfg
            params = jax.eval_shape(lambda k: init_params(cfg, k),
                                    jax.random.key(0))
            cache = jax.eval_shape(
                lambda: init_cache(cfg, BATCH, MAX_LEN, enc_len=ENC_LEN))
            for shape in GRIDS:
                m = mesh(shape)
                rec = {"cache": specs(cache_sharding_rules(cache, m))}
                for fsdp in (True, False):
                    p_sh = param_sharding_rules(params, m, fsdp_params=fsdp)
                    rec[f"params/{fsdp}"] = specs(p_sh)
                    rec[f"zero1/{fsdp}"] = specs(
                        zero1_opt_sharding(p_sh, params, m))
                out[f"{arch}/{size}/{shape[0]}x{shape[1]}"] = rec
    print(json.dumps(out))
"""


_SPECS: dict = {}


@pytest.fixture
def reference(run_in_8dev_subprocess):
    """{case: the reference's specs} of every arch, size and grid (one
    subprocess a module)."""
    if not _SPECS:
        head = (f"GRIDS = {GRIDS!r}\nBATCH, MAX_LEN, ENC_LEN = {BATCH}, "
                f"{MAX_LEN}, {ENC_LEN}\n")
        _SPECS.update(run_in_8dev_subprocess(
            head + textwrap.dedent(_REFERENCE), timeout=600))
    return _SPECS


def flat(tree, path=()) -> dict:
    """{"a/b/0/c": leaf} of nested dicts and lists (spec tuples are
    leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def as_json(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@functools.lru_cache(maxsize=None)
def config(arch, size):
    cfg = TR.get_arch(arch)
    return cfg.reduced() if size == "reduced" else cfg


@functools.lru_cache(maxsize=None)
def meta_trees(arch, size):
    """(parameter tree, cache tree) of meta tensors in the reference's
    layout."""
    cfg = config(arch, size)
    model = init_params(cfg, device="meta")
    params = convert.lm_tree(dict(model.named_parameters()), cfg)
    cache = init_cache(cfg, BATCH, MAX_LEN, enc_len=ENC_LEN, device="meta")
    return params, convert.lm_cache_tree(cache, cfg)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", TR.ARCHS)
def test_rules_equal_the_reference_leaf_for_leaf(reference, arch, size,
                                                 grid):
    want = reference[f"{arch}/{size}/{grid[0]}x{grid[1]}"]
    params, cache = meta_trees(arch, size)
    g = GridShape(data=grid[0], model=grid[1])
    got = {"cache": S.cache_sharding_rules(cache, g)}
    for fsdp in (True, False):
        p_specs = S.param_sharding_rules(params, g, fsdp_params=fsdp)
        got[f"params/{fsdp}"] = p_specs
        got[f"zero1/{fsdp}"] = S.zero1_opt_sharding(p_specs, params, g)
    assert set(got) == set(want)
    for key, tree in got.items():
        mine = {k: as_json(v) for k, v in flat(tree).items()}
        assert mine == want[key], key


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_batch_spec_equals_the_reference(reference, grid):
    g = GridShape(data=grid[0], model=grid[1])
    assert as_json(S.batch_spec(g)) == reference[f"batch/{grid[0]}x"
                                                 f"{grid[1]}"]
    assert S.batch_spec(g) == ("data",)


@pytest.mark.parametrize("arch", TR.ARCHS)
def test_meta_init_has_the_shapes_of_a_real_one(arch):
    cfg = TR.get_arch(arch).reduced()
    real = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meta = init_params(cfg, device="meta")
    got = {n: (tuple(p.shape), p.dtype, p.device.type)
           for n, p in meta.named_parameters()}
    assert got == {n: (tuple(p.shape), p.dtype, "meta")
                   for n, p in real.named_parameters()}
    with pytest.raises(ValueError, match="draws nothing"):
        init_params(cfg, torch.Generator(), device="meta")


def test_layer_specs_of_llama_drop_the_layer_dim():
    """lm_param_specs at the full llama3.2-1b on two model ranks: each
    layer takes its stacked leaf's spec without the layer dim."""
    cfg = TR.get_arch("llama3.2-1b")
    model = init_params(cfg, device="meta")
    specs = S.lm_param_specs(model, cfg, GridShape(model=2))
    assert set(specs) == {n for n, _ in model.named_parameters()}
    want = {"attn.wq.w": (None, "model"), "attn.wk.w": (None, "model"),
            "attn.wv.w": (None, "model"), "attn.wo.w": ("model", None),
            "mlp.wi.w": (None, "model"), "mlp.wg.w": (None, "model"),
            "mlp.wo.w": ("model", None), "ln1.scale": ("model",),
            "ln2.scale": ("model",)}
    for i in range(cfg.n_layers):
        for leaf, spec in want.items():
            assert specs[f"layers.{i}.{leaf}"] == spec, (i, leaf)
    assert specs["tok_embed"] == ("model", None)
    assert specs["lm_head.w"] == (None, "model")
    assert specs["ln_f.scale"] == (None,)


# ---- the reference's unit tests of the rules (tests/test_dist_units.py) ----

def test_param_rules_orientation():
    cfg = TR.get_arch("llama3.2-1b").reduced(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=512)
    params = convert.lm_tree(dict(init_params(cfg, device="meta")
                                  .named_parameters()), cfg)
    sh = flat(S.param_sharding_rules(params, GridShape(1, 1)))
    # column-parallel: output dim on model; row-parallel: input dim
    wq = next(v for k, v in sh.items() if k.endswith("attn/wq/w"))
    wo = next(v for k, v in sh.items() if k.endswith("attn/wo/w"))
    assert wq[-1] == "model" and wq[0] == "data"
    assert wo[0] == "model"
    assert sh["tok_embed"][0] == "model"
    # norms replicate
    ln = next(v for k, v in sh.items() if k.endswith("ln_f/scale"))
    assert all(a is None for a in ln)


def test_model_dim_orientation_helper():
    """Name-tagged orientation: column-parallel shards the output dim,
    row-parallel the input dim, embeddings the vocab dim; unknown ≥2-d
    leaves fall back to their largest dim; vectors are never sharded."""
    md = S._model_dim
    assert md(["layers", "attn", "wq", "w"], (64, 64)) == 1
    assert md(["layers", "attn", "wo", "w"], (64, 64)) == 0
    assert md(["tok_embed"], (512, 64)) == 0
    assert md(["moe", "wi"], (8, 64, 128)) == 2    # expert stacks
    assert md(["moe", "wo"], (8, 128, 64)) == 1
    assert md(["ssm", "A_log"], (128, 16)) == 0    # largest-dim
    assert md(["ln_f", "scale"], (64,)) is None
    # the last tagged name decides; the largest dim's tie goes first
    assert md(["wo", "router", "w"], (6, 8)) == 1
    assert md(["conv_w"], (8, 8)) == 0
    assert S._COL_PARALLEL & S._ROW_PARALLEL == frozenset()
    assert S._EMBED == frozenset({"tok_embed"})


def test_cache_rules_batch_dim_offset():
    cache = {
        "stacked": {"k": torch.empty((2, 8, 16, 4, 32), device="meta")},
        "list": [{"k": torch.empty((8, 16, 4, 32), device="meta")}],
    }
    sh = S.cache_sharding_rules(cache, GridShape(1, 1))
    assert sh["stacked"]["k"][1] in ("data", None)
    assert sh["stacked"]["k"][0] is None              # layer axis local
    assert sh["list"][0]["k"][0] in ("data", None)
    # a batch of one is never put on "data"; a batch dim of size > 1 is,
    # even on a data axis of one (the reference's quirk, kept)
    one = S.cache_sharding_rules(
        {"list": [{"k": torch.empty((1, 16, 4, 32))}]}, GridShape(1, 2))
    assert one["list"][0]["k"] == (None, None, "model", None)
    assert S.cache_sharding_rules(cache, GridShape(1, 2))["list"][0]["k"] \
        == ("data", None, "model", None)


def test_zero1_adds_data_axis():
    g = GridShape(1, 1)
    params = {"w": torch.ones((4, 6))}
    p_sh = S.param_sharding_rules(params, g, fsdp_params=False)
    assert "data" not in p_sh["w"]                 # params: model only
    m_sh = S.zero1_opt_sharding(p_sh, params, g)
    assert set(m_sh) == set(p_sh)
    assert "data" in m_sh["w"]                     # moments gained DP
    assert "model" in m_sh["w"]                    # and kept the model
    # a spec shorter than its leaf is padded, a multi-axis entry counts
    m2 = S.zero1_opt_sharding({"w": (("data", "model"),)},
                              {"w": torch.ones((4, 6))}, GridShape(2, 2))
    assert m2["w"] == (("data", "model"), None)


def test_a_grid_is_anything_with_axis_sizes():
    """A HostGrid and a GridShape of one shape place alike."""
    from repro_torch.launch.mesh import single_grid
    params, cache = meta_trees("llama3.2-1b", "reduced")
    host = single_grid("cpu")
    assert S.param_sharding_rules(params, host) == \
        S.param_sharding_rules(params, GridShape(1, 1))
    assert S.cache_sharding_rules(cache, host) == \
        S.cache_sharding_rules(cache, GridShape(1, 1))
    assert (GridShape(2, 4).axis_size("data"),
            GridShape(2, 4).axis_size("model")) == (2, 4)
