"""The port's compressed data-parallel gradients against the JAX package's,
on CPU grids over gloo.

``compressed_psum_grads`` on a (2, 1) grid of spawned ranks equals the
reference's on a (2,) data mesh of two forced host devices bit for bit
when both are fed the noise JAX's keys draw (a mean of two is exact in
any order); a ``compress_dp`` Trainer on a (2, 1) grid keeps its replicas
bit-identical over 3 steps, its gradients within 3·max|g|/127 of the
exact mean (tests/test_dist.py's limit); at data size 1 the port's
``compress_dp`` Trainer's first step equals the reference's one-device
one, fed the same noise: the loss and parameters within 1e-6, the
moments (the compressed gradient, clipped and scaled) within 1e-5 of each
leaf's largest value — the tolerance of the gradients themselves — but
for the rare value that those last bits carry across a rounding
boundary, which lands one quantization level away.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
import repro.launch.train as RT

import torch_grid_ranks as R
import repro_torch.configs.registry as TR
from repro_torch import convert
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import spawn_grid

SHAPES = {"a": (4, 333), "b": (300,), "c": (8,)}


def test_compressed_psum_grads_equals_the_reference_on_two_ranks(
        run_in_8dev_subprocess):
    want = run_in_8dev_subprocess(f"""
        from jax.experimental.shard_map import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.dist.collectives import compressed_psum_grads

        shapes = {SHAPES!r}
        rng = np.random.default_rng(0)
        g = {{k: jnp.asarray(rng.normal(size=(2,) + s).astype(np.float32))
             for k, s in shapes.items()}}
        mesh = jax.make_mesh((2,), ("data",), devices=jax.devices()[:2])

        def local(g, key):
            out = compressed_psum_grads({{k: v[0] for k, v in g.items()}},
                                        ("data",), key[0])
            return {{k: v[None] for k, v in out.items()}}

        fn = shard_map(local, mesh=mesh, in_specs=(P("data"), P()),
                       out_specs=P("data"), check_rep=False)
        keys = jax.random.split(jax.random.key(0), 1)
        out = {{k: np.asarray(v) for k, v in fn(g, keys).items()}}
        ks = jax.random.split(keys[0], len(shapes))
        noise = [jax.random.uniform(ks[i], (-(-int(np.prod(s)) // 256), 256),
                                    jnp.float32, -0.5, 0.5)
                 for i, s in enumerate(shapes.values())]
        bits = lambda a: np.asarray(a).view(np.uint32).ravel().tolist()
        print(json.dumps({{"out": {{k: [bits(v[0]), bits(v[1])]
                                  for k, v in out.items()}},
                          "noise": [bits(n) for n in noise]}}))
    """)
    rng = np.random.default_rng(0)
    g = {k: rng.normal(size=(2,) + s).astype(np.float32)
         for k, s in SHAPES.items()}
    noise = [np.asarray(n, np.uint32).view(np.float32).reshape(-1, 256)
             for n in want["noise"]]
    ranks = spawn_grid(R.compressed_psum_rank, model=1, data=2,
                       device="cpu", timeout_s=120,
                       args=([{k: v[r] for k, v in g.items()}
                              for r in range(2)], noise))
    for r, res in enumerate(ranks):
        for k in SHAPES:
            np.testing.assert_array_equal(
                res["out"][k].view(np.uint32).ravel(),
                np.asarray(want["out"][k][r], np.uint32), err_msg=(r, k))
        # the only wire traffic: each leaf's payload and scales gathered
        assert res["log"]["counts"] == {"all-gather": 2 * len(SHAPES)}
        nb = sum(-(-int(np.prod(s)) // 256) for s in SHAPES.values())
        assert res["log"]["payload_bytes"] == 2 * nb * (256 + 4)


@pytest.fixture(scope="module")
def dp_ranks():
    return spawn_grid(R.compress_dp_rank, model=1, data=2, device="cpu",
                      timeout_s=120, args=(3,))


def test_compress_dp_replicas_stay_bit_identical(dp_ranks):
    a, b = dp_ranks
    assert a["losses"] == b["losses"] and len(a["losses"]) == 3
    assert set(a["params"]) == set(b["params"])
    for k, v in a["params"].items():
        assert v.tobytes() == b["params"][k].tobytes(), k
    # per step: one gather of the payload and one of the scales a leaf,
    # one all-reduce of the loss
    n_leaves = len(a["params"])
    assert a["log"]["counts"] == {"all-gather": 3 * 2 * n_leaves,
                                  "all-reduce": 3}


def test_compress_dp_gradients_are_close_to_the_exact_mean(dp_ranks):
    for res in dp_ranks:
        # 3 quantization steps of the largest gradient (test_dist.py's)
        assert res["err"] <= 3 * res["g_max"] / 127.0, res["err"]
        assert res["err"] > 0


def within_a_level(got, want, what):
    """`got` within 1e-5 of the leaf's largest value (the gradients' own
    tolerance against JAX's backward), but where that backward's last
    bits moved a value across a rounding boundary: there one
    quantization level apart (≤ max/127 of a moment μ ∝ g, ≤ 2.02·max/127
    of ν ∝ g²), at under 0.1 % of the elements."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    scale = float(np.abs(want).max()) or 1.0
    flips = d > 1e-5 * scale
    assert flips.mean() <= 1e-3, (what, int(flips.sum()))
    assert not flips.any() or d[flips].max() <= 2.02 / 127 * scale, what


def test_compress_dp_at_data_size_1_matches_the_reference(monkeypatch):
    kw = R.TRAIN_KW
    tc = dict(batch=2, seq_len=16, steps=8, warmup_steps=2)
    ref = RT.Trainer(RR.get_arch("llama3.2-1b").reduced(**kw),
                     RT.TrainConfig(**tc), compress_dp=True)
    cfg = TR.get_arch("llama3.2-1b").reduced(**kw)
    port = TT.Trainer(cfg, TT.TrainConfig(**tc), compress_dp=True,
                      device="cpu")
    assert port.grid.shape == (1, 1)
    np_params = jax.tree.map(np.asarray, ref.params)
    port.params.load_state_dict(convert.lm_params_from_numpy(
        np_params, cfg, "cpu").state_dict())
    port.opt = convert.opt_state_from_numpy(
        jax.tree.map(np.asarray, ref.opt), cfg, "cpu")
    # the noise the reference's step-0 key draws for each leaf
    leaves = jax.tree.leaves(ref.params)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(0), 0),
                            len(leaves))
    noise = [torch.from_numpy(np.array(jax.random.uniform(
        keys[i], (-(-leaf.size // 256), 256), jnp.float32, -0.5, 0.5)))
        for i, leaf in enumerate(leaves)]
    real = TT.compressed_psum_grads

    def fed(grads, grid, seed, axis="data"):
        assert [tuple(g.shape) for g in grads.values()] == \
            [leaf.shape for leaf in leaves]
        return real(grads, grid, seed, axis, noise=noise)

    monkeypatch.setattr(TT, "compressed_psum_grads", fed)
    want = ref.run(1)["history"][0]["loss"]
    got = port.run(1)["history"][0]["loss"]
    assert abs(got - want) <= 1e-6
    opt = convert.opt_state_to_numpy(port.opt, cfg)
    for field in ("mu", "nu"):
        mine = convert.lm_untree(opt[field], cfg)
        for name, w in convert.lm_untree(jax.tree.map(
                np.asarray, getattr(ref.opt, field)), cfg).items():
            within_a_level(mine[name], w, (field, name))
    for name, w in convert.lm_untree(jax.tree.map(np.asarray, ref.params),
                                     cfg).items():
        np.testing.assert_allclose(
            dict(port.params.named_parameters())[name].detach().numpy(), w,
            rtol=1e-6, atol=1e-6, err_msg=name)
