"""repro_torch's LM modules against the JAX package's, on the CPU.

Each module of ``repro_torch.models`` is held against its ``repro.models``
function on the same numpy-seeded inputs and the same weights (the JAX
package's init, carried over as numpy arrays), in f32 within rtol/atol
1e-4 unless a test says otherwise. Also here: the port's init (names,
shapes, dtypes, scales), the configs field for field, the converter's
layouts and round trip, and one bf16 case.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs as RC
import repro.configs.registry as RR
import repro.data as RD
import repro.models as RM
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import mlp as RMLP
from repro.models import moe as RMOE
from repro.models import rglru as RG
from repro.models import ssm as RS

import repro_torch.configs as TC
import repro_torch.configs.registry as TR
import repro_torch.data as TD
import repro_torch.models as TM
from repro_torch import convert
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import mlp as TMLP
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TG
from repro_torch.models import ssm as TS

TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def load(module: torch.nn.Module, tree) -> torch.nn.Module:
    """`module` holding the JAX parameter dict `tree` (same names)."""
    flat = convert._flatten(np_tree(tree))
    own = module.state_dict()
    assert set(flat) == set(own)
    with torch.no_grad():
        for name, v in own.items():
            assert tuple(flat[name].shape) == tuple(v.shape), name
            v.copy_(t(flat[name]))
    return module


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def cfgs(arch, **kw):
    """(reference config, port config) of `arch`'s reduced() size."""
    return (RR.get_arch(arch).reduced(**kw), TR.get_arch(arch).reduced(**kw))


def randn(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ---- layers -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_the_reference(kind):
    rng = np.random.default_rng(1)
    x = randn(rng, 2, 5, 48) * 3 + 1
    p = {"scale": randn(rng, 48)}
    if kind == "layernorm":
        p["bias"] = randn(rng, 48)
    port = TL.Norm(t(p["scale"]), t(p["bias"]) if "bias" in p else None)
    want = RL.norm_apply(kind, jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    close(TL.norm_apply(kind, port, t(x)), want)


def test_rope_and_sinusoids_match_the_reference():
    rng = np.random.default_rng(2)
    x = randn(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, size=(2, 7))
    close(TL.rope(t(x), t(pos), 500000.0),
          RL.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    close(TL.sinusoidal_positions(40, 32, torch.float32, device=CPU),
          RL.sinusoidal_positions(40, 32, jnp.float32))
    for pos in (0, 3, 1234):
        close(TL.sinusoidal_position_at(pos, 32, torch.float32, device=CPU),
              RL.sinusoidal_position_at(jnp.asarray(pos), 32, jnp.float32))


# ---- attention --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(Lq=64, Lk=64, causal=True, window=0),
    # several blocks each way, blocks wholly outside the window
    dict(Lq=64, Lk=64, causal=True, window=8, block_q=16, block_k=16),
    # bidirectional (encoder / cross)
    dict(Lq=24, Lk=40, causal=False, window=0),
    # a Lq (and Lk) that the block does not divide: the block shrinks to 24
    dict(Lq=48, Lk=48, causal=True, window=0, block_q=32, block_k=32),
    dict(Lq=16, Lk=48, causal=True, window=0, q_offset=32, block_k=16),
], ids=["causal", "windowed", "bidirectional", "smaller_block", "q_offset"])
def test_flash_attention_matches_the_reference(case):
    case = dict(case)
    Lq, Lk = case.pop("Lq"), case.pop("Lk")
    rng = np.random.default_rng(3)
    q, k, v = (randn(rng, 2, Lq, 8, 16), randn(rng, 2, Lk, 2, 16),
               randn(rng, 2, Lk, 2, 16))
    close(TA.flash_attention(t(q), t(k), t(v), **case),
          RA.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             **case))


@pytest.mark.parametrize("window,S,ts", [
    (0, 12, (0, 5, 11, 12, 15)),      # linear; t ≥ S keeps the last slot
    (8, 8, (3, 7, 8, 13, 20)),        # a ring past its window
], ids=["linear", "ring"])
def test_decode_attention_matches_the_reference(window, S, ts):
    rcfg, tcfg = cfgs("llama3.2-1b")
    p = RA.init_attn(jax.random.key(4), rcfg)
    port = load(TA.init_attn(gen(), tcfg), p)
    rng = np.random.default_rng(4)
    shp = (2, S, rcfg.n_kv_heads, rcfg.hd)
    ck, cv = randn(rng, *shp), randn(rng, *shp)
    jk, jv, pk, pv = jnp.asarray(ck), jnp.asarray(cv), t(ck), t(cv)
    for step in ts:
        x = randn(rng, 2, 1, rcfg.d_model)
        want, jk, jv = RA.decode_attention(p, jnp.asarray(x), jk, jv, step,
                                           rcfg, window=window)
        got, pk, pv = TA.decode_attention(port, t(x), pk, pv, step, tcfg,
                                          window=window)
        close(got, want)
        close(pk, jk)
        close(pv, jv)


def test_kv_to_ring_cache_matches_the_reference():
    rng = np.random.default_rng(5)
    k, v = randn(rng, 2, 21, 2, 4), randn(rng, 2, 21, 2, 4)
    for S in (8, 21, 30):
        for got, want in zip(TA.kv_to_ring_cache(t(k), t(v), S),
                             RA.kv_to_ring_cache(jnp.asarray(k),
                                                 jnp.asarray(v), S)):
            close(got, want, rtol=0, atol=0)


# ---- feed-forward -----------------------------------------------------------

def test_swiglu_and_gelu_mlp_match_the_reference():
    rng = np.random.default_rng(6)
    x = randn(rng, 2, 5, 64)
    p = RMLP.init_swiglu(jax.random.key(6), 64, 96, jnp.float32)
    port = load(TMLP.init_swiglu(gen(), 64, 96, torch.float32), p)
    close(TMLP.swiglu(port, t(x)), RMLP.swiglu(p, jnp.asarray(x)))
    p = RMLP.init_gelu_mlp(jax.random.key(7), 64, 96, jnp.float32)
    port = load(TMLP.init_gelu_mlp(gen(), 64, 96, torch.float32), p)
    close(TMLP.gelu_mlp(port, t(x * 3)), RMLP.gelu_mlp(p, jnp.asarray(x * 3)))


@pytest.mark.parametrize("arch,capacity_factor", [
    ("kimi-k2-1t-a32b", 4.0),     # dropless at smoke scale
    ("kimi-k2-1t-a32b", 0.5),     # tokens over capacity go to the overflow
    ("arctic-480b", 1.0),         # top-2 with the dense residual FFN
])
def test_moe_block_matches_the_reference(arch, capacity_factor):
    rcfg, tcfg = cfgs(arch, capacity_factor=capacity_factor)
    p = RMOE.init_moe(jax.random.key(8), rcfg)
    port = load(TMOE.init_moe(gen(), tcfg), p)
    x = randn(np.random.default_rng(8), 2, 16, rcfg.d_model)
    y, aux = TMOE.moe_block(port, t(x), tcfg)
    want_y, want_aux = jax.jit(RMOE.moe_block, static_argnums=2)(
        p, jnp.asarray(x), rcfg)
    close(y, want_y)
    close(aux, want_aux)
    assert float(aux.detach()) > 0


# ---- recurrences ------------------------------------------------------------

def test_causal_conv_matches_the_reference():
    rng = np.random.default_rng(9)
    w, b, x = randn(rng, 4, 24), randn(rng, 24), randn(rng, 2, 11, 24)
    tail = randn(rng, 2, 3, 24)
    for tl in (None, tail):
        got = TS._conv1d_causal(t(w), t(b), t(x),
                                None if tl is None else t(tl))
        want = RS._conv1d_causal(jnp.asarray(w), jnp.asarray(b),
                                 jnp.asarray(x),
                                 None if tl is None else jnp.asarray(tl))
        close(got[0], want[0])
        close(got[1], want[1])


def test_selective_scan_matches_the_reference_across_chunks():
    rng = np.random.default_rng(10)
    B, L, DI, S = 2, 20, 16, 4
    u, delta = randn(rng, B, L, DI), np.abs(randn(rng, B, L, DI)) * 0.1
    Bc, Cc = randn(rng, B, L, S), randn(rng, B, L, S)
    A = np.abs(randn(rng, DI, S)) + 0.5
    D, h0 = randn(rng, DI), randn(rng, B, DI, S)
    # chunk 8 → 2 chunks of 10 in both packages
    y, h = TS._selective_scan(t(u), t(delta), t(Bc), t(Cc), t(A), t(D),
                              t(h0), chunk=8)
    wy, wh = RS._selective_scan(*map(jnp.asarray, (u, delta, Bc, Cc, A, D,
                                                   h0)), chunk=8)
    close(y, wy)
    close(h, wh)


def test_rglru_scan_matches_the_reference():
    rcfg, tcfg = cfgs("recurrentgemma-2b")
    p = RG.init_rglru(jax.random.key(11), rcfg)
    port = load(TG.init_rglru(gen(), tcfg), p)
    rng = np.random.default_rng(11)
    xs, h0 = randn(rng, 2, 9, rcfg.lru_width), randn(rng, 2, rcfg.lru_width)
    y, h = TG._rglru_scan(port, t(xs), t(h0))
    wy, wh = RG._rglru_scan(p, jnp.asarray(xs), jnp.asarray(h0))
    close(y, wy)
    close(h, wh)


def test_softplus_has_no_threshold():
    x = torch.tensor([-30.0, 0.0, 19.0, 20.5, 25.0])
    close(TS.softplus(x), jax.nn.softplus(jnp.asarray(x.numpy())),
          rtol=1e-6, atol=0)


# ---- init -------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_inits(arch):
    cfg = RR.get_arch(arch).reduced()
    a = convert._flatten(np_tree(RM.init_params(cfg, jax.random.key(0))))
    b = convert._flatten(np_tree(RM.init_params(cfg, jax.random.key(1))))
    return a, b


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_init_has_the_reference_names_shapes_dtypes_and_scales(arch):
    """Each parameter of the port's init has the reference's name (in the
    reference's layout), shape and dtype; a deterministic one (norm scales,
    biases, A_log, D) its values, a random one its std within 10 %."""
    tcfg = TR.get_arch(arch).reduced()
    ref, ref2 = _ref_inits(arch)
    port = convert._flatten(convert.lm_params_to_numpy(
        TM.init_params(tcfg, gen(3), CPU), tcfg))
    assert sorted(port) == sorted(ref)
    for name, want in ref.items():
        got = port[name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if np.array_equal(want, ref2[name]):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            ratio = np.std(got.astype(np.float64)) / np.std(
                want.astype(np.float64))
            assert abs(ratio - 1) < 0.1, (name, ratio)


def test_init_keeps_f32_parameters_under_bf16():
    """A_log, D, lambda, the router and the RG-LRU gates stay f32 when the
    parameters are bf16, as in the reference; the rest is bf16."""
    f32 = ("A_log", "D", "lambda", "router", "gate_a", "gate_x")
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b", "kimi-k2-1t-a32b"):
        cfg = TR.get_arch(arch).reduced(param_dtype="bfloat16",
                                        activation_dtype="bfloat16")
        model = TM.init_params(cfg, gen(), CPU)
        for name, p in model.state_dict().items():
            want = torch.float32 if any(f".{k}" in f".{name}" for k in f32) \
                else torch.bfloat16
            assert p.dtype == want, (arch, name, p.dtype)


def test_init_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_params(TR.get_arch("llama3.2-1b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_cache(TR.get_arch("llama3.2-1b").reduced(), 1, 8)


# ---- configs, exports -------------------------------------------------------

@pytest.mark.parametrize("arch", RR.ARCHS)
def test_get_arch_equals_the_reference_field_for_field(arch):
    for size in ("full", "reduced", "reduced_scan"):
        ref, port = RR.get_arch(arch), TR.get_arch(arch)
        if size != "full":
            kw = {"scan_layers": True} if size == "reduced_scan" else {}
            ref, port = ref.reduced(**kw), port.reduced(**kw)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref), size
        for prop in ("hd", "d_inner", "dt_rank", "lru_width", "layer_kinds",
                     "uniform_layers"):
            assert getattr(port, prop) == getattr(ref, prop), prop
        assert port.pdt == getattr(torch, ref.pdt.name)
        assert port.adt == getattr(torch, ref.adt.name)


def test_registry_equals_the_reference():
    assert TR.ARCHS == RR.ARCHS and TR.SHAPES == RR.SHAPES
    assert list(TR.cells()) == list(RR.cells())
    for arch in RR.ARCHS:
        assert TR.get_skips(arch) == RR.get_skips(arch)
        assert TR.get_shapes(arch) == RR.get_shapes(arch)
    from repro.configs import heaan_mul as rh
    from repro_torch.configs import heaan_mul as th
    assert th.HE_SHAPES == rh.HE_SHAPES
    for port, ref in ((th.CONFIG, rh.CONFIG), (th.SMOKE, rh.SMOKE)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_packages_export_the_reference_names():
    for port, ref in ((TM, RM), (TC, RC), (TD, RD)):
        assert set(ref.__all__) <= set(port.__all__), port.__name__
        for name in ref.__all__:
            assert hasattr(port, name), (port.__name__, name)
    for port, ref in ((TA, RA), (TL, RL), (TMLP, RMLP), (TMOE, RMOE),
                      (TS, RS), (TG, RG)):
        names = getattr(ref, "__all__", None) or [
            n for n in vars(ref) if n.startswith("init_")]
        assert set(names) <= set(port.__all__), port.__name__

    def public(cls):
        names = {n for n in dir(cls) if not n.startswith("_")}
        if dataclasses.is_dataclass(cls):
            names |= {f.name for f in dataclasses.fields(cls)}
        return names

    assert public(TM.ModelConfig) == public(RM.ModelConfig)
    assert public(TD.SyntheticLM) == public(RD.SyntheticLM)


# ---- the converter ----------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    ("llama3.2-1b", {}),
    ("llama3.2-1b", {"scan_layers": True}),
    ("recurrentgemma-2b", {"scan_layers": True, "n_layers": 4}),
    ("recurrentgemma-2b", {"scan_layers": True, "n_layers": 3}),
    ("whisper-base", {}),
], ids=["layers_list", "layers", "groups_tail", "groups_no_tail", "enc_dec"])
def test_converter_round_trip(arch, kw):
    """The reference's tree -> the port -> the reference's layout again, bit
    for bit; the port's model -> numpy -> the port again, too."""
    rcfg, tcfg = cfgs(arch, **kw)
    tree = np_tree(RM.init_params(rcfg, jax.random.key(12)))
    model = convert.lm_params_from_numpy(tree, tcfg, CPU)
    back = convert.lm_params_to_numpy(model, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = convert.lm_params_from_numpy(back, tcfg, CPU).state_dict()
    for name, v in model.state_dict().items():
        assert torch.equal(again[name], v), name
    with pytest.raises(ValueError, match="names differ"):
        convert.lm_params_from_numpy({**tree, "extra": tree["tok_embed"]},
                                     tcfg, CPU)


# ---- the stacked layouts and bf16, end to end -------------------------------

def _batch(cfg, rng, B, L):
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, L)
                                ).astype(np.int32)}
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    if cfg.enc_dec:
        b["frames"] = randn(rng, B, 2 * L, cfg.d_model)
    if cfg.frontend == "vision":
        b["patch_embeds"] = randn(rng, B, cfg.n_frontend_tokens, cfg.d_model)
    return b


@pytest.mark.parametrize("arch,kw", [
    ("llama3.2-1b", {"scan_layers": True}),
    ("recurrentgemma-2b", {"scan_layers": True, "n_layers": 4}),
], ids=["layers", "groups_tail"])
def test_stacked_layouts_prefill_and_decode_match_the_reference(arch, kw):
    """scan_layers=True: the reference's stacked parameters and caches are
    read (prefill's cache written back in its layout, decode fed the
    reference's cache)."""
    rcfg, tcfg = cfgs(arch, **kw)
    P = RM.init_params(rcfg, jax.random.key(13))
    assert ("layers" if rcfg.uniform_layers else "groups") in P
    model = convert.lm_params_from_numpy(np_tree(P), tcfg, CPU)
    b = _batch(rcfg, np.random.default_rng(13), 2, 12)
    want, cache = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, 20))(
        P, {"tokens": jnp.asarray(b["tokens"])})
    got, tcache = TM.prefill(model, {"tokens": t(b["tokens"])}, tcfg, 20)
    close(got, want)
    mine = convert.lm_cache_to_numpy(tcache, tcfg)
    assert jax.tree.structure(mine) == jax.tree.structure(np_tree(cache))
    for a, w in zip(jax.tree.leaves(mine), jax.tree.leaves(np_tree(cache))):
        close(a, w)
    tok = b["tokens"][:, :1]
    want, _ = jax.jit(lambda p, c, x: RM.decode_step(p, c, x, 12, rcfg))(
        P, cache, jnp.asarray(tok))
    fed = convert.lm_cache_from_numpy(np_tree(cache), tcfg, CPU)
    got, _ = TM.decode_step(model, fed, t(tok), 12, tcfg)
    close(got, want)


def test_bf16_prefill_and_forward_match_the_reference():
    """llama3.2-1b's reduced config in bf16 (weights and activations):
    within 2e-2."""
    bf = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
    rcfg, tcfg = cfgs("llama3.2-1b", **bf)
    P = RM.init_params(rcfg, jax.random.key(14))
    model = convert.lm_params_from_numpy(np_tree(P), tcfg, CPU)
    assert model.layers[0].attn.wq.w.dtype == torch.bfloat16
    b = _batch(rcfg, np.random.default_rng(14), 2, 16)
    tol = dict(rtol=2e-2, atol=2e-2)
    with torch.no_grad():
        got, _ = TM.forward_train(model, {"tokens": t(b["tokens"])}, tcfg)
    # eager, as the reference's tests run it: jit's fusions round bf16
    # intermediates elsewhere
    jb = {"tokens": jnp.asarray(b["tokens"])}
    want, _ = RM.forward_train(P, jb, rcfg)
    close(got, want, **tol)
    got, _ = TM.prefill(model, {"tokens": t(b["tokens"])}, tcfg, 24)
    want, _ = RM.prefill(P, jb, rcfg, 24)
    assert got.dtype == torch.float32
    close(got, want, **tol)
