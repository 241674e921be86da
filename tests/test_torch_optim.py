"""repro_torch.optim against the JAX package's optim, on the CPU.

The same numpy-seeded inputs go through both: ``warmup_cosine`` within
1e-7 at every step of two schedules; ``global_norm`` and two
``adamw_update`` steps (clipping on and off, f32 and bf16 moments) within
1e-6 relative; ``compress_int8`` fed the noise JAX's key draws equal to
JAX's payload and scales bit for bit, and ``decompress_int8`` too. Also
the reference's own optimizer and compression tests
(tests/test_optim_data.py) on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
from repro.optim import adamw as RA
from repro.optim import compress as RC
from repro.optim import schedule as RS

from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.optim import schedule as TS


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---- schedule ---------------------------------------------------------------

@pytest.mark.parametrize("peak_lr,warmup,total", [(3e-4, 10, 100),
                                                  (3e-3, 2, 8),
                                                  (1e-3, 0, 5)])
def test_warmup_cosine_matches_the_reference(peak_lr, warmup, total):
    kw = dict(peak_lr=peak_lr, warmup_steps=warmup, total_steps=total)
    for step in range(total + 3):
        want = RS.warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = TS.warmup_cosine(s, **kw)
            assert got.dtype == torch.float32 and got.shape == ()
            assert abs(float(got) - float(want)) <= 1e-7, (step, got, want)


def test_warmup_cosine_shape():
    assert float(TS.warmup_cosine(0, peak_lr=1.0, warmup_steps=10,
                                  total_steps=100)) == 0.0
    assert abs(float(TS.warmup_cosine(10, peak_lr=1.0, warmup_steps=10,
                                      total_steps=100)) - 1.0) < 1e-6
    end = float(TS.warmup_cosine(100, peak_lr=1.0, warmup_steps=10,
                                 total_steps=100))
    assert abs(end - 0.1) < 1e-6


# ---- AdamW ------------------------------------------------------------------

SHAPES = {"a": (4, 3), "b.c": (300,), "b.d": (7, 5, 2)}


def nest(flat: dict) -> dict:
    """{"a": x, "b.c": y} -> {"a": x, "b": {"c": y}}."""
    out: dict = {}
    for k, v in flat.items():
        *heads, last = k.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def unnest(tree: dict, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(unnest(v, name) if isinstance(v, dict) else {name: v})
    return out


def rel_close(got, want, rtol=1e-6):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_global_norm_and_adamw_update_match_the_reference(moments,
                                                          grad_scale):
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in SHAPES.items()}
    mdt_j = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[moments]
    mdt_t = {"float32": torch.float32, "bfloat16": torch.bfloat16}[moments]
    # a state one step in: moments drawn, then rounded to their dtype
    mu = {k: jnp.asarray(rng.normal(size=s).astype(np.float32) * 0.1
                         ).astype(mdt_j) for k, s in SHAPES.items()}
    nu = {k: jnp.asarray(rng.random(size=s).astype(np.float32) * 0.01
                         ).astype(mdt_j) for k, s in SHAPES.items()}
    jstate = RA.OptState(step=jnp.asarray(1, jnp.int32), mu=nest(mu),
                         nu=nest(nu))
    jp = nest({k: jnp.asarray(v) for k, v in p.items()})
    tp = {k: t(v) for k, v in p.items()}
    tstate = TA.OptState(
        step=torch.tensor(1, dtype=torch.int32),
        mu={k: t(np.asarray(v.astype(jnp.float32))).to(mdt_t)
            for k, v in mu.items()},
        nu={k: t(np.asarray(v.astype(jnp.float32))).to(mdt_t)
            for k, v in nu.items()})
    for step in range(2):
        g = {k: rng.normal(size=s).astype(np.float32) * grad_scale
             for k, s in SHAPES.items()}
        jg = nest({k: jnp.asarray(v) for k, v in g.items()})
        tg = {k: t(v) for k, v in g.items()}
        rel_close(TA.global_norm(tg), RA.global_norm(jg))
        jp, jstate, jm = RA.adamw_update(jg, jstate, jp, lr=1e-2)
        tp, tstate, tm = TA.adamw_update(tg, tstate, tp, lr=1e-2)
        for k in ("grad_norm", "clip_scale"):
            rel_close(tm[k], jm[k])
        assert (float(tm["clip_scale"]) < 1.0) == (grad_scale > 1.0)
        assert int(tstate.step) == int(jstate.step) == step + 2
        for name, want in unnest(jp).items():
            assert tp[name].dtype == torch.float32
            rel_close(tp[name], want)
        for got, want in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            for name, w in unnest(want).items():
                assert got[name].dtype == mdt_t
                rel_close(got[name].float(), np.asarray(w.astype(
                    jnp.float32)))


def test_adamw_matches_reference_formula():
    rng = np.random.default_rng(0)
    p = {"w": t(rng.normal(size=(4, 3)).astype(np.float32))}
    g = {"w": t(rng.normal(size=(4, 3)).astype(np.float32))}
    p0 = p["w"].numpy().copy()
    st = TA.adamw_init(p)
    lr, b1, b2, eps, wd = 1e-2, 0.9, 0.95, 1e-8, 0.1
    p2, st2, m = TA.adamw_update(g, st, p, lr=lr, b1=b1, b2=b2, eps=eps,
                                 weight_decay=wd, clip_norm=1e9)
    gw = g["w"].numpy()
    mhat = (1 - b1) * gw / (1 - b1)
    vhat = (1 - b2) * gw ** 2 / (1 - b2)
    expect = p0 - lr * (mhat / (np.sqrt(vhat) + eps) + wd * p0)
    np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-5)
    assert abs(float(m["grad_norm"]) - np.linalg.norm(gw)) < 1e-4
    assert int(st2.step) == 1


def test_adamw_clip_scales_gradients():
    p = {"w": torch.ones(2)}
    g = {"w": torch.full((2,), 100.0)}
    _, _, m = TA.adamw_update(g, TA.adamw_init(p), p, lr=0.0, clip_norm=1.0)
    assert float(m["clip_scale"]) < 0.01


def test_adamw_bf16_moments_shapes_and_dtype():
    p = {"w": torch.ones(8, dtype=torch.bfloat16)}
    st = TA.adamw_init(p, moments_dtype=torch.bfloat16)
    assert st.mu["w"].dtype == torch.bfloat16
    g = {"w": torch.full((8,), 0.1, dtype=torch.bfloat16)}
    p2, st2, _ = TA.adamw_update(g, st, p, lr=1e-2)
    assert st2.mu["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.bfloat16


def test_adamw_init_from_a_model_and_refuses_missing_grads():
    model = torch.nn.Linear(3, 2)
    st = TA.adamw_init(model)
    assert set(st.mu) == {"weight", "bias"} and st.step.dtype == torch.int32
    with pytest.raises(ValueError, match="do not match"):
        TA.adamw_update({"weight": torch.zeros(2, 3)}, st, model, lr=1e-3)


# ---- int8 compression -------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (4, 333), (256,), (8, 130),
                                   (3,)])
def test_compress_int8_with_the_reference_noise_is_bitwise(shape):
    """A size that pads its last block, one exact block, one under a
    block; one block all zero (the scale's floor)."""
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 5).astype(np.float32)
    if x.size > 512:
        x.reshape(-1)[:256] = 0.0
    key = jax.random.key(7)
    q8, scale, meta = RC.compress_int8(jnp.asarray(x), key)
    noise = jax.random.uniform(key, q8.shape, jnp.float32, -0.5, 0.5)
    tq8, tscale, tmeta = TC.compress_int8(t(x), noise=t(noise))
    assert tq8.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(q8))
    np.testing.assert_array_equal(tscale.numpy().view(np.uint32),
                                  np.asarray(scale).view(np.uint32))
    assert tmeta == (tuple(meta[0]), meta[1])
    back = TC.decompress_int8(tq8, tscale, tmeta)
    want = RC.decompress_int8(q8, scale, meta)
    np.testing.assert_array_equal(back.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_int8_compression_roundtrip_error_bound():
    rng = np.random.default_rng(1)
    x = t(rng.normal(size=(1000,)).astype(np.float32) * 5)
    q8, scale, meta = TC.compress_int8(x, torch.Generator().manual_seed(0))
    back = TC.decompress_int8(q8, scale, meta)
    # per-block error bounded by the quantization step
    assert float((back - x).abs().max()) <= float(scale.max()) * 1.01
    with pytest.raises(ValueError, match="noise"):
        TC.compress_int8(x, noise=torch.zeros(3, 256))
