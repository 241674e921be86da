"""repro_torch's LM serving path against the JAX package's, on the CPU.

For every architecture at its ``reduced()`` size, the JAX package's
weights are carried into the port (``convert.lm_params_from_numpy``) and
both run the same numpy-seeded batch: ``forward_train`` and ``loss_fn``'s
value, ``prefill``'s logits and cache, ``decode_step`` fed the same cache,
and greedy ``generate``, teacher-forced: the reference's ``decode_step``
is fed the port's own tokens, each step's logits must agree within 1e-4,
and the tokens must be equal wherever the reference's top-2 gap exceeds
1e-3 (a greedy token may flip on a near tie). Also the synthetic data and
the LM command line.
"""

import functools
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
import repro.data as RD
import repro.models as RM

import repro_torch.configs.registry as TR
import repro_torch.data as TD
import repro_torch.models as TM
from repro_torch import convert
from repro_torch.launch import serve

B, L, GEN = 2, 16, 4
MAX_LEN = L + GEN + 4
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")


def close(got, want, **tol):
    np.testing.assert_allclose(
        got.float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), **(tol or TOL))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close_trees(got: dict, want: dict):
    """Two caches (numpy trees in the reference's layout) leaf by leaf."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(a, b, err_msg=jax.tree_util.keystr(path),
                                   **TOL)


@functools.lru_cache(maxsize=None)
def setup(arch):
    """The reference's jitted functions, weights and batch for `arch`, and
    the port's model holding the same weights."""
    rcfg = RR.get_arch(arch).reduced()
    tcfg = TR.get_arch(arch).reduced()
    P = RM.init_params(rcfg, jax.random.key(0))
    rng = np.random.default_rng(RR.ARCHS.index(arch))
    b = {"tokens": rng.integers(0, rcfg.vocab_size, size=(B, L)
                                ).astype(np.int32),
         "labels": rng.integers(-1, rcfg.vocab_size, size=(B, L)
                                ).astype(np.int32)}
    if rcfg.enc_dec:
        b["frames"] = rng.normal(size=(B, 2 * L, rcfg.d_model)
                                 ).astype(np.float32)
    if rcfg.frontend == "vision":
        b["patch_embeds"] = rng.normal(
            size=(B, rcfg.n_frontend_tokens, rcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    train = jax.jit(lambda p, b: (RM.forward_train(p, b, rcfg),
                                  RM.loss_fn(p, b, rcfg)))
    (logits, aux), (total, metrics) = train(P, jb)
    pre = jax.jit(lambda p, b: RM.prefill(p, b, rcfg, MAX_LEN))
    pre_logits, cache = pre(P, jb)
    step = jax.jit(lambda p, c, tok, t: RM.decode_step(p, c, tok, t, rcfg))
    model = convert.lm_params_from_numpy(np_tree(P), tcfg, CPU)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    return dict(rcfg=rcfg, tcfg=tcfg, P=P, b=b, jb=jb, tb=tb, model=model,
                step=step, logits=np.asarray(logits), aux=float(aux),
                total=float(total), metrics=np_tree(metrics),
                pre_logits=np.asarray(pre_logits), cache=cache)


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_forward_train_and_loss_match_the_reference(arch):
    s = setup(arch)
    with torch.no_grad():
        logits, aux = TM.forward_train(s["model"], s["tb"], s["tcfg"])
        total, metrics = TM.loss_fn(s["model"], s["tb"], s["tcfg"])
    assert logits.dtype == torch.float32
    close(logits, s["logits"])
    close(aux, s["aux"])
    close(total, s["total"])
    for k in ("loss", "aux_loss", "tokens"):
        close(metrics[k], s["metrics"][k])


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_prefill_logits_and_cache_match_the_reference(arch):
    s = setup(arch)
    logits, cache = TM.prefill(s["model"], s["tb"], s["tcfg"], MAX_LEN)
    assert logits.shape == (B, 1, s["tcfg"].vocab_size)
    close(logits, s["pre_logits"])
    close_trees(convert.lm_cache_to_numpy(cache, s["tcfg"]),
                np_tree(s["cache"]))


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_decode_step_fed_the_same_cache_matches_the_reference(arch):
    s = setup(arch)
    cache = convert.lm_cache_from_numpy(np_tree(s["cache"]), s["tcfg"], CPU)
    jcache = s["cache"]
    for i in range(2):
        tok = s["b"]["tokens"][:, i: i + 1]
        want, jcache = s["step"](s["P"], jcache, jnp.asarray(tok), L + i)
        got, cache = TM.decode_step(s["model"], cache, torch.from_numpy(tok),
                                    L + i, s["tcfg"])
        close(got, want)
        close_trees(convert.lm_cache_to_numpy(cache, s["tcfg"]),
                    np_tree(jcache))


@pytest.mark.parametrize("arch", RR.ARCHS)
def test_generate_teacher_forced_matches_the_reference(arch):
    s = setup(arch)
    tcfg, tb = s["tcfg"], s["tb"]
    extra = {k: v for k, v in tb.items() if k in ("frames", "patch_embeds")}
    out = serve.generate(s["model"], tcfg, tb["tokens"], GEN, MAX_LEN,
                         batch_extra=extra)
    assert out.shape == (B, GEN) and out.dtype == torch.int32
    # the port's own logits along its tokens: generate's loop, unrolled
    logits, cache = TM.prefill(s["model"], {"tokens": tb["tokens"], **extra},
                               tcfg, MAX_LEN)
    mine = [logits]
    for i in range(GEN - 1):
        logits, cache = TM.decode_step(s["model"], cache, out[:, i: i + 1],
                                       L + i, tcfg)
        mine.append(logits)
    # the reference fed the port's tokens
    want = [s["pre_logits"]]
    jcache = s["cache"]
    for i in range(GEN - 1):
        w, jcache = s["step"](s["P"], jcache, jnp.asarray(out[:, i: i + 1]),
                              L + i)
        want.append(np.asarray(w))
    for i, (m, w) in enumerate(zip(mine, want)):
        close(m, w)
        assert torch.equal(m[:, -1].argmax(-1).to(torch.int32), out[:, i])
        top2 = np.sort(w[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 1e-3
        np.testing.assert_array_equal(
            out[:, i].numpy()[clear], w[:, -1].argmax(-1)[clear])


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "recurrentgemma-2b"])
def test_windowed_decode_beyond_the_window_matches_the_reference(arch):
    """Ring caches past an 8-token window: prefill of 24 tokens (the roll
    by L % S) and decode steps fed the reference's cache."""
    rcfg = RR.get_arch(arch).reduced(window=8)
    tcfg = TR.get_arch(arch).reduced(window=8)
    P = RM.init_params(rcfg, jax.random.key(2))
    model = convert.lm_params_from_numpy(np_tree(P), tcfg, CPU)
    toks = np.random.default_rng(8).integers(0, rcfg.vocab_size,
                                             size=(B, 27)).astype(np.int32)
    want, jcache = RM.prefill(P, {"tokens": jnp.asarray(toks[:, :24])}, rcfg,
                              32)
    got, cache = TM.prefill(model, {"tokens": torch.from_numpy(toks[:, :24])},
                            tcfg, 32)
    close(got, want)
    close_trees(convert.lm_cache_to_numpy(cache, tcfg), np_tree(jcache))
    cache = convert.lm_cache_from_numpy(np_tree(jcache), tcfg, CPU)
    step = jax.jit(lambda p, c, tok, t: RM.decode_step(p, c, tok, t, rcfg))
    for i in range(24, 27):
        tok = toks[:, i: i + 1]
        want, jcache = step(P, jcache, jnp.asarray(tok), i)
        got, cache = TM.decode_step(model, cache, torch.from_numpy(tok), i,
                                    tcfg)
        close(got, want)


# ---- the synthetic data -----------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-base",
                                  "llava-next-mistral-7b"])
def test_synthetic_batches_equal_the_reference_word_for_word(arch):
    rcfg, tcfg = RR.get_arch(arch).reduced(), TR.get_arch(arch).reduced()
    ref = RD.SyntheticLM(rcfg, 4, 12, seed=3)
    port = TD.SyntheticLM(tcfg, 4, 12, seed=3, device="cpu")
    assert port.enc_len == ref.enc_len
    for step in (0, 1, 17):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert set(got) == set(want)
        for k, v in want.items():
            v = np.asarray(v)
            assert got[k].dtype == getattr(torch, v.dtype.name), k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        for proc in range(2):
            sl = port.shard_slice(got, proc, 2)
            for k, v in ref.shard_slice(want, proc, 2).items():
                np.testing.assert_array_equal(sl[k].numpy(), np.asarray(v))
    specs = TD.make_batch_specs(tcfg, 4, 12, enc_len=24)
    for k, v in RD.make_batch_specs(rcfg, 4, 12, enc_len=24).items():
        assert specs[k].device.type == "meta"
        assert tuple(specs[k].shape) == v.shape
        assert specs[k].dtype == getattr(torch, v.dtype.name)
    assert set(specs) == set(RD.make_batch_specs(rcfg, 4, 12, enc_len=24))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TD.SyntheticLM(tcfg, 4, 12)


# ---- the command line -------------------------------------------------------

@pytest.mark.parametrize("arch", RR.ARCHS)
def test_lm_cli_smoke_runs_on_the_cpu(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", arch, "--preset", "smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = buf.getvalue()
    assert f"arch={arch} preset=smoke generated (2, 3) on cpu" in out, out


def test_lm_cli_defaults_to_the_card_and_refuses_model_shards():
    """The LM command line defaults to the card; --model-shards 2, once
    refused on the LM path, now serves across two model ranks and prints
    the one-rank line with its grid (the name is kept from the refusal)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "llama3.2-1b", "--gen", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", "llama3.2-1b", "--gen", "1",
                        "--model-shards", "2"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(["--arch", "llama3.2-1b", "--preset", "smoke",
                    "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--gen", "3", "--model-shards", "2"])
    out = buf.getvalue()
    assert ("arch=llama3.2-1b preset=smoke generated (2, 3) on cpu grid 1x2 "
            "(gloo, 12 collectives a decode step on rank 0)") in out, out
    one = io.StringIO()
    with redirect_stdout(one):
        serve.main(["--arch", "llama3.2-1b", "--preset", "smoke",
                    "--device", "cpu", "--batch", "2", "--prompt-len", "8",
                    "--gen", "3"])
    first = [ln for ln in out.splitlines() if "first tokens" in ln]
    assert first and first[0] in one.getvalue()
