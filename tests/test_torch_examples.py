"""The port's five examples (``repro_torch.examples``) on the CPU.

Each example's ``main([..., "--device", "cpu"])`` passes its own checks.
The quickstart's product, rescaled and final ciphertexts equal the JAX
package's ``repro.core.heaan`` calls word for word on the same keys and
seeds; he_inference's served ciphertexts, and so the scores they decrypt
to, equal a JAX ``HESession`` run of the same traced model on the same
keys and encryptions. The keys are made by the port at the examples'
seed and carried into JAX with ``convert`` (JAX's keygen costs compile
time). serve_lm runs an SSM and a hybrid arch; train_lm stops after 4 of
6 steps and resumes bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
from repro.client import HESession as JHESession
from repro.core import heaan as JH
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core import test_params as j_test_params
from repro.core.keys import EvalKey as JEvalKey
from repro.core.keys import PublicKey as JPublicKey
from repro.core.keys import SecretKey as JSecretKey

from repro_torch import convert
from repro_torch.core import test_params as t_test_params
from repro_torch.core.keys import keygen
from repro_torch.examples import (
    CheckFailed, bootstrap_demo, he_inference, quickstart, serve_lm,
    train_lm,
)

EXAMPLES = [quickstart, he_inference, bootstrap_demo, serve_lm, train_lm]


def _jkeys(params):
    """The port's keys at the examples' seed 0, as the JAX package's."""
    sk, pk, evk = keygen(params, seed=0, device="cpu")
    return tuple(cls(**{k: jnp.asarray(v) for k, v in
                        convert.to_numpy(key).items()})
                 for cls, key in ((JSecretKey, sk), (JPublicKey, pk),
                                  (JEvalKey, evk)))


def _jct(ct):
    f = convert.to_numpy(ct)
    return JCiphertext(ax=jnp.asarray(f["ax"]), bx=jnp.asarray(f["bx"]),
                       logq=f["logq"], logp=f["logp"], n_slots=f["n_slots"])


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_quickstart_equals_the_reference_bit_for_bit():
    out = quickstart.main(["--device", "cpu"])
    assert out["session_bitwise"] and out["max_err"] < 1e-2
    params = j_test_params(logN=8, beta_bits=32, logQ=120, logp=24)
    _, pk, evk = _jkeys(t_test_params(logN=8, beta_bits=32, logQ=120,
                                      logp=24))
    rng = np.random.default_rng(0)
    z1 = rng.normal(size=64) + 1j * rng.normal(size=64)
    z2 = rng.normal(size=64) + 1j * rng.normal(size=64)

    def calls(pk, evk):             # the example's, jitted as one program
        c1 = JH.encrypt_message(z1, pk, params, seed=1)
        c2 = JH.encrypt_message(z2, pk, params, seed=2)
        product = JH.he_mul(c1, c2, evk, params)
        c3 = JH.rescale(product, params)
        return product, c3, JH.he_add(c3, JH.he_mod_down(c1, params,
                                                         c3.logq))

    for mine, ref in zip((out["product"], out["rescaled"], out["result"]),
                         jax.jit(calls)(pk, evk)):
        assert (mine.logq, mine.logp) == (ref.logq, ref.logp)
        np.testing.assert_array_equal(_words(mine.ax), np.asarray(ref.ax))
        np.testing.assert_array_equal(_words(mine.bx), np.asarray(ref.bx))


def test_he_inference_serves_what_the_references_session_serves():
    out = he_inference.main(["--device", "cpu"])
    assert out["max_err"] < 1e-2 and out["cache"]["plain_hits"] >= 1
    params = j_test_params(logN=7, beta_bits=32, logQ=144, logp=24)
    sk, pk, evk = _jkeys(t_test_params(logN=7, beta_bits=32, logQ=144,
                                       logp=24))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    session = JHESession(params, sk, pk, evk, mesh=mesh, batch=2)
    w, b, _, _, _ = he_inference.train_probe()
    # the example's encryptions at its seeds (the port's encrypt equals the
    # reference's word for word: tests/test_torch_client.py)
    handles = [he_inference.traced_probs([session.input(_jct(ct))
                                          for ct in cts], w, b)
               for cts in out["inputs"]]
    # the served ciphertexts word for word, so the scores they decrypt to
    # under the one key are equal (JAX's eager decrypt costs ≈ 5 s)
    for mine, fut in zip(out["served"], session.run(handles)):
        ref = fut.result()
        assert (mine.logq, mine.logp) == (ref.logq, ref.logp)
        np.testing.assert_array_equal(_words(mine.ax), np.asarray(ref.ax))
        np.testing.assert_array_equal(_words(mine.bx), np.asarray(ref.bx))


def test_bootstrap_demo_serves_past_the_depth_limit():
    out = bootstrap_demo.main(["--device", "cpu"])
    assert "needs bootstrapping" in out["refused"]
    assert out["spliced"] == 1 and out["diagonal_hits"] > 0
    assert out["square_err"] <= out["square_budget"]
    assert out["refresh_err"] <= out["error_bound"]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-2b"])
def test_serve_lm_decodes_as_it_prefills(arch):
    out = serve_lm.main(["--arch", arch, "--device", "cpu"])
    assert out["tokens"].shape == (4, 24)
    assert out["decode_vs_prefill"] <= serve_lm.DECODE_TOL


def test_a_failed_check_raises(monkeypatch):
    monkeypatch.setattr(serve_lm, "DECODE_TOL", -1.0)
    with pytest.raises(CheckFailed, match="decode differs from prefill"):
        serve_lm.main(["--arch", "falcon-mamba-7b", "--batch", "1",
                       "--prompt-len", "4", "--gen", "2", "--device", "cpu"])


def test_train_lm_resumes_bit_for_bit(tmp_path, monkeypatch):
    whole = train_lm.main(["--tiny", "--steps", "6", "--ckpt-dir",
                           str(tmp_path / "a"), "--device", "cpu"])
    assert whole["resumed_from"] == 0 and whole["step"] == 6

    class Killed(train_lm.Trainer):
        def run(self, steps=None):          # stops after step 4 of 6
            return super().run(4)

    argv = ["--tiny", "--steps", "6", "--ckpt-dir", str(tmp_path / "b"),
            "--device", "cpu"]
    monkeypatch.setattr(train_lm, "Trainer", Killed)
    first = train_lm.main(argv)
    monkeypatch.undo()
    assert first["step"] == 4
    rest = train_lm.main(argv)
    assert rest["resumed_from"] == 4 and rest["step"] == 6
    assert [h["loss"] for h in first["history"] + rest["history"]] == \
        [h["loss"] for h in whole["history"]]
    # every array of the last checkpoint, byte for byte (its manifest
    # holds the time of the save)
    a, b = tmp_path / "a" / "step_00000006", tmp_path / "b" / "step_00000006"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "manifest.json" in names
    names.remove("manifest.json")
    assert len(names) > 10 and all(n.endswith(".npy") for n in names)
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.mark.parametrize("example", EXAMPLES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in EXAMPLES])
def test_examples_run_on_the_card_unless_asked(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        example.main([])
