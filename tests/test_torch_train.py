"""repro_torch.launch.train against the JAX package's Trainer, on the CPU.

The port's Trainer and the reference's start from the same weights and
AdamW state (the reference's init, carried over with ``convert``) and
train tests/test_fault_tolerance.py's reduced llama (f32) on the same
synthetic batches: the loss history within 1e-4 over 4 steps. The
reference's fault-tolerance cases on the port: crash/restart replay bit
for bit, the straggler flag, the loss decreasing over 60 steps; the
train-then-serve cycle through the port's ``generate``
(tests/test_system.py); and the command line's summary line.
"""

import io
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
import repro.launch.train as RT

import repro_torch.configs.registry as TR
from repro_torch import convert
from repro_torch.launch import train as TT
from repro_torch.launch.mesh import HostGrid
from repro_torch.launch.serve import generate
from repro_torch.runtime import FailureInjector

KW = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
          d_ff=128, vocab_size=256)


def _cfg():
    return TR.get_arch("llama3.2-1b").reduced(**KW)


def _tc(**kw):
    base = dict(batch=2, seq_len=16, steps=8, ckpt_every=2, warmup_steps=2)
    base.update(kw)
    return TT.TrainConfig(**base)


def load_reference_state(trainer, params, opt, cfg):
    """`trainer` holding the reference's params and OptState."""
    np_params = jax.tree.map(np.asarray, params)
    trainer.params.load_state_dict(convert.lm_params_from_numpy(
        np_params, cfg, "cpu").state_dict())
    trainer.opt = convert.opt_state_from_numpy(
        jax.tree.map(np.asarray, opt), cfg, "cpu")


def test_train_config_has_the_reference_fields_and_defaults():
    import dataclasses
    assert dataclasses.asdict(TT.TrainConfig()) == \
        dataclasses.asdict(RT.TrainConfig())


def test_trainer_matches_the_reference_from_the_same_state():
    cfg = _cfg()
    ref = RT.Trainer(RR.get_arch("llama3.2-1b").reduced(**KW),
                     RT.TrainConfig(**vars(_tc())))
    port = TT.Trainer(cfg, _tc(), device="cpu")
    load_reference_state(port, ref.params, ref.opt, cfg)
    want = ref.run(4)["history"]
    got = port.run(4)["history"]
    assert [h["step"] for h in got] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 1e-4, (g, w)
    assert int(port.opt.step) == int(ref.opt.step) == 4
    # the parameters after 4 steps: AdamW's sign-like first steps move a
    # weight whose gradient is near 0 by up to lr either way
    for name, w in convert.lm_untree(jax.tree.map(np.asarray, ref.params),
                                     cfg).items():
        got_w = dict(port.params.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got_w, w, atol=1e-3, err_msg=name)


def test_crash_restart_bitwise_identical(tmp_path):
    cfg = _cfg()
    # uninterrupted reference run
    ref = TT.Trainer(cfg, _tc(), ckpt_dir=str(tmp_path / "ref"),
                     device="cpu")
    ref.run()

    # crashing run: dies at steps 3 and 6, restarts from latest checkpoint
    ck = str(tmp_path / "crash")
    inj = FailureInjector(fail_at_steps=[3, 6])
    trainer, out, restarts = TT.run_with_restarts(
        lambda: TT.Trainer(cfg, _tc(), ckpt_dir=ck, injector=inj,
                           device="cpu"),
        total_steps=8)
    assert restarts == 2
    assert trainer.step == 8 and out["history"][-1]["step"] == 8
    for (ka, a), (kb, b) in zip(ref.params.state_dict().items(),
                                trainer.params.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    for k, m in ref.opt.mu.items():
        assert torch.equal(m, trainer.opt.mu[k])
        assert torch.equal(ref.opt.nu[k], trainer.opt.nu[k])


def test_straggler_injection_is_flagged(tmp_path):
    inj = FailureInjector(straggle_at_steps=[6], straggle_seconds=1.5)
    tr = TT.Trainer(_cfg(), _tc(), ckpt_dir=str(tmp_path / "s"),
                    injector=inj, device="cpu")
    out = tr.run()
    assert any(h["straggler"] for h in out["history"]), \
        "injected straggler step was not flagged"
    assert (tmp_path / "s" / "heartbeat").exists()


def test_loss_decreases_on_synthetic_data():
    tr = TT.Trainer(_cfg(), _tc(steps=60, batch=8, seq_len=32,
                                ckpt_every=1000, warmup_steps=5,
                                peak_lr=3e-3), device="cpu")
    losses = [h["loss"] for h in tr.run()["history"]]
    head = sum(losses[:5]) / 5
    tail = sum(losses[-5:]) / 5
    assert tail < head * 0.8, (head, tail)


def test_train_then_serve_cycle(tmp_path):
    cfg = _cfg()
    tr = TT.Trainer(cfg, _tc(steps=4), ckpt_dir=str(tmp_path),
                    device="cpu")
    tr.run()
    assert tr.step == 4
    toks = torch.arange(16, dtype=torch.int32)[None].repeat(2, 1)
    out = generate(tr.params, cfg, toks, gen_steps=4, max_len=24)
    assert out.shape == (2, 4)
    assert int(out.max()) < cfg.vocab_size


def test_cli_smoke_prints_the_reference_summary(monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", TT.CUBLAS_WORKSPACE_CONFIG)
    monkeypatch.setattr(sys, "argv", [
        "train", "--preset", "smoke", "--steps", "3", "--batch", "2",
        "--seq", "16", "--device", "cpu"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        TT.main()
    line = buf.getvalue().strip().splitlines()[-1]
    assert line.startswith("arch=llama3.2-1b preset=smoke loss ")
    assert line.endswith("(3 steps)")


def test_trainer_defaults_to_the_card_and_checks_the_batch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.Trainer(_cfg(), _tc())
    grid = HostGrid(data=2, model=1, rank=0, device=torch.device("cpu"),
                    backend=None)
    with pytest.raises(ValueError, match="must divide batch=3"):
        TT.Trainer(_cfg(), _tc(batch=3), grid=grid, compress_dp=True)
