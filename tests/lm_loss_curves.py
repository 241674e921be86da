"""Both packages' Trainers side by side on the CPU: the loss at each step.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/lm_loss_curves.py \\
        [--steps 6] [--batch 8] [--seq 128] [--dtype bfloat16]

The model is llama3.2-1b at the reference's ``--preset 100m`` size (8
layers, d 768, 12 heads, 4 KV heads, d_ff 2048, vocab 32000, stacked) in
`--dtype` (the published config's bfloat16 by default, as chip_smoke.py's
phase 14a trains it); the schedule is phase 14a's (``TrainConfig(batch,
seq_len, steps, warmup_steps=2)``). The port's Trainer starts from the
reference's weights and AdamW state (carried over with ``convert``) and
both train on the same synthetic batches. Prints one JSON line: both loss
curves and their largest difference.
"""

import argparse
import json
import time

import jax
import numpy as np

import repro.core  # noqa: F401  (x64 on, as in the reference's tests)
import repro.configs.registry as RR
import repro.launch.train as RT

import repro_torch.configs.registry as TR
from repro_torch import convert
from repro_torch.launch import train as TT

PRESET_100M = dict(n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
                   head_dim=64, d_ff=2048, vocab_size=32000,
                   scan_layers=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    kw = dict(PRESET_100M, param_dtype=args.dtype,
              activation_dtype=args.dtype)
    tc = dict(batch=args.batch, seq_len=args.seq, steps=args.steps,
              warmup_steps=2)
    t0 = time.perf_counter()
    ref = RT.Trainer(RR.get_arch("llama3.2-1b").reduced(**kw),
                     RT.TrainConfig(**tc))
    cfg = TR.get_arch("llama3.2-1b").reduced(**kw)
    port = TT.Trainer(cfg, TT.TrainConfig(**tc), device="cpu")
    port.params.load_state_dict(convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, ref.params), cfg, "cpu").state_dict())
    port.opt = convert.opt_state_from_numpy(
        jax.tree.map(np.asarray, ref.opt), cfg, "cpu")
    want = [h["loss"] for h in ref.run()["history"]]
    got = [h["loss"] for h in port.run()["history"]]
    out = {"config": "llama3.2-1b --preset 100m " + args.dtype,
           "train_config": tc, "reference": want, "port": got,
           "max_abs_diff": max(abs(a - b) for a, b in zip(got, want)),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
