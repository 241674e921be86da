"""Train a ~100M-parameter LM for a few hundred steps.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 20 --tiny

Uses the full production path: synthetic counter-based data pipeline,
AdamW + warmup-cosine, checkpoint/restart (kill it mid-run and rerun — it
resumes bit-identically), straggler monitoring. Runs on the card unless
``--device cpu``; the checkpoints go to ``--ckpt-dir`` (default
``repro_torch_train_lm`` in the temporary directory).
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

from repro_torch.configs.registry import get_arch
from repro_torch.core.context import resolve_device
from repro_torch.examples import check
from repro_torch.launch.train import (
    CUBLAS_WORKSPACE_CONFIG, TrainConfig, Trainer,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_lm")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # before the first cuBLAS call of this process (exact replay)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)

    full = get_arch("llama3.2-1b")
    if args.tiny:
        cfg = full.reduced()
        tc = TrainConfig(batch=8, seq_len=64, steps=args.steps,
                         peak_lr=3e-3, warmup_steps=10, ckpt_every=50)
    else:
        # ~100M params: 8L × d768 × ff2048, 32k vocab
        cfg = full.reduced(n_layers=8, d_model=768, n_heads=12,
                           n_kv_heads=4, head_dim=64, d_ff=2048,
                           vocab_size=32000, scan_layers=True)
        tc = TrainConfig(batch=8, seq_len=256, steps=args.steps,
                         peak_lr=1e-3, warmup_steps=20, ckpt_every=50)

    trainer = Trainer(cfg, tc, ckpt_dir=args.ckpt_dir, device=dev)
    resumed = trainer.step
    if resumed:
        print(f"resumed from checkpoint at step {resumed}")
    out = trainer.run()
    hist = out["history"]
    if hist:
        print(f"steps {hist[0]['step']}..{hist[-1]['step']} on {dev}  "
              f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}  "
              f"({sum(h['sec'] for h in hist):.0f}s, "
              f"{len(out['breaches'])} straggler flags)")
    check(all(math.isfinite(h["loss"]) for h in hist), "a loss is not finite")
    return {"device": str(dev), "resumed_from": resumed, "history": hist,
            "breaches": out["breaches"], "step": trainer.step,
            "ckpt_dir": args.ckpt_dir}


if __name__ == "__main__":
    main()
