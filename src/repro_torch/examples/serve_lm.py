"""Batched LM serving demo: prefill + greedy decode with KV caches.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch llama3.2-1b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch falcon-mamba-7b

Runs the reduced config of the chosen architecture (any of the 10 assigned
ids), demonstrating the cache machinery across attention / SSM / hybrid
families, and verifies decode-vs-prefill consistency on the fly: decoding
the prompt token by token from an empty cache reproduces prefill's
last-position logits (within 2e-2). Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.context import resolve_device
from repro_torch.examples import check, wall
from repro_torch.launch.serve import generate
from repro_torch.models import decode_step, init_cache, init_params, prefill

DECODE_TOL = 2e-2


def decode_from_empty(model, cfg, batch: dict, max_len: int, cache=None):
    """The last logits of decoding batch["tokens"] step by step from an
    empty cache (the encoder-decoder's cross-attention memory taken from
    prefill's `cache`, as the reference's test does)."""
    toks = batch["tokens"]
    B, L = toks.shape
    dev = toks.device
    if cfg.enc_dec:
        empty = init_cache(cfg, B, max_len, enc_len=cache["dec"][0]["xk"]
                           .shape[1], device=dev)
        state = {"dec": [{**c2, "xk": c1["xk"], "xv": c1["xv"]}
                         for c1, c2 in zip(cache["dec"], empty["dec"])]}
    else:
        state = init_cache(cfg, B, max_len, device=dev)
    logits = None
    for t in range(L):
        logits, state = decode_step(model, state, toks[:, t: t + 1], t, cfg)
    return logits


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_lm")
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()
    rng = np.random.default_rng(0)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(args.batch, args.prompt_len)
    ).astype(np.int32)).to(dev)
    extra = {}
    if cfg.enc_dec:
        extra["frames"] = torch.from_numpy(rng.normal(
            size=(args.batch, 2 * args.prompt_len, cfg.d_model)
        ).astype(np.float32)).to(dev)
    if cfg.frontend == "vision":
        extra["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(args.batch, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)).to(dev)
    max_len = args.prompt_len + args.gen + 8

    t0 = wall(dev)
    out = generate(model, cfg, tokens, args.gen, max_len, batch_extra=extra)
    dt = wall(dev) - t0
    print(f"arch={args.arch} family generated {tuple(out.shape)} tokens "
          f"on {dev} in {dt:.1f}s ({args.batch * args.gen / dt:.1f} tok/s, "
          "first run)")
    print("first sequence:", out[0].cpu().numpy()[:16], "...")

    batch = {"tokens": tokens, **extra}
    with torch.no_grad():
        pre, cache = prefill(model, batch, cfg, max_len)
        dec = decode_from_empty(model, cfg, batch, max_len, cache)
    err = float((dec.float() - pre.float()).abs().max())
    ok = bool(((dec.float() - pre.float()).abs()
               <= DECODE_TOL + DECODE_TOL * pre.float().abs()).all())
    print(f"decode from an empty cache == prefill's last logits "
          f"(max |err| {err:.2e}, tolerance {DECODE_TOL})")
    check(ok, f"{args.arch}: decode differs from prefill by {err}")
    return {"device": str(dev), "arch": args.arch, "tokens": out.cpu(),
            "decode_vs_prefill": err, "s": dt}


if __name__ == "__main__":
    main()
