"""Deterministic synthetic LM data: counter-based, restart-reproducible.

Each global step's batch is a pure function of (seed, step) — no stateful
iterators — so a restarted job regenerates byte-identical batches. The
numpy stream is the JAX package's (``default_rng((seed, step))``, the
same draws in the same order), so both packages see the same batches.

The stream is a mixture of structured patterns (arithmetic mod-V walks and
repeats) so that a model can actually reduce loss on it, plus next-token
labels (shift folded in here, not in the model).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.context import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticLM", "make_batch_specs"]


class SyntheticLM:
    """Counter-based synthetic batches for any assigned architecture, as
    tensors on `device` (default the card; raises without CUDA)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq_len: int,
                 seed: int = 0, enc_len: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.enc_len = enc_len or 2 * seq_len if cfg.enc_dec else 0
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, step))
        B, L, V = self.batch, self.seq_len, cfg.vocab_size
        start = rng.integers(0, V, size=(B, 1))
        stride = rng.integers(1, 7, size=(B, 1))
        seq = (start + stride * np.arange(L + 1)[None, :]) % V
        noise_mask = rng.random((B, L + 1)) < 0.05
        noise = rng.integers(0, V, size=(B, L + 1))
        seq = np.where(noise_mask, noise, seq).astype(np.int32)
        out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if cfg.enc_dec:
            out["frames"] = rng.normal(
                size=(B, self.enc_len, cfg.d_model)).astype(np.float32)
        if cfg.frontend == "vision":
            out["patch_embeds"] = rng.normal(
                size=(B, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in out.items()}

    def shard_slice(self, batch: Dict[str, torch.Tensor], proc: int,
                    n_procs: int) -> Dict[str, torch.Tensor]:
        """Host-side per-process slicing for multi-process launches."""
        per = self.batch // n_procs
        return {k: v[proc * per:(proc + 1) * per] for k, v in batch.items()}


def make_batch_specs(cfg: ModelConfig, batch: int, seq_len: int,
                     enc_len: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Shape-and-dtype stand-ins for a training batch: tensors on the
    ``meta`` device (the reference returns ``jax.ShapeDtypeStruct``s)."""

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {
        "tokens": spec((batch, seq_len), torch.int32),
        "labels": spec((batch, seq_len), torch.int32),
    }
    if cfg.enc_dec:
        specs["frames"] = spec((batch, enc_len or seq_len, cfg.d_model),
                               torch.float32)
    if cfg.frontend == "vision":
        specs["patch_embeds"] = spec(
            (batch, cfg.n_frontend_tokens, cfg.d_model), torch.float32)
    return specs
