"""Gradient compression for the explicit-collective DP path.

int8 block quantization with stochastic rounding: each 256-value block
carries an f32 scale; gathering the int8 payload cuts DP gradient traffic
4× against f32 (it composes with the training step in
:mod:`repro_torch.dist.collectives` — compress, all-gather, decompress).

The arithmetic is the JAX package's step for step (f32 division by the
scale, round half to even, clip to ±127), so given the same noise the
payload and scales are the reference's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), n


def compress_int8(x: torch.Tensor, generator: Optional[torch.Generator] = None,
                  *, noise: Optional[torch.Tensor] = None) -> tuple:
    """f32 tensor -> (int8 payload (N/B, B), f32 scales (N/B,), meta).

    The rounding noise is `noise` (shape (N/B, B), f32) when given, else
    U(−0.5, 0.5) drawn from `generator` (on x's device)."""
    flat, n = _pad_to_block(x.to(torch.float32))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = blocks / scale
    if noise is None:
        if generator is None:
            raise ValueError("compress_int8 needs a generator or noise=")
        noise = torch.rand(q.shape, generator=generator,
                           dtype=torch.float32, device=q.device) - 0.5
    elif tuple(noise.shape) != tuple(q.shape):
        raise ValueError(f"noise of shape {tuple(noise.shape)} for "
                         f"{tuple(q.shape)} blocks")
    q8 = torch.clamp(torch.round(q + noise), -127, 127).to(torch.int8)
    return q8, scale[:, 0], (tuple(x.shape), n)


def decompress_int8(q8: torch.Tensor, scale: torch.Tensor, meta
                    ) -> torch.Tensor:
    shape, n = meta
    flat = (q8.to(torch.float32) * scale[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)
