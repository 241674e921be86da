"""Learning-rate schedules."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  final_frac=0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to final_frac·peak, in f32 on the
    step's device (the CPU for a Python int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
