"""Shared layers: norms, RoPE, embeddings, initializers.

A parameter container is an ``nn.Module`` whose attribute names are the
JAX package's dict keys: :class:`Linear` holds ``w`` — in the reference's
``(d_in, d_out)`` orientation, so ``dense`` is ``x @ w`` — and an optional
bias ``b``; :class:`Norm` holds ``scale`` and, for layernorm, ``bias``.
Initializers draw from an explicit ``torch.Generator`` on its device.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["rmsnorm", "layernorm", "rope", "init_linear", "init_norm",
           "dense", "norm_apply", "sinusoidal_positions",
           "sinusoidal_position_at", "Linear", "Norm"]


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal draws in f32 on the generator's device."""
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


class Linear(nn.Module):
    """A dense layer's weight ``w`` (d_in, d_out) and optional bias ``b``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor | None = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b) if b is not None else None


class Norm(nn.Module):
    """A norm's ``scale`` and, for layernorm, its ``bias``."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        self.scale = nn.Parameter(scale)
        self.bias = nn.Parameter(bias) if bias is not None else None


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, bias: bool = False,
                scale: float | None = None) -> Linear:
    scale = scale if scale is not None else d_in ** -0.5
    w = normal(gen, (d_in, d_out)) * scale
    b = torch.zeros((d_out,), dtype=dtype, device=gen.device) if bias \
        else None
    return Linear(w.to(dtype), b)


def init_norm(d: int, dtype: torch.dtype, kind: str = "rmsnorm", *,
              device: torch.device) -> Norm:
    scale = torch.ones((d,), dtype=dtype, device=device)
    bias = torch.zeros((d,), dtype=dtype, device=device) \
        if kind == "layernorm" else None
    return Norm(scale, bias)


def dense(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p.scale.float()).to(x.dtype)


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    # jnp.var is the population variance
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p.scale.float()
    if p.bias is not None:
        out = out + p.bias.float()
    return out.to(x.dtype)


def norm_apply(kind: str, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., L, H, hd); positions: (..., L)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., :, None].float() * freqs           # (..., L, half)
    cos = torch.cos(ang)[..., :, None, :]                    # (...,L,1,half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _sinusoid(ang: torch.Tensor, d: int) -> torch.Tensor:
    pe = torch.zeros(ang.shape[:-1] + (d,), dtype=torch.float32,
                     device=ang.device)
    pe[..., 0::2] = torch.sin(ang)
    pe[..., 1::2] = torch.cos(ang[..., : (d - d // 2)])
    return pe


def sinusoidal_positions(n: int, d: int, dtype: torch.dtype, *,
                         device: torch.device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / d))
    return _sinusoid(ang, d).to(dtype)


def sinusoidal_position_at(t, d: int, dtype: torch.dtype, *,
                           device: torch.device) -> torch.Tensor:
    """Single-position embedding at position t (an int). Returns (d,)."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    ang = float(t) / (10000.0 ** (dim / d))
    return _sinusoid(ang, d).to(dtype)
