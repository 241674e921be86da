"""Feed-forward blocks: SwiGLU (llama family) and GELU (whisper).

Across model ranks (``tp``) both are Megatron pairs where d_ff divides:
the columns of wi (and wg) then the rows of wo, one f32 all-reduce;
else the one-device code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, dense, init_linear

__all__ = ["init_swiglu", "swiglu", "init_gelu_mlp", "gelu_mlp", "SwiGLU",
           "GeluMLP"]


class SwiGLU(nn.Module):
    """``wi`` (up), ``wg`` (gate) and ``wo`` (down)."""

    def __init__(self, wi: Linear, wg: Linear, wo: Linear):
        super().__init__()
        self.wi, self.wg, self.wo = wi, wg, wo


class GeluMLP(nn.Module):
    """``wi`` and ``wo``, each with a bias."""

    def __init__(self, wi: Linear, wo: Linear):
        super().__init__()
        self.wi, self.wo = wi, wo


def init_swiglu(gen: torch.Generator, d_model: int, d_ff: int,
                dtype: torch.dtype) -> SwiGLU:
    return SwiGLU(
        wi=init_linear(gen, d_model, d_ff, dtype),
        wg=init_linear(gen, d_model, d_ff, dtype),
        wo=init_linear(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
    )


def swiglu(p: SwiGLU, x: torch.Tensor, tp=None) -> torch.Tensor:
    if tp is not None:
        if tp.splits(tp.whole(p.wi.w, 1)):
            wi, wg = tp.columns(p.wi), tp.columns(p.wg)
            h = F.silu(dense(wg, x).float()).to(x.dtype)
            return tp.rows(p.wo, h * dense(wi, x))
        p = tp.gathered(p)
    h = F.silu(dense(p.wg, x).float()).to(x.dtype)
    return dense(p.wo, h * dense(p.wi, x))


def init_gelu_mlp(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype: torch.dtype) -> GeluMLP:
    return GeluMLP(
        wi=init_linear(gen, d_model, d_ff, dtype, bias=True),
        wo=init_linear(gen, d_ff, d_model, dtype, bias=True,
                       scale=d_ff ** -0.5),
    )


def gelu_mlp(p: GeluMLP, x: torch.Tensor, tp=None) -> torch.Tensor:
    if tp is not None:
        if tp.splits(tp.whole(p.wi.w, 1)):
            h = F.gelu(dense(tp.columns(p.wi), x).float(),
                       approximate="tanh").to(x.dtype)
            return tp.rows(p.wo, h)
        p = tp.gathered(p)
    # jax.nn.gelu is the tanh approximation by default
    h = F.gelu(dense(p.wi, x).float(), approximate="tanh").to(x.dtype)
    return dense(p.wo, h)
