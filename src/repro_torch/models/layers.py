"""Shared layers: norms, RoPE, embeddings, initializers.

A parameter container is an ``nn.Module`` whose attribute names are the
JAX package's dict keys: :class:`Linear` holds ``w`` — in the reference's
``(d_in, d_out)`` orientation, so ``dense`` is ``x @ w`` — and an optional
bias ``b``; :class:`Norm` holds ``scale`` and, for layernorm, ``bias``.
Initializers draw from an explicit ``torch.Generator`` on its device; on
the ``meta`` device (:data:`SHAPES_ONLY` in place of the generator) they
draw nothing and give shapes only.

:class:`TensorParallel` is one rank's part in the tensor-parallel forward
over the "model" axis of a grid: the layers take it as ``tp`` (None: the
one-device path, unchanged) and split, reduce or gather through it.
"""

from __future__ import annotations

import dataclasses
import types

import torch
from torch import nn

__all__ = ["rmsnorm", "layernorm", "rope", "init_linear", "init_norm",
           "dense", "norm_apply", "sinusoidal_positions",
           "sinusoidal_position_at", "Linear", "Norm", "SHAPES_ONLY",
           "TensorParallel", "held_dim"]


class _ShapesOnly:
    """The generator of a model on the ``meta`` device: no draws."""

    device = torch.device("meta")


SHAPES_ONLY = _ShapesOnly()


def normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard normal draws in f32 on the generator's device."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def uniform(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform draws on [0, 1) in f32 on the generator's device."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device,
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


def norm_apply(kind: str, p: Norm, x: torch.Tensor, tp=None
               ) -> torch.Tensor:
    if tp is not None:
        p = tp.gathered(p)
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


# ---- tensor parallelism ----------------------------------------------------

def held_dim(t: torch.Tensor):
    """The dim along which this rank holds only its chunk of parameter `t`
    (``dist.sharding.shard_lm`` marks it), or None for a whole one."""
    return getattr(t, "model_dim", None)


class TensorParallel:
    """One rank's part in a forward split over the "model" axis of `grid`
    (a ``launch.mesh.HostGrid``); every collective goes through
    ``dist.comm`` into the grid's log `book`.

    Rank r's chunk of a dim of n is [r·n/R, (r+1)·n/R). A column-parallel
    product takes the chunk of a weight's output dim, a row-parallel one
    the chunk of its input dim and sums the ranks' partial products in f32
    (one cast after, the bias added once). A weight held split is gathered
    where a layer needs it whole."""

    def __init__(self, grid, book: str):
        self.grid, self.book = grid, book
        self.size, self.rank = grid.model, grid.model_rank

    def splits(self, *dims: int) -> bool:
        """Whether every one of `dims` divides into R chunks."""
        return all(n % self.size == 0 for n in dims)

    def whole(self, t: torch.Tensor, dim: int) -> int:
        """The size of `t`'s `dim` in the whole parameter."""
        return t.shape[dim] * (self.size if held_dim(t) == dim else 1)

    def local(self, t, dim: int):
        """This rank's chunk of `t` along `dim`: `t` itself where it is held
        split there, else a slice of the whole."""
        if t is None or held_dim(t) == dim:
            return t
        t = self.full(t)
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.rank * n, n)

    def full(self, t):
        """`t` whole: gathered over the model ranks where it is held
        split."""
        dim = held_dim(t) if t is not None else None
        if dim is None:
            return t
        from repro_torch.dist import comm
        out = comm.all_gather(self.grid, t.detach().movedim(dim, 0),
                              book=self.book)
        return out.movedim(0, dim)

    def gathered(self, module: nn.Module, skip: tuple = ()):
        """A view of `module` with the same attribute names and every
        parameter whole (the children named in `skip` as they are)."""
        out = {}
        for name, child in module.named_children():
            out[name] = child if name in skip else self.gathered(child)
        for name, p in module.named_parameters(recurse=False):
            out[name] = self.full(p)
        for name in ("b", "bias"):      # optional parameters left unset
            if name not in out and getattr(module, name, False) is None:
                out[name] = None
        return types.SimpleNamespace(**out)

    def columns(self, p: Linear) -> types.SimpleNamespace:
        """The column-parallel chunk of dense layer `p`."""
        return types.SimpleNamespace(w=self.local(p.w, p.w.dim() - 1),
                                     b=self.local(p.b, 0))

    def reduce(self, partial: torch.Tensor, dtype: torch.dtype
               ) -> torch.Tensor:
        """The f32 sum of every rank's `partial`, cast once to `dtype`."""
        from repro_torch.dist import comm
        return comm.all_reduce(self.grid, partial.float().contiguous(),
                               book=self.book).to(dtype)

    def rows(self, p: Linear, x_local: torch.Tensor) -> torch.Tensor:
        """Row-parallel dense: `x_local` (this rank's chunk of the input
        features) times its rows of ``p.w``, summed over the ranks in f32,
        cast once; the bias added once after."""
        w = self.local(p.w, p.w.dim() - 2)
        y = self.reduce(x_local.float() @ w.float(), x_local.dtype)
        if p.b is not None:
            y = y + self.full(p.b).to(y.dtype)
        return y

    def rows_of(self, p: Linear, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel dense of a whole input `x`: its chunk of the
        features through :meth:`rows` where they divide, else the whole
        layer gathered."""
        if not self.splits(x.shape[-1]):
            return dense(self.gathered(p), x)
        n = x.shape[-1] // self.size
        return self.rows(p, x.narrow(-1, self.rank * n, n))

    def local_heads(self, cfg):
        """`cfg` for this rank's heads (head_dim pinned), or None where
        the query or KV heads do not divide over the ranks."""
        if not self.splits(cfg.n_heads, cfg.n_kv_heads):
            return None
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // self.size,
                                   n_kv_heads=cfg.n_kv_heads // self.size,
                                   head_dim=cfg.hd)
