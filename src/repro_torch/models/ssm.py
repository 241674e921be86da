"""Mamba-1 selective state-space block (falcon-mamba architecture).

x -> in_proj -> [x, z]; x -> causal depthwise conv1d -> SiLU ->
selective scan (input-dependent Δ, B, C; diagonal A) -> ·SiLU(z) -> out_proj.

The scan is the reference's: an outer loop over fixed-size chunks (the
reference's chunk-count rule, the chunks sliced as views), each chunk
rematerialized under a non-reentrant ``torch.utils.checkpoint`` while
gradients are recorded, with the inner sequential recurrence one step a
position inside. Memory held for backward stays O(B·d_inner·d_state·
n_chunks) during training, plus one chunk's steps while that chunk is
recomputed; the steps and their arithmetic do not depend on the chunking,
so every chunking gives the same bits. Decode carries the recurrent state
and a (conv-1)-deep input tail.

Across model ranks (``tp``) in_proj's output interleaves x and z, so the
block runs gathered: every leaf but out_proj whole, the whole state on
every rank, and out_proj row-parallel on this rank's chunk of d_inner.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, dense, init_linear, normal

__all__ = ["init_ssm", "ssm_block", "ssm_decode_step", "init_ssm_state",
           "SSM", "softplus"]

CHUNK = 128


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) without F.softplus's switch to the identity above 20
    (jax.nn.softplus has none)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class SSM(nn.Module):
    """``in_proj``, ``conv_w`` (K, DI), ``conv_b``, ``x_proj``,
    ``dt_proj``, the f32 ``A_log`` (DI, S) and ``D`` (DI,), ``out_proj``."""

    def __init__(self, in_proj: Linear, conv_w, conv_b, x_proj: Linear,
                 dt_proj: Linear, A_log, D, out_proj: Linear):
        super().__init__()
        self.in_proj = in_proj
        self.conv_w, self.conv_b = nn.Parameter(conv_w), nn.Parameter(conv_b)
        self.x_proj, self.dt_proj = x_proj, dt_proj
        self.A_log, self.D = nn.Parameter(A_log), nn.Parameter(D)
        self.out_proj = out_proj


def init_ssm(gen: torch.Generator, cfg) -> SSM:
    D, DI, R, S = cfg.d_model, cfg.d_inner, cfg.dt_rank, cfg.ssm_state
    dt, dev = cfg.pdt, gen.device
    A = torch.arange(1, S + 1, dtype=torch.float32, device=dev)[None, :] \
        .repeat(DI, 1)
    return SSM(
        in_proj=init_linear(gen, D, 2 * DI, dt),
        conv_w=(normal(gen, (cfg.ssm_conv, DI))
                * (cfg.ssm_conv * DI) ** -0.5).to(dt),
        conv_b=torch.zeros((DI,), dtype=dt, device=dev),
        x_proj=init_linear(gen, DI, R + 2 * S, dt),
        dt_proj=init_linear(gen, R, DI, dt, bias=True),
        A_log=torch.log(A),                        # f32 (stability)
        D=torch.ones((DI,), dtype=torch.float32, device=dev),
        out_proj=init_linear(gen, DI, D, dt, scale=DI ** -0.5),
    )


def _conv1d_causal(w, b, x, tail=None):
    """Depthwise causal conv. x: (B, L, DI); w: (K, DI); tail: (B, K-1, DI)."""
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)
    out = sum(xp[:, i: i + x.shape[1]] * w[i][None, None, :].to(x.dtype)
              for i in range(K))
    return out + b.to(x.dtype), xp[:, -(K - 1):]


def n_chunks_of(L: int, chunk: int) -> int:
    """The reference's chunk count: L // chunk (at least 1), lowered until
    it divides L (L = 20, chunk 8 → 2 chunks of 10; a prime L → 1)."""
    n = max(1, L // chunk)
    while L % n:
        n -= 1
    return n


def chunked(step, carry, xs: tuple, L: int, chunk: int, remat: bool):
    """Run ``carry, ys = step(carry, *views)`` over the chunks of the time
    axis (dim 1) of every tensor of `xs`; returns (carry, ys of every
    chunk concatenated on dim 1). With `remat` and gradients recorded,
    each chunk runs under a non-reentrant checkpoint: its forward keeps
    only its inputs, and backward recomputes the chunk's steps."""
    ch = L // n_chunks_of(L, chunk)
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        def run(*args):
            return checkpoint(step, *args, use_reentrant=False,
                              preserve_rng_state=False)
    else:
        run = step
    ys = []
    for s in range(0, L, ch):
        carry, y = run(carry, *(x[:, s: s + ch] for x in xs))
        ys.append(y)
    return carry, (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1))


def _ssm_chunk(h, u, delta, Bc, Cc, negA):
    """The sequential steps of one chunk; returns (h, y (B, ch, DI))."""
    ys = []
    for t in range(u.shape[1]):
        dt_ = delta[:, t]
        dA = torch.exp(dt_[..., None] * negA)                # (B, DI, S)
        dBu = dt_[..., None] * Bc[:, t, None, :] * u[:, t, :, None]
        h = dA * h + dBu
        ys.append(torch.einsum("bds,bs->bd", h, Cc[:, t]))
    return h, torch.stack(ys, dim=1)


def _selective_scan(u, delta, Bc, Cc, A, D, h0, chunk=CHUNK, remat=True):
    """u: (B, L, DI); delta: (B, L, DI); Bc/Cc: (B, L, S); A: (DI, S).

    h_t = exp(Δ_t A)·h_{t-1} + Δ_t·B_t·u_t ;  y_t = C_t·h_t + D·u_t.
    Returns (y (B, L, DI) f32, h_final (B, DI, S) f32). The time axis runs
    in :func:`n_chunks_of` chunks, each rematerialized when `remat` is
    set and gradients are recorded.
    """
    negA = (-A)[None]
    h, y = chunked(lambda h, u, d, b, c: _ssm_chunk(h, u, d, b, c, negA),
                   h0, (u, delta, Bc, Cc), u.shape[1], chunk, remat)
    return y + u * D[None, None, :], h


def _ssm_inner(p: SSM, x, cfg, conv_tail=None, h0=None, tp=None):
    out_proj = p.out_proj
    if tp is not None:
        p = tp.gathered(p, skip=("out_proj",))
    B, L, _ = x.shape
    DI, R, S = cfg.d_inner, cfg.dt_rank, cfg.ssm_state
    xz = dense(p.in_proj, x)
    xs, z = torch.chunk(xz, 2, dim=-1)
    xs, new_tail = _conv1d_causal(p.conv_w, p.conv_b, xs, conv_tail)
    xs = F.silu(xs.float())
    proj = dense(p.x_proj, xs.to(x.dtype)).float()
    dt_in, Bc, Cc = torch.split(proj, [R, S, S], dim=-1)
    delta = softplus(dt_in @ p.dt_proj.w.float() + p.dt_proj.b.float())
    A = torch.exp(p.A_log)
    if h0 is None:
        h0 = torch.zeros((B, DI, S), dtype=torch.float32, device=x.device)
    # the reference's arguments: the config's chunk, and remat unless the
    # policy is "none" (cfg.remat itself is not read here)
    y, h = _selective_scan(xs, delta, Bc, Cc, A, p.D, h0,
                           chunk=cfg.ssm_chunk,
                           remat=cfg.remat_policy != "none")
    y = (y * F.silu(z.float())).to(x.dtype)
    out = dense(out_proj, y) if tp is None else tp.rows_of(out_proj, y)
    return out, new_tail, h


def ssm_block(p: SSM, x, cfg):
    out, _, _ = _ssm_inner(p, x, cfg)
    return out


def init_ssm_state(cfg, batch: int, dtype: torch.dtype, *,
                   device: torch.device) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv_tail": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                                 dtype=dtype, device=device),
    }


def ssm_decode_step(p: SSM, x_t, state: dict, cfg, tp=None):
    """x_t: (B, 1, D). Returns (out (B, 1, D), new state)."""
    out, tail, h = _ssm_inner(p, x_t, cfg, conv_tail=state["conv_tail"],
                              h0=state["h"], tp=tp)
    return out, {"h": h, "conv_tail": tail}
