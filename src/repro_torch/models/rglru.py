"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427).

Block: x -> [linear branch with GELU gate] ∥ [linear -> causal conv1d ->
RG-LRU] -> multiply -> out linear.

RG-LRU (diagonal gated linear recurrence):
    r_t = σ(W_a x_t + b_a)                  (recurrence gate)
    i_t = σ(W_x x_t + b_x)                  (input gate)
    a_t = a^(c·r_t)  with  a = σ(Λ), c = 8
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The scan is chunked and rematerialized as ssm.py's, with two quirks of
the reference's kept: the chunk is this module's ``CHUNK``, not
``cfg.ssm_chunk``, and the chunks are checkpointed whatever the config's
remat policy (while gradients are recorded; with none recorded there is
nothing to keep). Decode carries (h, conv tail).

Across model ranks (``tp``) the gates mix the whole width, so the block
runs gathered: every leaf but ``out`` whole, the whole state on every
rank, and ``out`` row-parallel on this rank's chunk of the width.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    Linear, dense, init_linear, normal, uniform,
)
from repro_torch.models.ssm import _conv1d_causal, chunked, softplus

__all__ = ["init_rglru", "rglru_block", "rglru_decode_step",
           "init_rglru_state", "RGLRU"]

C_CONST = 8.0
CHUNK = 128


class RGLRU(nn.Module):
    """``in_x``, ``in_y``, ``conv_w`` (4, W), ``conv_b``, the f32 gates
    ``gate_a`` and ``gate_x``, the f32 ``lambda`` (W,) and ``out``."""

    def __init__(self, in_x: Linear, in_y: Linear, conv_w, conv_b,
                 gate_a: Linear, gate_x: Linear, lam, out: Linear):
        super().__init__()
        self.in_x, self.in_y = in_x, in_y
        self.conv_w, self.conv_b = nn.Parameter(conv_w), nn.Parameter(conv_b)
        self.gate_a, self.gate_x = gate_a, gate_x
        self.register_parameter("lambda", nn.Parameter(lam))
        self.out = out


def init_rglru(gen: torch.Generator, cfg) -> RGLRU:
    D, W = cfg.d_model, cfg.lru_width
    dt, dev = cfg.pdt, gen.device
    in_x = init_linear(gen, D, W, dt)
    in_y = init_linear(gen, D, W, dt)
    conv_w = (normal(gen, (4, W)) * (4 * W) ** -0.5).to(dt)
    gate_a = init_linear(gen, W, W, torch.float32, bias=True)
    # Λ init so a = σ(Λ) ∈ (0.9, 0.999) (paper's stable range)
    u = 0.9 + (0.999 - 0.9) * uniform(gen, (W,))
    lam = torch.log(u ** (1.0 / C_CONST) / (1 - u ** (1.0 / C_CONST)))
    gate_x = init_linear(gen, W, W, torch.float32, bias=True)
    out = init_linear(gen, W, D, dt, scale=W ** -0.5)
    return RGLRU(in_x, in_y, conv_w, torch.zeros((W,), dtype=dt, device=dev),
                 gate_a, gate_x, lam, out)


def _rglru_scan(p: RGLRU, xs, h0):
    """xs: (B, L, W) f32. Returns (y (B, L, W) f32, h_final)."""
    r = torch.sigmoid(xs @ p.gate_a.w + p.gate_a.b)
    i = torch.sigmoid(xs @ p.gate_x.w + p.gate_x.b)
    log_a = -C_CONST * softplus(getattr(p, "lambda"))[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xs)
    h, y = chunked(_rglru_chunk, h0, (a, gated), xs.shape[1], CHUNK, True)
    return y, h


def _rglru_chunk(h, a, gated):
    """The sequential steps of one chunk; returns (h, h of every step)."""
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gated[:, t]
        ys.append(h)
    return h, torch.stack(ys, dim=1)


def _rglru_inner(p: RGLRU, x, cfg, conv_tail=None, h0=None, tp=None):
    out_lin = p.out
    if tp is not None:
        p = tp.gathered(p, skip=("out",))
    B, L, _ = x.shape
    W = cfg.lru_width
    y_branch = F.gelu(dense(p.in_y, x).float(), approximate="tanh")
    xs = dense(p.in_x, x)
    xs, new_tail = _conv1d_causal(p.conv_w, p.conv_b, xs, conv_tail)
    if h0 is None:
        h0 = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    h_seq, h = _rglru_scan(p, xs.float(), h0)
    out = (h_seq * y_branch).to(x.dtype)
    out = dense(out_lin, out) if tp is None else tp.rows_of(out_lin, out)
    return out, new_tail, h


def rglru_block(p: RGLRU, x, cfg):
    out, _, _ = _rglru_inner(p, x, cfg)
    return out


def init_rglru_state(cfg, batch: int, dtype: torch.dtype, *,
                     device: torch.device) -> dict:
    return {
        "hr": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                          device=device),
        "conv_tail": torch.zeros((batch, 3, cfg.lru_width), dtype=dtype,
                                 device=device),
    }


def rglru_decode_step(p: RGLRU, x_t, state: dict, cfg, tp=None):
    out, tail, h = _rglru_inner(p, x_t, cfg, conv_tail=state["conv_tail"],
                                h0=state["hr"], tp=tp)
    return out, {"hr": h, "conv_tail": tail}
