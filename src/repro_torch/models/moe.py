"""Mixture-of-Experts: top-k routing with capacity-bounded sort dispatch.

Expert weight tensors carry E as their leading axis; dispatch is
sort-based (no (T, E, C) one-hot blowup): assignments are argsorted by
expert (stable), positions within each expert computed by searchsorted,
tokens over capacity dropped into an overflow slot that is cut off.

Aux load-balancing loss (Switch-style) is returned alongside.

Across model ranks (``tp``) the router is gathered whole, so every rank
routes alike; where d_ff divides, each rank runs its columns of every
expert's wi/wg and rows of its wo, combines its partial outputs in f32
and sums them over the ranks (one all-reduce); the dense residual is its
own Megatron pair.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, init_linear, normal
from repro_torch.models.mlp import SwiGLU, init_swiglu, swiglu

__all__ = ["init_moe", "moe_block", "MoE"]


class MoE(nn.Module):
    """The f32 ``router``, the expert stacks ``wi``, ``wg`` (E, D, F) and
    ``wo`` (E, F, D), and the optional ``dense`` residual SwiGLU."""

    def __init__(self, router: Linear, wi: torch.Tensor, wg: torch.Tensor,
                 wo: torch.Tensor, dense: SwiGLU | None = None):
        super().__init__()
        self.router = router
        self.wi, self.wg, self.wo = (nn.Parameter(wi), nn.Parameter(wg),
                                     nn.Parameter(wo))
        self.dense = dense


def init_moe(gen: torch.Generator, cfg) -> MoE:
    E, D, Fw = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.pdt

    def expert_stack(d_in, d_out, scale):
        return normal(gen, (E, d_in, d_out)).to(dt) * scale

    router = init_linear(gen, D, E, torch.float32)
    wi = expert_stack(D, Fw, D ** -0.5)
    wg = expert_stack(D, Fw, D ** -0.5)
    wo = expert_stack(Fw, D, Fw ** -0.5)
    dense = init_swiglu(gen, D, cfg.dense_d_ff or cfg.d_ff, dt) \
        if cfg.moe_dense_residual else None
    return MoE(router, wi, wg, wo, dense)


def moe_block(p: MoE, x: torch.Tensor, cfg, tp=None):
    """x: (B, L, D) -> (y (B, L, D), aux_loss scalar)."""
    experts = (p.wi, p.wg, p.wo)
    split = tp is not None and tp.splits(tp.whole(p.wi, 2))
    if split:
        experts = (tp.local(p.wi, 2), tp.local(p.wg, 2), tp.local(p.wo, 1))
    elif tp is not None:
        experts = tuple(tp.full(w) for w in experts)
    wi, wg, wo = experts
    router = p.router.w if tp is None else tp.full(p.router.w)
    B, L, D = x.shape
    T = B * L
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(T, D)

    logits = xt.float() @ router                              # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                      # (T, k)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    # Switch aux loss: E · Σ_e f_e · P_e
    f = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, idx.reshape(-1), torch.ones(T * k, device=dev)) / (T * k)
    P = probs.mean(0)
    aux = E * torch.sum(f * P)

    C = max(1, int(cfg.capacity_factor * T * k / E))

    flat_e = idx.reshape(-1)                                      # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # rank within expert segment
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(T * k, device=dev) - first
    keep = pos < C
    tok = order // k                                              # token id
    slot_e = torch.where(keep, sorted_e, E - 1)
    slot_c = torch.where(keep, pos, C)                            # overflow->C

    buf = torch.zeros((E, C + 1, D), dtype=x.dtype, device=dev)
    buf[slot_e, slot_c] = xt[tok] * keep[:, None].to(x.dtype)
    buf = buf[:, :C]                                              # (E, C, D)

    h = torch.einsum("ecd,edf->ecf", buf, wg.to(x.dtype))
    h = F.silu(h.float()).to(x.dtype)
    h = h * torch.einsum("ecd,edf->ecf", buf, wi.to(x.dtype))
    # split: this rank's partial sums over its d_ff chunk, in f32
    ydt = torch.float32 if split else x.dtype
    y_buf = torch.einsum("ecf,efd->ecd", h.to(ydt), wo.to(ydt))

    # combine back: each kept assignment gathers its expert output × gate
    y_assign = y_buf[slot_e, torch.clamp_max(slot_c, C - 1)]      # (T·k, D)
    w_assign = (gate.reshape(-1)[order] * keep).to(ydt)
    y = torch.zeros((T, D), dtype=ydt, device=dev).index_add_(
        0, tok, y_assign * w_assign[:, None])
    if split:
        y = tp.reduce(y, x.dtype)

    if p.dense is not None:
        y = y + swiglu(p.dense, xt, tp)
    return y.reshape(B, L, D), aux
