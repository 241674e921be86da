"""Mixture-of-Experts: top-k routing with capacity-bounded sort dispatch.

Expert weight tensors carry E as their leading axis; dispatch is
sort-based (no (T, E, C) one-hot blowup): assignments are argsorted by
expert (stable), positions within each expert computed by searchsorted,
tokens over capacity dropped into an overflow slot that is cut off.

Aux load-balancing loss (Switch-style) is returned alongside.
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


def moe_block(p: MoE, x: torch.Tensor, cfg):
    """x: (B, L, D) -> (y (B, L, D), aux_loss scalar)."""
    B, L, D = x.shape
    T = B * L
    E, k = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(T, D)

    logits = xt.float() @ p.router.w                              # (T, E)
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

    h = torch.einsum("ecd,edf->ecf", buf, p.wg.to(x.dtype))
    h = F.silu(h.float()).to(x.dtype)
    h = h * torch.einsum("ecd,edf->ecf", buf, p.wi.to(x.dtype))
    y_buf = torch.einsum("ecf,efd->ecd", h, p.wo.to(x.dtype))

    # combine back: each kept assignment gathers its expert output × gate
    y_assign = y_buf[slot_e, torch.clamp_max(slot_c, C - 1)]      # (T·k, D)
    w_assign = (gate.reshape(-1)[order] * keep).to(x.dtype)
    y = torch.zeros((T, D), dtype=x.dtype, device=dev).index_add_(
        0, tok, y_assign * w_assign[:, None])

    if p.dense is not None:
        y = y + swiglu(p.dense, xt)
    return y.reshape(B, L, D), aux
