"""AdamW with decoupled weight decay and global-norm clipping.

Moments are kept in f32 regardless of param dtype (bf16 training safety);
the update is computed in f32 and cast back. The state holds one moment
tensor per parameter name (the names of the model's ``named_parameters``,
which :mod:`repro_torch.convert` maps to the reference's leaves), not
torch's ``optimizer.state``, so the checkpoint treats it like the
parameters.

:func:`adamw_update` writes the parameters and the moments in place (the
parameters are the model's ``nn.Parameter``s). A caller that keeps a copy
of either across an update — a checkpoint snapshot — must take a finished
host copy first.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Union

import torch
from torch import nn

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor                      # () int32
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def named(params: Params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a model's parameters or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: Params, moments_dtype=torch.float32) -> OptState:
    """Zero moments beside each parameter; moments_dtype=bfloat16 halves
    optimizer memory and checkpoint traffic (the update math still runs
    in f32)."""
    leaves = named(params)
    mu = {k: torch.zeros(p.shape, dtype=moments_dtype, device=p.device)
          for k, p in leaves.items()}
    nu = {k: torch.zeros_like(m) for k, m in mu.items()}
    dev = next(iter(leaves.values())).device if leaves else None
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=mu, nu=nu)


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the f32 sum of squares, leaf by leaf in the mapping's
    order (the trainer passes the reference's flatten order)."""
    leaves = list(tree.values())
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else None)
    for g in leaves:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: OptState,
                 params: Params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0):
    """One step: writes `params` and the moments in place; returns
    (params, new_state, metrics). `grads` has a tensor for every name of
    `params`, in the order the gradient norm sums them."""
    leaves = named(params)
    if set(grads) != set(leaves):
        raise ValueError(f"gradients for {sorted(set(grads) ^ set(leaves))} "
                         f"do not match the parameters")
    gnorm = global_norm(grads)
    scale = torch.clamp_max(clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for name, g in grads.items():
        p, m, v = leaves[name], state.mu[name], state.nu[name]
        g = g.to(torch.float32) * scale
        m2 = b1 * m.to(torch.float32) + (1 - b1) * g
        v2 = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m2 / c1
        vhat = v2 / c2
        delta = mhat / (torch.sqrt(vhat) + eps) + \
            weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * delta
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), {
        "grad_norm": gnorm, "clip_scale": scale}
