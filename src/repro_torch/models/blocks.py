"""Per-layer blocks (attn / ssm / rglru, dense or MoE FFN).

A layer is a :class:`Block` whose children carry the JAX package's keys
(``ln1``, ``attn``/``ssm``/``rglru``, ``ln2``, ``mlp``/``moe``); the
functions below are the reference's, on those children. The serving
paths take ``tp`` (a ``layers.TensorParallel``) to run one rank's part
across the model ranks of a grid; None is the one-device path.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import (
    attention_block, decode_attention, init_attn, kv_to_ring_cache,
)
from repro_torch.models.layers import init_norm, norm_apply
from repro_torch.models.mlp import init_swiglu, swiglu
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.rglru import (
    _rglru_inner, init_rglru, init_rglru_state, rglru_block,
    rglru_decode_step,
)
from repro_torch.models.ssm import (
    _ssm_inner, init_ssm, init_ssm_state, ssm_block, ssm_decode_step,
)

__all__ = ["init_layer", "apply_layer", "apply_layer_decode",
           "apply_layer_prefill", "init_layer_cache", "Block"]


class Block(nn.Module):
    """One layer: its children under the reference's keys."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)


def _ffn_init(gen, cfg) -> dict:
    if cfg.n_experts:
        return {"moe": init_moe(gen, cfg)}
    return {"mlp": init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.pdt)}


def _ffn_apply(p: Block, x, cfg, tp=None):
    if hasattr(p, "moe"):
        return moe_block(p.moe, x, cfg, tp)
    return swiglu(p.mlp, x, tp), torch.zeros((), dtype=torch.float32,
                                         device=x.device)


def init_layer(gen: torch.Generator, cfg, kind: str) -> Block:
    nk, dev = cfg.norm, gen.device

    def norm():
        return init_norm(cfg.d_model, cfg.pdt, nk, device=dev)

    if kind in ("attn", "swa"):
        return Block(ln1=norm(), attn=init_attn(gen, cfg), ln2=norm(),
                     **_ffn_init(gen, cfg))
    if kind == "ssm":
        return Block(ln1=norm(), ssm=init_ssm(gen, cfg))
    if kind == "rglru":
        return Block(ln1=norm(), rglru=init_rglru(gen, cfg), ln2=norm(),
                     **_ffn_init(gen, cfg))
    raise ValueError(f"unknown layer kind {kind!r}")


def _window_for(kind: str, cfg) -> int:
    if kind == "swa" or (kind == "attn" and cfg.attention == "swa"):
        return cfg.window
    if kind == "attn" and cfg.layer_pattern:
        return cfg.window          # hybrid archs use local attention
    return 0


def apply_layer(p: Block, x, cfg, kind: str, positions=None):
    """Training path. Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "swa"):
        h = norm_apply(cfg.norm, p.ln1, x)
        att = attention_block(p.attn, h, cfg, positions=positions,
                              causal=True, window=_window_for(kind, cfg))
        x = x + att
        h2 = norm_apply(cfg.norm, p.ln2, x)
        f, aux = _ffn_apply(p, h2, cfg)
        x = x + f
    elif kind == "ssm":
        x = x + ssm_block(p.ssm, norm_apply(cfg.norm, p.ln1, x), cfg)
    elif kind == "rglru":
        x = x + rglru_block(p.rglru, norm_apply(cfg.norm, p.ln1, x), cfg)
        h2 = norm_apply(cfg.norm, p.ln2, x)
        f, aux = _ffn_apply(p, h2, cfg)
        x = x + f
    else:
        raise ValueError(kind)
    return x, aux


def apply_layer_prefill(p: Block, x, cfg, kind: str, max_len: int,
                        positions=None, tp=None):
    """Prefill path: like apply_layer but also builds this layer's cache."""
    if kind in ("attn", "swa"):
        h = norm_apply(cfg.norm, p.ln1, x, tp)
        w = _window_for(kind, cfg)
        att, k, v = attention_block(
            p.attn, h, cfg, positions=positions, causal=True,
            window=w, return_kv=True, tp=tp)
        S = min(max_len, w) if w else max_len
        ck, cv = kv_to_ring_cache(k, v, S)
        x = x + att
        h2 = norm_apply(cfg.norm, p.ln2, x, tp)
        f, _ = _ffn_apply(p, h2, cfg, tp)
        return x + f, {"k": ck, "v": cv}
    if kind == "ssm":
        out, tail, hs = _ssm_inner(p.ssm, norm_apply(cfg.norm, p.ln1, x, tp),
                                   cfg, tp=tp)
        return x + out, {"h": hs, "conv_tail": tail}
    if kind == "rglru":
        out, tail, hs = _rglru_inner(
            p.rglru, norm_apply(cfg.norm, p.ln1, x, tp), cfg, tp=tp)
        x = x + out
        h2 = norm_apply(cfg.norm, p.ln2, x, tp)
        f, _ = _ffn_apply(p, h2, cfg, tp)
        return x + f, {"hr": hs, "conv_tail": tail}
    raise ValueError(kind)


def init_layer_cache(cfg, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype, *, device: torch.device) -> dict:
    if kind in ("attn", "swa"):
        w = _window_for(kind, cfg)
        S = min(max_len, w) if w else max_len
        shp = (batch, S, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shp, dtype=dtype, device=device),
                "v": torch.zeros(shp, dtype=dtype, device=device)}
    if kind == "ssm":
        return init_ssm_state(cfg, batch, dtype, device=device)
    if kind == "rglru":
        return init_rglru_state(cfg, batch, dtype, device=device)
    raise ValueError(kind)


def apply_layer_decode(p: Block, x_t, cache: dict, t: int, cfg, kind: str,
                       tp=None):
    """Single-token decode. Returns (x_t, new_cache); an attention layer's
    cache tensors are written in place."""
    if kind in ("attn", "swa"):
        h = norm_apply(cfg.norm, p.ln1, x_t, tp)
        w = _window_for(kind, cfg)
        att, ck, cv = decode_attention(p.attn, h, cache["k"], cache["v"],
                                       t, cfg, window=w, tp=tp)
        x_t = x_t + att
        h2 = norm_apply(cfg.norm, p.ln2, x_t, tp)
        f, _ = _ffn_apply(p, h2, cfg, tp)
        return x_t + f, {"k": ck, "v": cv}
    if kind == "ssm":
        out, st = ssm_decode_step(
            p.ssm, norm_apply(cfg.norm, p.ln1, x_t, tp), cache, cfg, tp)
        return x_t + out, st
    if kind == "rglru":
        out, st = rglru_decode_step(
            p.rglru, norm_apply(cfg.norm, p.ln1, x_t, tp), cache, cfg, tp)
        x_t = x_t + out
        h2 = norm_apply(cfg.norm, p.ln2, x_t, tp)
        f, _ = _ffn_apply(p, h2, cfg, tp)
        return x_t + f, st
    raise ValueError(kind)
