"""GQA attention: blockwise-softmax training/prefill path + cached decode.

- Training/prefill: blockwise softmax (running max / normalizer) over KV
  blocks, in f32, with the JAX package's block-size rule. Causal, sliding-
  window (SWA / local), and bidirectional (encoder, cross) masks. This is
  the reference's ``jnp`` formulation, not a library attention call.
- Decode: one query position against a (possibly ring-buffered) KV cache,
  written in place.

Shapes: q (B, L, H, hd); k/v (B, S, Hkv, hd); GQA groups H into Hkv bands.

Across the model ranks of a grid (``tp``, a ``layers.TensorParallel``)
attention is Megatron-style where the query and KV heads both divide:
rank r runs heads [rH/R, (r+1)H/R) and KV heads [rHkv/R, …) on its
columns of wq/wk/wv (so the GQA map h // (H/Hkv) holds locally), keeps
those KV heads' cache, and sums its rows of wo over the ranks. Where the
heads do not divide, every projection is gathered whole and every rank
runs the one-device code with the whole cache.
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, dense, init_linear, rope

__all__ = ["NEG_INF", "Attention", "init_attn", "flash_attention",
           "attention_block", "kv_to_ring_cache", "decode_attention"]

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections ``wq``, ``wk``, ``wv`` and ``wo``."""

    def __init__(self, wq: Linear, wk: Linear, wv: Linear, wo: Linear):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def init_attn(gen: torch.Generator, cfg, d_model=None, cross=False
              ) -> Attention:
    d = d_model or cfg.d_model
    hd = cfg.hd
    return Attention(
        wq=init_linear(gen, d, cfg.n_heads * hd, cfg.pdt, bias=cfg.qkv_bias),
        wk=init_linear(gen, d, cfg.n_kv_heads * hd, cfg.pdt,
                       bias=cfg.qkv_bias),
        wv=init_linear(gen, d, cfg.n_kv_heads * hd, cfg.pdt,
                       bias=cfg.qkv_bias),
        wo=init_linear(gen, cfg.n_heads * hd, d, cfg.pdt,
                       scale=(cfg.n_heads * hd) ** -0.5),
    )


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _block_mask(q_pos, k_pos, causal, window) -> torch.Tensor:
    """(Qb, Kb) additive mask."""
    m = torch.zeros((q_pos.shape[0], k_pos.shape[0]), dtype=torch.float32,
                    device=q_pos.device)
    if causal:
        m = torch.where(k_pos[None, :] > q_pos[:, None], NEG_INF, m)
    if window and window > 0:
        m = torch.where(k_pos[None, :] <= q_pos[:, None] - window, NEG_INF, m)
    return m


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    block_q=512, block_k=512) -> torch.Tensor:
    """Blockwise-softmax attention.

    q: (B, Lq, H, hd); k, v: (B, Lk, Hkv, hd). Returns (B, Lq, H, hd).
    """
    B, Lq, H, hd = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    bq = min(block_q, Lq)
    while Lq % bq:
        bq -= 1
    bk = min(block_k, Lk)
    while Lk % bk:
        bk -= 1
    nq, nk = Lq // bq, Lk // bk
    dev = q.device

    scale = hd ** -0.5
    qf = (q.float() * scale).reshape(B, nq, bq, Hkv, g, hd)
    kf = k.float().reshape(B, nk, bk, Hkv, hd)
    vf = v.float().reshape(B, nk, bk, Hkv, hd)

    outs = []
    for qi in range(nq):
        qblk = qf[:, qi]                               # (B, bq, Hkv, g, hd)
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        m_run = torch.full((B, Hkv, g, bq), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, Hkv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, g, bq, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_pos = ki * bk + torch.arange(bk, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kf[:, ki])
            s = s + _block_mask(q_pos, k_pos, causal, window)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            alpha = torch.exp(m_run - m_new)
            p = torch.exp(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, ki])
            m_run = m_new
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None])
    # (B, nq, Hkv, g, bq, hd) -> (B, Lq, H, hd)
    out = torch.stack(outs, dim=1).permute(0, 2, 3, 1, 4, 5)
    return out.reshape(B, Hkv * g, nq * bq, hd).transpose(1, 2).to(q.dtype)


def _rank_part(p: Attention, cfg, tp):
    """(projections, cfg, tp) this rank runs attention with: its heads'
    columns of wq/wk/wv, wo as held, and their config; where the heads do
    not divide, the whole layer and no tp."""
    local = tp.local_heads(cfg)
    if local is None:
        return tp.gathered(p), cfg, None
    return (types.SimpleNamespace(wq=tp.columns(p.wq), wk=tp.columns(p.wk),
                                  wv=tp.columns(p.wv), wo=p.wo), local, tp)


def _out(p, o, tp):
    return dense(p.wo, o) if tp is None else tp.rows(p.wo, o)


def attention_block(p: Attention, x, cfg, *, positions=None, causal=True,
                    window=0, kv_x=None, use_rope=True, return_kv=False,
                    tp=None):
    """Full attention sub-layer (projections + blockwise core).

    kv_x: encoder memory for cross-attention (bidirectional, no rope).
    return_kv: also return the (rotated) k/v for prefill cache building.
    tp: this rank's part across the model ranks (None: one device).
    """
    if tp is not None:
        p, cfg, tp = _rank_part(p, cfg, tp)
    B, L, _ = x.shape
    hd = cfg.hd
    src = kv_x if kv_x is not None else x
    q = _split_heads(dense(p.wq, x), cfg.n_heads, hd)
    k = _split_heads(dense(p.wk, src), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p.wv, src), cfg.n_kv_heads, hd)
    if positions is None:
        positions = torch.arange(L, device=x.device)[None, :]
    if use_rope and kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal and kv_x is None,
                        window=window)
    out = _out(p, o.reshape(B, L, cfg.n_heads * hd), tp)
    if return_kv:
        return out, k, v
    return out


def kv_to_ring_cache(k, v, S: int):
    """Pack the last S positions of prefill k/v into the decode ring layout.

    decode_attention writes position t at slot t % S; after prefilling L
    tokens, position L-S+i must sit at slot (L-S+i) % S — a roll by L % S.
    """
    L = k.shape[1]
    if L <= S:
        pad = (0, 0, 0, 0, 0, S - L)
        return F.pad(k, pad), F.pad(v, pad)
    kw, vw = k[:, L - S:], v[:, L - S:]
    return (torch.roll(kw, L % S, dims=1), torch.roll(vw, L % S, dims=1))


# ---- decode path -----------------------------------------------------------

def decode_attention(p: Attention, x_t, cache_k, cache_v, t: int, cfg, *,
                     window=0, use_rope=True, tp=None):
    """One-token attention against the KV cache.

    x_t: (B, 1, D); cache_k/v: (B, S, Hkv, hd) (S = max context or window,
    ring-buffered when windowed; this rank's KV heads under `tp`); t:
    current absolute position (an int). The new key and value are written
    into cache_k/v in place. Returns (out (B, 1, D), cache_k, cache_v).
    """
    if tp is not None:
        p, cfg, tp = _rank_part(p, cfg, tp)
    B = x_t.shape[0]
    hd = cfg.hd
    S = cache_k.shape[1]
    dev = x_t.device
    q = _split_heads(dense(p.wq, x_t), cfg.n_heads, hd)
    k = _split_heads(dense(p.wk, x_t), cfg.n_kv_heads, hd)
    v = _split_heads(dense(p.wv, x_t), cfg.n_kv_heads, hd)
    if use_rope:
        pos = torch.full((B, 1), t, device=dev)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    # a linear cache keeps writing its last slot once t ≥ S, as the
    # reference's does
    slot = t % S if window else min(t, S - 1)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]

    Hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qf = (q.float() * hd ** -0.5).reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qf, cache_k.float())
    # valid slots: absolute position of slot i is i (linear cache) or within
    # the last `window` writes (ring cache)
    idx = torch.arange(S, device=dev)
    if window:
        age = (t % S - idx) % S            # steps since written
        valid = age < min(t + 1, S)
    else:
        valid = idx <= t
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, cache_v.float()).to(x_t.dtype)
    o = o.reshape(B, 1, cfg.n_heads * hd)
    return _out(p, o, tp), cache_k, cache_v
