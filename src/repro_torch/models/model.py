"""Model top level: init / train forward / prefill / decode for all families.

Decoder-only (dense, MoE, SSM, hybrid, VLM-backbone) and encoder-decoder
(whisper) assemblies. :class:`LM` holds one :class:`~repro_torch.models.
blocks.Block` a layer in an ``nn.ModuleList``, whatever layout the JAX
package stacks its parameters in (``layers``, ``groups``/``tail`` or
``layers_list``; :mod:`repro_torch.convert` reads and writes all three).
The functions keep the reference's signatures with the model in place of
the parameter tree. The training stack honours the config's remat policy
as the reference does (:func:`_remat_wrap`: ``"full"`` recomputes each
layer in the backward pass, ``"dots"`` keeps the matmul outputs); remat
changes no value. A cache is ``{"list": [one dict a layer]}``, or
``{"dec": [...]}`` for the encoder-decoder; decode writes attention
caches in place.

``prefill`` and ``decode_step`` take ``grid=`` (a ``launch.mesh.HostGrid``)
to run one rank's part of a model sharded over its "model" axis by
``dist.sharding.shard_lm``: the vocab-split embedding is a masked local
lookup summed over the ranks, the vocab-split logits are gathered whole
before anyone takes an argmax, and each layer runs as its module says
(``layers.TensorParallel``). Their collectives are recorded in the grid's
"prefill" and "decode" logs. With no grid, or a model size of 1, the
one-device path runs unchanged.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.context import resolve_device
from repro_torch.models.attention import (
    _rank_part, _split_heads, attention_block, decode_attention, init_attn,
    kv_to_ring_cache,
)
from repro_torch.models.blocks import (
    Block, apply_layer, apply_layer_decode, apply_layer_prefill, init_layer,
    init_layer_cache,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    SHAPES_ONLY, Linear, Norm, TensorParallel, dense, held_dim, init_linear,
    init_norm, norm_apply, normal, sinusoidal_position_at,
    sinusoidal_positions,
)
from repro_torch.models.mlp import gelu_mlp, init_gelu_mlp

__all__ = ["LM", "init_params", "forward_train", "loss_fn", "init_cache",
           "prefill", "decode_step"]

Batch = Dict[str, torch.Tensor]


class LM(nn.Module):
    """``tok_embed`` (V, D), ``ln_f``, ``lm_head`` and either ``layers``
    (decoder-only) or ``enc`` (``layers``, ``ln_post``) and ``dec``
    (``layers``) for the encoder-decoder."""

    def __init__(self, tok_embed: torch.Tensor, ln_f: Norm, lm_head: Linear,
                 layers: list | None = None, enc: nn.ModuleDict | None = None,
                 dec: nn.ModuleDict | None = None):
        super().__init__()
        self.tok_embed = nn.Parameter(tok_embed)
        self.ln_f, self.lm_head = ln_f, lm_head
        if layers is not None:
            self.layers = nn.ModuleList(layers)
        if enc is not None:
            self.enc, self.dec = enc, dec


# The model stands where the reference's parameter tree does: every
# function here takes an LM in place of the reference's Params dict.
Params = LM


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda") -> LM:
    """The model at `cfg`'s shapes, dtypes and init scales on `device`
    (default the card; raises without CUDA), drawn from `generator` (on
    that device; default one seeded 0). On ``device="meta"`` nothing is
    drawn: the model has the shapes and dtypes only."""
    dev = resolve_device(device)
    if dev.type == "meta":
        if generator is not None:
            raise ValueError("a model on the meta device draws nothing")
        generator = SHAPES_ONLY
    gen = generator if generator is not None \
        else torch.Generator(device=dev).manual_seed(0)
    if torch.device(gen.device).type != dev.type:
        raise ValueError(f"the generator is on {gen.device}, the model "
                         f"goes to {dev}")
    tok_embed = (normal(gen, (cfg.vocab_size, cfg.d_model)) * 0.02
                 ).to(cfg.pdt)
    ln_f = init_norm(cfg.d_model, cfg.pdt, cfg.norm, device=gen.device)
    lm_head = init_linear(gen, cfg.d_model, cfg.vocab_size, cfg.pdt)
    if cfg.enc_dec:
        return LM(tok_embed, ln_f, lm_head, enc=_init_encoder(gen, cfg),
                  dec=_init_dec_layers(gen, cfg))
    kinds = cfg.layer_kinds
    return LM(tok_embed, ln_f, lm_head,
              layers=[init_layer(gen, cfg, kinds[i])
                      for i in range(cfg.n_layers)])


def _init_encoder(gen, cfg) -> nn.ModuleDict:
    def norm():
        return init_norm(cfg.d_model, cfg.pdt, cfg.norm, device=gen.device)

    layers = [Block(ln1=norm(), attn=init_attn(gen, cfg), ln2=norm(),
                    mlp=init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt))
              for _ in range(cfg.n_enc_layers)]
    return nn.ModuleDict({"layers": nn.ModuleList(layers),
                          "ln_post": norm()})


def _init_dec_layers(gen, cfg) -> nn.ModuleDict:
    def norm():
        return init_norm(cfg.d_model, cfg.pdt, cfg.norm, device=gen.device)

    layers = [Block(ln1=norm(), self_attn=init_attn(gen, cfg), ln_x=norm(),
                    cross_attn=init_attn(gen, cfg, cross=True), ln2=norm(),
                    mlp=init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, cfg.pdt))
              for _ in range(cfg.n_layers)]
    return nn.ModuleDict({"layers": nn.ModuleList(layers)})


# --------------------------------------------------------------------------
# stacks (train)
# --------------------------------------------------------------------------

# the matmuls without batch dimensions (x @ w of a dense layer): what
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _remat_wrap(fn, cfg):
    """Apply the configured remat policy to a layer function."""
    if not cfg.remat or cfg.remat_policy == "none":
        return fn
    from torch.utils.checkpoint import (
        checkpoint, create_selective_checkpoint_contexts,
    )
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_SAVED_DOTS))
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")

    def wrapped(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, **kw, **kwargs)
    return wrapped


def _run_stack(model: LM, x, cfg, positions=None):
    """Returns (x, total_aux)."""
    kinds = cfg.layer_kinds
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = _remat_wrap(apply_layer, cfg) if torch.is_grad_enabled() \
        else apply_layer
    for i, lp in enumerate(model.layers):
        x, a = layer(lp, x, cfg, kinds[i], positions=positions)
        aux_total = aux_total + a
    return x, aux_total


def _encode_frames(model: LM, frames, cfg, tp=None):
    """Whisper encoder over stub frame embeddings (B, S, D)."""
    x = frames.to(cfg.adt)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, cfg.adt,
                                 device=x.device)[None]
    for lp in model.enc["layers"]:
        h = norm_apply(cfg.norm, lp.ln1, x, tp)
        x = x + attention_block(lp.attn, h, cfg, causal=False,
                                use_rope=False, tp=tp)
        h2 = norm_apply(cfg.norm, lp.ln2, x, tp)
        x = x + gelu_mlp(lp.mlp, h2, tp)
    return norm_apply(cfg.norm, model.enc["ln_post"], x, tp)


def _decoder_stack_encdec(model: LM, x, memory, cfg):
    for lp in model.dec["layers"]:
        h = norm_apply(cfg.norm, lp.ln1, x)
        x = x + attention_block(lp.self_attn, h, cfg, causal=True,
                                use_rope=False)
        hx = norm_apply(cfg.norm, lp.ln_x, x)
        x = x + attention_block(lp.cross_attn, hx, cfg, kv_x=memory,
                                use_rope=False)
        h2 = norm_apply(cfg.norm, lp.ln2, x)
        x = x + gelu_mlp(lp.mlp, h2)
    return x


def _embed(model: LM, tokens, cfg, tp=None):
    # gather, then cast: the reference casts the table first, same values
    table = model.tok_embed
    if tp is None or held_dim(table) is None:
        return table[tokens].to(cfg.adt)
    # this rank's vocab rows; a token elsewhere looks up zeros, so the f32
    # sum over the ranks is the one row, exactly
    n = table.shape[0]
    idx = tokens.long() - tp.rank * n
    inside = (idx >= 0) & (idx < n)
    rows = table[idx.clamp(0, n - 1)].float()
    rows = torch.where(inside[..., None], rows, torch.zeros((), device=rows
                                                            .device))
    return tp.reduce(rows, cfg.adt)


def _logits(model: LM, x, tp=None):
    """f32 logits of `x`; the vocab-split head's gathered whole."""
    head = model.lm_head
    if tp is None or held_dim(head.w) is None:
        return dense(head, x).float()
    part = dense(tp.columns(head), x).float()
    from repro_torch.dist import comm
    whole = comm.all_gather(tp.grid, part.movedim(-1, 0), book=tp.book)
    return whole.movedim(0, -1)


def _tp(grid, book: str):
    """This rank's TensorParallel on `grid` (None without one)."""
    if grid is None or grid.model == 1:
        return None
    return TensorParallel(grid, book)


# --------------------------------------------------------------------------
# train forward / loss
# --------------------------------------------------------------------------

def forward_train(model: LM, batch: Batch, cfg: ModelConfig):
    """Returns (logits (B, L, V) f32, aux_loss)."""
    tokens = batch["tokens"]
    B, L = tokens.shape
    x = _embed(model, tokens, cfg)
    dev = x.device

    if cfg.enc_dec:
        memory = _encode_frames(model, batch["frames"], cfg)
        x = x + sinusoidal_positions(L, cfg.d_model, cfg.adt,
                                     device=dev)[None]
        x = _decoder_stack_encdec(model, x, memory, cfg)
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        positions = torch.arange(L, device=dev)[None, :]
        vision = cfg.frontend == "vision" and "patch_embeds" in batch
        if vision:
            pe = batch["patch_embeds"].to(cfg.adt)
            x = torch.cat([pe, x], dim=1)
            positions = torch.arange(x.shape[1], device=dev)[None, :]
        x, aux = _run_stack(model, x, cfg, positions=positions)
        if vision:
            x = x[:, -L:]
    x = norm_apply(cfg.norm, model.ln_f, x)
    logits = dense(model.lm_head, x).float()
    return logits, aux


def loss_fn(model: LM, batch: Batch, cfg: ModelConfig):
    logits, aux = forward_train(model, batch, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels_safe = torch.clamp_min(labels, 0).long()
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels_safe[..., None], dim=-1)[..., 0]
    loss = (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux, "tokens": mask.sum()}


# --------------------------------------------------------------------------
# serving: cache init / prefill / decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """An empty cache on `device` (default the card; raises without
    CUDA)."""
    dev = resolve_device(device)
    dtype = cfg.adt
    if cfg.enc_dec:
        shp = (batch, max_len, cfg.n_kv_heads, cfg.hd)
        xshp = (batch, enc_len, cfg.n_kv_heads, cfg.hd)
        return {"dec": [
            {"k": torch.zeros(shp, dtype=dtype, device=dev),
             "v": torch.zeros(shp, dtype=dtype, device=dev),
             "xk": torch.zeros(xshp, dtype=dtype, device=dev),
             "xv": torch.zeros(xshp, dtype=dtype, device=dev)}
            for _ in range(cfg.n_layers)]}
    kinds = cfg.layer_kinds
    return {"list": [init_layer_cache(cfg, kinds[i], batch, max_len, dtype,
                                      device=dev)
                     for i in range(cfg.n_layers)]}


@torch.no_grad()
def prefill(model: LM, batch: Batch, cfg: ModelConfig, max_len: int, *,
            grid=None):
    """Run the prompt, build the cache. Returns (last-token logits, cache).

    Patch embeddings are not prepended here, as in the reference (only
    forward_train reads them). With `grid`, this rank's part of a sharded
    model (see the module docstring)."""
    tp = _tp(grid, "prefill")
    tokens = batch["tokens"]
    B, L = tokens.shape
    x = _embed(model, tokens, cfg, tp)
    dev = x.device
    kinds = cfg.layer_kinds

    if cfg.enc_dec:
        memory = _encode_frames(model, batch["frames"], cfg, tp)
        x = x + sinusoidal_positions(L, cfg.d_model, cfg.adt,
                                     device=dev)[None]
        caches = []
        for lp in model.dec["layers"]:
            h = norm_apply(cfg.norm, lp.ln1, x, tp)
            att, k, v = attention_block(lp.self_attn, h, cfg, causal=True,
                                        use_rope=False, return_kv=True,
                                        tp=tp)
            ck, cv = kv_to_ring_cache(k, v, max_len)
            x = x + att
            hx = norm_apply(cfg.norm, lp.ln_x, x, tp)
            xatt, xk, xv = attention_block(lp.cross_attn, hx, cfg,
                                           kv_x=memory, use_rope=False,
                                           return_kv=True, tp=tp)
            x = x + xatt
            h2 = norm_apply(cfg.norm, lp.ln2, x, tp)
            x = x + gelu_mlp(lp.mlp, h2, tp)
            caches.append({"k": ck, "v": cv, "xk": xk, "xv": xv})
        x = norm_apply(cfg.norm, model.ln_f, x, tp)
        return _logits(model, x[:, -1:], tp), {"dec": caches}

    positions = torch.arange(L, device=dev)[None, :]
    caches = []
    for i, lp in enumerate(model.layers):
        x, c = apply_layer_prefill(lp, x, cfg, kinds[i], max_len,
                                   positions=positions, tp=tp)
        caches.append(c)
    x = norm_apply(cfg.norm, model.ln_f, x, tp)
    return _logits(model, x[:, -1:], tp), {"list": caches}


@torch.no_grad()
def decode_step(model: LM, cache: dict, token_t: torch.Tensor, t: int,
                cfg: ModelConfig, *, grid=None):
    """One decode step. token_t: (B, 1) int; t: current position (an int).

    Returns (logits (B, 1, V), new_cache). With `grid`, this rank's part
    of a sharded model and its cache (see the module docstring)."""
    tp = _tp(grid, "decode")
    x = _embed(model, token_t, cfg, tp)
    kinds = cfg.layer_kinds

    if cfg.enc_dec:
        pos = sinusoidal_position_at(t, cfg.d_model, cfg.adt,
                                     device=x.device)[None, None]
        x = x + pos
        new = []
        for lp, c in zip(model.dec["layers"], cache["dec"]):
            h = norm_apply(cfg.norm, lp.ln1, x, tp)
            att, ck, cv = decode_attention(lp.self_attn, h, c["k"], c["v"],
                                           t, cfg, use_rope=False, tp=tp)
            x = x + att
            hx = norm_apply(cfg.norm, lp.ln_x, x, tp)
            # cross attention: static memory, no causal mask
            x = x + _cross_decode(lp.cross_attn, hx, c["xk"], c["xv"], cfg,
                                  tp)
            h2 = norm_apply(cfg.norm, lp.ln2, x, tp)
            x = x + gelu_mlp(lp.mlp, h2, tp)
            new.append({"k": ck, "v": cv, "xk": c["xk"], "xv": c["xv"]})
        x = norm_apply(cfg.norm, model.ln_f, x, tp)
        return _logits(model, x, tp), {"dec": new}

    new_list = []
    for i, (lp, c) in enumerate(zip(model.layers, cache["list"])):
        x, c2 = apply_layer_decode(lp, x, c, t, cfg, kinds[i], tp)
        new_list.append(c2)
    x = norm_apply(cfg.norm, model.ln_f, x, tp)
    return _logits(model, x, tp), {"list": new_list}


def _cross_decode(p, x_t, xk, xv, cfg, tp=None):
    """Decode-time cross attention against static encoder memory (this
    rank's KV heads under `tp`)."""
    if tp is not None:
        p, cfg, tp = _rank_part(p, cfg, tp)
    B = x_t.shape[0]
    hd = cfg.hd
    q = _split_heads(dense(p.wq, x_t), cfg.n_heads, hd)
    Hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    qf = (q.float() * hd ** -0.5).reshape(B, Hkv, g, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qf, xk.float())
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, xv.float())
    o = o.to(x_t.dtype).reshape(B, 1, cfg.n_heads * hd)
    return dense(p.wo, o) if tp is None else tp.rows(p.wo, o)
