"""Unified model configuration covering all 10 assigned architectures.

The JAX package's ``ModelConfig`` field for field, with the same defaults
and the same :meth:`ModelConfig.reduced`; :attr:`pdt` and :attr:`adt`
give torch dtypes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig"]


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    # core transformer dims
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: Optional[int] = None          # default d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    # attention
    attention: str = "full"                  # full | swa | none
    window: int = 4096                       # SWA / local-attn window
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    # norm / activation
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    # MoE
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False         # arctic: dense FFN in parallel
    dense_d_ff: int = 0                      # width of the dense residual FFN
    # SSM (mamba-1)
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid pattern: tuple like ("rglru", "rglru", "attn"); empty = uniform
    layer_pattern: Tuple[str, ...] = ()
    rglru_width: Optional[int] = None        # default d_model
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    # modality frontend stub: none | audio | vision
    frontend: str = "none"
    n_frontend_tokens: int = 0               # patches prepended (vision)
    # dtypes
    param_dtype: str = "float32"
    activation_dtype: str = "float32"
    # training
    remat: bool = True
    remat_policy: str = "full"               # full | dots | none (§Perf)
    # the JAX package stacks layers under lax.scan; the port holds one
    # module a layer and writes this layout back (convert.py)
    scan_layers: bool = True
    ssm_chunk: int = 128                     # recurrence chunk (§Perf)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def pdt(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    @property
    def adt(self) -> torch.dtype:
        return _dtype(self.activation_dtype)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, (self.d_model + 15) // 16)

    @property
    def lru_width(self) -> int:
        return self.rglru_width if self.rglru_width else self.d_model

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind, resolved from the pattern (cycled) or uniform."""
        if self.layer_pattern:
            pat = self.layer_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.ssm:
            return tuple("ssm" for _ in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    @property
    def uniform_layers(self) -> bool:
        kinds = self.layer_kinds
        return all(k == kinds[0] for k in kinds)

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test-sized copy of the same family (assignment: per-arch
        smoke tests instantiate a REDUCED config of the same family)."""
        base = dict(
            n_layers=min(self.n_layers, 2 + (2 if self.layer_pattern else 0)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4
                                  // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            capacity_factor=4.0,   # dropless at smoke scale: C reaches T
            dense_d_ff=128 if self.moe_dense_residual else 0,
            rglru_width=128 if self.rglru_width else None,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_frontend_tokens=min(self.n_frontend_tokens, 16),
            window=64,
            param_dtype="float32",
            activation_dtype="float32",
            scan_layers=False,
        )
        if self.layer_pattern:
            base["n_layers"] = len(self.layer_pattern)
        base.update(overrides)
        return dataclasses.replace(self, **base)
