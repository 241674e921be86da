"""LM model substrate: every assigned architecture family in PyTorch.

Families: dense decoder (GQA/SWA/RoPE/SwiGLU), MoE (top-k, optional dense
residual), SSM (Mamba-1), hybrid (RG-LRU + local attention), encoder-decoder
(whisper, stub audio frontend), VLM (stub patch frontend + decoder backbone).

The JAX package's ``models`` package with an ``nn.Module`` in place of
the parameter tree: :func:`init_params` builds an :class:`LM` on a
device, and the other functions take it where the reference takes
``params``. No kernel of the port lies on this path; it is plain
PyTorch, as the reference is plain ``jnp``.
"""

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    LM, decode_step, forward_train, init_cache, init_params, loss_fn, prefill,
)

__all__ = [
    "ModelConfig", "LM", "init_params", "forward_train", "loss_fn",
    "prefill", "decode_step", "init_cache",
]
