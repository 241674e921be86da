"""Architecture / shape registry: --arch <id> resolution.

SHAPES are the assignment's per-arch input-shape set. ``decode_*`` /
``long_*`` lower serve_step (one token against a seq_len KV cache);
``train_*`` / ``prefill_*`` lower train_step / prefill. Skips are per-arch
(SKIP_SHAPES), documented in DESIGN.md §6.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
}

ARCHS = tuple(_MODULES)

# assignment shape set: (kind, seq_len, global_batch)
SHAPES: Dict[str, Tuple[str, int, int]] = {
    "train_4k": ("train", 4096, 256),
    "prefill_32k": ("prefill", 32768, 32),
    "decode_32k": ("decode", 32768, 128),
    "long_500k": ("decode", 524288, 1),
}


def get_arch(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(_MODULES[arch_id])
    return mod.CONFIG


def get_skips(arch_id: str) -> Tuple[str, ...]:
    mod = importlib.import_module(_MODULES[arch_id])
    return getattr(mod, "SKIP_SHAPES", ())


def get_shapes(arch_id: str) -> Dict[str, Tuple[str, int, int]]:
    skips = set(get_skips(arch_id))
    return {k: v for k, v in SHAPES.items() if k not in skips}


def cells():
    """All (arch, shape) baseline cells, skips excluded."""
    for a in ARCHS:
        for s in get_shapes(a):
            yield a, s
