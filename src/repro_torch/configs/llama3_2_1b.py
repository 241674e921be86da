"""llama3.2-1b [dense] — 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256. [hf:meta-llama/Llama-3.2-1B; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128256,
    attention="full",
    rope_theta=500000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

# O(L²) attention: long_500k is architecturally unsupported (DESIGN.md §6).
SKIP_SHAPES = ("long_500k",)
