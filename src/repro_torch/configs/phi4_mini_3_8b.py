"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    attention="full",
    rope_theta=10000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SKIP_SHAPES = ("long_500k",)
