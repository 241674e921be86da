"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    attention="full",
    qkv_bias=True,
    rope_theta=1000000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SKIP_SHAPES = ("long_500k",)
