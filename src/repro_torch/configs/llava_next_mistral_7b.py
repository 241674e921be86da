"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — transformer BACKBONE only; anyres patch tiling is a STUB
(input_specs supplies precomputed patch embeddings prepended to tokens).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention="full",
    frontend="vision",
    n_frontend_tokens=576,       # one anyres tile of 24×24 patches
    rope_theta=1000000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SKIP_SHAPES = ("long_500k",)
