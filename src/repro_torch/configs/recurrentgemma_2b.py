"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, 1 attention : 2 recurrent.
[arXiv:2402.19427; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attention="full",            # attention layers in the pattern are local
    window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    rglru_width=2560,
    rope_theta=10000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

# RG-LRU recurrence + bounded local window: sub-quadratic, long_500k runs.
SKIP_SHAPES = ()
