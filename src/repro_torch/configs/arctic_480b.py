"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128 experts top-2 + dense residual FFN.
[hf:Snowflake/snowflake-arctic-base; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,                 # per-expert FFN width
    vocab_size=32000,
    attention="full",
    n_experts=128,
    top_k=2,
    capacity_factor=1.25,
    moe_dense_residual=True,
    dense_d_ff=4864,
    rope_theta=10000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SKIP_SHAPES = ("long_500k",)
