"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]

NOTE (DESIGN.md §6): at full size this exceeds 16 GiB/chip HBM even fully
sharded over 512 v5e chips; the dry-run compiles and reports the honest
bytes/device (EXPERIMENTS.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=112,
    d_ff=2048,                 # per-expert FFN width
    vocab_size=163840,
    attention="full",
    n_experts=384,
    top_k=8,
    capacity_factor=1.25,
    rope_theta=50000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SKIP_SHAPES = ("long_500k",)
