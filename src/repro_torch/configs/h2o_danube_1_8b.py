"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    attention="swa",
    window=4096,
    rope_theta=10000.0,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

# SWA is sub-quadratic (bounded window): long_500k runs.
SKIP_SHAPES = ()
