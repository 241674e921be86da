"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024,
ssm_state=16 — Mamba-1 architecture. [arXiv:2410.05355; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64,
    d_model=4096,
    n_heads=1,                  # unused (attention-free)
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,                     # no FFN — Mamba mixer only
    vocab_size=65024,
    attention="none",
    ssm=True,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    norm="rmsnorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

# Constant-size recurrent state: long_500k runs.
SKIP_SHAPES = ()
