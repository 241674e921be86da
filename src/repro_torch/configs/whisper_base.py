"""whisper-base [audio] — 6L (enc+dec) d_model=512 8H d_ff=2048 vocab=51865
— encoder-decoder; conv frontend is a STUB (input_specs supplies precomputed
frame embeddings). [arXiv:2212.04356; unverified]

Shape semantics (DESIGN.md §6): prefill_32k = encoder over 32,768 stub
frames + decoder prefill; decode = one decoder step cross-attending to the
32,768-frame memory. long_500k skipped (full bidirectional encoder
attention is O(L²)).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    n_layers=6,                  # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    attention="full",
    enc_dec=True,
    frontend="audio",
    norm="layernorm",
    param_dtype="bfloat16",
    activation_dtype="bfloat16",
)

SKIP_SHAPES = ("long_500k",)
