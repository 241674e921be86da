"""Batched HE Mul on one device.

  - he_pipeline: the paper's Fig. 2 two-region HE Mul over a batch of
                 ciphertext pairs as one step, bitwise identical to
                 core.heaan.he_mul item by item; its batched stages are
                 factored as make_stage_fns / make_keyswitch_step, and
                 route through the CUDA kernels with use_kernels=True,
                 across the paper's optimization ladder (CRT strategies,
                 modified Shoup).

The JAX package's mesh sharding and collectives are not ported yet.
"""

from repro_torch.dist import he_pipeline  # noqa: F401

__all__ = ["he_pipeline"]
