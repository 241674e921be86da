"""The paper's own workload as a config: batched HEAAN HE Mul serving.

Full parameters (Table III/VI): (p, L, Q, N) = (2^30, 40, 2^1200, 2^16),
β = 2^32 (TPU-native), np ≈ 81/122. A batch of ciphertext pairs is
multiplied per step — the unit a privacy-preserving serving system
schedules. Distribution: batch → data axis, primes → model axis
(DESIGN.md §5).
"""

from repro_torch.core.params import HEParams, paper_params, test_params

CONFIG: HEParams = paper_params(beta_bits=32)
SMOKE: HEParams = test_params(logN=5, beta_bits=32)

# HE shapes: ciphertext-pair batches per HE Mul step.
HE_SHAPES = {
    "he_mul_b16": dict(batch=16),
    "he_mul_b64": dict(batch=64),
}
