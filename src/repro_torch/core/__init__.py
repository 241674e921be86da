# The paper's primary contribution — the HEAAN HE-Mul pipeline
# (CRT → NTT → pointwise → iNTT → iCRT, regions 1+2) — in PyTorch.

from repro_torch.core.params import HEParams, paper_params, test_params
from repro_torch.core.context import HEContext, make_context

__all__ = [
    "HEParams",
    "paper_params",
    "test_params",
    "HEContext",
    "make_context",
]
