"""Plain torch versions of the NTT/iNTT kernels.

Delegates to the core transforms, as the JAX package's ref.py does.
"""

from __future__ import annotations

from repro_torch.core.ntt import intt as intt_ref
from repro_torch.core.ntt import ntt as ntt_ref

__all__ = ["ntt_ref", "intt_ref"]
