"""Plain torch version of the CRT kernel: the core CRT with the kernel's
strategy (acc3 by default; mod2/mod4 for the Table VIII ladder)."""

from __future__ import annotations

from repro_torch.core.crt import crt

__all__ = ["crt_ref"]


def crt_ref(x, tb, tb_shoup, primes, *, strategy: str = "acc3"):
    return crt(x, tb, tb_shoup, primes, strategy=strategy)
