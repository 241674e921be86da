"""Plain torch version of the CRT kernel (3-word accumulation)."""

from __future__ import annotations

from repro_torch.core.crt import crt as crt_ref

__all__ = ["crt_ref"]
