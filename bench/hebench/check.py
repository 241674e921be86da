"""The comparison that decides `correct`: the program's output words
against the plain reference's (``bench/heref.py``), word for word.

HE Mul and rotation are exact integer functions, so the one number
compared is the count of output words that differ, and its limit is 0.
"""

from __future__ import annotations

import torch

LIMIT_MISMATCHED_WORDS = 0


def mismatched(got: torch.Tensor, want: torch.Tensor) -> int:
    """Words of `got` that differ from `want` (same shape and type)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel())
    return int((got.to(want.device) != want).sum())


def mismatched_words(mismatched: int, compared: int) -> dict:
    """The check of the exact kinds, by its name: the output words that
    differ from the reference's, of the words compared."""
    return {"mismatched_words": {"value": mismatched,
                                 "limit": LIMIT_MISMATCHED_WORDS,
                                 "compared": compared}}
