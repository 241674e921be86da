"""The JAX package's five examples on the port, each a runnable module.

    python -m repro_torch.examples.<name> [--device cpu] [options]

``quickstart``, ``he_inference``, ``bootstrap_demo``, ``serve_lm`` and
``train_lm`` keep the reference examples' parameters, seeds, steps and
printed checks. Each runs on the card unless ``--device cpu`` is passed
(without CUDA it raises rather than fall back), has an importable
``main(argv) -> dict`` that returns the values it checks, and exits
non-zero when a check fails (:class:`CheckFailed`).
"""

from __future__ import annotations

import time

import torch

__all__ = ["CheckFailed", "check", "wall"]


class CheckFailed(AssertionError):
    """An example's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def wall(dev: torch.device) -> float:
    """perf_counter() once the work queued on `dev` has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()
