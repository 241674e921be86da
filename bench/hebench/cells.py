"""What a cell's run shares: its settings (`Run`), its measurement
(`Measure`, which the per-layer readers take), and the comparison of a
sample of its answers with the plain reference."""

from __future__ import annotations

import dataclasses
import gc
import random
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Run:
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    # wraps the timed path (the step, or the server's engine) to plant a
    # fault; the tests of the check use it, a benchmark run never does
    fault: Optional[Callable] = None
    reference_short: int = 0      # primes the reference leaves out


@dataclasses.dataclass
class Measure:
    kind: str
    config: dict
    traffic: dict
    device_name: str
    batch: int
    setup_s: float = 0.0
    window_s: float = 0.0
    ops: int = 0
    steps: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    serve: Optional[dict] = None
    trace: object = None
    memory_peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    mismatched_words: int = 0
    compared_words: int = 0
    # the numbers that decide `correct`, each by its name: {"value":
    # the reading, "limit": the most it may read, "compared": how many
    # answers or words it was read over}; the driver fills them
    checks: dict = dataclasses.field(default_factory=dict)


def correct(m: Measure) -> bool:
    """Every sampled answer came, the driver gave a check, and each check
    compared something and reads within its limit."""
    return (m.failed == 0 and bool(m.checks)
            and all(c["compared"] > 0 and c["value"] <= c["limit"]
                    for c in m.checks.values()))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(seed: int, n: int, k: int, salt: str) -> list:
    """k of range(n), drawn from the seed (all of them when k >= n)."""
    rng = random.Random(f"{seed}:{salt}")
    return sorted(rng.sample(range(n), min(k, n)))


def free(device: torch.device) -> None:
    """Drop what the program held, so that the reference runs in the
    memory it leaves."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
