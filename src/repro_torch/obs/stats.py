"""Bounded streaming accumulators for long-lived serving processes.

:class:`Reservoir` keeps ServeMetrics' latency and queue-depth streams in
fixed memory: Vitter's Algorithm R keeps a fixed-size uniform sample for
quantiles while count / sum / min / max stay EXACT (they are O(1)
scalars, no reason to approximate them). The sampler is seeded
deterministically so metric summaries are reproducible run-to-run —
telemetry that jitters between identical runs reads as a regression.

p50/p99 from a 4096-sample uniform reservoir sit well within a few
percent of the exact quantiles for the unimodal-ish latency
distributions serving produces. This is the JAX package's
``obs/stats.py``, ported unchanged: the same seeded sampling.
"""

from __future__ import annotations

import random
from typing import List

__all__ = ["Reservoir"]

DEFAULT_CAPACITY = 4096


class Reservoir:
    """Fixed-memory stream summary: exact moments, sampled quantiles.

    capacity: max retained samples (memory ceiling). Quantiles are
        computed over this uniform sample; count/total/min/max are
        exact regardless of how many values streamed through.
    seed: RNG seed for Algorithm R's replacement draws. Fixed by
        default so two identical runs summarize identically.
    """

    __slots__ = ("capacity", "count", "total", "min", "max",
                 "_sample", "_rng")

    def __init__(self, capacity: int = DEFAULT_CAPACITY, seed: int = 0):
        if capacity <= 0:                # not assert: gone under python -O
            raise ValueError(f"capacity must be > 0, got {capacity}")
        self.capacity = capacity
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._sample: List[float] = []
        self._rng = random.Random(seed)

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if len(self._sample) < self.capacity:
            self._sample.append(x)
        else:
            # Algorithm R: keep each of the n seen values with p = cap/n
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self._sample[j] = x

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    def __len__(self) -> int:
        return self.count

    def __bool__(self) -> bool:
        return self.count > 0

    @property
    def sample_size(self) -> int:
        """Retained samples (≤ capacity) — the actual memory footprint."""
        return len(self._sample)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the retained sample, linear
        interpolation between order statistics (numpy's default)."""
        if not self._sample:
            return 0.0
        xs = sorted(self._sample)
        if len(xs) == 1:
            return xs[0]
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }
