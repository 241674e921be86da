"""Steady-state serving accounting: throughput, latency, queue depth.

The paper's premise (§V) is that HE Mul THROUGHPUT under batching — not
single-op latency — is what makes HEAAN serviceable; this module gives
the serving runtime the numbers to prove it per op kind:

  - per-(op) throughput: valid (non-padding) ops per second of engine
    wall time, each signature's first (warm-up) run excluded (steady
    state);
  - request latency: submit → batch-complete, p50/p99;
  - batch efficiency: padding fraction per op;
  - queue depth samples over the run;
  - flush causes: how many batches ran because a bucket was full, hit
    its age deadline (the continuous-batching SLO path), or was drained —
    the knob-tuning signal for `HEServer(max_age_s=...)`;
  - co-batching: of the batches that carried circuit nodes, how many
    mixed nodes from TWO OR MORE circuits — the cross-circuit co-batch
    rate the circuit-aware scheduler exists to raise (`HEServer(
    schedule=True)`), plus its deferral and table-prefetch counts.

Everything is plain host-side accumulation, so the metrics can run on a
frontend host next to the RequestQueue. This is the JAX package's
``hserve/metrics.py``, ported unchanged.

Memory contract: latency and queue-depth streams accumulate into
BOUNDED reservoirs (`repro_torch.obs.stats.Reservoir`), not lists — a
week-old server at production request counts holds a fixed few thousand
samples per op, with count/mean/max exact and p50/p99 sampled (within
tolerance).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List

from repro_torch.obs.stats import Reservoir

__all__ = ["ServeMetrics"]


@dataclasses.dataclass
class _OpStats:
    batches: int = 0
    valid: int = 0
    padded: int = 0
    wall_s: float = 0.0
    latencies: Reservoir = dataclasses.field(default_factory=Reservoir)


class ServeMetrics:
    """Accumulate per-batch records; summarize steady-state rates."""

    FLUSH_CAUSES = ("full", "age", "drain")

    def __init__(self):
        self._ops: Dict[str, _OpStats] = defaultdict(_OpStats)
        self._depths = Reservoir()
        self._levels: set = set()
        self._flushes: Dict[str, int] = {c: 0 for c in self.FLUSH_CAUSES}
        self._circuit_batches = 0
        self._cross_circuit_batches = 0
        self._circuit_nodes = 0

    def record_batch(self, op: str, logq: int, n_valid: int, n_pad: int,
                     wall_s: float, latencies_s: List[float]) -> None:
        s = self._ops[op]
        s.batches += 1
        s.valid += n_valid
        s.padded += n_pad
        s.wall_s += wall_s
        s.latencies.extend(latencies_s)
        self._levels.add(logq)

    def record_depth(self, depth: int) -> None:
        self._depths.add(depth)

    def record_flush(self, cause: str) -> None:
        """Count why a batch was released: "full" (bucket reached the
        target), "age" (oldest request hit the deadline), "drain"."""
        if cause not in self.FLUSH_CAUSES:   # not assert: gone under -O
            raise ValueError(f"unknown flush cause {cause!r}; one of "
                             f"{self.FLUSH_CAUSES}")
        self._flushes[cause] += 1

    def record_circuit_batch(self, n_circuits: int, n_nodes: int) -> None:
        """One served batch carried `n_nodes` circuit nodes from
        `n_circuits` distinct circuits (co-batching accounting)."""
        if n_nodes <= 0:
            return
        self._circuit_batches += 1
        self._circuit_nodes += n_nodes
        if n_circuits >= 2:
            self._cross_circuit_batches += 1

    def summary(self) -> dict:
        per_op = {}
        for op, s in sorted(self._ops.items()):
            served = s.valid + s.padded
            lat = s.latencies
            per_op[op] = {
                "batches": s.batches,
                "requests": s.valid,
                "ops_per_s": round(s.valid / s.wall_s, 3)
                if s.wall_s > 0 else 0.0,
                "wall_s": round(s.wall_s, 4),
                "pad_frac": round(s.padded / served, 4) if served else 0.0,
                "latency_ms": {
                    "p50": round(1e3 * lat.percentile(50), 3),
                    "p99": round(1e3 * lat.percentile(99), 3),
                    # max is exact — reservoirs track extremes outside
                    # the sample
                    "max": round(1e3 * lat.max, 3) if lat else 0.0,
                },
            }
        return {
            "per_op": per_op,
            "levels_served": sorted(self._levels),
            "flushes": dict(self._flushes),
            "cobatch": {
                "circuit_batches": self._circuit_batches,
                "circuit_nodes": self._circuit_nodes,
                "cross_circuit_batches": self._cross_circuit_batches,
                "cross_circuit_rate": round(
                    self._cross_circuit_batches / self._circuit_batches, 4)
                if self._circuit_batches else 0.0,
            },
            "queue_depth": {
                "mean": round(self._depths.mean, 2) if self._depths
                else 0.0,
                "max": int(self._depths.max) if self._depths else 0,
                "samples": len(self._depths),
            },
        }
