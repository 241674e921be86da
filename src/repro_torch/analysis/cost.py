"""Bench-calibrated cost model: device-seconds per (op, level).

The paper's Table III observation is that HE op cost is dominated by a
small set of (N log N)-shaped transform passes whose COUNT per op is
known statically and whose per-unit cost is a device constant. We
exploit exactly that separation:

  analytic units  u(op, logq)   — how many weighted transform/limb
                                  units the op performs at that level
                                  (paper Fig. 2's region-1/region-2
                                  decomposition, counted below);
  fitted constant κ_op          — measured seconds per unit, fitted
                                  from a serve_he bench's throughputs
                                  (so κ absorbs batching efficiency,
                                  device FLOPs, and runtime overheads).

Estimated device-seconds for an op is then κ_op · u(op, logq); for a
circuit, the sum over nodes. The model is intentionally coarse — its
two consumers need only ORDERING, not absolute accuracy:

  - `CircuitScheduler` asks "is deferring this bucket worth a batching
    win?" (a bucket of add at 2 limbs costs ~µs — flush it; a bucket
    of mul at full depth costs ~ms — wait for co-batching);
  - the analyzer reports per-circuit cost so regressions in circuit
    STRUCTURE show up in review, before any benchmark runs.

Unit counts (paper Fig. 2 / §III: HE Mul = 4 forward + 3 inverse
region-1 transforms at np1 primes plus 1 forward + 2 inverse region-2
transforms at np2 primes; rotate/conjugate = the region-2 key switch
only; mul_plain = region-1 products only, no key switch; add-likes and
level ops are per-limb linear passes):

  mul         (7·np1 + 3·np2) · N·logN
  rotate      3·np2 · N·logN          (also conjugate)
  slot_sum    log2(n) · (rotate + add)
  mul_plain   5·np1 · N·logN
  add/sub     qlimbs · N               (also add_plain, rescale,
                                        mod_down — limb-linear)

This is the JAX package's ``analysis/cost.py``; a model fitted from the
reference's BENCH_serve_he.json estimates that record's CPU/TPU runs, not
the card.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.analysis.dataflow import Meta, OpNode, propagate
from repro_torch.core.params import HEParams

__all__ = ["op_units", "CostModel"]


def op_units(op: str, logq: int, params: HEParams, *,
             n_slots: Optional[int] = None) -> float:
    """Analytic work units for one (unbatched) op at level logq."""
    N = params.N
    nlogn = N * max(1, params.logN)
    np1 = params.np_region1(logq)
    np2 = params.np_region2(logq)
    limb = params.qlimbs(logq) * N
    if op == "mul":
        return (7 * np1 + 3 * np2) * nlogn
    if op in ("rotate", "conjugate"):
        return 3 * np2 * nlogn
    if op == "slot_sum":
        n = n_slots if n_slots else params.n_slots_max
        rounds = max(1, int(round(math.log2(max(2, n)))))
        return rounds * (3 * np2 * nlogn + limb)
    if op == "mul_plain":
        return 5 * np1 * nlogn
    # add, sub, add_plain, rescale, mod_down: limb-linear passes
    return limb


class CostModel:
    """κ_op constants fitted from a serve_he bench result.

    The bench reports batched throughput (ops/s at batch B); κ_op is
    fitted as mean over the measured levels of
    ``(1 / ops_per_s) / op_units(op, logq)`` — i.e. κ includes the
    bench's batching amortization, so estimates answer "what does one
    more of these cost the device IN the served configuration".
    Ops the bench doesn't measure fall back to the mean fitted κ
    (transform-dominated ops are within ~2× of each other per unit;
    the limb-linear ops have their own tiny unit counts).
    """

    def __init__(self, kappa: Dict[str, float], default_kappa: float,
                 params: HEParams, calibrated_from: str = "<dict>"):
        self.kappa = dict(kappa)
        self.default_kappa = float(default_kappa)
        self.params = params
        self.calibrated_from = calibrated_from

    @classmethod
    def from_bench(cls, bench: Union[str, Path, dict],
                   params: Optional[HEParams] = None) -> "CostModel":
        """Fit from a serve_he bench result (path or already-loaded dict;
        the layout of the JAX package's BENCH_serve_he.json, whose numbers
        are a CPU/TPU record, not the card's).

        Uses mul_per_s / rotate_per_s over the bench's measured levels
        and the plain block's throughputs at logQ; params default to
        the bench's own (logN, logQ, logp, beta_bits).
        """
        name = "<dict>"
        if not isinstance(bench, dict):
            name = str(bench)
            bench = json.loads(Path(bench).read_text())
        p = bench.get("params", {})
        if params is None:
            params = HEParams(logN=p["logN"], logQ=p["logQ"],
                              logp=p["logp"],
                              log_delta=p.get("log_delta", p["logp"]),
                              beta_bits=p["beta_bits"])
        levels = [int(x) for x in bench.get("levels", [params.logQ])]
        kappa: Dict[str, float] = {}

        def fit(op: str, per_s: Optional[float],
                at_levels: Sequence[int]):
            if per_s and per_s > 0:
                ks = [(1.0 / per_s) / op_units(op, lq, params)
                      for lq in at_levels]
                kappa[op] = sum(ks) / len(ks)

        fit("mul", bench.get("mul_per_s"), levels)
        fit("rotate", bench.get("rotate_per_s"), levels)
        plain = bench.get("plain", {})
        fit("mul_plain", plain.get("mul_plain_per_s"), [params.logQ])
        fit("add_plain", plain.get("add_plain_per_s"), [params.logQ])
        if not kappa:
            raise ValueError(
                f"cost model: no usable throughputs in {name} "
                f"(need mul_per_s / rotate_per_s / plain.*_per_s)")
        default = sum(kappa.values()) / len(kappa)
        return cls(kappa, default, params, calibrated_from=name)

    def op_seconds(self, op: str, logq: int, *,
                   n_slots: Optional[int] = None) -> float:
        """Estimated device-seconds for ONE op at this level, in the
        calibrated serving configuration."""
        k = self.kappa.get(op)
        if k is None and op == "conjugate":
            k = self.kappa.get("rotate")     # same key-switch machinery
        if k is None and op == "slot_sum":
            k = self.kappa.get("rotate")     # a ladder of rotates
        if k is None:
            k = self.default_kappa
        return k * op_units(op, logq, self.params, n_slots=n_slots)

    def estimate_circuit(self, ops: Sequence[OpNode],
                         input_meta: Dict[str, Meta],
                         meta: Optional[Sequence[Meta]] = None
                         ) -> Tuple[float, List[float]]:
        """(total device-seconds, per-node seconds) for one pass of the
        circuit. Each node is costed at its INPUT level — the level the
        batched step actually runs at."""
        if meta is None:
            meta = propagate(ops, input_meta, params=self.params)
        per: List[float] = []
        for i, node in enumerate(ops):
            a = node.args[0]
            in_logq = (input_meta[a][0] if isinstance(a, str)
                       else meta[a][0])
            per.append(self.op_seconds(node.op, in_logq))
        return sum(per), per
