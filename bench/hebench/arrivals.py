"""The arrival generator of the serving mixes: an open loop at the rate
the mix fixes.

Inter-arrival gaps are exponential (Poisson arrivals), drawn as the n
quantiles of the distribution at (i + 1/2)/n and put in an order drawn
from the seed; the (op, level) of each request comes from exact shares of
the mix, shuffled by the seed; its operands are drawn from the level's
pool. So every seed offers the same gaps and the same work, in another
order.
"""

from __future__ import annotations

import dataclasses
import math
import random


@dataclasses.dataclass(frozen=True)
class Request:
    due_s: float          # from the start of the open loop
    op: str               # "mul" | "rotate"
    r: int                # the rotation's amount (0 for mul)
    logq: int
    operands: tuple       # indices into the level's pool


def _counts(weights: list, n: int) -> list:
    """n split in proportion to `weights` (largest remainders)."""
    total = sum(weights)
    raw = [w * n / total for w in weights]
    out = [math.floor(x) for x in raw]
    for i in sorted(range(len(raw)), key=lambda i: out[i] - raw[i])[
            :n - sum(out)]:
        out[i] += 1
    return out


def schedule(mix: dict, seed: int, horizon_s: float) -> list:
    """The requests a mix offers over `horizon_s` seconds, in due order."""
    rate = mix["rate_per_s"]
    n = math.ceil(rate * horizon_s) + 1
    rng = random.Random(seed)
    gaps = [-math.log1p(-(i + 0.5) / n) / rate for i in range(n)]
    rng.shuffle(gaps)
    kinds = [(op, lv) for op in mix["ops"] for lv in mix["levels"]]
    weights = [op["weight"] * lv[1] for op, lv in kinds]
    labels = [k for k, c in zip(kinds, _counts(weights, n))
              for _ in range(c)]
    rng.shuffle(labels)
    pool = mix["pool_per_level"]
    out, t = [], 0.0
    for gap, (op, lv) in zip(gaps, labels):
        t += gap
        arity = 2 if op["op"] == "mul" else 1
        out.append(Request(due_s=t, op=op["op"], r=op.get("r", 0),
                           logq=lv[0],
                           operands=tuple(rng.randrange(pool)
                                          for _ in range(arity))))
    return out
