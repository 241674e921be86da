#!/usr/bin/env python3
"""Find the highest rate a serving mix sustains, once, on the card.

    python3 bench/tools/sweep_serve.py --workload <serve cell> --seed <n>
        --seconds <s> --rates R1 R2 ...

One server (the cell's set-up) serves the mix's open loop at each rate in
turn for `seconds`, and prints a JSON line a rate: requests due, the rate
served (all of them over the time to the last one done), p50 and p95
from due to done (over the whole window and over its first and last
thirds), the requests pending (submitted, not done) on average in its
first and last thirds, how long the rest took after the close, and the
generator's lateness. A rate is sustained when the pending requests of
the last third stay within one batch of the first third's: no growing
backlog. The cell's rate is fixed in its traffic file from this sweep;
the benchmark itself never searches.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def p95(values: list):
    v = sorted(values)
    return v[max(0, -(-len(v) * 95 // 100) - 1)] if v else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from hebench import arrivals, cells, servecell, spec

    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    dev = torch.device("cuda", 0)
    r = cells.Run(workload=args.workload, config=cell.config,
                  traffic=cell.traffic, seed=args.seed, seconds=args.seconds,
                  trace=False, device=dev, t_start=time.perf_counter())
    _, server, cts, _, _, _ = servecell.setup(r)
    servecell.warm_up(server, cts,
                      arrivals.schedule(cell.traffic, args.seed, 1.0))
    T = args.seconds
    batch = cell.traffic["server"]["batch"]
    for rate in args.rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        reqs = arrivals.schedule(mix, args.seed, T)
        n = sum(1 for q in reqs if q.due_s < T)
        server.reset_metrics()
        loop = servecell.Loop(server, cts, reqs, set())
        t0 = time.perf_counter()
        loop.run(0, n, t0)
        wall = time.perf_counter() - t0
        lat = {k: 1e3 * (t - reqs[k].due_s) for k, t in loop.done_s.items()}
        thirds = [[lat[k] for k in range(n)
                   if lo <= 3 * reqs[k].due_s / T < lo + 1] for lo in (0, 2)]
        pend = [[p for t, p in loop.pending if lo <= 3 * t / T < lo + 1]
                for lo in (0, 2)]
        mean_pend = [statistics.mean(p) if p else 0.0 for p in pend]
        sustained = mean_pend[1] <= mean_pend[0] + batch
        print(json.dumps({
            "rate_per_s": rate, "due": n, "served_per_s": n / wall,
            "p50_ms": statistics.median(lat.values()),
            "p95_ms": p95(list(lat.values())),
            "p95_thirds_ms": [p95(t) for t in thirds],
            "pending_thirds": mean_pend, "after_close_s": wall - T,
            "late_ms": 1e3 * loop.late_s,
            "flushes": server.metrics.summary()["flushes"],
            "batches": loop.batches, "sustained": sustained}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
