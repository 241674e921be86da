"""Offline trace analysis: Fig. 3 attribution + latency decomposition.

`python -m repro_torch.obs report trace.json` reads a Chrome trace-event
file written by `python -m repro_torch.launch.serve --he --trace` (or by
the JAX package's server: the event format is the same) and prints:

  - per-op / per-stage attribution (cat="stage" events): wall seconds
    in each of the paper's CRT / NTT / modmul / iCRT buckets, their
    fraction of the op's bucketed total, and the Fig. 2 region split —
    the table the paper's Fig. 3 is;
  - a queue-wait vs device-wall latency decomposition (lifecycle
    events): how much of each op's request latency is spent waiting in
    a bucket (the batching/SLO trade) vs on the device (the compute
    floor) — the serving-side split HEAX argues pipeline occupancy
    from.

Stdlib-only on purpose: the report runs anywhere the trace file lands,
no torch or numpy needed.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List

from repro_torch.obs.stages import STAGES

__all__ = ["load_events", "analyze", "format_report"]


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    return [e for e in events if e.get("ph") == "X"]


def analyze(events: List[dict]) -> dict:
    """Aggregate a trace into the report's two tables (seconds)."""
    stage_s: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {s: 0.0 for s in STAGES})
    region_s: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    wait_s: Dict[str, float] = defaultdict(float)
    wait_n: Dict[str, int] = defaultdict(int)
    dev_s: Dict[str, float] = defaultdict(float)
    dev_batches: Dict[str, int] = defaultdict(int)
    complete_n: Dict[str, int] = defaultdict(int)
    latency_s: Dict[str, float] = defaultdict(float)
    for e in events:
        cat = e.get("cat")
        op = (e.get("args") or {}).get("op", "?")
        dur = e.get("dur", 0.0) / 1e6
        name = e.get("name")
        if cat == "stage":
            if name in STAGES:
                stage_s[op][name] += dur
            else:
                region_s[op][name] += dur
        elif cat == "lifecycle":
            if name == "bucket_wait":
                wait_s[op] += dur
                wait_n[op] += 1
            elif name == "device_wall":
                dev_s[op] += dur
                dev_batches[op] += 1
            elif name == "complete":
                complete_n[op] += 1
                latency_s[op] += (e.get("args") or {}).get("latency_s",
                                                           0.0)
    return {
        "stages": {op: dict(v) for op, v in stage_s.items()},
        "regions": {op: dict(v) for op, v in region_s.items()},
        "queue_wait": {op: {"total_s": wait_s[op], "n": wait_n[op]}
                       for op in wait_n},
        "device_wall": {op: {"total_s": dev_s[op],
                             "batches": dev_batches[op]}
                        for op in dev_batches},
        "complete": {op: {"n": complete_n[op],
                          "latency_total_s": latency_s[op]}
                     for op in complete_n},
    }


def _fmt_ms(s: float) -> str:
    return f"{1e3 * s:10.2f}"


def format_report(a: dict) -> str:
    lines: List[str] = []
    if a["stages"]:
        lines.append("Fig. 3 stage attribution (ms, per op kind)")
        hdr = f"{'op':>10} " + " ".join(f"{s:>10}" for s in STAGES) \
            + f" {'sum':>10}"
        lines.append(hdr)
        for op in sorted(a["stages"]):
            row = a["stages"][op]
            tot = sum(row.values())
            lines.append(f"{op:>10} "
                         + " ".join(_fmt_ms(row[s]) for s in STAGES)
                         + f" {_fmt_ms(tot)}")
            if tot > 0:
                lines.append(f"{'':>10} "
                             + " ".join(f"{row[s] / tot:>9.1%} "
                                        for s in STAGES))
        for op in sorted(a["regions"]):
            reg = a["regions"][op]
            parts = ", ".join(f"{k}={1e3 * v:.2f}ms"
                              for k, v in sorted(reg.items()))
            lines.append(f"{op:>10} regions: {parts}")
        lines.append("")
    else:
        lines.append("no stage events (run serve with --profile-stages "
                     "for Fig. 3 attribution)")
        lines.append("")
    lines.append("latency decomposition: queue wait vs device wall")
    lines.append(f"{'op':>10} {'waits':>7} {'wait_ms':>10} "
                 f"{'batches':>8} {'device_ms':>10} {'mean_lat_ms':>12}")
    ops = sorted(set(a["queue_wait"]) | set(a["device_wall"])
                 | set(a["complete"]))
    for op in ops:
        w = a["queue_wait"].get(op, {"total_s": 0.0, "n": 0})
        d = a["device_wall"].get(op, {"total_s": 0.0, "batches": 0})
        c = a["complete"].get(op, {"n": 0, "latency_total_s": 0.0})
        mean_lat = 1e3 * c["latency_total_s"] / c["n"] if c["n"] else 0.0
        lines.append(f"{op:>10} {w['n']:>7} {_fmt_ms(w['total_s'])} "
                     f"{d['batches']:>8} {_fmt_ms(d['total_s'])} "
                     f"{mean_lat:>12.2f}")
    return "\n".join(lines)
