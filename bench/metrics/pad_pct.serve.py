"""Per-layer metric `pad_pct.serve`: the share of the engine's batch slots
that were padding, from the server's counters over the window (every
batch is `batch` slots; the valid ones are the requests it served)."""


def read(m):
    per_op = (m.serve or {}).get("per_op", {})
    slots = sum(s["batches"] for s in per_op.values()) * m.batch
    if not slots:
        return None
    valid = sum(s["requests"] for s in per_op.values())
    return 100.0 * (slots - valid) / slots
