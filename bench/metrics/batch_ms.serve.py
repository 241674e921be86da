"""Per-layer metric `batch_ms.serve`: the engine's wall per batch over the
window, dispatch to its event synchronised, as the server records it."""


def read(m):
    per_op = (m.serve or {}).get("per_op", {})
    batches = sum(s["batches"] for s in per_op.values())
    if not batches:
        return None
    return 1e3 * sum(s["wall_s"] for s in per_op.values()) / batches
