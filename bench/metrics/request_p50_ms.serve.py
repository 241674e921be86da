"""Per-layer metric `request_p50_ms.serve`: the median over every request
due in the window, from when it was due to when its result was complete
on the card."""

import statistics


def read(m):
    if not m.latencies_ms:
        return None
    return statistics.median(m.latencies_ms)
