"""Per-layer metric `device_idle_pct.serve`: the share of the traced
stretch of serving in which no device event ran."""

from hebench import readers


def read(m):
    return readers.idle_pct(m)
