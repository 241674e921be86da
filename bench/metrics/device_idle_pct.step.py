"""Per-layer metric `device_idle_pct.step`: the share of the traced
stretch of steps in which no device event ran."""

from hebench import readers


def read(m):
    return readers.idle_pct(m)
