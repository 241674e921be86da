"""Per-layer metric `device_events_per_op.step` of the step cells (see hebench.readers)."""

from hebench import readers


def read(m):
    return readers.device_events_per_op(m)
