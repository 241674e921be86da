"""Per-layer metric `glue_device_pct.step` of the step cells (see hebench.readers)."""

from hebench import readers


def read(m):
    return readers.glue_device_pct(m)
