"""Per-layer metric `step_mfu_pct.step` of the step cells (see hebench.readers)."""

from hebench import readers


def read(m):
    return readers.step_mfu_pct(m)
