"""Per-layer metric `kernels_roofline_pct.step` of the step cells (see hebench.readers)."""

from hebench import readers


def read(m):
    return readers.kernels_roofline_pct(m)
