"""What the per-layer metrics' readers share (``bench/metrics/*.py``).

A reader takes the run's measurement `m` (``cells.Measure``) and returns
its metric's value, or None where the run holds nothing to read: no
trace, no peak for the card, or no work of the layer in the stretch."""

from __future__ import annotations

from hebench import roofline, tracing


def idle_pct(m):
    t = m.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def step_mfu_pct(m):
    """The whole step's share of the card's peak: the least time of the
    window's steps (roofline.step_bound_s) over the window's time. For
    cells whose `steps` are batched HE Mul steps of `batch` pairs: the
    metric's `workloads` in BENCHMARK.json name them."""
    if not m.steps:
        return None
    bound = roofline.step_bound_s(m.config, m.batch, m.device_name)
    if bound is None:
        return None
    return 100.0 * m.steps * bound / m.window_s


def kernels_roofline_pct(m):
    """The port's kernels' share of their bound: the bounds of the
    families found in the trace with the launch count the program's
    counters give (and the plan's count of calls), over the device time
    of every kernel that is not PyTorch's own."""
    t = m.trace
    if t is None or not t.steps:
        return None
    bounds = roofline.family_bounds_s(m.config, m.batch, m.device_name)
    if bounds is None:
        return None
    seen: dict = {}
    other_s = 0.0
    for name, (sec, n) in t.kernels.items():
        if tracing.is_torch(name):
            continue
        other_s += sec
        f = tracing.family(name)
        if f is not None:
            seen[f] = seen.get(f, 0) + n
    if other_s <= 0:
        return None
    bound_s = 0.0
    for f, (calls, per_step) in bounds.items():
        launched = t.launches.get(f, 0)
        if (seen.get(f, 0) and launched == calls * t.steps
                and seen[f] % launched == 0):
            bound_s += per_step * t.steps
    return 100.0 * bound_s / other_s


def glue_device_pct(m):
    t = m.trace
    if t is None or t.device_s <= 0:
        return None
    return 100.0 * t.torch_s / t.device_s


def device_events_per_op(m):
    t = m.trace
    if t is None or not t.ops:
        return None
    return t.device_events / t.ops
