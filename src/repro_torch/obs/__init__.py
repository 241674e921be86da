"""Span tracing, stage attribution and serving telemetry for the port.

The JAX package's ``obs`` package, ported:

  - :class:`Tracer` (`trace.py`) — nested spans with injectable clocks,
    exported as Chrome trace-event JSON (Perfetto / chrome://tracing):
    the request lifecycle (submit → enqueue → bucket_wait → flush →
    batch_assemble → dispatch → device_wall → complete), the server's
    entry points (submit, poll, prefetch), engine spans (table-slice
    fetch, H2D transfer, warm runs) and, under ``profile_stages``,
    per-stage Fig. 3 events. While torch.profiler records, every live
    span is also a profiler range, on the profiler's clock.
  - :func:`device_range` (`trace.py`) — the profiler range
    ``repro_torch/<cat>/<name>`` (:data:`RANGE_PREFIX`) that the spans,
    and the dist pipeline's unfenced stages (``stage/<stage>``) and
    steps (``step/<op>``), open while a profiler records; a no-op
    otherwise.
  - :class:`MetricsRegistry` (`registry.py`) — counters, gauges and
    bounded histograms plus pull sources (ServeMetrics, TableCache,
    CircuitScheduler publish), snapshot as JSON on demand.
  - :class:`StageTimer` (`stages.py`) — the ``make_stage_fns`` hook that
    buckets an op's wall time into the paper's CRT / NTT / modmul / iCRT
    taxonomy, fencing the card around each stage.

`python -m repro_torch.obs report trace.json` prints the attribution
table and the queue-wait vs device-wall latency decomposition
(`report.py`).
"""

from repro_torch.obs.registry import MetricsRegistry, merge_snapshots
from repro_torch.obs.stages import STAGES, StageTimer
from repro_torch.obs.stats import Reservoir
from repro_torch.obs.trace import RANGE_PREFIX, Span, Tracer, device_range

__all__ = ["MetricsRegistry", "merge_snapshots", "RANGE_PREFIX",
           "Reservoir", "Span", "StageTimer", "STAGES", "Tracer",
           "device_range"]
