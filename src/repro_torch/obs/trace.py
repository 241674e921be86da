"""Span tracing with Chrome trace-event export (Perfetto-loadable), and
the port's profiler ranges.

One :class:`Tracer` instance is threaded through the serving stack
(HEServer → OpEngine → TableCache → StageTimer) and records everything
as complete events — ph "X" with explicit pid/tid/ts/dur/name/cat —
because a single uniform event shape keeps downstream consumers
(repro_torch.obs.report, Perfetto) trivial:
instants are just zero-duration spans. Timestamps come from an
injectable clock (same convention as `hserve.queue.RequestQueue`), so
tests drive the tracer with a fake clock and assert exact orderings.

Lanes: trace-event `tid` must be an integer, but call sites think in
names ("requests", "engine", "stage"). The tracer interns each lane
name to a small int and emits one "M"/thread_name metadata record per
lane so Perfetto shows the name. Metadata records carry the same
ts/dur/cat keys as everything else — one schema, no special cases.

The DISABLED tracer is free: `span()`/`event()`/`instant()` return a
shared no-op singleton and append nothing, so `serve --he` without
`--trace` allocates zero objects per request on the hot path.

Profiler ranges. The tracer's clock (`time.perf_counter`) is not
torch.profiler's: the profiler stamps its host and device events on the
epoch clock (`time.time_ns()`), and nothing relates the two. So the
program names its work on the profiler's own timeline as well:
:func:`device_range` opens a range ``repro_torch/<cat>/<name>`` while a
profiler records and is a shared no-op otherwise (one flag check), and
every live :meth:`Tracer.span` opens one for its lifetime, so a traced
server's spans lie on the device trace's clock beside the kernels they
launch. The dist pipeline's stages and steps open ranges of their own
(``repro_torch/stage/<stage>``, ``repro_torch/step/<op>``). A range is
an operator-scope record function: it adds a host event and no device
event (a user-scope `torch.profiler.record_function` range would add a
GPU annotation on the card, which counts as a device event).

Apart from the ranges this is the JAX package's ``obs/trace.py``, ported
unchanged: a port trace has the same Chrome trace-event JSON as the
reference's.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Callable, Dict, List, Optional

import torch

__all__ = ["RANGE_PREFIX", "Span", "Tracer", "device_range"]

# every profiler range the program opens is named RANGE_PREFIX + cat/name
RANGE_PREFIX = "repro_torch/"
_NO_RANGE = contextlib.nullcontext()
# the range factory: a record function of operator scope
_RANGE = torch._C._profiler._RecordFunctionFast


def device_range(name: str, cat: str):
    """A profiler range ``repro_torch/<cat>/<name>`` while torch.profiler
    records, else a shared no-op context: off, it costs one flag check.
    The range has operator scope, so it adds a host event and no device
    event (see the module docstring)."""
    if torch._C._autograd._profiler_enabled():
        return _RANGE(f"{RANGE_PREFIX}{cat}/{name}")
    return _NO_RANGE


# Metadata records reuse the full event schema (ts/dur keys and all) so
# every element of traceEvents validates against the same OBS_SCHEMA.
_EVENT_KEYS = ("pid", "tid", "ts", "dur", "name", "cat", "ph")


class Span:
    """An open span: entered at construction time, closed on `end()` /
    context exit. The no-op singleton (`tracer disabled`) shares this
    class with `_live=False` so the hot path has no isinstance checks.
    A live span holds its profiler range (`device_range`) open until it
    ends."""

    __slots__ = ("_tracer", "name", "cat", "lane", "args", "_t0", "_live",
                 "_range")

    def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
                 lane: str, args: Optional[dict], t0: float, live: bool,
                 rng=None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.lane = lane
        self.args = args
        self._t0 = t0
        self._live = live
        self._range = rng

    def end(self, **extra_args) -> None:
        if not self._live:
            return
        self._live = False
        self._range.__exit__(None, None, None)
        tr = self._tracer
        args = self.args
        if extra_args:
            args = {**(args or {}), **extra_args}
        tr.event(self.name, cat=self.cat, lane=self.lane, ts=self._t0,
                 dur=tr.clock() - self._t0, args=args)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


_NULL_SPAN = Span(None, "", "", "", None, 0.0, live=False)


class Tracer:
    """Record spans/instants; export Chrome trace-event JSON.

    enabled: when False every recording call is a no-op returning a
        shared singleton — the zero-cost default for serving.
    clock: seconds-valued monotonic callable (injectable for tests;
        HEServer passes its own clock so queue timestamps and trace
        timestamps share one axis).
    pid: the trace-event process id (one server = one pid).
    max_events: hard cap on retained events — a tracer left on for a
        week must not become its own unbounded-memory bug. Overflow
        drops new events and counts them (`dropped`).
    """

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 pid: int = 1, max_events: int = 1_000_000):
        self.enabled = enabled
        self.clock = clock if clock is not None else time.perf_counter
        self.pid = pid
        self.max_events = max_events
        self.dropped = 0
        self._events: List[dict] = []
        self._lanes: Dict[str, int] = {}
        self._t0 = self.clock()

    # ---- recording --------------------------------------------------------

    def _lane_tid(self, lane: str) -> int:
        tid = self._lanes.get(lane)
        if tid is None:
            tid = self._lanes[lane] = len(self._lanes)
            # thread_name metadata so Perfetto labels the lane; carries
            # the full event key set (see module docstring).
            self._events.append({
                "pid": self.pid, "tid": tid, "ts": 0.0, "dur": 0.0,
                "name": "thread_name", "cat": "__metadata", "ph": "M",
                "args": {"name": lane},
            })
        return tid

    def event(self, name: str, *, cat: str, lane: str, ts: float,
              dur: float = 0.0, args: Optional[dict] = None) -> None:
        """Append one complete event with EXPLICIT clock-domain
        timestamps (seconds on this tracer's clock). The server emits
        lifecycle events from queue-recorded times (`t_submit`) rather
        than wrapping code in spans — that needs the explicit form."""
        if not self.enabled:
            return
        if len(self._events) >= self.max_events:
            self.dropped += 1
            return
        ev = {
            "pid": self.pid, "tid": self._lane_tid(lane),
            "ts": (ts - self._t0) * 1e6,        # trace-event µs
            "dur": dur * 1e6,
            "name": name, "cat": cat, "ph": "X",
        }
        if args is not None:
            ev["args"] = args
        self._events.append(ev)

    def span(self, name: str, *, cat: str, lane: str,
             args: Optional[dict] = None) -> Span:
        """Open a span at now(); closes (and records) on end()/exit.
        While torch.profiler records, the span is also the profiler range
        ``repro_torch/<cat>/<name>``."""
        if not self.enabled:
            return _NULL_SPAN
        rng = device_range(name, cat)
        rng.__enter__()
        return Span(self, name, cat, lane, args, self.clock(), live=True,
                    rng=rng)

    def instant(self, name: str, *, cat: str, lane: str,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self.event(name, cat=cat, lane=lane, ts=self.clock(), args=args)

    # ---- export -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> List[dict]:
        return self._events

    def to_chrome(self) -> dict:
        """The Chrome trace-event container Perfetto /
        chrome://tracing load directly."""
        return {"traceEvents": list(self._events),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Write trace JSON; returns the event count (metadata
        included)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return len(self._events)

    def clear(self) -> None:
        """Drop recorded events and lane metadata; keep the clock/t0 so
        timestamps stay on one axis across measurement windows."""
        self._events = []
        self._lanes = {}
        self.dropped = 0
