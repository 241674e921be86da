"""The program's profiler ranges in a traced stretch, and what they read.

`repro_torch` opens a profiler range ``repro_torch/<cat>/<name>`` around
its Fig. 3 stages (``stage/crt``, ``stage/ntt``, ``stage/modmul``,
``stage/icrt``; ``stage/region1``, ``stage/region2``), its batched steps
(``step/mul``, ``step/rotate``) and, with a tracer on the server, its
spans (``server/poll``, ``server/submit``, ``server/prefetch``,
``lifecycle/batch_assemble``, ``lifecycle/dispatch``, …) while
torch.profiler records. The ranges are host events on the profiler's own
clock, so two reductions place the device's time in them:

- a device event goes to the innermost range that launched it: the host
  op its ``linked_correlation_id`` names (or, where that fails, the CUDA
  runtime call that shares its correlation id), then the innermost range
  open on that op's thread at the op's start;
- an idle gap of the device goes to the innermost range open on the
  issuing thread at the gap's midpoint.

Times are in microseconds from the trace's start, as `prof.events()`
gives them. Nothing here needs a card: the tests feed hand-built events.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import NamedTuple, Optional

PREFIX = "repro_torch/"
STAGES = ("crt", "ntt", "modmul", "icrt")
SERVER = PREFIX + "server/"
# the CUDA API's calls (cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync,
# …): each shares a correlation id with the device work it starts
RUNTIME = re.compile(r"^cu(da)?[A-Z]")


class Host(NamedTuple):
    thread: int
    start: float
    end: float
    name: str
    id: int = 0


class Device(NamedTuple):
    start: float
    end: float
    name: str
    id: int = 0        # the runtime call's correlation id
    linked: int = 0    # the launching host op's id


def events_of(prof) -> tuple:
    """(host events, device events) of a finished torch.profiler run; the
    GPU annotations of user-scope ranges are not device work and are
    left out."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append(Device(e.time_range.start, e.time_range.end,
                                  e.name, e.id,
                                  getattr(e, "linked_correlation_id", 0)))
        elif e.device_type == DeviceType.CPU:
            host.append(Host(e.thread, e.time_range.start, e.time_range.end,
                             e.name, e.id))
    return host, dev


def enclosing(ranges: list, points: list) -> list:
    """For each point, the tuple of `ranges` (Host events of one thread,
    properly nested) open at it, outermost first."""
    rs = sorted(ranges, key=lambda r: (r.start, -r.end))
    out: list = [()] * len(points)
    stack: list = []
    i = 0
    for k in sorted(range(len(points)), key=points.__getitem__):
        p = points[k]
        while i < len(rs) and rs[i].start <= p:
            while stack and stack[-1].end < rs[i].start:
                stack.pop()
            stack.append(rs[i])
            i += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out[k] = tuple(stack)
    return out


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def idle_gaps(dev: list, window: Optional[tuple] = None) -> list:
    """The device's idle intervals: between its busy intervals and, with
    a window (start, end), before the first and after the last."""
    busy = union((d.start, d.end) for d in dev)
    edges = [window[0]] if window else []
    for s, e in busy:
        edges += [s, e]
    if window:
        edges.append(window[1])
    elif edges:
        edges = edges[1:-1]
    return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]


def issuing_thread(host: list):
    """The thread that opened the most program ranges (the one that
    launches the work), or None."""
    n = Counter(h.thread for h in host if h.name.startswith(PREFIX))
    return n.most_common(1)[0][0] if n else None


class Attribution(NamedTuple):
    device_s: dict      # innermost range (None: none) -> device seconds
    idle_s: dict        # innermost range at the gap's middle -> seconds
    device_total_s: float
    stacks: list        # per device event: the ranges open at its launch


def launch_stacks(host: list, dev: list) -> list:
    """For each device event, the program ranges open where it was
    launched, outermost first: at the start of the host op that its
    `linked` id names, else of the runtime call that shares its `id`
    (an op that is itself a range ends its stack)."""
    ranges = defaultdict(list)
    ops, runtime = {}, {}
    for h in host:
        if h.name.startswith(PREFIX):
            ranges[h.thread].append(h)
        if RUNTIME.match(h.name):
            runtime[h.id] = h
        else:
            ops[h.id] = h
    launch = [ops.get(d.linked) if d.linked else None for d in dev]
    launch = [op if op is not None else runtime.get(d.id)
              for op, d in zip(launch, dev)]
    by_thread = defaultdict(list)
    for k, h in enumerate(launch):
        if h is not None:
            by_thread[h.thread].append(k)
    out: list = [()] * len(dev)
    for t, ks in by_thread.items():
        points = [launch[k].start for k in ks]
        for k, stack in zip(ks, enclosing(ranges[t], points)):
            if launch[k] in stack:
                stack = stack[:stack.index(launch[k]) + 1]
            out[k] = stack
    return out


def attribute(host: list, dev: list,
              window: Optional[tuple] = None) -> Attribution:
    """Each device event to the innermost range that launched it, each
    idle gap to the innermost range of the issuing thread at its middle."""
    stacks = launch_stacks(host, dev)
    device_s: Counter = Counter()
    for d, st in zip(dev, stacks):
        device_s[st[-1].name if st else None] += (d.end - d.start) * 1e-6
    main = issuing_thread(host)
    mine = [h for h in host if h.thread == main and h.name.startswith(PREFIX)]
    gaps = idle_gaps(dev, window)
    idle_s: Counter = Counter()
    for (a, b), st in zip(gaps, enclosing(mine, [(a + b) / 2
                                               for a, b in gaps])):
        idle_s[st[-1].name if st else None] += (b - a) * 1e-6
    return Attribution(dict(device_s), dict(idle_s),
                       sum(device_s.values()), stacks)


def launched_in(att: Attribution, dev: list, name: str) -> float:
    """Device seconds launched anywhere inside the range `name` (without
    the prefix), at any depth."""
    key = PREFIX + name
    return sum((d.end - d.start) * 1e-6 for d, st in zip(dev, att.stacks)
               if any(h.name == key for h in st))


def stage_ms(att: Attribution, window_s: float, ops: int) -> Optional[dict]:
    """Per HE operation: each Fig. 3 stage's charge (device time launched
    inside its range plus the idle gaps whose middle the host spent in
    it), and `other`, the rest of the stretch, so that the five sum to
    window_s / ops. None where the trace holds no program range."""
    if not ops or set(att.device_s) | set(att.idle_s) <= {None}:
        return None
    out = {}
    for s in STAGES:
        key = f"{PREFIX}stage/{s}"
        out[s] = 1e3 * (att.device_s.get(key, 0.0)
                        + att.idle_s.get(key, 0.0)) / ops
    out["other"] = 1e3 * window_s / ops - sum(out.values())
    return out


def covered_pct(att: Attribution) -> Optional[float]:
    """The share of the device time launched inside some program range."""
    if att.device_total_s <= 0:
        return None
    inside = sum(v for k, v in att.device_s.items() if k is not None)
    return 100.0 * inside / att.device_total_s


def server_idle_pct(host: list, dev: list, window: tuple) -> Optional[float]:
    """The share of the window in which the device is idle while the
    issuing thread is inside a server range (``server/submit``, or
    ``server/poll`` and all it holds). None without a server range."""
    main = issuing_thread(host)
    spans = union((h.start, h.end) for h in host
                  if h.thread == main and h.name.startswith(SERVER))
    if not spans or window[1] <= window[0]:
        return None
    both, j = 0.0, 0
    for a, b in idle_gaps(dev, window):
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            both += min(b, spans[k][1]) - max(a, spans[k][0])
            k += 1
    return 100.0 * both / (window[1] - window[0])


def nearest_rank(values: list, pct: float) -> Optional[float]:
    """The smallest value with at least pct % of the values at or below
    it; None without a value."""
    s = sorted(values)
    return s[max(0, math.ceil(len(s) * pct / 100) - 1)] if s else None


def queue_wait_p95_ms(events: list) -> Optional[float]:
    """The nearest-rank p95 of the tracer's ``bucket_wait`` durations
    (submit to pop from the bucket), in ms; None without one."""
    waits = [e["dur"] / 1e3 for e in events
             if e.get("name") == "bucket_wait" and e.get("ph") == "X"]
    return nearest_rank(waits, 95)
