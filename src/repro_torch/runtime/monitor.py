"""Step-time SLA monitoring and heartbeats (straggler mitigation layer).

The failure seen most often in a fleet is not a crash but a slow worker:
one host's step time degrades (thermals, ECC retries, a flaky link) and
whatever waits on it is dragged along. The monitor keeps an EMA of step
wall-time and flags breaches of ``slack × EMA``.

Heartbeat files let an external supervisor detect a hung process (no write
within `timeout`) and kill/restart it — the standard watchdog contract.
The multi-host serving tier (``repro_torch.hserve.frontend``) reads them
to declare a worker dead.

This is the JAX package's ``runtime/monitor.py``, copied (it is pure
Python; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional


class StepMonitor:
    """EMA step-time SLA with breach-streak re-anchoring.

    The EMA deliberately freezes during a breach (a straggler must not
    drag the baseline up, or the alert stops firing exactly when the
    degradation persists). But a PERMANENT degradation — the pod now
    just runs at 2.5× — would then breach forever, burying real alerts
    in noise. After `reanchor_after` CONSECUTIVE breaches the monitor
    concedes the new normal and re-anchors the baseline to the streak's
    minimum step time, capped at `reanchor_cap × EMA` so one re-anchor
    can never absorb an unbounded regression in a single jump (a 100×
    degradation re-baselines in capped stages, each logged). Re-anchors
    are recorded in `reanchors` — the degrade event the launcher's
    policy escalates on even once the alerts quiesce.
    """

    def __init__(self, ema_alpha: float = 0.1, slack: float = 2.0,
                 warmup_steps: int = 3, reanchor_after: int = 8,
                 reanchor_cap: float = 4.0):
        self.alpha = ema_alpha
        self.slack = slack
        self.warmup = warmup_steps
        self.reanchor_after = reanchor_after
        self.reanchor_cap = reanchor_cap
        self.ema: Optional[float] = None
        self.count = 0
        self.breaches = []
        self.reanchors = []          # (step, old_ema, new_ema)
        self._streak = 0
        self._streak_min = float("inf")
        # per-publisher child monitors (multi-host: one per worker id) —
        # see `record(worker=...)`
        self._per: Dict[object, "StepMonitor"] = {}

    def for_worker(self, worker) -> "StepMonitor":
        """The child monitor for one publisher (same knobs), created on
        first use. A single StepMonitor fed by N workers would mix their
        step-time distributions into one EMA — worker 0's fast steps
        would make worker 1's normal steps read as breaches, and one
        straggling worker would drag every baseline. Namespacing by
        worker id keeps each publisher's SLA independent (the same
        collision the registry's `merge_snapshots` solves for labels)."""
        if worker not in self._per:
            self._per[worker] = StepMonitor(
                ema_alpha=self.alpha, slack=self.slack,
                warmup_steps=self.warmup,
                reanchor_after=self.reanchor_after,
                reanchor_cap=self.reanchor_cap)
        return self._per[worker]

    def record(self, step: int, seconds: float, worker=None) -> bool:
        """Returns True if this step breached the SLA (straggler signal).
        With `worker`, the sample routes to that publisher's child
        monitor instead of the shared baseline."""
        if worker is not None:
            return self.for_worker(worker).record(step, seconds)
        self.count += 1
        if self.count <= self.warmup:
            # min over warmup: the first step carries compilation time and
            # must not poison the baseline.
            self.ema = seconds if self.ema is None else min(self.ema,
                                                            seconds)
            return False
        breach = seconds > self.slack * self.ema
        if breach:
            self.breaches.append((step, seconds, self.ema))
            self._streak += 1
            self._streak_min = min(self._streak_min, seconds)
            if self._streak >= self.reanchor_after:
                # concede the new normal: anchor to the best the streak
                # ever did (not its mean — a recovering pod should not
                # inherit its worst steps), capped so one jump is
                # bounded
                new = min(self._streak_min, self.reanchor_cap * self.ema)
                self.reanchors.append((step, self.ema, new))
                self.ema = new
                self._streak = 0
                self._streak_min = float("inf")
        else:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * seconds
            self._streak = 0
            self._streak_min = float("inf")
        return breach


class Heartbeat:
    """Watchdog file with an optional live-telemetry payload.

    `metrics` duck-types `repro_torch.obs.MetricsRegistry` (anything with a
    `snapshot() -> dict`): each beat embeds the current snapshot under
    a "metrics" key, so the supervisor reading the heartbeat for
    liveness gets the serving telemetry plane for free — the health
    channel the multi-host tier consumes. `metrics` may instead be a
    dict of {publisher_id: registry-or-snapshot}: multiple publishers'
    snapshots are then merged with their label spaces namespaced by
    publisher id (`repro_torch.obs.registry.merge_snapshots`), so two workers
    both counting "worker.batches" never collide in one heartbeat.

    `clock` is the timestamp source for the "time" field AND the
    interval gate (default wall `time.time`). The frontend's in-process
    fault tests inject their fake clock here so `is_alive(..., now=...)`
    compares on one timeline; subprocess workers keep wall time, which
    matches the frontend's wall-clock death detection.
    """

    def __init__(self, path: str, interval: float = 10.0, metrics=None,
                 clock: Callable[[], float] = time.time):
        self.path = path
        self.interval = interval
        self.metrics = metrics
        self._clock = clock
        self._last: Optional[float] = None

    def _metrics_doc(self) -> dict:
        m = self.metrics
        if isinstance(m, dict):
            from repro_torch.obs.registry import merge_snapshots
            return merge_snapshots({
                str(k): (v.snapshot() if hasattr(v, "snapshot")
                         else dict(v))
                for k, v in m.items()})
        return m.snapshot()

    def beat(self, step: int, payload: Optional[dict] = None) -> None:
        now = self._clock()
        if self._last is not None and now - self._last < self.interval:
            return
        self._last = now
        doc = {"step": step, "time": now, **(payload or {})}
        if self.metrics is not None:
            doc["metrics"] = self._metrics_doc()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, timeout: float,
                 now: Optional[float] = None) -> bool:
        """Whether the file was beaten within `timeout` of `now`
        (default wall time; pass a fake-clock reading when the beats
        were stamped by an injected clock)."""
        try:
            with open(path) as f:
                data = json.load(f)
            t = time.time() if now is None else now
            return t - data["time"] < timeout
        except (OSError, ValueError, KeyError):
            return False
