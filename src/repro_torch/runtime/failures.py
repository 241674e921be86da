"""Deterministic failure injection for fault-tolerance tests.

Simulates the pod-scale failure classes the launcher and the multi-host
serving tier must survive:
  - hard failure (process dies mid-step → restart from latest checkpoint),
  - straggler (a step takes k× longer → SLA breach surfaced by StepMonitor),
  - worker death (a serving worker vanishes after its Nth batch → the
    frontend requeues its in-flight work and re-routes; see
    `repro_torch.hserve.frontend.HEFrontend(injector=...)`).

This is the JAX package's ``runtime/failures.py``, copied (pure Python).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Mapping, Set


class SimulatedFailure(RuntimeError):
    pass


class FailureInjector:
    def __init__(self, fail_at_steps: Iterable[int] = (),
                 straggle_at_steps: Iterable[int] = (),
                 straggle_seconds: float = 0.5,
                 kill_worker_at: Mapping[int, int] | None = None):
        self.fail_at: Set[int] = set(fail_at_steps)
        self.straggle_at: Set[int] = set(straggle_at_steps)
        self.straggle_seconds = straggle_seconds
        self.fired: Set[int] = set()
        # worker-kill mode: {worker id: kill after this many dispatched
        # batches}. Deterministic by construction — the frontend asks
        # after every dispatch, and each worker dies at most once.
        self.kill_worker_at: Dict[int, int] = dict(kill_worker_at or {})
        self.killed_workers: Set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")
        if step in self.straggle_at and step not in self.fired:
            self.fired.add(step)
            time.sleep(self.straggle_seconds)

    def maybe_kill_worker(self, wid: int, n_batches: int) -> bool:
        """Should worker `wid` die now, having dispatched `n_batches`
        lifetime batches? Fires at most once per worker. The caller
        (the frontend, post-dispatch) actually kills the transport, so
        the batch in flight is lost mid-serve — the requeue path."""
        at = self.kill_worker_at.get(wid)
        if at is not None and n_batches >= at \
                and wid not in self.killed_workers:
            self.killed_workers.add(wid)
            return True
        return False
