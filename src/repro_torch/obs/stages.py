"""Fig. 3 stage attribution: where does an HE op's wall time go?

The paper's Fig. 3 buckets HE Mul wall time into CRT, NTT, modmul, and
iCRT — the measurement every optimization in §IV follows from. PyTorch
issues each stage asynchronously on the card, so no host clock sees a
stage unless it is fenced: :class:`StageTimer` fences the device before a
stage (so work queued ahead of it is not booked to it) and after it (a
CUDA event recorded behind the stage's launches and synchronized), then
reads the clock. Only the engine's ``profile_stages`` path threads a
timer through the stage bundle (``dist.he_pipeline.make_stage_fns``); the
stage math is unchanged, so profiling is bit for bit identical to
serving, just slower (the fences defeat asynchronous issue on purpose).
CPU tensors run synchronously and need no fence.

Taxonomy mapping (the Fig. 3 attribution contract):

  crt     — limbs → RNS residues (`_crt_b`)
  ntt     — forward NTT *and* inverse NTT (`_ntt_b`, `_intt_b`; the
            paper plots them as one transform bucket)
  modmul  — every eval-domain pointwise product: region-1 Montgomery
            muls and region-2 Shoup key products
  icrt    — RNS residues → limbs (`_icrt_b`)

Un-bucketed remainder (BigInt adds/shifts, automorphism permutes) is the
gap between the stage sum and the op's metered wall: the stages'
coverage of that wall.

`region("region1"/"region2")` additionally attributes Fig. 2's two
regions (ciphertext product vs key switch) per op.

This is the JAX package's ``obs/stages.py``; the fence
(``jax.block_until_ready`` there) is the only change, and the fence
before each stage is new.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Callable, Dict, Optional

import torch

__all__ = ["STAGES", "StageTimer"]

STAGES = ("crt", "ntt", "modmul", "icrt")


def _fence(out) -> None:
    """Wait until the card has finished `out`: a CUDA event recorded on
    the current stream of its device, synchronized. CPU tensors are
    complete when the call returns."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(out.device))
        ev.synchronize()


class StageTimer:
    """Accumulate per-op per-stage wall seconds with device fencing.

    tracer: optional :class:`repro_torch.obs.trace.Tracer` — each timed
        call also lands as a cat="stage" span on the "stage" lane.
    clock: injectable for tests (defaults to perf_counter; stage spans
        and the tracer should share one clock so the trace lines up).
    """

    def __init__(self, tracer=None,
                 clock: Optional[Callable[[], float]] = None):
        self.tracer = tracer
        self.clock = clock if clock is not None else time.perf_counter
        self._stage_s: Dict[str, Dict[str, float]] = defaultdict(
            lambda: {s: 0.0 for s in STAGES})
        self._calls: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {s: 0 for s in STAGES})
        self._region_s: Dict[str, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._op: str = "?"
        self._paused = 0

    # ---- scoping ----------------------------------------------------------

    @contextmanager
    def op(self, label: str):
        """Attribute nested timed() calls to this op kind ("mul", …)."""
        prev, self._op = self._op, label
        try:
            yield
        finally:
            self._op = prev

    @contextmanager
    def pause(self):
        """Suspend recording (warm-up runs must not pollute the
        steady-state attribution — `OpEngine.warm_batch` wraps its
        throwaway run in this)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ---- recording --------------------------------------------------------

    def timed(self, stage: str, thunk: Callable):
        """Run thunk between two device fences, book the elapsed wall
        under (current op, stage). Returns the thunk's result."""
        if self._paused:
            return thunk()
        if stage not in self._stage_s[self._op]:   # not assert: gone
            raise ValueError(                      # under python -O
                f"unknown stage {stage!r}; one of {STAGES}")
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()    # work queued before the stage
        t0 = self.clock()
        out = thunk()
        _fence(out)
        dt = self.clock() - t0
        self._stage_s[self._op][stage] += dt
        self._calls[self._op][stage] += 1
        if self.tracer is not None:
            self.tracer.event(stage, cat="stage", lane="stage", ts=t0,
                              dur=dt, args={"op": self._op})
        return out

    @contextmanager
    def region(self, name: str):
        """Attribute a Fig. 2 region ("region1" ciphertext product /
        "region2" key switch) for the current op. Region walls are
        host-elapsed: the stages inside are fenced, so only trailing
        un-bucketed work (BigInt shifts) issues past the exit."""
        if self._paused:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            dt = self.clock() - t0
            self._region_s[self._op][name] += dt
            if self.tracer is not None:
                self.tracer.event(name, cat="stage", lane="stage", ts=t0,
                                  dur=dt, args={"op": self._op})

    # ---- export -----------------------------------------------------------

    def stage_total(self, op: str) -> float:
        """Sum of the four Fig. 3 buckets for one op kind — the
        numerator of the stages' coverage of the op's metered wall."""
        return sum(self._stage_s[op].values()) if op in self._stage_s \
            else 0.0

    def summary(self) -> dict:
        return {
            "stages": {op: {s: v[s] for s in STAGES}
                       for op, v in sorted(self._stage_s.items())},
            "calls": {op: {s: v[s] for s in STAGES}
                      for op, v in sorted(self._calls.items())},
            "regions": {op: dict(v)
                        for op, v in sorted(self._region_s.items())},
        }

    def reset(self) -> None:
        self._stage_s.clear()
        self._calls.clear()
        self._region_s.clear()
