"""Circuit-aware scheduler: lookahead co-batching + table prefetch.

`HEServer.submit_circuit` drops each READY node into the generic FIFO
queue, so two circuits one stage out of phase never share a batch: the
drain policy pads circuit A's lone (op, level) bucket while circuit B's
identical node is one parent-completion away from joining it. That
throws away exactly the win the paper's batching argument (§V) and
Medha's microcoded instruction scheduling are about — the level schedule
of a validated circuit is KNOWN ahead of execution, so the server can
look at it.

:class:`CircuitScheduler` walks every submitted circuit's validated
(logq, logp) schedule (`hserve.circuit.circuit_schedule`) and keeps, per
queue bucket key, the set of nodes that are *going to* arrive:

  - **Lookahead co-batching** — `expected_within(key, horizon)` counts
    not-yet-ready nodes whose bucket key matches and whose chain of
    unfinished ancestors is at most `horizon` engine batches deep. The
    server's drain flush defers an under-full bucket with expected
    siblings in favor of one with none, so the sibling lands in the same
    batch instead of a padded straggler pair (cross-circuit co-batch
    rate and pad_frac are in `HEServer.stats()`).
  - **Progress guarantee** — deferral alone DEADLOCKS: in a 2-deep
    circuit [mul(x,x), mul(0,0)] both nodes share one bucket key, so the
    only non-empty bucket "expects a sibling" whose parent is the bucket
    itself, and a drain that keeps deferring never serves anything.
    `drain_key` therefore always returns SOME non-empty bucket — when
    every candidate is deferred, the oldest flushes anyway (the expected
    sibling's parent is necessarily queued or in flight, so flushing it
    is the only way the sibling ever arrives).
  - **Table prefetch** — `prefetch_levels(...)` materializes the NEXT
    levels' TableCache row/column slices (and their per-np iCRT entries,
    the only host-side build) while the current batch is in flight,
    riding the same `OpEngine.dispatch`/`wait` double buffer the overlap
    path uses. Successor levels come from the registered schedules; the
    batch op's own output level (rescale/mod-down) is prefetched too.

The scheduler NEVER changes results — it only reorders drain flushes
and warms caches — so scheduled vs. unscheduled serving is bitwise
identical.

This is the JAX package's ``hserve/scheduler.py``; its cost model is
``repro_torch.analysis.cost.CostModel``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.hserve.queue import BucketKey

__all__ = ["CircuitScheduler"]


class _SchedCircuit:
    """Per-circuit lookahead state: the static schedule + progress."""

    __slots__ = ("keys", "int_args", "succ", "enqueued", "completed")

    def __init__(self, keys: List[BucketKey],
                 int_args: List[Tuple[int, ...]]):
        self.keys = keys
        self.int_args = int_args            # per node: earlier-node refs
        self.succ: List[Tuple[int, ...]] = [() for _ in keys]
        for i, args in enumerate(int_args):
            for a in set(args):
                self.succ[a] += (i,)
        self.enqueued: Set[int] = set()
        self.completed: Set[int] = set()

    def steps_to_ready(self, i: int, memo: Dict[int, int]) -> int:
        """Engine batches that must complete before node i can enter the
        queue: 0 if already enqueued (or done), else one more than its
        deepest unfinished ancestor chain."""
        if i in self.enqueued or i in self.completed:
            return 0
        if i in memo:
            return memo[i]
        memo[i] = d = 1 + max(
            (self.steps_to_ready(a, memo)
             for a in self.int_args[i] if a not in self.completed),
            default=0)
        return d


class CircuitScheduler:
    """Cross-circuit lookahead over validated level schedules.

    lookahead: horizon (in engine batches) within which a pending node
        counts as an expected sibling for its bucket; 0 disables
        deferral, larger values wait for deeper-chained siblings.
    cost_model: optional `repro_torch.analysis.cost.CostModel` consulted by
        the deferral decision: deferring a bucket is only worth a drain
        round trip when the padded batch it avoids actually costs
        device time. Limb-cheap buckets (add/rescale/mod_down at µs
        scale) flush immediately even with siblings coming — waiting
        saves padding on an op whose whole batch is cheaper than the
        bookkeeping. None (the default) keeps the pure
        expected_within policy, bit-for-bit.
    defer_min_s: the device-seconds a padded batch must waste before
        deferral is worth it (only read when cost_model is set).
    """

    def __init__(self, lookahead: int = 2, *, cost_model=None,
                 defer_min_s: float = 1e-3):
        if lookahead < 0:               # not assert: gone under python -O
            raise ValueError(f"lookahead must be >= 0, got {lookahead}")
        self.lookahead = lookahead
        self.cost_model = cost_model
        self.defer_min_s = defer_min_s
        self._circ: Dict[int, _SchedCircuit] = {}
        # pending (registered, not yet enqueued) nodes per bucket key
        self._expected: Dict[BucketKey, Set[Tuple[int, int]]] = {}
        self.deferrals = 0
        self.cost_skips = 0             # deferrals skipped as too cheap
        self.prefetches = 0
        self.prefetched_levels: Set[int] = set()

    # ---- circuit lifecycle (driven by HEServer) --------------------------

    def register(self, cid: int, keys: Sequence[BucketKey],
                 int_args: Sequence[Tuple[int, ...]]) -> None:
        """Adopt one validated circuit's schedule: per-node bucket keys
        and earlier-node argument references (str inputs excluded)."""
        sc = _SchedCircuit(list(keys), list(int_args))
        self._circ[cid] = sc
        for i, k in enumerate(sc.keys):
            self._expected.setdefault(k, set()).add((cid, i))

    def on_enqueued(self, cid: int, i: int) -> None:
        """Node i's request entered the queue: it is no longer expected —
        the queue itself now advertises it."""
        sc = self._circ.get(cid)
        if sc is None:
            return
        sc.enqueued.add(i)
        self._drop_expected(sc.keys[i], cid, i)

    def on_completed(self, cid: int, i: int) -> None:
        sc = self._circ.get(cid)
        if sc is None:
            return
        sc.enqueued.discard(i)
        sc.completed.add(i)

    def on_finished(self, cid: int) -> None:
        """Circuit done (its last node completed): purge every leftover
        expectation — dangling unsubmitted nodes will never arrive, and a
        stale expectation would defer their bucket forever."""
        sc = self._circ.pop(cid, None)
        if sc is None:
            return
        for i, k in enumerate(sc.keys):
            if i not in sc.enqueued and i not in sc.completed:
                self._drop_expected(k, cid, i)

    def _drop_expected(self, key: BucketKey, cid: int, i: int) -> None:
        s = self._expected.get(key)
        if s is not None:
            s.discard((cid, i))
            if not s:
                del self._expected[key]

    # ---- the flush-policy hooks ------------------------------------------

    def expected_within(self, key: BucketKey,
                        horizon: Optional[int] = None) -> int:
        """Pending same-key nodes at most `horizon` engine batches away
        (default: the configured lookahead)."""
        horizon = self.lookahead if horizon is None else horizon
        pend = self._expected.get(key)
        if not pend:
            return 0
        n = 0
        memos: Dict[int, Dict[int, int]] = {}
        for cid, i in pend:
            sc = self._circ[cid]
            if sc.steps_to_ready(i, memos.setdefault(cid, {})) <= horizon:
                n += 1
        return n

    def _worth_deferring(self, key: BucketKey, depth: int,
                         batch: int) -> bool:
        """Cost-model gate on deferral: is the padding this bucket
        would waste worth a drain round trip? Without a cost model,
        always yes (the pre-cost-model policy, bit-for-bit). With one,
        the padded lanes' estimated device-seconds must reach
        defer_min_s — an under-full add bucket at 2 limbs pads
        microseconds and should just flush."""
        if self.cost_model is None:
            return True
        op, logq = key[0], key[1]
        n_slots = key[2] if op == "slot_sum" else None
        pad_s = (batch - depth) * self.cost_model.op_seconds(
            op, logq, n_slots=n_slots)
        if pad_s >= self.defer_min_s:
            return True
        self.cost_skips += 1
        return False

    def drain_key(self, queue, batch: int) -> Optional[BucketKey]:
        """The drain flush's bucket choice: oldest non-empty bucket with
        no expected siblings within the lookahead horizon; under-full
        buckets with siblings coming are deferred (counted) — IF the
        cost model (when configured) says the avoided padding is worth
        device time (see :meth:`_worth_deferring`). PROGRESS
        GUARANTEE: if every non-empty bucket is deferred, the oldest
        flushes anyway — the sibling's parents sit in the queue or in
        flight, and deferring everything would stall drain() forever
        (the drain-vs-circuit deadlock this module's docstring walks
        through)."""
        depths = queue.bucket_depths()
        fallback = None
        for k, depth in depths.items():
            if fallback is None:
                fallback = k
            if depth < batch and self.expected_within(k) \
                    and self._worth_deferring(k, depth, batch):
                self.deferrals += 1
                continue
            return k
        return fallback

    # ---- prefetch ---------------------------------------------------------

    @staticmethod
    def levels_for_key(key: BucketKey) -> Set[int]:
        """Levels (logq) a request with this bucket key touches: its
        input level, plus — for the level-CHANGING ops, whose target is
        encoded in the key's extra — the level it produces. The single
        home of the op → output-level mapping (used both for successor
        keys and for the in-flight batch's own key). mod_raise walks
        UP the chain (a bootstrap circuit's raised-level tail): without
        it, prefetch only ever warms descending levels and every
        post-mod-raise node cold-misses the TableCache."""
        op, logq, extra = key
        out = {logq}
        if op == "rescale":
            out.add(logq - extra)
        elif op in ("mod_down", "mod_raise"):
            out.add(extra)
        return out

    def next_levels(self, tags: Iterable[Tuple[int, int]]) -> Set[int]:
        """Levels the successor nodes of the given (cid, node) tags will
        touch — inputs and (for level-dropping successors) outputs, so
        the slice exists before the grandchild's step ever asks for
        it."""
        out: Set[int] = set()
        for cid, i in tags:
            sc = self._circ.get(cid)
            if sc is None:
                continue
            for j in sc.succ[i]:
                if j not in sc.completed:
                    out |= self.levels_for_key(sc.keys[j])
        return out

    def prefetch_levels(self, cache, levels: Iterable[int]) -> int:
        """Materialize table slices for `levels` that the cache has not
        served yet (row/column views of the resident set + the per-np
        iCRT entries — the latter are the host-side build this hides
        behind the in-flight batch). Returns how many were cold."""
        n = 0
        for logq in levels:
            if cache.has_level(logq):
                continue
            cache.level_tables(logq)
            self.prefetches += 1
            self.prefetched_levels.add(logq)
            n += 1
        return n

    # ---- accounting -------------------------------------------------------

    def reset_counters(self) -> None:
        """Zero the deferral/prefetch counters (a fresh measurement
        window — HEServer.reset_metrics calls this); registered circuit
        schedules are kept."""
        self.deferrals = 0
        self.cost_skips = 0
        self.prefetches = 0
        self.prefetched_levels = set()

    def stats(self) -> dict:
        return {
            "lookahead": self.lookahead,
            "cost_model": self.cost_model is not None,
            "circuits_tracked": len(self._circ),
            "deferrals": self.deferrals,
            "cost_skips": self.cost_skips,
            "prefetches": self.prefetches,
            "prefetched_levels": sorted(self.prefetched_levels),
        }
