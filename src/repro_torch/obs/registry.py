"""Unified metrics plane: counters, gauges, bounded histograms, sources.

One :class:`MetricsRegistry` per server process. Two publication
styles, both snapshot into a single JSON document:

  - **First-class instruments** — `counter(name)` / `gauge(name)` /
    `histogram(name)` return live handles a component increments on its
    own hot path. Histograms are :class:`~repro_torch.obs.stats.Reservoir`
    backed, so a registry never grows without bound.
  - **Pull sources** — `add_source(name, fn)` registers a zero-arg
    callable returning a dict; `snapshot()` calls it. This is how the
    existing stats surfaces (ServeMetrics.summary, TableCache.stats,
    CircuitScheduler.stats) publish without restructuring —
    the registry pulls their current view instead of them pushing every
    update.

Naming scheme: dotted lowercase,
`<component>.<noun>[.<unit>]` — e.g. `serve.polls`, `serve.batch.wall_s`,
`client.runs`. Source names are bare component names ("serve", "cache",
"scheduler") and own a sub-document each.

`snapshot()` output feeds `python -m repro_torch.launch.serve --he
--metrics PATH`. This is the JAX package's ``obs/registry.py``, ported
unchanged (it is pure Python).
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.obs.stats import Reservoir

__all__ = ["Counter", "Gauge", "MetricsRegistry", "merge_snapshots"]


class Counter:
    """Monotonic count. `inc()` on the hot path, value in snapshots."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set value (queue depth, inflight batches, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, x: float) -> None:
        self.value = float(x)


class MetricsRegistry:
    def __init__(self, histogram_capacity: int = 4096):
        self._histogram_capacity = histogram_capacity
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Reservoir] = {}
        self._sources: Dict[str, Callable[[], dict]] = {}

    # ---- instruments ------------------------------------------------------

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Reservoir:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Reservoir(
                capacity=self._histogram_capacity)
        return h

    # ---- pull sources -----------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Register (or replace) a snapshot contributor. Replacement is
        deliberate: `HEServer.reset_metrics` swaps in a fresh
        ServeMetrics and re-registers it under the same name."""
        self._sources[name] = fn

    def remove_source(self, name: str) -> None:
        self._sources.pop(name, None)

    # ---- export -----------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON document: instruments + every source's current view.
        A source that raises poisons health reporting exactly when it is
        needed most, so failures are captured inline instead."""
        out = {
            "counters": {k: c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }
        for name, fn in sorted(self._sources.items()):
            try:
                out[name] = fn()
            except Exception as e:          # noqa: BLE001 — see docstring
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out


def merge_snapshots(snaps: Dict[str, dict]) -> dict:
    """Merge per-publisher registry snapshots into one document with
    every label namespaced by its publisher id.

    Multi-host serving has N workers each publishing its own registry
    (every worker counts "worker.batches", sources its own "engine"
    view, ...). Naively dict-merging those snapshots silently keeps one
    publisher's value per colliding key; prefixing every instrument key
    and source name with ``"<publisher>."`` makes collisions impossible
    by construction while keeping the merged document's top-level shape
    (counters/gauges/histograms + source sub-docs) identical to a
    single registry's — heartbeat consumers parse either.
    """
    out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
    for pub, snap in sorted(snaps.items()):
        for section in ("counters", "gauges", "histograms"):
            for k, v in (snap.get(section) or {}).items():
                out[section][f"{pub}.{k}"] = v
        for name, sub in snap.items():
            if name in ("counters", "gauges", "histograms"):
                continue
            out[f"{pub}.{name}"] = sub
    return out
