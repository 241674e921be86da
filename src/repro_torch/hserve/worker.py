"""Worker engine process for the multi-host serving tier.

A worker owns exactly the device-side half of ``HEServer``: one device, a
resident level-sliced :class:`TableCache`, and the :class:`OpEngine`
steps. Everything queue/scheduler/cache shaped stays on the frontend
(``repro_torch.hserve.frontend``); the worker only sees fully-assembled
fixed-shape batches arriving as transport frames, moves them to its
device, executes them, and frames the stacked results back as host arrays.

Requests cross the wire as metadata only (rid + per-operand
(logq, logp, n_slots) + op parameters) — the engine reads nothing else
off a ``Request`` once the batch arrays are assembled, so
:class:`_CtMeta` stands in for operand ciphertexts and no limb data is
duplicated outside the batch arrays.

Health: each worker publishes a ``runtime.monitor.Heartbeat`` file
embedding its :class:`MetricsRegistry` snapshot (``worker.*`` counters
plus engine/cache sources and the process's kernel launch counts). The
frontend's ``check_workers`` reads these; a stale heartbeat marks the
worker dead and its in-flight batch is requeued.

:func:`main` runs the subprocess loop: read an ``init`` frame from stdin
(params, device, the grid's shape, key material), then serve ``batch``/
``add_key``/``stats`` frames until ``shutdown``.

This is the JAX package's ``hserve/worker.py``: ``device=`` (default
"cuda") in place of ``mesh=``, and ``grid=`` (a HostGrid of data size 1,
this process its rank 0) for a model grid — the reference's
``(1, worker_devices)`` mesh: the cache and engine then hold this rank's
prime rows, and the worker's init, keys and every step are relayed, tagged
with its ``wid``, to the grid's other ranks, which run
``hserve.serve_follower`` (two in-process workers of one frontend share
its followers). A worker that cannot open its device fails its init;
there is no fallback to the CPU. Words cross the wire as the reference's
(``transport.words``: uint32 at β = 2^32, uint64 at β = 2^64).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.cipher import EvalKey
from repro_torch.core.context import resolve_device
from repro_torch.core.params import HEParams
from repro_torch.core.rns import kernels_on
from repro_torch.dist import comm
from repro_torch.hserve.engine import OpEngine
from repro_torch.hserve.queue import Batch, Request
from repro_torch.hserve.server import leader_backend
from repro_torch.hserve.tables import TableCache
from repro_torch.hserve.transport import words
from repro_torch.kernels import common
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.runtime.monitor import Heartbeat

__all__ = ["WorkerEngine", "main"]

_KEY_FIELDS = ("ax_ev", "ax_ev_shoup", "bx_ev", "bx_ev_shoup")


@dataclasses.dataclass(frozen=True)
class _CtMeta:
    """Operand stand-in: the level metadata the engine's output-wrap
    reads (`OpEngine._wrap` touches cts[i].logq/.logp/.n_slots only —
    the limb tensors already ride the batch's stacked arrays)."""

    logq: int
    logp: int
    n_slots: int


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A frame array as a CPU tensor without a copy; words become the
    port's stored bit patterns: uint32 as int32, uint64 as int64."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a)


def _eval_key(arrays: Dict[str, np.ndarray], prefix: str = "") -> EvalKey:
    return EvalKey(**{f: _tensor(arrays[prefix + f]) for f in _KEY_FIELDS})


def _batch_from_frame(head: Dict[str, Any],
                      arrays: Dict[str, np.ndarray]) -> Batch:
    """Rebuild an assembly-complete Batch from a "batch" frame (its
    tensors on the CPU; the engine places them)."""
    op, logq, extra = head["key"]
    key = (op, int(logq), None if extra is None else int(extra))
    reqs = []
    for m in head["reqs"]:
        cts = tuple(_CtMeta(logq=int(logq), logp=int(lp),
                            n_slots=int(m["n_slots"]))
                    for lp in m["logps"])
        reqs.append(Request(
            rid=int(m["rid"]), op=op, cts=cts, r=int(m.get("r", 0)),
            dlogp=int(m.get("dlogp", 0)), logq2=int(m.get("logq2", 0)),
            pt=None, pt_logp=int(m.get("pt_logp", 0))))
    return Batch(key=key, requests=reqs,
                 arrays={k: _tensor(v) for k, v in arrays.items()},
                 n_valid=int(head["n_valid"]))


class WorkerEngine:
    """One worker: device + TableCache + OpEngine behind a frame handler.

    Constructed directly by the frontend for the in-process transport,
    or from an ``init`` frame by :func:`main` for the subprocess one.
    Either way the message surface is :meth:`handle`.
    """

    def __init__(self, params: HEParams, evk=None, rot_keys=None,
                 conj_key=None, *, device: str | torch.device = "cuda",
                 wid: int = 0, grid=None,
                 clock: Callable[[], float] = time.perf_counter,
                 heartbeat_path=None, heartbeat_interval: float = 0.0,
                 heartbeat_clock: Optional[Callable[[], float]] = None,
                 use_kernels: bool = True, **engine_knobs):
        self.params = params
        self.wid = wid
        self.device = resolve_device(device)
        kernels_on(use_kernels, params)
        self.grid = grid if grid is not None and grid.model > 1 else None
        if self.grid is None:
            self.cache = TableCache(params, evk, rot_keys, conj_key,
                                    device=self.device)
            self.engine = OpEngine(params, self.device, self.cache,
                                   use_kernels=use_kernels, **engine_knobs)
        else:
            # rank 0 of a model grid: this worker's rows, announced to the
            # followers under its wid
            self.cache, self.engine = leader_backend(
                params, self.device, self.grid, evk, rot_keys, conj_key,
                wid=wid, who="a worker on a grid", use_kernels=use_kernels,
                **engine_knobs)
        self._clock = clock
        self.batches = 0
        self.registry = MetricsRegistry()
        self._c_batches = self.registry.counter("worker.batches")
        self._c_requests = self.registry.counter("worker.requests")
        self._h_wall = self.registry.histogram("worker.batch.wall_s")
        self.registry.add_source("cache", self.cache.stats)
        self.registry.add_source(
            "engine", lambda: {"steps_compiled": self.engine.n_compiled,
                               "compile_s": self.engine.compile_s})
        # kernel launches of this process since its last reset (a
        # subprocess worker's are its own; in-process workers share the
        # frontend process's counts)
        self.registry.add_source("kernels", lambda: dict(common.LAUNCHES))
        if self.grid is not None:
            # this rank's collectives in its steps and its relay (counts,
            # bytes, seconds)
            self.registry.add_source("grid", lambda: {
                "shape": self.grid.name,
                "step": comm.summary(self.grid, "step"),
                "feed": comm.summary(self.grid, "feed")})
        self.heartbeat = None
        if heartbeat_path is not None:
            # the heartbeat timestamp must live on the FRONTEND's
            # death-detection timeline (wall time.time for subprocess
            # workers, the injected fake clock for in-process tests) —
            # not on the perf_counter batch-wall clock.
            hb_clock = heartbeat_clock if heartbeat_clock is not None \
                else time.time
            self.heartbeat = Heartbeat(heartbeat_path,
                                       interval=heartbeat_interval,
                                       metrics=self.registry,
                                       clock=hb_clock)
            self.heartbeat.beat(step=0, payload={"wid": wid})

    def _beat(self) -> None:
        if self.heartbeat is not None:
            self.heartbeat.beat(step=self.batches,
                                payload={"wid": self.wid})

    def handle(self, head: Dict[str, Any], arrays: Dict[str, np.ndarray]
               ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
        """Dispatch one frontend frame; returns the reply frame parts."""
        t = head["type"]
        if t == "batch":
            reply = self.serve_batch(head, arrays)
        elif t == "add_key":
            ek = _eval_key(arrays)
            if head["kind"] == "rot":
                self.cache.add_rot_key(int(head["r"]), ek)
            elif head["kind"] == "conj":
                self.cache.add_conj_key(ek)
            else:
                raise ValueError(f"unknown key kind {head['kind']!r}")
            reply = ({"type": "ok"}, {})
        elif t == "stats":
            reply = ({"type": "stats",
                      "snapshot": self.registry.snapshot()}, {})
            if head.get("reset_launches"):
                common.reset_launches()
                if self.grid is not None:
                    comm.reset(self.grid)
        elif t == "shutdown":
            reply = ({"type": "ok"}, {})
        else:
            raise ValueError(f"unknown message type {t!r}")
        self._beat()
        return reply

    def serve_batch(self, head: Dict[str, Any],
                    arrays: Dict[str, np.ndarray]
                    ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        """Run one batch: `wall` is the engine's dispatch → ready (the
        host-to-device copy included), `d2h_s` the stacked results'
        copy back to the host."""
        b = _batch_from_frame(head, arrays)
        t0 = self._clock()
        outs, _ = self.engine.wait(self.engine.dispatch(b))
        wall = self._clock() - t0
        self.batches += 1
        self._c_batches.inc()
        self._c_requests.inc(b.n_valid)
        self._h_wall.add(wall)
        t1 = time.perf_counter()
        rarrays = {"ax": words(torch.stack([c.ax for c in outs]).cpu()),
                   "bx": words(torch.stack([c.bx for c in outs]).cpu())}
        rhead = {"type": "result", "seq": head["seq"], "wall": wall,
                 "d2h_s": time.perf_counter() - t1,
                 "outs": [{"logq": c.logq, "logp": c.logp,
                           "n_slots": c.n_slots} for c in outs]}
        return rhead, rarrays


def _keys_from_init(head: Dict[str, Any], arrays: Dict[str, np.ndarray]):
    """Rebuild (evk, rot_keys, conj_key) from an init frame's arrays
    (named ``evk.<f>`` / ``rot.<r>.<f>`` / ``conj.<f>``), as CPU tensors
    (the TableCache moves them to the worker's device)."""
    evk = _eval_key(arrays, "evk.") if head.get("has_evk") else None
    rot_keys = {int(r): _eval_key(arrays, f"rot.{r}.")
                for r in head.get("rot_rs", [])}
    conj_key = _eval_key(arrays, "conj.") if head.get("has_conj") else None
    return evk, rot_keys or None, conj_key


def main(out) -> None:
    """Subprocess entry: frames over stdin/stdout.

    `out` is the frame stream; the transport's command line reserves it
    before importing anything (see ``transport._WORKER_CMD``), which is
    the only way a worker starts. A worker that fails its init
    (no such device, a kernel build that fails) answers with an "error"
    frame and exits non-zero.

    An init frame whose ``"grid"`` is ``[1, R]`` with R > 1 makes this
    process rank 0 of its own R-rank grid: it spawns R − 1 followers
    beside it (``launch.mesh.spawn_followers`` running
    ``hserve.serve_follower``, on the worker's device) and serves every
    batch across them; its ack names their pids. A shutdown ends them;
    a follower whose worker is killed ends itself.
    """
    import sys

    from repro_torch.hserve.server import relay_stop, serve_follower
    from repro_torch.hserve.transport import read_frame, write_frame
    from repro_torch.launch.mesh import spawn_followers

    inp = sys.stdin.buffer
    head, arrays = read_frame(inp)
    if head["type"] != "init":
        raise SystemExit(f"expected init frame, got {head['type']!r}")
    grid = group = None
    try:
        params = HEParams(**head["params"])
        evk, rot_keys, conj_key = _keys_from_init(head, arrays)
        hb = head.get("heartbeat") or {}
        knobs = head.get("knobs", {})
        kernels_on(knobs.get("use_kernels", True), params)
        device = head["device"]
        model = int((head.get("grid") or [1, 1])[1])
        if model > 1:
            grid, group = spawn_followers(serve_follower, model=model,
                                          device=device, args=(params,))
            device = grid.device
        worker = WorkerEngine(
            params, evk, rot_keys, conj_key, device=device,
            wid=int(head.get("wid", 0)), grid=grid,
            heartbeat_path=hb.get("path"),
            heartbeat_interval=float(hb.get("interval", 0.0)), **knobs)
        if worker.device.type == "cuda" and knobs.get("use_kernels", True):
            common.library()            # build or load before the ack
    except Exception as e:                    # noqa: BLE001 — reported
        write_frame(out, {"type": "error",
                          "error": f"{type(e).__name__}: {e}"})
        if group is not None:
            group.join(timeout_s=0.0)
        raise SystemExit(1) from e
    del arrays                                # the cache holds the keys
    write_frame(out, {"type": "ok", "wid": worker.wid,
                      "device": str(worker.device),
                      "grid": None if grid is None else list(grid.shape),
                      "followers": [] if group is None else group.pids})
    timing: Dict[str, float] = {}
    while True:
        head, arrays = read_frame(inp, timing)
        if head["type"] == "shutdown" and grid is not None:
            relay_stop(grid)
            group.join()
            grid.close()
        reply = worker.handle(head, arrays)
        if reply is not None:
            if reply[0]["type"] == "result":
                reply[0]["read_s"] = timing["read_s"]
            write_frame(out, *reply)
        if head["type"] == "shutdown":
            break
