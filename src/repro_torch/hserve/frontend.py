"""HEFrontend: the multi-host disaggregated serving tier.

``HEServer`` owns both halves of serving: the queue/scheduler/plain-cache
frontend AND the device/tables/engine backend. This module splits them.
:class:`HEFrontend` keeps the engine-free serving core (it subclasses
HEServer and reuses ``_init_core`` / ``_choose_flush`` /
``_pop_assemble`` / ``_complete`` verbatim — submit, circuits, metrics,
scheduling are all inherited) and routes assembled batches to N
:class:`~repro_torch.hserve.worker.WorkerEngine` workers over
:mod:`~repro_torch.hserve.transport` frames. Each worker owns its device,
resident TableCache, and OpEngine steps — the per-host state that cannot
be shared across processes.

The frontend is the host tier: its core runs on the CPU
(``device="cpu"``), so its queue holds and assembles host tensors, which
frame without a copy, and a frontend with subprocess workers needs no
CUDA context at all. Workers default to ``"cuda"`` and do the host-to-
device and device-to-host copies themselves. Operands must lie on the
CPU at submit (``HESession`` moves them there explicitly); nothing is
moved silently.

Routing is (op, level)-bucket affinity with load-first tiebreak: an idle
worker always beats a busy one (a single hot bucket must spill across
hosts or scaling is zero), and among equally-loaded workers the one whose
step/table cache is already warm for the bucket wins — so in steady state
hot levels stay pinned to the worker holding their table slices, and a
spill warms exactly one new worker.

Health and death: workers publish ``runtime.monitor.Heartbeat`` files
(registry snapshots embedded); the frontend marks a worker dead on a
transport error OR a stale heartbeat (``check_workers``), requeues the
dead worker's in-flight batch at the original rids — circuit routing and
FIFO order survive — and re-routes on the next poll. Ops are
deterministic integer arithmetic, so a re-served batch is bitwise
identical to the first attempt. With every worker dead and work still
queued, :class:`NoLiveWorkersError` is raised (drain propagates it
instead of spinning); the batch that found no worker goes back to the
queue first, so after ``revive_workers()`` polling on serves every request
(the reference drops it).

``runtime.failures.FailureInjector(kill_worker_at={wid: n})`` drives
worker death deterministically.

This is the JAX package's ``hserve/frontend.py``. What differs:
``worker_device`` (a device string, default "cuda") and ``grid`` in place
of ``mesh``. The reference gives its workers a model mesh in two ways,
and so does the port: in-process workers share the frontend's ``grid=``
(a HostGrid of data size 1 whose rank 0 this process is; every worker
holds its rows there and relays its steps, tagged with its ``wid``, to
the other ranks, which run ``hserve.serve_follower``; ``close()`` ends
them), and with ``transport="subprocess"`` each worker process is rank 0
of its own ``(1, worker_devices)`` grid, its followers spawned beside it
on its device (the init frame carries the grid's shape; killing the
worker ends them, a respawn starts a new group). A worker that fails its
init raises :class:`WorkerDied` here, and the workers already started are
closed;
each worker keeps its init's seconds and bytes and a log of its last
batches' frame sizes and times (``frame_log``); :meth:`worker_stats`
asks every live worker for its registry snapshot (its kernel launch
counts included).
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.cipher import Ciphertext, EvalKey
from repro_torch.core.params import HEParams
from repro_torch.core.rns import kernels_on
from repro_torch.hserve.queue import Batch
from repro_torch.hserve.server import HEServer, relay_stop, traced_entry
from repro_torch.hserve.tables import PlainCache
from repro_torch.hserve.transport import (
    InProcTransport, SubprocessTransport, WorkerDied, words,
)
from repro_torch.hserve.worker import _KEY_FIELDS, WorkerEngine
from repro_torch.runtime.monitor import Heartbeat

__all__ = ["NoLiveWorkersError", "FrontendCatalog", "WorkerHandle",
           "HEFrontend"]

_HOST = torch.device("cpu")


class NoLiveWorkersError(RuntimeError):
    """Work is queued (or in flight) but every worker is dead — the
    typed drain-instead-of-hang contract of the fault tests."""


class FrontendCatalog:
    """The frontend's key/plain-operand catalog — TableCache's submit-
    time surface with NO device state.

    The frontend must answer "can this op be served?" at submit (the
    same raise-before-enqueue contract TableCache gives HEServer) and
    resolve plaintext operands, but the device copies of the keys live in
    the workers. So this holds the EvalKeys as given + a host PlainCache,
    mirrors TableCache's query API (evk/rot_key/conj_key/
    rotation_amounts/has_conj_key/put_plain/get_plain/has_plain), and
    forwards key additions to every live worker via the frontend's
    broadcast hook.
    """

    def __init__(self, params: HEParams, evk: Optional[EvalKey] = None,
                 rot_keys: Optional[Dict[int, EvalKey]] = None,
                 conj_key: Optional[EvalKey] = None,
                 plain_cache_mib: Optional[float] = 256.0):
        self.params = params
        self._ek = evk
        self._rot: Dict[int, EvalKey] = {
            int(r): rk for r, rk in (rot_keys or {}).items()}
        self._conj = conj_key
        self.plain = PlainCache(_HOST, cap_mib=plain_cache_mib)
        self.tracer = None
        # set by HEFrontend: broadcast(kind, r, key) ships a key to
        # every live worker before it can be referenced by a batch
        self._broadcast: Optional[Callable] = None

    # ---- submit-time key checks (same messages as TableCache) ---------

    def evk(self) -> EvalKey:
        if self._ek is None:
            raise ValueError("no evaluation key loaded (mul unavailable)")
        return self._ek

    def rot_key(self, r: int) -> EvalKey:
        try:
            return self._rot[int(r)]
        except KeyError:
            raise KeyError(
                f"no rotation key for r={r}; loaded: "
                f"{sorted(self._rot)}") from None

    def conj_key(self) -> EvalKey:
        if self._conj is None:
            raise ValueError(
                "no conjugation key loaded (conjugate unavailable)")
        return self._conj

    def add_rot_key(self, r: int, rk: EvalKey) -> None:
        r = int(r)
        new = r not in self._rot
        self._rot[r] = rk
        if new and self._broadcast is not None:
            self._broadcast("rot", r, rk)

    def add_conj_key(self, ck: EvalKey) -> None:
        new = self._conj is None
        self._conj = ck
        if new and self._broadcast is not None:
            self._broadcast("conj", 0, ck)

    @property
    def has_conj_key(self) -> bool:
        return self._conj is not None

    @property
    def rotation_amounts(self):
        return sorted(self._rot)

    # ---- plaintext operands (delegated; HEServer.submit's surface) ----

    def put_plain(self, h: str, logq: int, pt) -> torch.Tensor:
        return self.plain.put(h, logq, pt)

    def get_plain(self, h: str, logq: int) -> torch.Tensor:
        return self.plain.get(h, logq)

    def has_plain(self, h: str, logq: int) -> bool:
        return self.plain.has(h, logq)

    def stats(self) -> dict:
        return {
            "rot_keys": self.rotation_amounts,
            "conj_key": self.has_conj_key,
            "plain_entries": len(self.plain),
            "plain_hits": self.plain.hits,
            "plain_misses": self.plain.misses,
            "plain_evictions": self.plain.evictions,
            "plain_mib": round(self.plain.nbytes / 2**20, 3),
        }


class _Pending:
    """One dispatched-but-unretired batch on a worker."""

    __slots__ = ("batch", "seq", "t0", "frame")

    def __init__(self, batch: Batch, seq: int, t0: float, frame: dict):
        self.batch = batch
        self.seq = seq
        self.t0 = t0
        self.frame = frame


class WorkerHandle:
    """Frontend-side view of one worker: transport + routing state.

    init_s / init_bytes / init_send_s: the last init's seconds (process
    spawn → ack: interpreter start, imports, the init frame, keys and
    tables on the device, the kernels loaded; the engine's construction
    for in-process workers), its frame's size and the seconds writing it
    took (subprocess workers). frame_log: the last batches' frame sizes
    and times, one dict each."""

    def __init__(self, wid: int, transport, heartbeat_path=None):
        self.wid = wid
        self.transport = transport
        self.heartbeat_path = heartbeat_path
        self.alive = True
        self.pending: Optional[_Pending] = None
        # routing state: buckets this worker has served (its steps +
        # table slices are warm for these), and busy seconds
        self.keys_warm: set = set()
        self.busy_s = 0.0
        self.batches = 0             # lifetime dispatches (injector key)
        self.served_requests = 0
        self.init_s = 0.0
        self.init_bytes = 0
        self.init_send_s = 0.0
        self.followers: List[int] = []     # a worker grid's follower pids
        self.spawned_at = time.perf_counter()
        self.frame_log: deque = deque(maxlen=256)

    def stats(self) -> dict:
        return {"wid": self.wid, "alive": self.alive,
                "transport": self.transport.kind,
                "batches": self.batches,
                "served_requests": self.served_requests,
                "busy_s": round(self.busy_s, 6),
                "keys_warm": sorted(str(k) for k in self.keys_warm),
                "pending": self.pending is not None,
                "init_s": round(self.init_s, 6),
                "init_bytes": self.init_bytes,
                "init_send_s": round(self.init_send_s, 6),
                "followers": list(self.followers)}


def _host(t: torch.Tensor) -> torch.Tensor:
    """A key tensor on the host, for framing (keys are framed at init and
    broadcast, never on the dispatch path)."""
    return t if t.device.type == "cpu" else t.cpu()


def _key_arrays(ek: EvalKey, prefix: str = "") -> Dict[str, object]:
    return {prefix + f: words(_host(getattr(ek, f))) for f in _KEY_FIELDS}


def _key_frames(evk: Optional[EvalKey], rot: Dict[int, EvalKey],
                conj: Optional[EvalKey]) -> Dict[str, object]:
    """Flatten key material into init-frame array names."""
    out: Dict[str, object] = {}
    if evk is not None:
        out.update(_key_arrays(evk, "evk."))
    for r, rk in rot.items():
        out.update(_key_arrays(rk, f"rot.{r}."))
    if conj is not None:
        out.update(_key_arrays(conj, "conj."))
    return out


class HEFrontend(HEServer):
    """The frontend process of the disaggregated serving tier.

    Inherits the whole intake/scheduling surface from HEServer (submit,
    submit_circuit, drain, metrics, the flush policy) and replaces the
    local engine with routed dispatch to `workers` worker engines.

    transport: "inproc" (worker engines in this process, framed — the
        default; they share this process's card) or "subprocess" (fresh
        interpreters running ``repro_torch.hserve.worker``, each with its
        own CUDA context).
    worker_device: the device every worker serves on (default "cuda"; a
        worker that cannot open it fails its init and this constructor
        raises — there is no fallback). "cpu" runs the plain versions.
        With `grid`, the grid's device.
    grid: a HostGrid of data size 1 whose rank 0 this process is (the
        others run ``hserve.serve_follower``): the in-process workers
        spread their tables, keys and steps over its model ranks. Needs
        ``transport="inproc"``; `close()` ends the followers.
    worker_devices: with ``transport="subprocess"``, the model ranks of
        each worker process's own grid (the reference's knob): R > 1
        spawns R − 1 followers beside each worker, on its device.
    use_kernels: as HEServer's; at β = 2^64 pass False (True raises
        here).
    injector: optional `runtime.failures.FailureInjector` whose
        `kill_worker_at` schedule this frontend consults after every
        dispatch (deterministic worker death for tests/benches).
    heartbeat_dir / heartbeat_timeout / heartbeat_interval: worker
        health files; `check_workers()` marks a worker dead when its
        file goes stale past the timeout. In-process workers beat on
        the frontend's (injectable) clock; subprocess workers beat on
        wall time.

    Unsupported vs HEServer: `overlap` (the per-worker pipeline IS the
    overlap — every worker holds one in-flight batch while the frontend
    assembles the next) and `profile_stages` (a worker-local measurement
    mode; run it on a single HEServer).
    """

    def __init__(self, params: HEParams, evk: Optional[EvalKey] = None,
                 rot_keys: Optional[Dict[int, EvalKey]] = None,
                 conj_key: Optional[EvalKey] = None, *,
                 workers: int = 2, transport: str = "inproc",
                 worker_device: str = "cuda", grid=None,
                 worker_devices: int = 1, batch: int = 8,
                 use_kernels: bool = True,
                 max_age_s: Optional[float] = None,
                 adaptive_target: bool = True,
                 schedule: bool = False, lookahead: int = 2,
                 cost_model=None,
                 plain_cache_mib: Optional[float] = 256.0,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None, registry=None, injector=None,
                 heartbeat_dir: Optional[str] = None,
                 heartbeat_timeout: float = 30.0,
                 heartbeat_interval: float = 0.0,
                 **engine_knobs):
        if workers < 1:
            raise ValueError(f"need at least one worker, got {workers}")
        if transport not in ("inproc", "subprocess"):
            raise ValueError(f"unknown transport {transport!r} "
                             "(inproc | subprocess)")
        kernels_on(use_kernels, params)
        grid = grid if grid is not None and grid.model > 1 else None
        if grid is not None:
            if transport != "inproc":
                raise ValueError(
                    "grid= spreads in-process workers over a model grid; "
                    "subprocess workers take worker_devices= (each its "
                    "own grid)")
            if grid.rank != 0 or grid.data != 1:
                raise ValueError(
                    f"HEFrontend(grid=) runs on rank 0 of a grid of data "
                    f"size 1; got rank {grid.rank} of {grid.name}")
            worker_device = str(grid.device)
        if worker_devices < 1 or (worker_devices > 1
                                  and transport != "subprocess"):
            raise ValueError(
                f"worker_devices={worker_devices}: a worker process's own "
                f"grid needs transport='subprocess' (in-process workers "
                f"take grid=)")
        self.grid = grid
        self._open = grid is not None
        self.worker_devices = worker_devices
        self.cache = FrontendCatalog(params, evk, rot_keys, conj_key,
                                     plain_cache_mib=plain_cache_mib)
        self.engine = None           # no local engine — workers own them
        self._init_core(params, device=_HOST, batch=batch,
                        max_age_s=max_age_s,
                        adaptive_target=adaptive_target, overlap=False,
                        schedule=schedule, lookahead=lookahead,
                        cost_model=cost_model, prefetch=False,
                        clock=clock, tracer=tracer, registry=registry)
        self.injector = injector
        self.transport_kind = transport
        self.heartbeat_timeout = heartbeat_timeout
        # spawn-time worker config, kept so revive_workers() can replay
        # a full init frame into a respawned subprocess worker
        self.worker_device = str(worker_device)
        self.heartbeat_interval = heartbeat_interval
        self.use_kernels = use_kernels
        self.engine_knobs = dict(engine_knobs)
        self._seq = 0
        # results completed out-of-poll (quiesce before a key
        # broadcast, eager retires) buffer here until the next poll
        self._ready: List[Tuple[int, Ciphertext]] = []
        self.workers: List[WorkerHandle] = []
        try:
            self._start_workers(workers, transport, heartbeat_dir, clock)
        except BaseException:
            self.close()                 # no worker process outlives us
            raise
        self.cache._broadcast = self._broadcast_key
        self._c_deaths = self.registry.counter("worker.deaths")
        self._c_requeued = self.registry.counter(
            "worker.requeued_requests")
        self._g_alive = self.registry.gauge("worker.alive")
        self._g_alive.set(len(self.workers))
        for w in self.workers:
            self.registry.add_source(f"worker{w.wid}", w.stats)

    # ---- worker lifecycle ------------------------------------------------

    def _start_workers(self, n: int, transport: str,
                       heartbeat_dir: Optional[str], clock) -> None:
        cat = self.cache
        for wid in range(n):
            hb_path = None
            if heartbeat_dir is not None:
                hb_path = os.path.join(heartbeat_dir,
                                       f"worker{wid}.heartbeat.json")
            if transport == "inproc":
                t0 = time.perf_counter()
                eng = WorkerEngine(
                    self.params, cat._ek, dict(cat._rot) or None,
                    cat._conj, device=self.worker_device, wid=wid,
                    clock=clock, heartbeat_path=hb_path,
                    heartbeat_interval=self.heartbeat_interval,
                    heartbeat_clock=clock, use_kernels=self.use_kernels,
                    grid=self.grid, **self.engine_knobs)
                w = WorkerHandle(wid, InProcTransport(eng),
                                 heartbeat_path=hb_path)
                w.init_s = time.perf_counter() - t0
                self.workers.append(w)
            else:
                # every process starts (and imports) at once; the init
                # frames follow
                self.workers.append(WorkerHandle(
                    wid, SubprocessTransport(device=self.worker_device),
                    heartbeat_path=hb_path))
        if transport == "subprocess":
            for w in self.workers:
                self._send_worker_init(w)
            # collect each worker's init ack (keys loaded, device up)
            for w in self.workers:
                self._await_init(w)

    def _send_worker_init(self, w: WorkerHandle) -> None:
        """Ship the init frame (params/device/knobs + ALL current key
        material) to a fresh subprocess worker. Reads keys from the
        catalog, not the constructor args, so a respawned worker also
        receives keys that were added (auto-provisioned rotations) after
        the fleet first came up. The caller awaits the ack
        (:meth:`_await_init`)."""
        cat = self.cache
        init = {"type": "init",
                "params": dataclasses.asdict(self.params),
                "device": w.transport.device,
                "grid": [1, self.worker_devices],
                "wid": w.wid,
                "has_evk": cat._ek is not None,
                "rot_rs": sorted(cat._rot),
                "has_conj": cat._conj is not None,
                "heartbeat": {"path": w.heartbeat_path,
                              "interval": self.heartbeat_interval}
                if w.heartbeat_path else None,
                "knobs": {"use_kernels": self.use_kernels,
                          **self.engine_knobs}}
        w.transport.send(init, _key_frames(cat._ek, cat._rot, cat._conj))
        w.init_bytes = w.transport.last_send["bytes"]
        w.init_send_s = w.transport.last_send["write_s"]

    def _await_init(self, w: WorkerHandle) -> None:
        head, _ = w.transport.recv()
        w.init_s = time.perf_counter() - w.spawned_at
        if head.get("type") != "ok":
            raise WorkerDied(f"worker {w.wid} failed init: {head}")
        w.followers = list(head.get("followers", []))

    def _alive_workers(self) -> List[WorkerHandle]:
        return [w for w in self.workers if w.alive]

    def _on_death(self, w: WorkerHandle, cause: str) -> None:
        """Mark a worker dead and requeue its in-flight batch (original
        rids — circuit routing and metrics bookkeeping survive)."""
        if not w.alive:
            return
        w.alive = False
        try:
            w.transport.kill()
        except Exception:                     # noqa: BLE001 — best effort
            pass
        self._c_deaths.inc()
        self._g_alive.set(len(self._alive_workers()))
        if w.pending is not None:
            reqs = w.pending.batch.requests[:w.pending.batch.n_valid]
            self.queue.requeue(reqs)
            self._c_requeued.inc(len(reqs))
            w.pending = None
        if self._tracer is not None:
            self._tracer.event(
                "worker_death", cat="worker", lane=f"worker{w.wid}",
                ts=self._clock(), args={"wid": w.wid, "cause": cause})

    def check_workers(self, now: Optional[float] = None) -> None:
        """Heartbeat sweep: a live worker whose heartbeat file has gone
        stale past `heartbeat_timeout` is declared dead (its in-flight
        batch requeues). In-process workers beat on the frontend's
        injected clock, so pass the same clock's reading via `now`
        (default: this frontend's clock for inproc, wall time for
        subprocess workers)."""
        for w in self._alive_workers():
            if w.heartbeat_path is None:
                continue
            t = now
            if t is None and w.transport.kind == "inproc":
                t = self._clock()
            if not Heartbeat.is_alive(w.heartbeat_path,
                                      self.heartbeat_timeout, now=t):
                self._on_death(w, "heartbeat_timeout")

    def revive_workers(self) -> None:
        """Bring every killed worker back online and restore the fleet
        to full strength.

        In-process workers are un-killed in place — their engines kept
        their built steps. Subprocess workers are RESPAWNED: a new
        interpreter comes up, the init frame is replayed with the
        catalog's CURRENT key material (including keys broadcast after
        the original spawn), and the "ok" ack is awaited before the
        worker is routable. The fresh process has no steps or table
        slices, so its warm-bucket routing state resets; anything it was
        serving when it died was already requeued at death, and
        re-served batches are bitwise identical (deterministic integer
        ops)."""
        respawned: List[WorkerHandle] = []
        for w in self.workers:
            if w.alive:
                continue
            if w.transport.kind == "inproc":
                w.transport.revive()     # engine kept its built steps
            else:
                w.spawned_at = time.perf_counter()
                w.transport.respawn()
                self._send_worker_init(w)
                w.keys_warm = set()      # blank interpreter: nothing warm
                respawned.append(w)
            w.alive = True
            w.pending = None
        for w in respawned:
            try:
                self._await_init(w)
            except WorkerDied:
                w.alive = False
                raise
        self._g_alive.set(len(self._alive_workers()))

    # ---- key broadcast ---------------------------------------------------

    def _quiesce(self, w: WorkerHandle) -> bool:
        """Retire `w`'s pending batch into the ready buffer so the strict
        request-reply protocol stays in step; False if it died."""
        if w.pending is not None:
            self._retire_worker(w)
        return w.alive

    def _broadcast_key(self, kind: str, r: int, ek: EvalKey) -> None:
        """Ship a late-added key to every live worker, each quiesced
        first."""
        arrays = _key_arrays(ek)
        for w in self._alive_workers():
            if not self._quiesce(w):
                continue
            try:
                w.transport.send({"type": "add_key", "kind": kind,
                                  "r": r}, arrays)
                head, _ = w.transport.recv()
                if head.get("type") != "ok":
                    raise WorkerDied(f"add_key nacked: {head}")
            except WorkerDied:
                self._on_death(w, "transport")

    def worker_stats(self, reset_launches: bool = False) -> Dict[int, dict]:
        """{wid: registry snapshot} of every live worker, each quiesced
        first; the snapshot's "kernels" source holds the worker
        process's kernel launch counts, which `reset_launches` sets to 0
        after reading (with a worker grid's collective logs, the
        snapshot's "grid" source)."""
        out: Dict[int, dict] = {}
        for w in self._alive_workers():
            if not self._quiesce(w):
                continue
            try:
                w.transport.send({"type": "stats",
                                  "reset_launches": reset_launches})
                head, _ = w.transport.recv()
            except WorkerDied:
                self._on_death(w, "transport")
                continue
            out[w.wid] = head["snapshot"]
        return out

    # ---- routed dispatch (replaces the local engine) ---------------------

    def _route(self, b: Batch) -> WorkerHandle:
        """Pick a worker: load first, bucket affinity second.

        Affinity-first would pin a single hot bucket onto one worker
        and serialize the whole stream (zero scaling); load-first lets
        a hot bucket spill to idle and less-busy workers — each spill
        warms exactly one more worker, converging to a balanced pinning
        — while the affinity tiebreak keeps multi-bucket streams from
        bouncing warm levels between equally loaded workers. Idle
        workers rank warmth before accumulated busy_s (their past load
        is sunk; reusing built steps + resident slices is free); busy
        workers rank busy_s before warmth (a warm-but-backlogged worker
        must NOT beat an idle-ish one — that is the pinning failure
        mode). wid breaks remaining ties deterministically (routing
        must be replayable).
        """
        alive = self._alive_workers()
        if not alive:
            raise NoLiveWorkersError(
                f"no live workers ({len(self.workers)} configured, all "
                f"dead) with {self.queue.depth} queued request(s)")

        def score(w: WorkerHandle):
            warm = 0 if b.key in w.keys_warm else 1
            if w.pending is None:
                return (0, warm, w.busy_s, w.wid)
            return (1, w.busy_s, warm, w.wid)

        return min(alive, key=score)

    def _dispatch_to(self, w: WorkerHandle, b: Batch) -> bool:
        """Frame + send one batch; False when the send killed the
        worker (caller re-routes)."""
        self._seq += 1
        seq = self._seq
        head = {"type": "batch", "seq": seq,
                "key": list(b.key), "n_valid": b.n_valid,
                "reqs": [{"rid": r.rid, "r": r.r, "dlogp": r.dlogp,
                          "logq2": r.logq2, "pt_logp": r.pt_logp,
                          "n_slots": r.cts[0].n_slots,
                          "logps": [c.logp for c in r.cts]}
                         for r in b.requests[:b.n_valid]]}
        tr = self._tracer
        arrays = {k: words(v) for k, v in b.arrays.items()}
        try:
            if tr is not None:
                with tr.span("dispatch", cat="lifecycle", lane="server",
                             args={"op": b.op, "batch": b.size,
                                   "worker": w.wid}):
                    w.transport.send(head, arrays)
            else:
                w.transport.send(head, arrays)
        except WorkerDied:
            self._on_death(w, "transport")
            return False
        w.pending = _Pending(b, seq, self._clock(),
                             {"op": b.op, "logq": b.logq,
                              "n_valid": b.n_valid,
                              "send": dict(w.transport.last_send)})
        w.batches += 1
        w.keys_warm.add(b.key)
        if self.injector is not None and \
                self.injector.maybe_kill_worker(w.wid, w.batches):
            # die AFTER the send: the batch is in flight on a worker
            # that will never answer — the mid-batch death window
            w.transport.kill()
        return True

    def _retire_worker(self, w: WorkerHandle) -> None:
        """Collect one worker's pending result into the ready buffer
        (or requeue it if the worker died under us)."""
        p = w.pending
        if p is None:
            return
        try:
            head, arrays = w.transport.recv()
            if head.get("type") != "result" or head.get("seq") != p.seq:
                raise WorkerDied(
                    f"protocol skew from worker {w.wid}: {head}")
        except WorkerDied:
            self._on_death(w, "transport")
            return
        w.pending = None
        wall = float(head["wall"])
        w.busy_s += wall
        w.served_requests += p.batch.n_valid
        w.frame_log.append({
            **p.frame, "recv": dict(w.transport.last_recv),
            "worker": {k: head[k] for k in ("wall", "d2h_s", "read_s")
                       if k in head}})
        if self._tracer is not None:
            self._tracer.event(
                "device_wall", cat="lifecycle", lane=f"worker{w.wid}",
                ts=p.t0, dur=wall,
                args={"op": p.batch.op, "logq": p.batch.logq,
                      "worker": w.wid, "n_valid": p.batch.n_valid})
        # the params' stored words (HEStatic.dtype): int32 bit patterns at
        # β = 2^32, int64 at β = 2^64, whatever the frame's label
        word = "int32" if self.params.beta_bits == 32 else "int64"
        ax = torch.from_numpy(arrays["ax"].view(word))
        bx = torch.from_numpy(arrays["bx"].view(word))
        outs = [Ciphertext(ax=ax[i], bx=bx[i], logq=int(m["logq"]),
                           logp=int(m["logp"]), n_slots=int(m["n_slots"]))
                for i, m in enumerate(head["outs"])]
        self._ready.extend(self._complete(p.batch, outs, wall))

    def _retire_oldest(self) -> None:
        pend = [w for w in self._alive_workers() if w.pending is not None]
        if pend:
            self._retire_worker(min(pend, key=lambda w: w.pending.t0))

    def _take_ready(self) -> List[Tuple[int, Ciphertext]]:
        out, self._ready = self._ready, []
        return out

    def _work_pending(self) -> bool:
        return bool(self._ready) or any(
            w.pending is not None for w in self._alive_workers())

    # ---- the serving loop (routed) ---------------------------------------

    @traced_entry("poll", "server")
    def poll(self, flush: bool = False) -> List[Tuple[int, Ciphertext]]:
        """One frontend scheduling step: health-check workers, release
        at most one batch per the inherited flush policy, route it, and
        return whatever results have completed. Workers run one-deep
        pipelines — a routed batch is NOT awaited here; it retires when
        its worker is next needed (or at drain), so W workers hold W
        batches in flight while the frontend keeps assembling."""
        self._c_polls.inc()
        self._g_depth.set(self.queue.depth)
        self.metrics.record_depth(self.queue.depth)
        now = self._clock()
        self.check_workers()
        key, cause = self._choose_flush(flush, now)
        if key is None:
            # nothing to release — retire the oldest pipelined batch
            # instead (HEServer retires its in-flight step here)
            self._retire_oldest()
            return self._take_ready()
        b = self._pop_assemble(key, cause)
        while True:
            try:
                w = self._route(b)
            except NoLiveWorkersError:
                # the batch goes back to the queue (its rids kept), so
                # revive_workers() and the next poll serve it
                self.queue.requeue(b.requests[:b.n_valid])
                raise
            if w.pending is not None:
                self._retire_worker(w)        # free its pipeline slot
                if not w.alive:
                    continue                  # died on retire: re-route
            if self._dispatch_to(w, b):
                break
        return self._take_ready()

    def drain(self) -> Dict[int, Ciphertext]:
        results = super().drain()
        # retire any stragglers still pipelined on the workers
        for w in self._alive_workers():
            self._retire_worker(w)
        for rid, ct in self._take_ready():
            results[rid] = ct
        return results

    # ---- accounting ------------------------------------------------------

    def reset_metrics(self) -> None:
        super().reset_metrics()
        for w in self.workers:
            w.busy_s = 0.0
            w.served_requests = 0
            w.frame_log.clear()
            # NOT w.batches: the injector's kill schedule counts
            # lifetime dispatches

    def stats(self) -> dict:
        eng = {"steps_compiled": 0, "compile_s": 0.0}
        for w in self.workers:
            if w.transport.kind == "inproc":
                e = w.transport.worker.engine
                eng["steps_compiled"] += e.n_compiled
                eng["compile_s"] += e.compile_s
        eng["compile_s"] = round(eng["compile_s"], 3)
        return {
            **self.metrics.summary(),
            "cache": self.cache.stats(),
            "engine": eng,
            "device": str(self.device),
            "batch": self.batch,
            "flush_policy": {
                "max_age_s": self.max_age_s,
                "adaptive_target": self.adaptive_target,
                "bucket_target": self._bucket_target(),
                "overlap": False,
            },
            "scheduler": {"enabled": self.schedule,
                          "prefetch_tables": self.prefetch,
                          **self.scheduler.stats()},
            "submitted": self.queue.submitted,
            "frontend": {
                "transport": self.transport_kind,
                "worker_device": self.worker_device,
                "worker_devices": self.worker_devices,
                "grid": None if self.grid is None else self.grid.name,
                "workers": len(self.workers),
                "alive": len(self._alive_workers()),
                "deaths": self._c_deaths.value,
                "requeued_requests": self._c_requeued.value,
            },
            "workers": [w.stats() for w in self.workers],
        }

    def close(self) -> None:
        """Shut every worker down (subprocess transports exit their
        frame loops, ending their followers; in-process ones just drop)
        and end the followers of this frontend's grid."""
        for w in self.workers:
            try:
                w.transport.close()
            except Exception:                 # noqa: BLE001 — best effort
                pass
            w.alive = False
        if self._open:
            self._open = False
            relay_stop(self.grid)
