"""HEServer: the composed serving runtime (queue → engine → metrics).

Glues the subsystem pieces into the request loop `launch.serve --he`
and `benchmarks/serve_he.py` drive:

  submit(op, cts, ...)   →  RequestQueue buckets by (op, level, extra)
  submit_circuit(ops, inputs)
                         →  walk an op-DAG server-side with level
                            tracking; nodes enter the same queue and
                            batch with everyone else's requests
  poll()                 →  release at most one batch, chosen by the
                            flush policy: a bucket at the adaptive
                            target ("full"), else — under an SLO — the
                            bucket whose oldest request hit the age
                            deadline ("age"), else, when flushing, the
                            oldest non-empty bucket ("drain"); run it on
                            the device (optionally double-buffered),
                            record metrics, return (rid, Ciphertext)
                            results
  drain()                →  serve until queue + circuits + the in-flight
                            step are all empty

One HEServer owns one resident TableCache (tables built once at logQ,
every level served as slices) and one OpEngine (one step per
(op, level) signature) — the serving design HEAX/Medha argue for: keys
and tables stay resident, work streams through them, and the WHOLE
ciphertext op set (mul, add/sub, rotate, conjugate, slot-sum, rescale,
mod-down) runs server-side so a client submits an encrypted circuit once
and gets one ciphertext back.

Continuous batching (ROADMAP → this PR): with ``max_age_s`` set, a
trickle of requests (arrival rate below the batch size) still meets the
latency SLO — poll() releases a bucket the moment its oldest request has
waited max_age_s, padding the batch. The bucket target itself adapts:
it is sized to the arrivals one deadline-window is expected to gather
(rate × max_age_s, clamped to [1, batch]), so at low rates the server
stops waiting for a full batch it will never see. Without ``max_age_s``
the drain-only behavior is kept (a sub-batch trickle then never
flushes without a drain).

Double buffering (``overlap=True``): poll() dispatches the new batch
BEFORE waiting on the previous one, so host-side batch assembly and the
issue of the next step overlap the in-flight device step and the card
never waits on the frontend. Results then arrive one poll late —
submit→result still runs front-to-back in drain(). It pays only if
dispatch never synchronizes the host with the card.

Circuit-aware scheduling (``schedule=True``): submitted circuits'
validated level schedules are registered with a
:class:`repro_torch.hserve.scheduler.CircuitScheduler`, which (a) defers an
under-full drain flush when a same-key sibling node from another
circuit is within the lookahead horizon — so concurrent circuits
co-batch even out of lockstep — and (b) prefetches the NEXT levels'
table slices while the current batch is in flight (riding the same
dispatch/wait double buffer). Scheduling never changes a result bit;
it only reorders drain flushes and warms caches.

This is the JAX package's ``hserve/server.py``: ``device=`` (default
"cuda", through ``core.context.resolve_device``) and an optional ``grid=``
in place of ``mesh=``, and ``stats()["device"]`` (and ``stats()["grid"]``)
in place of ``stats()["mesh"]``. The queue refuses operands that lie
elsewhere, at submit. ``submit_bootstrap`` serves a `repro_torch.boot` plan
like any circuit, and a tracer gets its ``boot.*`` lane.

Across ranks (``grid=`` a HostGrid of data size 1 and model size R > 1,
this process its rank 0): the queue, the scheduler and the metrics run
here only; every other rank runs :func:`serve_follower`. The server
broadcasts over the model group (``relay_*``), before each engine step
runs here, a header (JSON: op, level, extra, the operands' names,
shapes and types) and then the operands; the followers run the same step
on their prime rows, and iCRT's all-reduces inside it give every rank
the same words, so the results are rank 0's own. Keys reach the
followers the same way (whole; each keeps its rows), booked in the
grid's feed log. ``close()`` (or a stop message) ends the followers'
loops; a follower that dies makes rank 0's next broadcast or all-reduce
raise, within the grid's time limit at most.
"""

from __future__ import annotations

import json
import math
import time
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.cipher import Ciphertext, EvalKey
from repro_torch.core.context import resolve_device
from repro_torch.core.params import HEParams
from repro_torch.hserve.circuit import CircuitOp, circuit_schedule
from repro_torch.hserve.engine import Inflight, OpEngine, slot_sum_rotations
from repro_torch.hserve.metrics import ServeMetrics
from repro_torch.hserve.queue import Batch, BatchAssembler, PLAIN_OPS, \
    RequestQueue
from repro_torch.hserve.scheduler import CircuitScheduler
from repro_torch.dist import comm
from repro_torch.dist.he_pipeline import check_grid, he_static
from repro_torch.hserve.tables import TableCache
from repro_torch.obs.registry import MetricsRegistry

__all__ = ["HEServer", "serve_follower", "relay_init", "relay_key",
           "relay_batch"]


_KEY_FIELDS = ("ax_ev", "ax_ev_shoup", "bx_ev", "bx_ev_shoup")


# The serving leader's messages to the other ranks of its model group: a
# header broadcast from rank 0 (its length, then its JSON bytes, on the
# host under gloo), then its tensors broadcast on the grid's device.

def _header_device(grid) -> torch.device:
    """The host where the backend takes host tensors (gloo), else the
    grid's device (nccl)."""
    return torch.device("cpu") \
        if "cpu" in comm.DEVICE_SUPPORT[grid.backend]["broadcast"] \
        else grid.device


def _send_header(grid, head: dict) -> None:
    data = json.dumps(head).encode()
    dev = _header_device(grid)
    comm.broadcast(grid, torch.tensor([len(data)], dtype=torch.int64,
                                      device=dev))
    comm.broadcast(grid, torch.frombuffer(bytearray(data), dtype=torch.uint8
                                          ).to(dev))


def _recv_header(grid) -> dict:
    dev = _header_device(grid)
    n = comm.broadcast(grid, torch.zeros(1, dtype=torch.int64, device=dev))
    buf = comm.broadcast(grid, torch.zeros(int(n.item()), dtype=torch.uint8,
                                           device=dev))
    return json.loads(bytes(buf.tolist()).decode())


def _to_followers(grid, tensors) -> None:
    for t in tensors:
        comm.broadcast(grid, t.to(grid.device).contiguous())


def relay_init(grid, knobs: dict) -> None:
    """Tell the followers the engine knobs to build their engines with."""
    _send_header(grid, {"kind": "init", "knobs": knobs})


def relay_key(grid, kind: str, r: Optional[int], key: EvalKey) -> None:
    """Send the followers a key, whole ("evk", "rot" with its amount,
    "conj"); each keeps its rows."""
    ts = [getattr(key, f) for f in _KEY_FIELDS]
    _send_header(grid, {"kind": "key", "key": kind, "r": r,
                        "shape": list(ts[0].shape)})
    _to_followers(grid, ts)


def relay_batch(grid, key: Tuple, arrays: Dict[str, torch.Tensor]) -> None:
    """Send the followers one engine step's signature and operands."""
    _send_header(grid, {
        "kind": "batch", "key": list(key),
        "arrays": [[k, list(v.shape), str(v.dtype).removeprefix("torch.")]
                   for k, v in arrays.items()]})
    _to_followers(grid, arrays.values())


def serve_follower(grid, params: HEParams) -> dict:
    """A model rank other than 0 of a serving grid: build this rank's
    TableCache and OpEngine from the leader's init message, then run every
    step (and load every key) the leader relays, until its stop message.
    Returns this rank's counts: steps run, the feed and step logs, and its
    table cache's stats. Every wait is a collective, bounded by the grid's
    time limit; a leader that is gone makes it raise."""
    if grid.model_rank == 0 or grid.data != 1:
        raise ValueError("serve_follower runs on model ranks 1.. of a grid "
                         "of data size 1; rank 0 runs HEServer(grid=)")
    head = _recv_header(grid)
    if head["kind"] != "init":
        raise RuntimeError(f"follower expected init, got {head['kind']!r}")
    cache = TableCache(params, device=grid.device, grid=grid)
    engine = OpEngine(params, grid.device, cache, grid=grid,
                      **head["knobs"])
    steps = 0
    while True:
        head = _recv_header(grid)
        kind = head["kind"]
        if kind == "stop":
            break
        if kind == "key":
            ts = [comm.broadcast(grid, torch.empty(
                head["shape"], dtype=torch.int32, device=grid.device))
                for _ in _KEY_FIELDS]
            ek = EvalKey(*ts)
            if head["key"] == "evk":
                cache.set_evk(ek)
            elif head["key"] == "rot":
                cache.add_rot_key(int(head["r"]), ek)
            else:
                cache.add_conj_key(ek)
        elif kind == "batch":
            arrays = {name: comm.broadcast(grid, torch.empty(
                shape, dtype=getattr(torch, dtype), device=grid.device))
                for name, shape, dtype in head["arrays"]}
            op, logq, extra = head["key"]
            engine.run_step((op, int(logq), extra), arrays)
            steps += 1
        else:
            raise RuntimeError(f"unknown relay message {kind!r}")
    if grid.device.type == "cuda":
        torch.cuda.synchronize(grid.device)
    return {"rank": grid.rank, "steps": steps,
            "feed": comm.summary(grid, "feed"),
            "step": comm.summary(grid, "step"), "cache": cache.stats()}


class _CircuitState:
    """One in-progress circuit: resolved values + submission bookkeeping.
    (The per-node bucket-key schedule lives in the scheduler, which is
    the only consumer — one copy, no drift.)"""

    def __init__(self, cid: int, ops: List[CircuitOp],
                 inputs: Dict[str, Ciphertext]):
        self.cid = cid
        self.ops = ops
        self.values: Dict[Union[int, str], Ciphertext] = dict(inputs)
        self.submitted: set = set()
        # per-node plaintext operands resolved from the server's
        # (hash, level) cache at submit_circuit time (nodes are frozen)
        self.pts: Dict[int, object] = {}


class HEServer:
    """Batched multi-level HE serving on one device.

    params: the HEAAN parameter set every request must use.
    evk:    evaluation key (required to serve "mul").
    rot_keys: {r: rotation key} (required for "rotate" r and for the
              doubling amounts of any "slot_sum").
    conj_key: conjugation key (required to serve "conjugate").
    device: the device every table, key, operand and step lives on
            (default "cuda"; raises when CUDA is absent — pass "cpu" for
            the kernels' plain versions).
    batch:  fixed engine batch size — every step runs (batch, N, qlimbs).
    use_kernels: route the stages through the CUDA kernels (the
            default, as the port's PipelineConfig; CPU tensors take the
            plain versions either way).
    max_age_s: latency SLO — flush a bucket once its oldest request has
            waited this long (None keeps drain-only flushing).
    adaptive_target: size the full-bucket target from the observed
            arrival rate (rate × max_age_s, clamped to [1, batch]) so a
            trickle flushes promptly; only active under max_age_s.
    overlap: double-buffer batch assembly and step issue against the
            in-flight engine step (results arrive one poll late).
    schedule: circuit-aware scheduling — defer under-full drain flushes
            for same-key sibling nodes within `lookahead` engine batches
            (cross-circuit co-batching) and prefetch next-level table
            slices behind the in-flight batch. Mutable attribute, so
            benchmarks can A/B it on one warm server.
    lookahead: the scheduler's sibling horizon in engine batches.
    cost_model: optional `repro_torch.analysis.cost.CostModel` — gates
            the scheduler's deferrals on estimated padded-batch device
            time (limb-cheap buckets flush immediately instead of
            waiting on siblings). Mutable via
            ``server.scheduler.cost_model``. None = pure lookahead policy.
    prefetch: table-slice prefetch on/off (only active under schedule).
    plain_cache_mib: LRU budget for the (hash, level) plaintext-operand
            cache (None = unbounded) — one-shot per-request operands
            must not accumulate forever on a long-running server.
    clock:  time source for ages/latencies (injectable for deterministic
            tests; defaults to time.perf_counter). Threaded into the
            RequestQueue so direct queue submits share the timeline.
    tracer: optional `repro_torch.obs.Tracer` — request-lifecycle spans
            (submit → enqueue → bucket_wait → flush → batch_assemble →
            dispatch → device_wall → complete) and engine spans land in
            it; export with tracer.write(path) (Chrome trace-event
            JSON). None (default) records nothing and allocates nothing
            per request. Mutable via the `tracer` property (propagates
            to the engine and table cache), so benchmarks toggle it on
            a warm server.
    profile_stages: fence the card around every stage so
            `engine.stage_timer` attributes the ops' wall to the paper's
            Fig. 3 CRT/NTT/modmul/iCRT buckets. Same bits, slower — a
            measurement mode, not a serving mode.
    registry: optional `repro_torch.obs.MetricsRegistry` to publish into
            (one is created when absent). ServeMetrics, TableCache,
            CircuitScheduler, and the engine register as pull sources;
            `registry.snapshot()` is the live-telemetry JSON heartbeats
            embed.
    grid:   optional HostGrid of data size 1 whose rank 0 this is: with
            model size R > 1 the tables and keys are held as each rank's
            prime rows and every step runs on all R ranks, the others
            in `serve_follower` (see the module docstring); call
            `close()` to end them. Model size 1 is the one-device server.
    """

    # the arrival-rate estimate decays over this many deadline windows,
    # so a post-idle trickle sees its own rate, not the last burst's
    _RATE_DECAY_WINDOWS = 8
    # one device unless __init__ is given a grid (HEFrontend never is);
    # _open while the followers of a grid still serve
    grid = None
    _open = False

    def __init__(self, params: HEParams, evk: Optional[EvalKey] = None,
                 rot_keys: Optional[Dict[int, EvalKey]] = None,
                 conj_key: Optional[EvalKey] = None, *,
                 device: str | torch.device = "cuda", batch: int = 8,
                 use_kernels: bool = True,
                 max_age_s: Optional[float] = None,
                 adaptive_target: bool = True,
                 overlap: bool = False,
                 schedule: bool = False,
                 lookahead: int = 2,
                 cost_model=None,
                 prefetch: bool = True,
                 plain_cache_mib: Optional[float] = 256.0,
                 clock: Callable[[], float] = time.perf_counter,
                 tracer=None, profile_stages: bool = False,
                 registry=None, grid=None,
                 **engine_knobs):
        device = resolve_device(device)
        self.grid = grid if grid is not None and grid.model > 1 else None
        if self.grid is None:
            self.cache = TableCache(params, evk, rot_keys, conj_key,
                                    plain_cache_mib=plain_cache_mib,
                                    device=device)
            self.engine = OpEngine(params, device, self.cache,
                                   use_kernels=use_kernels, tracer=tracer,
                                   profile_stages=profile_stages,
                                   **engine_knobs)
        else:
            if grid.data != 1 or grid.rank != 0 or grid.device != device:
                raise ValueError(
                    f"HEServer(grid=) runs on rank 0 of a grid of data "
                    f"size 1, on the grid's device; got rank {grid.rank} "
                    f"of {grid.name} on {grid.device}, asked {device}")
            check_grid(he_static(params, params.logQ), self.grid)
            self._open = True
            self.cache = TableCache(
                params, plain_cache_mib=plain_cache_mib, device=device,
                grid=self.grid, relay=partial(relay_key, self.grid))
            self.engine = OpEngine(params, device, self.cache,
                                   use_kernels=use_kernels, tracer=tracer,
                                   profile_stages=profile_stages,
                                   grid=self.grid,
                                   relay=partial(relay_batch, self.grid),
                                   **engine_knobs)
            relay_init(self.grid, self.engine.knobs)
            if evk is not None:
                self.cache.set_evk(evk)
            for r, rk in (rot_keys or {}).items():
                self.cache.add_rot_key(r, rk)
            if conj_key is not None:
                self.cache.add_conj_key(conj_key)
        self._init_core(params, device=device, batch=batch,
                        max_age_s=max_age_s,
                        adaptive_target=adaptive_target, overlap=overlap,
                        schedule=schedule, lookahead=lookahead,
                        cost_model=cost_model, prefetch=prefetch,
                        clock=clock, tracer=tracer, registry=registry)
        self.registry.add_source("cache", self.cache.stats)
        self.registry.add_source(
            "engine", lambda: {"steps_compiled": self.engine.n_compiled,
                               "compile_s": round(self.engine.compile_s,
                                                  3)})

    def _init_core(self, params: HEParams, *, device: torch.device,
                   batch: int,
                   max_age_s: Optional[float], adaptive_target: bool,
                   overlap: bool, schedule: bool, lookahead: int,
                   cost_model, prefetch: bool,
                   clock: Callable[[], float], tracer, registry) -> None:
        """The engine-free serving core: queue + scheduler + circuit
        state + metrics plane, kept apart from the TableCache/OpEngine so
        that a multi-host frontend (which routes batches to worker
        engines instead, `repro_torch.hserve.frontend.HEFrontend`) can
        share it, as the reference's does. Expects `self.cache` to be set
        already."""
        self.params = params
        self.device = device
        self.batch = batch
        self.max_age_s = max_age_s
        self.adaptive_target = adaptive_target
        self.overlap = overlap
        self.schedule = schedule
        self.prefetch = prefetch
        self._clock = clock
        self.queue = RequestQueue(clock=clock, device=device)
        self.assembler = BatchAssembler(batch)
        self.metrics = ServeMetrics()
        # always constructed (registration is cheap bookkeeping), so
        # `schedule` can be toggled on a warm server without losing the
        # in-progress circuits' schedules
        self.scheduler = CircuitScheduler(lookahead=lookahead,
                                          cost_model=cost_model)
        self._inflight: Optional[Inflight] = None
        self._circuits: Dict[int, _CircuitState] = {}
        self._node_of_rid: Dict[int, Tuple[int, int]] = {}
        # cid -> per-node pipeline-stage labels for in-flight bootstrap
        # circuits (submit_bootstrap): drives the boot.* trace lane
        self._boot_stages: Dict[int, List[str]] = {}
        self._tracer = tracer
        self.cache.tracer = tracer
        # telemetry plane: every subsystem publishes into ONE registry.
        # Sources read through `self.metrics` (a lambda, not the bound
        # method) so reset_metrics()'s window swap stays published.
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.registry.add_source("serve", lambda: self.metrics.summary())
        self.registry.add_source("scheduler", self.scheduler.stats)
        self._c_polls = self.registry.counter("serve.polls")
        self._c_batches = self.registry.counter("serve.batches")
        self._c_requests = self.registry.counter("serve.requests")
        self._g_depth = self.registry.gauge("serve.queue.depth")
        self._h_wall = self.registry.histogram("serve.batch.wall_s")

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, t) -> None:
        """Re-point the trace sink everywhere at once (engine + table
        cache + the profile-mode stage timer follow the server's)."""
        self._tracer = t
        if self.engine is not None:
            self.engine.tracer = t
        self.cache.tracer = t

    # ---- request intake --------------------------------------------------

    def submit(self, op: str, cts, r: int = 0, dlogp: int = 0,
               logq2: int = 0, pt=None, pt_logp: int = 0,
               pt_hash: Optional[str] = None,
               pt_owned: bool = False) -> int:
        """Enqueue one request; returns its rid (used to match results).

        Lifecycle trace: a traced submit lands two instants — "submit"
        (intake, before validation) and "enqueue" (accepted into its
        bucket) — on the "requests" lane; the untraced path takes no
        clock reads and allocates nothing.

        Key availability is checked HERE, not at execution: a request
        the engine cannot serve must never enter the queue (it would
        fail mid-drain, after being popped, taking the batch's other
        requests down with it). rescale's dlogp defaults to params.logp;
        mul_plain's pt_logp to params.log_delta. The plaintext ops need
        NO key material — that is their point; with a pt_hash their
        encoded operand is registered in (pt given) or resolved from
        (pt None) the server's (hash, level) plaintext cache, so a
        reused operand ships and encodes ONCE. pt_owned marks pt as a
        server-owned resident tensor (a cache entry) the queue may
        alias instead of copying; hash-resolved operands set it
        themselves. t_submit comes from the queue's clock (the server's
        injected one). Operands must lie on the server's device.
        """
        tr = self._tracer
        t_in = self._clock() if tr is not None else 0.0
        register = None
        if op in PLAIN_OPS and pt_hash is not None:
            first = cts[0] if isinstance(cts, (tuple, list)) else cts
            if pt is None:
                pt = self.cache.get_plain(pt_hash, first.logq)
                pt_owned = True
            else:
                # registration happens AFTER queue validation below — a
                # rejected operand must never poison the cache (a later
                # hash-only circuit would resolve it and fail mid-drain)
                register = (pt_hash, first.logq)
        if op == "mul":
            self.cache.evk()                  # raises when absent
        elif op == "rotate":
            self.cache.rot_key(r)             # raises when absent
        elif op == "conjugate":
            self.cache.conj_key()             # raises when absent
        elif op == "slot_sum":
            first = cts[0] if isinstance(cts, (tuple, list)) else cts
            missing = [rr for rr in slot_sum_rotations(first.n_slots)
                       if rr not in self.cache.rotation_amounts]
            if missing:
                raise KeyError(
                    f"slot_sum over {first.n_slots} slots needs rotation "
                    f"keys {missing}; loaded: {self.cache.rotation_amounts}")
        elif op == "rescale" and dlogp == 0:
            dlogp = self.params.logp          # negative falls through to
                                              # the queue's ValueError
        elif op == "mul_plain" and pt_logp == 0:
            pt_logp = self.params.log_delta
        rid = self.queue.submit(op, cts, r=r, dlogp=dlogp, logq2=logq2,
                                pt=pt, pt_logp=pt_logp, pt_owned=pt_owned)
        if register is not None:
            self.cache.put_plain(register[0], register[1], pt)
        self._c_requests.inc()
        if tr is not None:
            tr.event("submit", cat="lifecycle", lane="requests", ts=t_in,
                     args={"rid": rid, "op": op})
            tr.event("enqueue", cat="lifecycle", lane="requests",
                     ts=self._clock(), args={"rid": rid, "op": op})
        return rid

    def submit_mul(self, c1: Ciphertext, c2: Ciphertext) -> int:
        return self.submit("mul", (c1, c2))

    def submit_add(self, c1: Ciphertext, c2: Ciphertext) -> int:
        return self.submit("add", (c1, c2))

    def submit_sub(self, c1: Ciphertext, c2: Ciphertext) -> int:
        return self.submit("sub", (c1, c2))

    def submit_rotate(self, ct: Ciphertext, r: int) -> int:
        return self.submit("rotate", (ct,), r=r)

    def submit_conjugate(self, ct: Ciphertext) -> int:
        return self.submit("conjugate", (ct,))

    def submit_slot_sum(self, ct: Ciphertext) -> int:
        return self.submit("slot_sum", (ct,))

    def submit_rescale(self, ct: Ciphertext,
                       dlogp: Optional[int] = None) -> int:
        return self.submit("rescale", (ct,), dlogp=dlogp or 0)

    def submit_mod_down(self, ct: Ciphertext, logq2: int) -> int:
        return self.submit("mod_down", (ct,), logq2=logq2)

    def submit_mod_raise(self, ct: Ciphertext, logq2: int) -> int:
        """Raise ct to a wider modulus logq2 > ct.logq (the exact
        centered lift — bootstrap stage 1; see `repro_torch.boot`)."""
        return self.submit("mod_raise", (ct,), logq2=logq2)

    def submit_mul_plain(self, ct: Ciphertext, pt=None,
                         pt_logp: Optional[int] = None,
                         pt_hash: Optional[str] = None) -> int:
        """Ciphertext × encoded plaintext (region 1 only — no key
        switch). pt: (N, qlimbs) mod-q words at ct's level on the
        server's device (core.heaan.encode_plain); pt_logp defaults to
        params.log_delta.
        pt_hash registers/references the server's plaintext cache —
        pt=None resolves a previously registered operand by hash."""
        return self.submit("mul_plain", (ct,), pt=pt, pt_logp=pt_logp or 0,
                           pt_hash=pt_hash)

    def submit_add_plain(self, ct: Ciphertext, pt=None,
                         pt_logp: Optional[int] = None,
                         pt_hash: Optional[str] = None) -> int:
        """Ciphertext + encoded plaintext (bx-only limb add; the
        plaintext must be encoded at ct's scale). pt_hash as in
        :meth:`submit_mul_plain`."""
        return self.submit("add_plain", (ct,), pt=pt, pt_logp=pt_logp or 0,
                           pt_hash=pt_hash)

    # ---- circuits --------------------------------------------------------

    def submit_circuit(self, ops: Sequence[CircuitOp],
                       inputs: Dict[str, Ciphertext]) -> int:
        """Submit a whole encrypted circuit; returns a cid whose result
        (the LAST node's ciphertext) appears in poll()/drain() output
        exactly like a plain request's.

        The DAG is validated up front — (logq, logp) propagated through
        every node from the input ciphertexts' metadata, key
        availability checked per op, every input and plaintext on the
        server's device — so an ill-formed circuit raises here, before
        anything is enqueued. Nodes are then submitted as
        their operands resolve: source nodes immediately, the rest as
        batches complete, so concurrent circuits (and plain requests)
        batch together whenever their (op, level) signatures align.
        """
        ops = list(ops)
        for where, t in [(name, x) for name, ct in inputs.items()
                         for x in (ct.ax, ct.bx)] + [
                (f"node {i} pt", node.pt) for i, node in enumerate(ops)
                if node.pt is not None]:
            if not isinstance(t, torch.Tensor) or t.device != self.device:
                raise ValueError(
                    f"circuit {where}: operands must be tensors on "
                    f"{self.device}, got "
                    f"{getattr(t, 'device', type(t).__name__)}")
        meta = {name: (ct.logq, ct.logp) for name, ct in inputs.items()}
        in_slots = {name: ct.n_slots for name, ct in inputs.items()}
        # the validated level schedule: per-node (logq, logp), per-node
        # queue bucket key (what the scheduler looks ahead at), per-node
        # slot count (every op preserves its first operand's n_slots)
        _, keys, nslots = circuit_schedule(ops, meta, in_slots, self.params)
        # key availability, up front — a node the engine cannot serve
        # must never let ANY of the circuit enter the queue (it would
        # fail mid-drain with siblings already submitted).
        for i, node in enumerate(ops):
            if node.op == "mul":
                self.cache.evk()
            elif node.op == "rotate":
                self.cache.rot_key(node.r)
            elif node.op == "conjugate":
                self.cache.conj_key()
            elif node.op == "slot_sum":
                missing = [rr for rr in slot_sum_rotations(nslots[i])
                           if rr not in self.cache.rotation_amounts]
                if missing:
                    raise KeyError(
                        f"circuit slot_sum over {nslots[i]} slots needs "
                        f"rotation keys {missing}; loaded: "
                        f"{self.cache.rotation_amounts}")
        # plaintext operands, resolved against the (hash, level) cache up
        # front: a hash the server never saw must reject the WHOLE
        # circuit here (never mid-drain); a provided pt with a hash is
        # registered so later circuits reference it without re-shipping
        pts: Dict[int, object] = {}
        for i, node in enumerate(ops):
            if node.op in PLAIN_OPS and node.pt_hash is not None:
                in_logq = keys[i][1]
                if node.pt is None:
                    try:
                        pts[i] = self.cache.get_plain(node.pt_hash, in_logq)
                    except KeyError as e:
                        raise ValueError(f"circuit node {i}: {e.args[0]}") \
                            from None
                else:
                    pts[i] = self.cache.put_plain(node.pt_hash, in_logq,
                                                  node.pt)
        cid = self.queue.reserve_rid()
        circ = _CircuitState(cid, ops, inputs)
        circ.pts = pts
        self._circuits[cid] = circ
        self.scheduler.register(
            cid, keys, [tuple(a for a in node.args if isinstance(a, int))
                        for node in ops])
        self._submit_ready(circ)
        return cid

    def submit_bootstrap(self, ct: Ciphertext, *, config=None,
                         plan=None) -> int:
        """Submit a full bootstrap pipeline (see `repro_torch.boot`) for
        one level-exhausted ciphertext; returns a cid whose result — the
        REFRESHED ciphertext at plan.out_logq — arrives like any other
        circuit's. Every stage rides submit_circuit, so concurrent
        bootstraps co-batch their aligned rotation/mul nodes, and the
        CtS/StC diagonals land in the plaintext cache (hash-only on
        every repeat shape). Pass a prebuilt `BootstrapPlan` to skip
        plan construction (sessions cache plans per input shape); one
        built here encodes its diagonals on the server's device."""
        from repro_torch.boot.pipeline import bootstrap_circuit
        if plan is None:
            plan = bootstrap_circuit(
                self.params, logq_in=ct.logq, logp=ct.logp,
                n_slots=ct.n_slots, config=config,
                plain_lookup=self.cache.has_plain, device=self.device)
        if (ct.logq, ct.logp, ct.n_slots) != (plan.logq_in, plan.logp,
                                              plan.n_slots):
            raise ValueError(
                f"plan was built for (logq={plan.logq_in}, "
                f"logp={plan.logp}, n={plan.n_slots}), got ciphertext "
                f"at (logq={ct.logq}, logp={ct.logp}, n={ct.n_slots})")
        cid = self.submit_circuit(plan.ops, {plan.in_name: ct})
        self._boot_stages[cid] = list(plan.stages)
        return cid

    def _submit_ready(self, circ: _CircuitState) -> None:
        """Enqueue every not-yet-submitted node whose operands are all
        resolved (inputs or completed earlier nodes)."""
        for i, node in enumerate(circ.ops):
            if i in circ.submitted:
                continue
            try:
                cts = tuple(circ.values[a] for a in node.args)
            except KeyError:
                continue                      # operands not ready yet
            rid = self.submit(node.op, cts, r=node.r, dlogp=node.dlogp,
                              logq2=node.logq2,
                              pt=circ.pts.get(i, node.pt),
                              pt_logp=node.pt_logp,
                              pt_owned=i in circ.pts)
            circ.submitted.add(i)
            self._node_of_rid[rid] = (circ.cid, i)
            self.scheduler.on_enqueued(circ.cid, i)

    def _feed_circuit(self, cid: int, node_idx: int, ct: Ciphertext
                      ) -> List[Tuple[int, Ciphertext]]:
        """Route one completed node result back into its circuit; returns
        the client-visible (cid, result) pair when the circuit finishes."""
        self.scheduler.on_completed(cid, node_idx)
        circ = self._circuits.get(cid)
        if circ is None:                      # finished via its last node
            return []                         # while a dangling node ran
        circ.values[node_idx] = ct
        if node_idx == len(circ.ops) - 1:
            del self._circuits[cid]
            self._boot_stages.pop(cid, None)
            self.scheduler.on_finished(cid)
            return [(cid, ct)]
        self._submit_ready(circ)
        return []

    # ---- the serving loop ------------------------------------------------

    def _bucket_target(self, now: Optional[float] = None) -> int:
        """Full-bucket release threshold. Fixed at `batch` without an
        SLO; under one, sized to the arrivals a deadline window is
        expected to gather so a trickle stops waiting for a full batch.
        The rate estimate decays over _RATE_DECAY_WINDOWS deadline
        windows — after an idle gap the target shrinks back to current
        traffic instead of staying inflated from the last burst (the
        post-idle flush-stall regression)."""
        if self.max_age_s is None or not self.adaptive_target:
            return self.batch
        now = self._clock() if now is None else now
        rate = self.queue.arrival_rate(
            now, self._RATE_DECAY_WINDOWS * self.max_age_s)
        if not rate:
            return self.batch
        return max(1, min(self.batch, math.ceil(rate * self.max_age_s)))

    def poll(self, flush: bool = False) -> List[Tuple[int, Ciphertext]]:
        """Release + run at most one batch per the flush policy (full →
        age → drain); returns completed (rid, Ciphertext) pairs (empty
        if no work ran). With overlap, the dispatched batch's results
        return on the NEXT poll; a poll with no new work retires the
        in-flight batch instead of returning nothing.

        The drain cause is scheduler-aware under ``schedule=True``: an
        under-full bucket expecting a same-key sibling node within the
        lookahead horizon is deferred so the sibling co-batches — but
        SOME non-empty bucket is always released (the scheduler's
        progress guarantee), so a flush-poll on a non-empty queue can
        never return without running work.
        """
        self._c_polls.inc()
        self._g_depth.set(self.queue.depth)
        self.metrics.record_depth(self.queue.depth)
        now = self._clock()
        key, cause = self._choose_flush(flush, now)
        if key is None:
            return self._retire(self._take_inflight())
        b = self._pop_assemble(key, cause)
        if self.overlap:
            prev = self._take_inflight()
            self._inflight = self._dispatch(b)
            self._prefetch_next(b)            # rides the in-flight step
            return self._retire(prev)
        inf = self._dispatch(b)
        if self.engine.profile_stages:
            # profiling dispatch is synchronous (fenced stages): there is
            # no in-flight step to hide the prefetch behind, and running
            # it before wait() would book its table-build time into this
            # batch's wall — sinking the Fig. 3 stage coverage.
            outs, wall = self.engine.wait(inf)
            self._prefetch_next(b)
            return self._complete(b, outs, wall)
        self._prefetch_next(b)                # host work while b runs
        outs, wall = self.engine.wait(inf)
        return self._complete(b, outs, wall)

    def _choose_flush(self, flush: bool, now: float
                      ) -> Tuple[Optional[Tuple], str]:
        """The flush policy: (bucket key, cause) per full → age → drain
        precedence, or (None, ...) when nothing should release."""
        key, cause = self.queue.ready_key(self._bucket_target(now)), "full"
        if key is None and self.max_age_s is not None:
            key, cause = self.queue.expired_key(self.max_age_s, now), "age"
        if key is None and flush:
            key = (self.scheduler.drain_key(self.queue, self.batch)
                   if self.schedule else self.queue.any_key())
            cause = "drain"
        return key, cause

    def _pop_assemble(self, key: Tuple, cause: str) -> Batch:
        """Pop one bucket and assemble the fixed-shape batch, with the
        bucket_wait / flush / batch_assemble lifecycle tracing and flush
        accounting."""
        reqs = self.queue.pop_bucket(key, self.batch)
        tr = self._tracer
        if tr is not None:
            # bucket_wait per request: submit → popped from its bucket
            t_pop = self._clock()
            for r in reqs:
                tr.event("bucket_wait", cat="lifecycle", lane="requests",
                         ts=r.t_submit, dur=t_pop - r.t_submit,
                         args={"rid": r.rid, "op": r.op})
            tr.event("flush", cat="lifecycle", lane="server", ts=t_pop,
                     args={"cause": cause, "op": key[0], "logq": key[1],
                           "n": len(reqs)})
            with tr.span("batch_assemble", cat="lifecycle", lane="server",
                         args={"op": key[0], "n": len(reqs)}):
                b = self.assembler.assemble(reqs)
        else:
            b = self.assembler.assemble(reqs)
        self.metrics.record_flush(cause)
        self._c_batches.inc()
        return b

    def _work_pending(self) -> bool:
        """Is anything dispatched but not yet completed? (The frontend
        overrides this with its per-worker in-flight view.)"""
        return self._inflight is not None

    def _dispatch(self, b: Batch) -> Inflight:
        """engine.dispatch under a "dispatch" lifecycle span (place +
        asynchronous issue; the device wall lands separately at wait)."""
        if self._tracer is None:
            return self.engine.dispatch(b)
        with self._tracer.span("dispatch", cat="lifecycle", lane="server",
                               args={"op": b.op, "batch": b.size}):
            return self.engine.dispatch(b)

    def _prefetch_next(self, b: Batch) -> None:
        """Materialize the table slices the NEXT levels need while `b`
        is in flight: the successor nodes' input levels from the
        registered circuit schedules, plus this batch's own output level
        for the level-changing ops (rescale / mod-down). The per-np iCRT
        entries (a host build and an upload) and the contiguous CRT
        columns are the work; hiding it behind the running batch is the
        prefetch win."""
        if not (self.schedule and self.prefetch):
            return
        tags = [t for t in (self._node_of_rid.get(r.rid)
                            for r in b.requests) if t is not None]
        levels = self.scheduler.next_levels(tags)
        levels |= self.scheduler.levels_for_key(b.key)
        self.scheduler.prefetch_levels(self.cache, levels)

    def _take_inflight(self) -> Optional[Inflight]:
        inf, self._inflight = self._inflight, None
        return inf

    def _retire(self, inf: Optional[Inflight]
                ) -> List[Tuple[int, Ciphertext]]:
        if inf is None:
            return []
        outs, wall = self.engine.wait(inf)
        return self._complete(inf.batch, outs, wall)

    def _complete(self, b: Batch, outs: List[Ciphertext], wall: float
                  ) -> List[Tuple[int, Ciphertext]]:
        """Account one finished batch and route results: circuit-node
        rids feed their circuits (possibly enqueueing successor nodes);
        everything else goes straight back to the client."""
        done = self._clock()
        self.metrics.record_batch(
            b.op, b.logq, b.n_valid, b.n_pad, wall,
            [done - r.t_submit for r in b.requests])
        self._h_wall.add(wall)
        if self._tracer is not None:
            for r in b.requests:
                self._tracer.event(
                    "complete", cat="lifecycle", lane="requests",
                    ts=done, args={"rid": r.rid, "op": r.op,
                                   "latency_s": done - r.t_submit})
        tags = [self._node_of_rid.get(r.rid) for r in b.requests]
        n_nodes = sum(1 for t in tags if t is not None)
        if n_nodes:
            self.metrics.record_circuit_batch(
                len({t[0] for t in tags if t is not None}), n_nodes)
        if self._tracer is not None and self._boot_stages:
            # boot.* lane: attribute this batch's wall to the bootstrap
            # pipeline stages it served, proportionally by node count —
            # one span per (circuit, stage) present in the batch
            by_stage: Dict[Tuple[int, str], int] = {}
            for t in tags:
                if t is not None and t[0] in self._boot_stages:
                    stage = self._boot_stages[t[0]][t[1]]
                    by_stage[(t[0], stage)] = \
                        by_stage.get((t[0], stage), 0) + 1
            for (cid, stage), count in sorted(by_stage.items()):
                self._tracer.event(
                    f"boot.{stage}", cat="boot", lane="boot",
                    ts=done - wall, dur=wall * count / b.n_valid,
                    args={"cid": cid, "nodes": count, "op": b.op,
                          "logq": b.logq})
        client: List[Tuple[int, Ciphertext]] = []
        for req, ct in zip(b.requests, outs):
            tag = self._node_of_rid.pop(req.rid, None)
            if tag is None:
                client.append((req.rid, ct))
            else:
                client.extend(self._feed_circuit(*tag, ct))
        return client

    def drain(self) -> Dict[int, Ciphertext]:
        """Serve until the queue, EVERY in-flight circuit, and the
        in-flight step are all empty (padding the stragglers); returns
        {rid: result} (circuit results under their cid).

        The loop iterates on all three states because a circuit node's
        parent can complete during the FINAL drain pass — its children
        are enqueued inside poll(), after this iteration's flush choice
        was made, and only the next iteration serves them. A flush-poll
        on a non-empty queue always runs a batch (the scheduler's
        deferral keeps a progress guarantee), so the loop terminates; if
        a circuit nevertheless ends up with no node queued or in flight,
        its ready nodes are re-armed once before giving up."""
        results: Dict[int, Ciphertext] = {}
        while (self.queue.depth or self._work_pending()
               or self._circuits):
            served = self.poll(flush=True)
            for rid, ct in served:
                results[rid] = ct
            if (not served and not self.queue.depth
                    and not self._work_pending()):
                if self._circuits:
                    # defensive self-heal: re-run readiness over the
                    # stragglers; anything enqueued keeps the loop alive
                    for circ in list(self._circuits.values()):
                        self._submit_ready(circ)
                    if self.queue.depth:
                        continue
                    raise RuntimeError(
                        f"circuit(s) {sorted(self._circuits)} stalled "
                        "with no pending requests")
                break
        return results

    # ---- accounting ------------------------------------------------------

    def reset_metrics(self) -> None:
        """Start a fresh measurement window (built steps and resident
        tables are kept — use after a warm-up pass so reported latencies
        are steady state). The scheduler's deferral/prefetch counters
        reset with it, so stats()["scheduler"] reads per-window too;
        in-progress circuit schedules are untouched."""
        self.metrics = ServeMetrics()
        self.scheduler.reset_counters()

    def close(self) -> None:
        """End the followers' loops (a grid); nothing on one device."""
        if self._open:
            _send_header(self.grid, {"kind": "stop"})
            self._open = False

    def stats(self) -> dict:
        st = self.engine.stage_timer
        grid = {} if self.grid is None else {"grid": {
            **self.grid.describe(), "feed": comm.summary(self.grid, "feed"),
            "step": comm.summary(self.grid, "step")}}
        return {
            **self.metrics.summary(),
            **({"stages": st.summary()} if st is not None else {}),
            "cache": self.cache.stats(),
            "engine": {"steps_compiled": self.engine.n_compiled,
                       "compile_s": round(self.engine.compile_s, 3)},
            "device": str(self.device),
            "batch": self.batch,
            "flush_policy": {
                "max_age_s": self.max_age_s,
                "adaptive_target": self.adaptive_target,
                "bucket_target": self._bucket_target(),
                "overlap": self.overlap,
            },
            "scheduler": {"enabled": self.schedule,
                          "prefetch_tables": self.prefetch,
                          **self.scheduler.stats()},
            "submitted": self.queue.submitted,
            **grid,
        }
