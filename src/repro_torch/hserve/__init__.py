"""Serving on one device: the JAX package's ``hserve`` package, ported.

The paper's claim (§V) is about HE Mul THROUGHPUT under batching, not
single-op latency: the server keeps one table set and every key resident
on the card and streams batches of like requests through it.

  - queue:     RequestQueue buckets requests by (op, level, extra) and
               tracks ages and the arrival rate; BatchAssembler stacks a
               bucket into fixed (B, N, qlimbs) batches on the device.
  - tables:    TableCache, one resident table set with per-level views,
               the evaluation, rotation and conjugation keys, and the
               (hash, level) plaintext cache.
  - engine:    one batched step per op (mul, rotate/conjugate, slot_sum,
               rescale, mod_down, mod_raise, add/sub, mul_plain,
               add_plain), each equal to its core op item by item, and
               OpEngine, which runs assembled batches through them with
               asynchronous dispatch/wait.
  - circuit:   CircuitOp lists, their level schedule, the degree-4 demo
               circuit and execute_circuit_reference, the oracle.
  - scheduler: CircuitScheduler, lookahead co-batching across circuits
               and table prefetch.
  - metrics:   ServeMetrics, throughput / latency / flush causes.
  - server:    HEServer, the composed loop: submit_* / submit_circuit,
               poll / drain, stats.
  - frontend, worker, transport: the multi-host tier — HEFrontend keeps
               the serving core on the host and routes assembled
               batches, as frames, to WorkerEngine workers (in this
               process or in worker processes, each on the card), with
               heartbeats, worker-death requeue and respawn.

Usage::

    from repro_torch.core import heaan as H
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import paper_params
    from repro_torch.core.rotate import conj_keygen
    from repro_torch.hserve import HEServer, degree4_demo_circuit

    params = paper_params()
    sk, pk, evk = keygen(params, seed=0)          # on the card
    server = HEServer(params, evk, conj_key=conj_keygen(params, sk),
                      batch=4, schedule=True)
    rid = server.submit_mul(c1, c2)
    cid = server.submit_circuit(degree4_demo_circuit(params)[0],
                                inputs={"x": x})
    results = server.drain()                  # {rid or cid: Ciphertext}

Most users should not write CircuitOp lists by hand:
`repro_torch.client`'s HESession/CipherHandle traces plain arithmetic and
compiles it to these circuits.
"""

from repro_torch.hserve import (  # noqa: F401
    circuit, engine, frontend, metrics, queue, scheduler, server, tables,
    transport, worker,
)
from repro_torch.hserve.circuit import (  # noqa: F401
    CircuitOp, circuit_schedule, degree4_demo_circuit, validate_circuit,
)
from repro_torch.hserve.engine import (  # noqa: F401
    Inflight, OpEngine, slot_sum_rotations,
)
from repro_torch.hserve.metrics import ServeMetrics  # noqa: F401
from repro_torch.hserve.queue import (  # noqa: F401
    Batch, BatchAssembler, Request, RequestQueue,
)
from repro_torch.hserve.frontend import (  # noqa: F401
    FrontendCatalog, HEFrontend, NoLiveWorkersError,
)
from repro_torch.hserve.scheduler import CircuitScheduler  # noqa: F401
from repro_torch.hserve.server import HEServer, serve_follower  # noqa: F401
from repro_torch.hserve.tables import PlainCache, TableCache  # noqa: F401
from repro_torch.hserve.transport import (  # noqa: F401
    InProcTransport, SubprocessTransport, WorkerDied,
)
from repro_torch.hserve.worker import WorkerEngine  # noqa: F401

__all__ = [
    "HEServer", "OpEngine", "TableCache", "PlainCache", "ServeMetrics",
    "Request", "Batch", "RequestQueue", "BatchAssembler",
    "CircuitOp", "validate_circuit", "circuit_schedule",
    "degree4_demo_circuit", "Inflight", "CircuitScheduler",
    "slot_sum_rotations",
    "HEFrontend", "FrontendCatalog", "NoLiveWorkersError",
    "WorkerEngine", "InProcTransport", "SubprocessTransport",
    "WorkerDied", "serve_follower",
]
