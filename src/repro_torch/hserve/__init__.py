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

The multi-host tier (frontend, worker, transport) is not ported yet.
"""

from repro_torch.hserve import (  # noqa: F401
    circuit, engine, metrics, queue, scheduler, server, tables,
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
from repro_torch.hserve.scheduler import CircuitScheduler  # noqa: F401
from repro_torch.hserve.server import HEServer  # noqa: F401
from repro_torch.hserve.tables import PlainCache, TableCache  # noqa: F401

__all__ = [
    "HEServer", "OpEngine", "TableCache", "PlainCache", "ServeMetrics",
    "Request", "Batch", "RequestQueue", "BatchAssembler",
    "CircuitOp", "validate_circuit", "circuit_schedule",
    "degree4_demo_circuit", "Inflight", "CircuitScheduler",
    "slot_sum_rotations",
]
