"""Serving on one device: circuits and the batched per-op steps.

  - circuit: CircuitOp lists, their level schedule (validate_circuit,
             circuit_schedule), the degree-4 demo circuit and
             execute_circuit_reference, the single-ciphertext oracle.
  - engine:  one batched step per op (rotate/conjugate, slot_sum,
             rescale, mod_down, mod_raise, add/sub, mul_plain,
             add_plain), each equal to its core op item by item.

The JAX package's queue, tables, scheduler, metrics, OpEngine and server
are not ported yet.
"""

from repro_torch.hserve import circuit, engine  # noqa: F401

__all__ = ["circuit", "engine"]
