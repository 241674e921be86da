"""Deterministic random traced expressions with plaintext shadows.

Shared by tests and drivers: grow a random expression over `CipherHandle`s while
evaluating the SAME ops on the plaintext slot values (the "shadow"), so
a decrypted result can be checked against what the arithmetic should
have produced — independently of how the compiler chose to lower it.

The generator tracks each subexpression's multiplicative depth and stops
spending levels at `max_depth`, so every generated trace compiles within
the parameter set's modulus budget by construction.

This is the JAX package's ``client/testing.py``, copied: the same seed
draws the same expression on both sides.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.client.handles import CipherHandle, PlainHandle

__all__ = ["random_expr", "OP_KINDS"]

# depth-spending kinds consume one rescale level each
OP_KINDS = ("mul", "mul_plain", "add", "sub", "add_plain", "rotate",
            "conjugate", "slot_sum")
_DEPTH_KINDS = ("mul", "mul_plain")


def random_expr(rng: np.random.Generator,
                leaves: List[Tuple[CipherHandle, np.ndarray]], *,
                n_ops: int = 4, max_depth: int = 2,
                rotations: Tuple[int, ...] = (1, 2)):
    """Grow a random traced expression chain over (handle, slots) leaves.

    Returns (handle, shadow): the traced root and the numpy slot values
    the decrypted result must approximate. Every op kind in
    :data:`OP_KINDS` can appear; multiplicative depth along any path is
    capped at `max_depth` (the mul kinds are withheld once the chain
    reaches it).
    """
    pool = [(h, np.asarray(z, dtype=np.complex128), 0)
            for h, z in leaves]
    n = pool[0][0].n_slots
    cur, cur_z, cur_d = pool[int(rng.integers(len(pool)))]
    for _ in range(n_ops):
        kinds = [k for k in OP_KINDS
                 if cur_d < max_depth or k not in _DEPTH_KINDS]
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind == "mul":
            o, oz, od = pool[int(rng.integers(len(pool)))]
            if od >= max_depth:        # operand already at the cap
                kind = "add"
            else:
                cur, cur_z = cur * o, cur_z * oz
                cur_d = max(cur_d, od) + 1
        if kind == "mul_plain":
            w = _rand_plain(rng, n)
            cur, cur_z, cur_d = cur * w, cur_z * w.broadcast(n), cur_d + 1
        elif kind in ("add", "sub"):
            o, oz, od = pool[int(rng.integers(len(pool)))]
            if kind == "add":
                cur, cur_z = cur + o, cur_z + oz
            else:
                cur, cur_z = cur - o, cur_z - oz
            cur_d = max(cur_d, od)
        elif kind == "add_plain":
            w = _rand_plain(rng, n)
            cur, cur_z = cur + w, cur_z + w.broadcast(n)
        elif kind == "rotate":
            r = int(rotations[int(rng.integers(len(rotations)))])
            cur, cur_z = cur.rotate(r), np.roll(cur_z, -r)
        elif kind == "conjugate":
            cur, cur_z = cur.conj(), np.conj(cur_z)
        elif kind == "slot_sum":
            cur, cur_z = cur.slot_sum(), np.full(n, cur_z.sum())
        pool.append((cur, cur_z, cur_d))
    return cur, cur_z


def _rand_plain(rng: np.random.Generator, n: int) -> PlainHandle:
    """A small random plain operand — scalar half the time (exercising
    broadcast), vector otherwise; magnitudes kept ≤ ~0.5 so chained
    products and slot sums stay well inside the scale budget."""
    if rng.integers(2):
        return PlainHandle(0.5 * complex(rng.normal(), rng.normal())
                           / np.sqrt(2))
    z = 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n)) / np.sqrt(2)
    return PlainHandle(z)
