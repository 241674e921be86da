"""repro_torch.client — the traced CipherHandle/HESession user API.

Writing `CircuitOp` lists with integer node refs and manual (logq, logp)
bookkeeping is evaluator assembly; this package is the compiler-style
frontend on top of the server:

  - :mod:`repro_torch.client.handles` — `CipherHandle` / `PlainHandle`:
    overloaded `* + - conj() rotate(r) slot_sum()` lazily trace an
    op-DAG; plain–plain arithmetic constant-folds eagerly.
  - :mod:`repro_torch.client.compile` — the lowering pass: auto
    rescale/mod_down level alignment, CSE, plaintext-cache-aware
    operand encoding; emits a validated `CircuitOp` list.
  - :mod:`repro_torch.client.session` — `HESession` owns keys +
    encrypt/decrypt and an `HEServer` (or wraps an `HEFrontend`);
    `run()` returns `CipherFuture`s so many traced circuits co-batch
    through one drain, optionally checked by the static analyzer first.
  - :mod:`repro_torch.client.testing` — deterministic random traced
    expressions with plaintext shadows.

Quickstart::

    from repro_torch.client import HESession
    from repro_torch.core.params import paper_params

    session = HESession(paper_params(), seed=0, batch=4)   # on the card
    x = session.encrypt(z)                    # traced input handle
    y = ((x * x) * w + x).rotate(1).conj().slot_sum()
    vals = session.decrypt(y)                 # compile → serve → decrypt

This is the JAX package's ``client`` package, bootstrapping included
(``run(..., bootstrap="auto")`` and ``HESession.bootstrap``).
"""

from repro_torch.client.compile import (  # noqa: F401
    CompiledCircuit, compile_handle,
)
from repro_torch.client.handles import (  # noqa: F401
    CipherHandle, PlainHandle, as_plain,
)
from repro_torch.client.session import CipherFuture, HESession  # noqa: F401

__all__ = [
    "HESession", "CipherHandle", "PlainHandle", "CipherFuture",
    "CompiledCircuit", "compile_handle", "as_plain",
]
