"""Traced ciphertext/plaintext handles — the `repro_torch.client`
expression frontend.

A :class:`CipherHandle` is a NODE in a lazily traced op-DAG, not a
ciphertext: `* + - conj() rotate(r) slot_sum()` build more nodes and
nothing touches the server until :meth:`CipherHandle.result` /
``HESession.run`` lowers the trace through the compile pass
(`repro_torch.client.compile`). The traced vocabulary is exactly the
ciphertext-level op set the server batches (mul, mul_plain, add,
add_plain, sub, rotate, conjugate, slot_sum) — level management
(rescale / mod-down) is deliberately ABSENT from the handle API: the
compiler owns it (paper §III-A's discipline, inserted automatically).

A :class:`PlainHandle` wraps a plaintext slot message (a complex vector
or a scalar broadcast at compile time). Plain–plain arithmetic never
reaches a trace: it constant-folds eagerly in numpy, so only
cipher-touching ops are ever served. At compile time each plain operand
is content-hashed (`core.encoding.message_hash`) so the server can cache
its encoding by (hash, level) — reused weights encode and ship once.

This is the JAX package's ``client/handles.py``, copied (the handles hold
a port ``Ciphertext`` in their input nodes).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from repro_torch.core.cipher import Ciphertext

__all__ = ["CipherHandle", "PlainHandle", "as_plain"]

Plainable = Union["PlainHandle", int, float, complex, np.ndarray, list,
                  tuple]

# every traced node kind ("input" wraps a real Ciphertext leaf)
TRACE_OPS = ("input", "mul", "mul_plain", "add", "add_plain", "sub",
             "rotate", "conjugate", "slot_sum")


def as_plain(v: Plainable) -> "PlainHandle":
    """Coerce a scalar / array / PlainHandle to a PlainHandle."""
    return v if isinstance(v, PlainHandle) else PlainHandle(v)


class PlainHandle:
    """A plaintext operand of a traced expression.

    Holds the slot MESSAGE (complex vector, or a scalar broadcast to the
    ciphertext's slot count at compile time) — never an encoding: the
    compile pass encodes at each use site's (level, scale), and skips
    even that when the server's plaintext cache already holds the
    operand's (hash, level) entry.

    Arithmetic between plain values folds eagerly (numpy); only ops
    with a :class:`CipherHandle` operand extend a trace.
    """

    __slots__ = ("z",)
    __array_ufunc__ = None        # numpy defers to our reflected ops

    def __init__(self, z: Plainable):
        if isinstance(z, PlainHandle):
            self.z = z.z
            return
        if isinstance(z, (int, float, complex, np.integer, np.floating,
                          np.complexfloating)):
            self.z = complex(z)
            return
        z = np.asarray(z, dtype=np.complex128)
        if z.ndim != 1:
            raise ValueError(
                f"plaintext message must be a scalar or 1-D slot vector, "
                f"got shape {z.shape}")
        self.z = z

    @property
    def is_scalar(self) -> bool:
        return not isinstance(self.z, np.ndarray)

    def broadcast(self, n_slots: int) -> np.ndarray:
        """The message as an (n_slots,) complex vector."""
        if self.is_scalar:
            return np.full(n_slots, self.z, dtype=np.complex128)
        if len(self.z) != n_slots:
            raise ValueError(
                f"plaintext has {len(self.z)} slots; ciphertext has "
                f"{n_slots}")
        return self.z

    # ---- eager constant folding -----------------------------------------

    def __mul__(self, other):
        if isinstance(other, CipherHandle):
            return other * self
        return PlainHandle(self.z * as_plain(other).z)

    __rmul__ = __mul__

    def __add__(self, other):
        if isinstance(other, CipherHandle):
            return other + self
        return PlainHandle(self.z + as_plain(other).z)

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CipherHandle):
            raise TypeError(
                "plain - cipher needs a ciphertext negation, which is "
                "not a served op; rewrite the expression so the "
                "ciphertext comes first (e.g. cipher * -1 + plain)")
        return PlainHandle(self.z - as_plain(other).z)

    def __rsub__(self, other):
        return PlainHandle(as_plain(other).z - self.z)

    def __neg__(self):
        return PlainHandle(-self.z)

    def conj(self) -> "PlainHandle":
        return PlainHandle(np.conj(self.z))

    def rotate(self, r: int) -> "PlainHandle":
        if self.is_scalar:
            return self                # a constant is rotation-invariant
        return PlainHandle(np.roll(self.z, -int(r)))

    def slot_sum(self) -> "PlainHandle":
        if self.is_scalar:
            raise ValueError(
                "slot_sum of a scalar plaintext needs a slot count; "
                "pass the full slot vector instead")
        return PlainHandle(np.full(len(self.z), self.z.sum()))

    def __repr__(self):
        return f"PlainHandle({self.z!r})"


class CipherHandle:
    """A lazily traced ciphertext expression node.

    Never holds an intermediate ciphertext: only "input" nodes wrap a
    real :class:`Ciphertext` (via ``HESession.encrypt`` /
    ``HESession.input``); every operator builds a new node. Compile +
    submit happen in ``HESession.run`` (or the :meth:`result`
    shorthand), which returns futures so many traced circuits co-batch
    through one server drain.
    """

    __slots__ = ("session", "op", "args", "plain", "r", "ct", "n_slots")
    __array_ufunc__ = None        # numpy defers to our reflected ops

    def __init__(self, session, op: str, args: Tuple["CipherHandle", ...]
                 = (), *, plain: Optional[PlainHandle] = None, r: int = 0,
                 ct: Optional[Ciphertext] = None):
        if op not in TRACE_OPS:
            raise ValueError(f"unknown traced op {op!r}; one of "
                             f"{TRACE_OPS}")
        self.session = session
        self.op = op
        self.args = tuple(args)
        self.plain = plain
        self.r = r
        self.ct = ct
        if op == "input":
            if ct is None:
                raise ValueError("input handles wrap a Ciphertext")
            self.n_slots = ct.n_slots
        else:
            self.n_slots = self.args[0].n_slots
        # slot-count mismatches fail at TRACE time, not at submit
        if plain is not None and not plain.is_scalar \
                and len(plain.z) != self.n_slots:
            raise ValueError(
                f"plaintext operand has {len(plain.z)} slots; the "
                f"ciphertext expression has {self.n_slots}")
        for a in self.args:
            if a.session is not self.session:
                raise ValueError(
                    "cannot mix handles from different sessions")
            if a.n_slots != self.n_slots:
                raise ValueError(
                    f"operand slot counts differ "
                    f"({a.n_slots} != {self.n_slots})")

    @property
    def ciphertext(self) -> Ciphertext:
        """The wrapped ciphertext — input handles only (traced nodes
        have no value until run)."""
        if self.op != "input":
            raise ValueError(
                "only input handles hold a ciphertext; call .result() "
                "to run the trace")
        return self.ct

    # ---- trace-building operators ---------------------------------------

    def __mul__(self, other):
        if isinstance(other, CipherHandle):
            return CipherHandle(self.session, "mul", (self, other))
        return CipherHandle(self.session, "mul_plain", (self,),
                            plain=as_plain(other))

    __rmul__ = __mul__            # mul and mul_plain both commute

    def __add__(self, other):
        if isinstance(other, CipherHandle):
            return CipherHandle(self.session, "add", (self, other))
        return CipherHandle(self.session, "add_plain", (self,),
                            plain=as_plain(other))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, CipherHandle):
            return CipherHandle(self.session, "sub", (self, other))
        return CipherHandle(self.session, "add_plain", (self,),
                            plain=-as_plain(other))

    def __rsub__(self, other):
        raise TypeError(
            "plain - cipher needs a ciphertext negation, which is not a "
            "served op; rewrite the expression so the ciphertext comes "
            "first (e.g. cipher * -1 + plain)")

    def rotate(self, r: int) -> "CipherHandle":
        """Left-rotate slots by r (slot i+r moves to slot i)."""
        r = int(r)
        if r <= 0:
            raise ValueError("rotate needs a positive left-rotation "
                             "amount r")
        return CipherHandle(self.session, "rotate", (self,), r=r)

    def conj(self) -> "CipherHandle":
        """Slotwise complex conjugation (σ₋₁)."""
        return CipherHandle(self.session, "conjugate", (self,))

    def slot_sum(self) -> "CipherHandle":
        """Every slot becomes the sum of all slots (log₂ n rotate+add
        rounds server-side)."""
        return CipherHandle(self.session, "slot_sum", (self,))

    # ---- execution shorthand --------------------------------------------

    def result(self) -> Ciphertext:
        """Compile, submit, and wait for this expression's ciphertext
        (co-batches with everything else pending on the session's
        server)."""
        return self.session.run([self])[0].result()

    def __repr__(self):
        if self.op == "input":
            return (f"CipherHandle(input, logq={self.ct.logq}, "
                    f"n_slots={self.n_slots})")
        return f"CipherHandle({self.op}, {len(self.args)} arg(s))"
