"""The `repro_torch.client` compile pass: traced handle DAG → validated
`CircuitOp` list.

What the user writes is arithmetic; what the server batches is a
topologically ordered, level-aligned encrypted circuit. This pass closes
the gap (the Evaluator-frontend design of SEAL / the graph compilation
of nGraph-HE, cf. PAPERS.md):

  1. **Auto level alignment** — the handle API has no rescale/mod_down;
     the compiler inserts them using the same (logq, logp) rules as
     `hserve.circuit.validate_circuit`:
       - after every `mul` / `mul_plain`, a `rescale` by params.logp
         brings the scale back to Δ (one level consumed — §III-A's
         discipline; assumes the repo-wide log_delta == logp convention);
       - binary-op operands at different moduli get a `mod_down` on the
         higher one; `add`/`sub` operands at different scales get a
         `rescale` on the higher-scale one first.
     A trace deeper than the modulus budget raises ValueError at
     compile — nothing reaches the queue.
  2. **Constant folding** — plain–plain arithmetic folded eagerly by
     `PlainHandle` never appears here; every emitted node touches a
     ciphertext.
  3. **Common-subexpression elimination** — nodes are hash-consed on
     (op, operand refs, parameters, plaintext hash); `x*x` written twice
     costs one HE Mul. Symmetric ops (mul, add) canonicalize operand
     order first.
  4. **Plaintext operand caching** — each plain operand is broadcast,
     content-hashed (`core.encoding.message_hash`), and encoded at its
     use site's level — UNLESS the server-side (hash, level) cache
     already holds it (`plain_lookup`), in which case the node ships
     hash-only and the client-side encode is skipped entirely.

The result is a :class:`CompiledCircuit`: ops ready for
``HEServer.submit_circuit`` (the LAST node is the output), the input
ciphertexts keyed by generated names, the output metadata, and the key
material the trace needs (so ``HESession`` can auto-provision rotation /
conjugation keys).

This is the JAX package's ``client/compile.py``: the same traces lower to
the same ``CircuitOp`` lists, level-management nodes and hash-only
plaintext operands included. A materialized plaintext is encoded as the
port's int32 words on ``device`` (default: the device of the trace's
inputs), and so are the diagonals of an auto-inserted bootstrap.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.dataflow import transfer
from repro_torch.client.handles import CipherHandle
from repro_torch.core import heaan as H
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.encoding import message_hash
from repro_torch.core.params import HEParams
from repro_torch.hserve.circuit import CircuitOp
from repro_torch.hserve.engine import slot_sum_rotations

__all__ = ["CompiledCircuit", "compile_handle"]

NodeRef = Union[int, str]

# a requirement is ("evk",), ("conj",), or ("rot", r)
Requirement = Tuple


@dataclasses.dataclass
class CompiledCircuit:
    """A lowered trace: everything ``HEServer.submit_circuit`` needs.

    plain_registers: the (hash, logq) plaintext operands this circuit
    carries materialized — i.e. what its submission will REGISTER in
    the server's cache. ``HESession.run`` feeds these into the lookup
    of later compiles in the same call, so sibling circuits ship
    hash-only even though nothing has been submitted yet.

    pt_bounds: per plain-op node index, the max |slot value| of that
    node's plaintext operand — recorded at lowering (where the message
    is still in hand, including for hash-only nodes whose encoding was
    skipped) so `repro_torch.analysis.noise` can bound plaintext products
    without re-materializing operands.
    """

    ops: List[CircuitOp]
    inputs: Dict[str, Ciphertext]
    out_logq: int
    out_logp: int
    n_slots: int
    requires: Set[Requirement]
    plain_registers: Set[Tuple[str, int]] = \
        dataclasses.field(default_factory=set)
    pt_bounds: Dict[int, float] = dataclasses.field(default_factory=dict)
    # node index of each auto-inserted bootstrap's mod_raise head
    # (compile_handle(bootstrap="auto")); empty when none fired
    bootstraps: List[int] = dataclasses.field(default_factory=list)


def _ref_key(ref: NodeRef):
    """Total order over node refs (ints before input names) — the
    canonical operand order for symmetric ops, so CSE sees x*y and y*x
    as one node."""
    return (1, ref) if isinstance(ref, str) else (0, ref)


class _Lowering:
    def __init__(self, params: HEParams,
                 plain_lookup: Optional[Callable[[str, int], bool]],
                 device: Optional[torch.device] = None,
                 bootstrap: bool = False):
        self.params = params
        self.lookup = plain_lookup
        self.device = device
        self.bootstrap = bootstrap
        self.ops: List[CircuitOp] = []
        self.meta: List[Tuple[int, int]] = []      # per-op (logq, logp)
        self.inputs: Dict[str, Ciphertext] = {}
        self.in_meta: Dict[str, Tuple[int, int]] = {}
        self.memo: Dict[CipherHandle, NodeRef] = {}
        self.cse: Dict[tuple, int] = {}
        self.requires: Set[Requirement] = set()
        self.plain_registers: Set[Tuple[str, int]] = set()
        self.pt_bounds: Dict[int, float] = {}
        self.bootstraps: List[int] = []
        self._boot_memo: Dict[NodeRef, NodeRef] = {}

    def m(self, ref: NodeRef) -> Tuple[int, int]:
        return self.in_meta[ref] if isinstance(ref, str) else self.meta[ref]

    def out(self, op: str, refs, **kw) -> Tuple[int, int]:
        """Output (logq, logp) for a node — THE shared transfer function
        (`repro_torch.analysis.dataflow.transfer`), the same rules
        `validate_circuit` applies at admission, so a circuit this pass
        emits can never be rejected by the server for level/scale
        errors. Raises trace-cited CircuitError (a ValueError)."""
        return transfer(op, [self.m(r) for r in refs], self.params, **kw)

    def emit(self, op: str, args: Tuple[NodeRef, ...], *, r: int = 0,
             dlogp: int = 0, logq2: int = 0, pt=None, pt_logp: int = 0,
             pt_hash: Optional[str] = None,
             out: Tuple[int, int]) -> int:
        sig = (op, args, r, dlogp, logq2, pt_hash, pt_logp)
        if sig in self.cse:
            return self.cse[sig]
        self.ops.append(CircuitOp(op, args, r=r, dlogp=dlogp, logq2=logq2,
                                  pt=pt, pt_logp=pt_logp, pt_hash=pt_hash))
        self.meta.append(out)
        self.cse[sig] = len(self.ops) - 1
        return self.cse[sig]

    # ---- level management (the compiler-owned part) ---------------------

    def mod_down(self, ref: NodeRef, logq2: int) -> NodeRef:
        if self.m(ref)[0] == logq2:
            return ref
        return self.emit("mod_down", (ref,), logq2=logq2,
                         out=self.out("mod_down", (ref,), logq2=logq2))

    def rescale(self, ref: NodeRef, dlogp: int) -> NodeRef:
        if dlogp == 0:
            return ref
        return self.emit("rescale", (ref,), dlogp=dlogp,
                         out=self.out("rescale", (ref,), dlogp=dlogp))

    def align_levels(self, a: NodeRef, b: NodeRef):
        la, lb = self.m(a)[0], self.m(b)[0]
        if la > lb:
            a = self.mod_down(a, lb)
        elif lb > la:
            b = self.mod_down(b, la)
        return a, b

    def align_scales_and_levels(self, a: NodeRef, b: NodeRef):
        pa, pb = self.m(a)[1], self.m(b)[1]
        if pa > pb:
            a = self.rescale(a, pa - pb)
        elif pb > pa:
            b = self.rescale(b, pb - pa)
        return self.align_levels(a, b)

    # ---- bootstrap insertion --------------------------------------------

    def maybe_bootstrap(self, ref: NodeRef, n_slots: int) -> NodeRef:
        """Auto-insertion (compile_handle(bootstrap="auto")): when a mul
        operand has no level left for the post-mul rescale — exactly
        where the dataflow pass would raise "needs bootstrapping" — the
        full `repro_torch.boot` pipeline is spliced in front of it, and
        the mul proceeds at the refreshed level. Per-ref memo: an
        exhausted value feeding several muls (x*x, or a shared
        subexpression) bootstraps ONCE."""
        if not self.bootstrap:
            return ref
        if self.m(ref)[0] - self.params.logp >= self.params.logp:
            return ref
        if ref in self._boot_memo:
            return self._boot_memo[ref]
        from repro_torch.boot.pipeline import bootstrap_circuit
        lq, lp = self.m(ref)
        plan = bootstrap_circuit(
            self.params, logq_in=lq, logp=lp, n_slots=n_slots,
            plain_lookup=lambda hs, q: (hs, q) in self.plain_registers
            or (self.lookup is not None and self.lookup(hs, q)),
            device=self.encode_device())
        off = len(self.ops)
        for node, m in zip(plan.ops, plan.meta):
            args = tuple(ref if isinstance(a, str) else a + off
                         for a in node.args)
            self.ops.append(dataclasses.replace(node, args=args))
            self.meta.append(m)
        for i, bnd in plan.pt_bounds.items():
            self.pt_bounds[i + off] = bnd
        self.requires |= plan.requires
        self.plain_registers |= plan.plain_registers
        self.bootstraps.append(off)
        out = len(self.ops) - 1
        self._boot_memo[ref] = out
        return out

    # ---- plaintext operands ---------------------------------------------

    def encode_device(self) -> torch.device:
        """Where materialized plaintexts are encoded: the caller's
        ``device``, else the device of the trace's inputs."""
        if self.device is None:
            self.device = next(iter(self.inputs.values())).ax.device
        return self.device

    def plain_operand(self, h: CipherHandle, log_delta: int, logq: int):
        """(pt, hash, bound) for a plain operand at a use site: hash
        (and the max-|slot| bound the noise estimator reads) always;
        the encode is SKIPPED when the server already caches
        (hash, logq) — or when an earlier node of THIS circuit already
        carries it (the lower-index node registers the operand at
        submission, before later nodes resolve it), so one weight
        vector applied to k ciphertexts in one trace encodes once."""
        z = h.plain.broadcast(h.n_slots)
        hsh = message_hash(z, log_delta)
        bound = float(np.max(np.abs(z))) if np.size(z) else 0.0
        if (hsh, logq) in self.plain_registers or (
                self.lookup is not None and self.lookup(hsh, logq)):
            return None, hsh, bound
        self.plain_registers.add((hsh, logq))
        return H.encode_plain(z, self.params, logq, log_delta=log_delta,
                              device=self.encode_device()), hsh, bound

    # ---- the lowering walk ----------------------------------------------

    def visit(self, h: CipherHandle) -> NodeRef:
        if h in self.memo:
            return self.memo[h]
        p = self.params
        if h.op == "input":
            name = f"in{len(self.inputs)}"
            self.inputs[name] = h.ct
            self.in_meta[name] = (h.ct.logq, h.ct.logp)
            self.memo[h] = name
            return name
        refs = [self.visit(a) for a in h.args]
        if h.op == "mul":
            a = self.maybe_bootstrap(refs[0], h.n_slots)
            b = self.maybe_bootstrap(refs[1], h.n_slots)
            a, b = self.align_levels(a, b)
            a, b = sorted((a, b), key=_ref_key)
            i = self.emit("mul", (a, b), out=self.out("mul", (a, b)))
            i = self.rescale(i, p.logp)
            self.requires.add(("evk",))
        elif h.op == "mul_plain":
            a, = refs
            a = self.maybe_bootstrap(a, h.n_slots)
            lq = self.m(a)[0]
            pt, hsh, bound = self.plain_operand(h, p.log_delta, lq)
            i = self.emit("mul_plain", (a,), pt=pt, pt_logp=p.log_delta,
                          pt_hash=hsh,
                          out=self.out("mul_plain", (a,),
                                       pt_logp=p.log_delta))
            self.pt_bounds[i] = bound
            i = self.rescale(i, p.logp)
        elif h.op in ("add", "sub"):
            a, b = self.align_scales_and_levels(*refs)
            if h.op == "add":
                a, b = sorted((a, b), key=_ref_key)
            i = self.emit(h.op, (a, b), out=self.out(h.op, (a, b)))
        elif h.op == "add_plain":
            a, = refs
            lq, lp = self.m(a)
            pt, hsh, bound = self.plain_operand(h, lp, lq)
            i = self.emit("add_plain", (a,), pt=pt, pt_logp=lp,
                          pt_hash=hsh,
                          out=self.out("add_plain", (a,), pt_logp=lp))
            self.pt_bounds[i] = bound
        elif h.op == "rotate":
            a, = refs
            i = self.emit("rotate", (a,), r=h.r,
                          out=self.out("rotate", (a,), r=h.r))
            self.requires.add(("rot", h.r))
        elif h.op == "conjugate":
            a, = refs
            i = self.emit("conjugate", (a,),
                          out=self.out("conjugate", (a,)))
            self.requires.add(("conj",))
        else:                          # slot_sum (TRACE_OPS is closed)
            a, = refs
            i = self.emit("slot_sum", (a,),
                          out=self.out("slot_sum", (a,)))
            self.requires.update(
                ("rot", r) for r in slot_sum_rotations(h.n_slots))
        self.memo[h] = i
        return i


def compile_handle(root: CipherHandle, params: HEParams, *,
                   plain_lookup: Optional[Callable[[str, int], bool]]
                   = None,
                   bootstrap: Union[bool, str] = False,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> CompiledCircuit:
    """Lower one traced expression to a served circuit.

    plain_lookup(hash, logq) → bool: whether the server's plaintext
    cache already holds an operand (``TableCache.has_plain``); matching
    operands ship hash-only, skipping the client-side encode.

    bootstrap: "auto" (or True) splices the `repro_torch.boot` pipeline in
    front of any mul operand too exhausted for its post-mul rescale —
    the trace may then exceed the native depth budget; the indices of
    inserted pipelines land in ``CompiledCircuit.bootstraps``. The
    default "off"/False: a too-deep trace raises "needs bootstrapping"
    at compile.

    device: where materialized plaintext operands (and an inserted
    bootstrap's diagonals) are encoded (default: the device of the
    trace's inputs); ``HESession`` passes its server's.
    """
    if bootstrap not in (False, True, "auto", "off"):
        raise ValueError(f"bootstrap must be 'auto' or 'off', "
                         f"got {bootstrap!r}")
    if root.op == "input":
        # a bare input needs no server round trip at all
        return CompiledCircuit(ops=[], inputs={"in0": root.ct},
                               out_logq=root.ct.logq,
                               out_logp=root.ct.logp,
                               n_slots=root.n_slots, requires=set())
    lw = _Lowering(params, plain_lookup,
                   None if device is None else torch.device(device),
                   bootstrap=bootstrap in (True, "auto"))
    out = lw.visit(root)
    if isinstance(out, str) or out != len(lw.ops) - 1:
        # defensive: the server returns the LAST node's ciphertext, so a
        # root that hash-consed onto an interior node gets an identity
        # mod_down tail (same modulus — a served no-op)
        lq, lp = lw.m(out)
        lw.ops.append(CircuitOp("mod_down", (out,), logq2=lq))
        lw.meta.append((lq, lp))
        out = len(lw.ops) - 1
    out_logq, out_logp = lw.meta[out]
    return CompiledCircuit(ops=lw.ops, inputs=lw.inputs,
                           out_logq=out_logq, out_logp=out_logp,
                           n_slots=root.n_slots, requires=lw.requires,
                           plain_registers=lw.plain_registers,
                           pt_bounds=lw.pt_bounds,
                           bootstraps=lw.bootstraps)
