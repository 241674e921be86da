"""The (logq, logp) dataflow of CKKS circuits: one transfer function.

:func:`transfer` is the per-op (logq, logp) transfer function and
:func:`propagate` the forward abstract interpretation over a
topologically ordered `CircuitOp` list, as in the JAX package's
``analysis/dataflow.py`` (a copy: the port imports nothing of it). Any
violation raises :class:`CircuitError`, a `ValueError` subclass that
cites the offending node index, its op, and the computed (logq, logp) at
the failure point.

The op tables live here too (``OPS`` maps op → ciphertext arity;
``PLAIN_OPS`` are the ops whose second operand is an encoded plaintext
riding the request — paper Fig. 2 region 1 only, no key switch;
``LEVEL_OPS`` the §III-A modulus-chain ops). The module needs params and
numpy only; a plaintext operand may be a numpy array or a tensor.
"""

from __future__ import annotations

from typing import (
    TYPE_CHECKING, Dict, List, Optional, Protocol, Sequence, Tuple, Union,
)

import numpy as np

from repro_torch.core.params import HEParams

if TYPE_CHECKING:
    import torch

__all__ = ["OPS", "PLAIN_OPS", "LEVEL_OPS", "CircuitError", "Meta",
           "OpNode", "transfer", "propagate"]

# op -> number of ciphertext operands
OPS: Dict[str, int] = {
    "mul": 2, "add": 2, "sub": 2, "rotate": 1, "conjugate": 1,
    "slot_sum": 1, "rescale": 1, "mod_down": 1, "mod_raise": 1,
    "mul_plain": 1, "add_plain": 1}

# ops whose second operand is an ENCODED PLAINTEXT riding the request
# (no key material, no region-2 key switch — paper Fig. 2 region 1 only)
PLAIN_OPS: Tuple[str, ...] = ("mul_plain", "add_plain")

# ops that exist purely for the paper's §III-A modulus-chain discipline
LEVEL_OPS: Tuple[str, ...] = ("rescale", "mod_down", "mod_raise")

NodeRef = Union[int, str]
Meta = Tuple[int, int]                               # (logq, logp)


class OpNode(Protocol):
    """Structural view of a circuit node — `hserve.circuit.CircuitOp`
    satisfies it, and so would any other frontend IR."""

    op: str
    args: Tuple[NodeRef, ...]
    r: int
    dlogp: int
    logq2: int
    pt: Optional[Union[np.ndarray, torch.Tensor]]
    pt_logp: int
    pt_hash: Optional[str]


class CircuitError(ValueError):
    """A dataflow violation, citing where in the circuit it happened.

    Attributes ``node`` (int index, or None for trace-time errors with
    no node yet), ``op``, ``logq``/``logp`` (the computed input metadata
    at the failure point, when known) let tools consume the location
    without parsing the message; the message itself leads with
    ``node {i} ({op}) at (logq=…, logp=…):`` for humans.
    """

    def __init__(self, msg: str, *, node: Optional[int] = None,
                 op: Optional[str] = None, logq: Optional[int] = None,
                 logp: Optional[int] = None):
        self.node = node
        self.op = op
        self.logq = logq
        self.logp = logp
        where = "trace" if node is None else f"node {node}"
        if op is not None:
            where += f" ({op})"
        if logq is not None:
            where += f" at (logq={logq}, logp={logp})"
        super().__init__(f"{where}: {msg}")


def transfer(op: str, metas: Sequence[Meta], params: HEParams, *,
             r: int = 0, dlogp: int = 0, logq2: int = 0,
             pt_logp: int = 0, node: Optional[int] = None) -> Meta:
    """The per-op (logq, logp) transfer function: input metadata in,
    output metadata out, :class:`CircuitError` on any §III-A violation.
    `metas` is one (logq, logp) pair per CIPHERTEXT operand.

    This is the only place in the repo where the level/scale rules are
    written down; `validate_circuit`, the compile pass, and the noise
    estimator all call it.
    """
    logq, logp = metas[0]

    def err(msg: str) -> CircuitError:
        return CircuitError(msg, node=node, op=op, logq=logq, logp=logp)

    if any(m[0] != logq for m in metas):
        raise err(f"operand levels differ ({[m[0] for m in metas]}); "
                  f"mod_down first (paper §III-B)")
    if op == "mul":
        logp = metas[0][1] + metas[1][1]
    elif op == "mul_plain":
        if pt_logp < 0:
            raise err(f"negative mul_plain pt_logp {pt_logp} "
                      f"(0 means params.log_delta)")
        logp += pt_logp or params.log_delta
    elif op == "add_plain":
        if pt_logp and pt_logp != logp:
            raise err(f"add_plain operand scales differ "
                      f"(plaintext logp {pt_logp} != {logp})")
    elif op in ("add", "sub"):
        if metas[0][1] != metas[1][1]:
            raise err(f"{op} operand scales differ "
                      f"(logp {metas[0][1]} != {metas[1][1]}); "
                      f"rescale first")
    elif op == "rotate":
        if r <= 0:
            raise err("rotate needs a positive rotation amount r")
    elif op == "rescale":
        if dlogp < 0:
            raise err(f"negative rescale dlogp {dlogp} "
                      f"(0 means params.logp)")
        d = dlogp or params.logp
        if logq - d <= 0:
            raise err(f"rescale by {d} exhausts the modulus "
                      f"(logq {logq}: the circuit is deeper than "
                      f"L={params.L} supports; needs bootstrapping)")
        logq -= d
        logp -= d
    elif op == "mod_down":
        if not 0 < logq2 <= logq:
            raise err(f"mod_down target logq2={logq2} "
                      f"outside (0, {logq}]")
        logq = logq2
    elif op == "mod_raise":
        if not logq < logq2 <= params.logQ:
            raise err(f"mod_raise target logq2={logq2} outside "
                      f"({logq}, {params.logQ}]")
        logq = logq2
    return (logq, logp)


def propagate(ops: Sequence[OpNode],
              input_meta: Dict[str, Meta],
              params: HEParams) -> List[Meta]:
    """Forward abstract interpretation over a topologically ordered op
    list: propagate (logq, logp) from the input ciphertexts' metadata
    through every node; raise :class:`CircuitError` — BEFORE anything
    is enqueued — on any ill-formed node. Returns the per-node output
    (logq, logp) list: the level schedule the server will serve.
    """
    if not ops:
        raise CircuitError("empty circuit")
    meta: List[Meta] = []
    for i, node in enumerate(ops):
        if node.op not in OPS:
            raise CircuitError(
                f"unknown op {node.op!r}; serve one of {set(OPS)}",
                node=i)
        if len(node.args) != OPS[node.op]:
            raise CircuitError(
                f"op {node.op!r} takes {OPS[node.op]} operand(s), "
                f"got {len(node.args)}", node=i, op=node.op)

        def resolve(a: NodeRef) -> Meta:
            if isinstance(a, str):
                if a not in input_meta:
                    raise CircuitError(
                        f"unknown input {a!r}; inputs: "
                        f"{sorted(input_meta)}", node=i, op=node.op)
                return input_meta[a]
            if not 0 <= a < i:
                raise CircuitError(
                    f"arg {a} is not an earlier node (circuits are "
                    f"topologically ordered lists)", node=i, op=node.op)
            return meta[a]

        ms = [resolve(a) for a in node.args]
        if node.op in PLAIN_OPS:
            logq, logp = ms[0]
            if node.pt is None and node.pt_hash is None:
                raise CircuitError(
                    f"{node.op} needs an encoded plaintext operand "
                    f"(core.heaan.encode_plain) or a pt_hash "
                    f"referencing the server's plaintext cache",
                    node=i, op=node.op, logq=logq, logp=logp)
            if node.pt is not None:
                shape = tuple(node.pt.shape)
                if len(shape) != 2 or shape[0] != params.N \
                        or shape[1] < params.qlimbs(logq):
                    raise CircuitError(
                        f"{node.op} plaintext shape {shape} does not "
                        f"cover ({params.N}, {params.qlimbs(logq)}) — "
                        f"encode at the node's input level 2^{logq}",
                        node=i, op=node.op, logq=logq, logp=logp)
        meta.append(transfer(node.op, ms, params, r=node.r,
                             dlogp=node.dlogp, logq2=node.logq2,
                             pt_logp=node.pt_logp, node=i))
    return meta
