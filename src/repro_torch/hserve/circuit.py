"""Encrypted-circuit representation for server-side evaluation.

A real encrypted computation is a small DAG of mul → rescale → mod-down →
rotate/conjugate ops at descending levels (§III-A's level-management
discipline), not one HE Mul. A circuit is a topologically ordered list of
:class:`CircuitOp` nodes. Each node's ``args`` reference either a named
client input (str) or the output of an earlier node (int index). The last
node is the circuit's output.

:func:`validate_circuit` is the level tracker: it propagates (logq, logp)
through the DAG from the input ciphertexts' metadata and raises before
anything runs on level mismatches between operands, scale mismatches on
add/sub, rescaling past exhaustion, out-of-range mod-down/mod-raise
targets, forward references, or unknown ops.
:func:`execute_circuit_reference` runs a circuit through the port's core
ops on the operands' device: the oracle a served circuit is held against.
This is the JAX package's ``hserve/circuit.py``, ported; the plaintext
operand ``pt`` may be a numpy uint32 array or an int32 tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.analysis.dataflow import propagate
from repro_torch.core import heaan as H
from repro_torch.core.params import HEParams
from repro_torch.core.rns import DEFAULT, PipelineConfig
from repro_torch.core.rotate import he_conjugate, he_rotate
from repro_torch.hserve.engine import slot_sum_rotations

__all__ = ["CircuitOp", "validate_circuit", "circuit_schedule",
           "degree4_demo_circuit", "affine_demo_circuit",
           "execute_circuit_reference"]

NodeRef = Union[int, str]


def degree4_demo_circuit(params: HEParams):
    """The repo's acceptance/demo circuit over one input "x":
    conj(x⁴) + x — mul → rescale → mul → rescale → mod-down → conjugate,
    plus the mod-down alignment of x and the final add, exercising every
    level-management op. Returns (ops, logq_md), where logq_md is the
    aligned modulus (logQ − 3·logp). Decrypts to conj(z⁴) + z."""
    logq_md = params.logQ - 3 * params.logp
    if logq_md <= 0:                    # not assert: gone under python -O
        raise ValueError(
            f"degree-4 demo circuit needs depth L >= 4 "
            f"(logQ={params.logQ}, logp={params.logp} gives only "
            f"L={params.L})")
    return [
        CircuitOp("mul", ("x", "x")),
        CircuitOp("rescale", (0,)),
        CircuitOp("mul", (1, 1)),
        CircuitOp("rescale", (2,)),
        CircuitOp("mod_down", (3,), logq2=logq_md),
        CircuitOp("conjugate", (4,)),
        CircuitOp("mod_down", ("x",), logq2=logq_md),
        CircuitOp("add", (5, 6)),
    ], logq_md


def affine_demo_circuit(params: HEParams, w: np.ndarray, b: np.ndarray,
                        device: str | torch.device = "cuda"):
    """An affine-layer circuit over one input "x" of len(w) slots at logQ:
    mul_plain by w → rescale → add_plain of b → rotate(1) → sub against
    the mod-down of x → slot_sum, its plaintexts encoded on `device`. w is
    encoded at scale 2^logp, so the rescale brings the product back to
    x's scale 2^log_delta; b is encoded at that scale and the rescaled
    level. Every slot decrypts to Σ_i (roll(w ⊙ z + b, −1) − z)_i."""
    logq1 = params.logQ - params.logp
    return [
        CircuitOp("mul_plain", ("x",), pt_logp=params.logp,
                  pt=H.encode_plain(w, params, params.logQ,
                                    log_delta=params.logp, device=device)),
        CircuitOp("rescale", (0,)),
        CircuitOp("add_plain", (1,), pt_logp=params.log_delta,
                  pt=H.encode_plain(b, params, logq1, device=device)),
        CircuitOp("rotate", (2,), r=1),
        CircuitOp("mod_down", ("x",), logq2=logq1),
        CircuitOp("sub", (3, 4)),
        CircuitOp("slot_sum", (5,)),
    ]


@dataclasses.dataclass(frozen=True)
class CircuitOp:
    """One node of an encrypted circuit.

    op:    any served op ("mul", "add", "sub", "rotate", "conjugate",
           "slot_sum", "rescale", "mod_down", "mod_raise", "mul_plain",
           "add_plain").
    args:  operand references — a str names a client input, an int the
           output of an earlier node (0-based index into the op list).
    r:     left-rotation amount ("rotate" only).
    dlogp: scale drop for "rescale" (0 → params.logp).
    logq2: target modulus for "mod_down"/"mod_raise".
    pt:    encoded plaintext operand for "mul_plain"/"add_plain" —
           (N, qlimbs) mod-q limbs at the node's input level
           (core.heaan.encode_plain: an int32 tensor; a numpy uint32
           array is taken too); excluded from equality/repr. May be
           None when `pt_hash` names an operand a server already holds
           in its (hash, level) plaintext cache.
    pt_logp: the plaintext's scale (mul_plain: 0 → params.log_delta;
           add_plain: must match the ciphertext's logp, 0 → assumed to).
    pt_hash: content hash of the plaintext MESSAGE at its encoding scale
           (core.encoding.message_hash). With `pt` set it registers the
           operand in the server's plaintext cache; alone it references
           a previously registered operand — affine-layer weights encode
           and ship once, not per request.
    """

    op: str
    args: Tuple[NodeRef, ...]
    r: int = 0
    dlogp: int = 0
    logq2: int = 0
    pt: Optional[Union[np.ndarray, torch.Tensor]] = dataclasses.field(
        default=None, compare=False, repr=False)
    pt_logp: int = 0
    pt_hash: Optional[str] = None


def validate_circuit(ops: List[CircuitOp],
                     input_meta: Dict[str, Tuple[int, int]],
                     params: HEParams) -> List[Tuple[int, int]]:
    """Propagate (logq, logp) through the DAG; raise on any ill-formed
    node. Returns the per-node output (logq, logp) list — the level
    schedule the server will serve.

    input_meta maps input names to their ciphertexts' (logq, logp).

    Delegates to :func:`repro_torch.analysis.dataflow.propagate`. Errors
    are `repro_torch.analysis.dataflow.CircuitError` (a `ValueError`)
    citing the node index, op, and computed (logq, logp).
    """
    return propagate(ops, input_meta, params)


def circuit_schedule(ops: List[CircuitOp],
                     input_meta: Dict[str, Tuple[int, int]],
                     input_nslots: Dict[str, int],
                     params: HEParams):
    """The circuit's full level schedule, computed BEFORE execution.

    Validates the DAG (see :func:`validate_circuit`) and returns
    ``(meta, keys, nslots)``: per-node output (logq, logp), per-node
    queue bucket key ``(op, input logq, extra)`` — the trace signature of
    the batched step that serves the node — and per-node slot count
    (every op preserves its first operand's n_slots). A circuit-aware
    scheduler looks ahead at it: knowing every future node's bucket key
    lets it co-batch same-key nodes across circuits before they are
    ready and prefetch the next level's tables.
    """
    meta = validate_circuit(ops, input_meta, params)
    keys: List[Tuple] = []
    nslots: List[int] = []
    for i, node in enumerate(ops):
        a = node.args[0]
        in_logq = input_meta[a][0] if isinstance(a, str) else meta[a][0]
        nslots.append(input_nslots[a] if isinstance(a, str) else nslots[a])
        if node.op == "rotate":
            keys.append((node.op, in_logq, node.r))
        elif node.op == "slot_sum":
            keys.append((node.op, in_logq, nslots[-1]))
        elif node.op == "rescale":
            keys.append((node.op, in_logq, node.dlogp or params.logp))
        elif node.op in ("mod_down", "mod_raise"):
            keys.append((node.op, in_logq, node.logq2))
        else:
            keys.append((node.op, in_logq, None))
    return meta, keys, nslots


def _words(pt, device: torch.device) -> torch.Tensor:
    """A plaintext operand as int32 words on `device`."""
    if isinstance(pt, np.ndarray):
        pt = torch.from_numpy(np.ascontiguousarray(
            pt.astype(np.uint32, copy=False)).view(np.int32))
    return pt.to(device)


def execute_circuit_reference(ops: List[CircuitOp],
                              inputs: Dict[str, "object"],
                              params: HEParams, *, evk=None,
                              rot_keys: Optional[Dict[int, object]] = None,
                              conj_key=None,
                              cfg: PipelineConfig = DEFAULT):
    """Run a circuit through the port's single-ciphertext core ops, on the
    device of the inputs.

    This is the bitwise oracle a served path is held against: every node
    maps to exactly the core.heaan / core.rotate call that the batched
    step of :mod:`repro_torch.hserve.engine` reproduces (slot_sum as the
    doubling rotate+add ladder). `cfg` goes to every op that takes one, so
    one circuit runs through the kernels or through the plain path.
    Plaintext nodes must carry a materialized `pt` (there is no cache on
    this path). Returns the last node's Ciphertext.
    """
    validate_circuit(
        ops, {n: (c.logq, c.logp) for n, c in inputs.items()}, params)
    device = next(iter(inputs.values())).ax.device
    rot_keys = rot_keys or {}
    values: Dict[NodeRef, object] = dict(inputs)
    for i, node in enumerate(ops):
        cts = [values[a] for a in node.args]
        if node.op == "mul":
            if evk is None:
                raise ValueError(f"node {i}: mul needs an evaluation key")
            out = H.he_mul(cts[0], cts[1], evk, params, cfg)
        elif node.op == "add":
            out = H.he_add(cts[0], cts[1])
        elif node.op == "sub":
            out = H.he_sub(cts[0], cts[1])
        elif node.op == "rotate":
            out = he_rotate(cts[0], node.r, rot_keys[node.r], params, cfg)
        elif node.op == "conjugate":
            if conj_key is None:
                raise ValueError(
                    f"node {i}: conjugate needs a conjugation key")
            out = he_conjugate(cts[0], conj_key, params, cfg)
        elif node.op == "slot_sum":
            out = cts[0]
            for r in slot_sum_rotations(out.n_slots):
                out = H.he_add(out, he_rotate(out, r, rot_keys[r], params,
                                              cfg))
        elif node.op == "rescale":
            out = H.rescale(cts[0], params, dlogp=node.dlogp or None)
        elif node.op == "mod_down":
            out = H.he_mod_down(cts[0], params, node.logq2)
        elif node.op == "mod_raise":
            out = H.he_mod_raise(cts[0], params, node.logq2)
        elif node.op in ("mul_plain", "add_plain"):
            if node.pt is None:
                raise ValueError(
                    f"node {i}: reference execution needs a materialized "
                    f"pt (no plaintext cache on this path)")
            pt = _words(node.pt, device)
            out = (H.he_mul_plain(cts[0], pt, params,
                                  pt_logp=node.pt_logp or None, cfg=cfg)
                   if node.op == "mul_plain"
                   else H.he_add_plain(cts[0], pt, params))
        else:                             # unreachable post-validation
            raise ValueError(f"node {i}: unknown op {node.op!r}")
        values[i] = out
    return values[len(ops) - 1]
