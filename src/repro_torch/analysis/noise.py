"""CKKS noise-budget estimation: per-op worst-case growth bounds.

The paper's §II modulus-chain accounting tracks WHERE in the chain a
ciphertext sits; this module tracks what that position costs in message
precision. We follow the standard CKKS canonical-embedding heuristic
(Cheon-Kim-Kim-Song 2017, "noise estimates"): every error polynomial e
is bounded by its canonical-embedding ∞-norm ν = ‖e‖^can_∞, which for a
random polynomial with i.i.d. coefficients of variance v concentrates
around √(N·v) per embedding value — we take the high-probability bound

    ν ≈ _C · √(N · v),      _C = 6  (erfc(6/√2) ≈ 2e-9 per value)

The canonical norm is sub-multiplicative (‖a·b‖ ≤ ‖a‖·‖b‖ — no extra
×N factor on mul, unlike coefficient-norm accounting; this is what
keeps the bounds non-vacuous), and a slot's decoded error is directly
ν / Δ at scale Δ = 2^logp. The repo's gap-subsampled decode (n < N/2
slots) reads a trace-folded subset of embedding values, so the same
per-value bound applies.

Contract (validated by a property test on ≥100 seeded random traced
circuits in the JAX package's tests): the predicted slot error
2^error_bits UPPER-BOUNDS the measured decrypt error with high
probability. It is worst-case over message magnitudes — the bound is
tight only when every slot sits at its magnitude bound simultaneously —
so expect a documented slack factor, not equality.

Key material (core.keys): s ternary with exactly h nonzeros; e, e0, e1
discrete Gaussian σ; u ∼ ZO(1/2) (±1 w.p. ¼ each, coeff variance ½);
evk/rot/conj keys live at modulus Q² (special modulus P = Q), so the
region-2 key-switch term scales by 2^(logq − logQ) ≤ 1.

This is the JAX package's ``analysis/noise.py``, copied (params and math
only).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.analysis.dataflow import Meta, OpNode, propagate
from repro_torch.core.params import HEParams

__all__ = ["NodeNoise", "estimate_noise", "fresh_noise",
           "keyswitch_noise", "rescale_noise", "encode_noise"]

_C = 6.0          # high-probability constant: P(|err| > C·std) ≈ 2e-9


def _embed(coeff_var: float, params: HEParams) -> float:
    """whp canonical-embedding bound for a random poly with i.i.d.
    coefficients of the given variance."""
    return _C * math.sqrt(params.N * coeff_var)


def encode_noise(n_slots: int) -> float:
    """Rounding error of encoding a message: ⌊Δ·z⌉ leaves a uniform
    [-½, ½] error on each of the 2·n_slots populated coefficients."""
    return 0.5 * _C * math.sqrt(2 * n_slots)


def fresh_noise(params: HEParams, n_slots: int) -> float:
    """ν of a fresh encryption: decrypt(Enc(m)) = m + u·e_pk + e0 +
    e1·s, plus the encode rounding of m itself."""
    b_u = _embed(0.5, params)                        # u ~ ZO(1/2)
    b_e = _embed(params.sigma ** 2, params)          # Gaussian errors
    b_s = _C * math.sqrt(params.h)                   # ternary secret
    return b_u * b_e + b_e + b_s * b_e + encode_noise(n_slots)


def rescale_noise(params: HEParams) -> float:
    """ν added by one rescale (also the key-switch mod-switch term):
    the rounding polys δ0 + δ1·s with δ coeffs uniform in [-½, ½]."""
    b_round = _embed(1.0 / 12.0, params)
    return b_round * (1.0 + _C * math.sqrt(params.h))


def keyswitch_noise(logq: int, params: HEParams) -> float:
    """ν added by one region-2 key switch (mul relinearization, rotate,
    conjugate): the key's Gaussian error times the switched part's
    rounding spread, scaled down by the special modulus (P = Q here:
    ×2^(logq − logQ)), plus the mod-switch rounding."""
    b_e = _embed(params.sigma ** 2, params)
    b_round = _embed(1.0 / 12.0, params)
    return (b_e * b_round * 2.0 ** (logq - params.logQ)
            + rescale_noise(params))


@dataclasses.dataclass(frozen=True)
class NodeNoise:
    """Noise state after one node: ν (canonical ∞-norm bound of the
    error polynomial), msg (bound on the SCALED message magnitude
    |Δ·z| in the embedding — needed because mul's cross terms are
    message × noise), and the node's (logq, logp, n_slots)."""

    nu: float
    msg: float
    logq: int
    logp: int
    n_slots: int

    @property
    def error_bits(self) -> float:
        """log2 of the predicted |slot error| = ν / 2^logp."""
        if self.nu <= 0.0:
            return float("-inf")
        return math.log2(self.nu) - self.logp

    @property
    def precision_bits(self) -> float:
        """Fractional bits of the decoded slot still trustworthy."""
        return -self.error_bits


def estimate_noise(ops: Sequence[OpNode],
                   input_meta: Dict[str, Meta],
                   params: HEParams, *,
                   input_bounds: Union[float, Dict[str, float]] = 1.0,
                   pt_bounds: Optional[Dict[int, float]] = None,
                   input_nslots: Optional[Dict[str, int]] = None,
                   meta: Optional[List[Meta]] = None
                   ) -> List[NodeNoise]:
    """Propagate noise bounds through a (level-valid) circuit.

    input_bounds: max |slot value| per input (one float for all inputs,
    or a per-name dict) — inputs are assumed FRESH encryptions at their
    (logq, logp). pt_bounds maps plain-op node index → max |slot| of
    its plaintext operand (``CompiledCircuit.pt_bounds``; defaults to
    1.0 per operand). Returns one :class:`NodeNoise` per node; the last
    entry is the circuit output's budget.
    """
    if meta is None:
        meta = propagate(ops, input_meta, params)
    pt_bounds = pt_bounds or {}
    input_nslots = input_nslots or {}

    def in_bound(name: str) -> float:
        if isinstance(input_bounds, dict):
            return float(input_bounds.get(name, 1.0))
        return float(input_bounds)

    state: Dict[Union[int, str], NodeNoise] = {}

    def resolve(a) -> NodeNoise:
        if isinstance(a, str) and a not in state:
            lq, lp = input_meta[a]
            ns = input_nslots.get(a, params.n_slots_max)
            state[a] = NodeNoise(nu=fresh_noise(params, ns),
                                 msg=in_bound(a) * 2.0 ** lp,
                                 logq=lq, logp=lp, n_slots=ns)
        return state[a]

    out: List[NodeNoise] = []
    for i, node in enumerate(ops):
        xs = [resolve(a) for a in node.args]
        x = xs[0]
        lq, lp = meta[i]
        ns = x.n_slots
        if node.op == "mul":
            y = xs[1]
            nu = x.msg * y.nu + y.msg * x.nu + x.nu * y.nu \
                + keyswitch_noise(lq, params)
            msg = x.msg * y.msg
        elif node.op == "mul_plain":
            pt_msg = pt_bounds.get(i, 1.0) \
                * 2.0 ** (node.pt_logp or params.log_delta)
            e_enc = encode_noise(ns)
            nu = (pt_msg + e_enc) * x.nu + e_enc * x.msg
            msg = x.msg * pt_msg
        elif node.op in ("add", "sub"):
            y = xs[1]
            nu = x.nu + y.nu
            msg = x.msg + y.msg
        elif node.op == "add_plain":
            nu = x.nu + encode_noise(ns)
            msg = x.msg + pt_bounds.get(i, 1.0) * 2.0 ** lp
        elif node.op in ("rotate", "conjugate"):
            nu = x.nu + keyswitch_noise(lq, params)
            msg = x.msg
        elif node.op == "slot_sum":
            nu = ns * x.nu + max(0, ns - 1) * keyswitch_noise(lq, params)
            msg = x.msg * ns
        elif node.op == "rescale":
            d = node.dlogp or params.logp
            nu = x.nu / 2.0 ** d + rescale_noise(params)
            msg = x.msg / 2.0 ** d
        elif node.op == "mod_raise":
            # the centered lift is exact in the decoded view: the q·I(X)
            # term it introduces is removed by the bootstrap's EvalMod
            # stage, whose approximation error is the pipeline's
            # documented error contract, not a
            # per-op noise term — so message and noise carry through
            nu, msg = x.nu, x.msg
        else:                                        # mod_down
            # power-of-two modulus masking is exact: no rounding term
            nu, msg = x.nu, x.msg
        nn = NodeNoise(nu=nu, msg=msg, logq=lq, logp=lp, n_slots=ns)
        state[i] = nn
        out.append(nn)
    return out
