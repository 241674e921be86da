"""Stage 1: mod-raise — the only op bootstrapping adds to the engine.

The arithmetic lives where all served limb arithmetic lives:
`core.heaan.mod_raise_poly` / `he_mod_raise` (the centered sign-extended
lift) and `hserve.engine`'s mod_raise step. This module is the pipeline's
view of it: the `CircuitOp` constructor and the raise-target policy.

Why the lift is what it is: q = 2^logq, so a coefficient c ∈ [0, q) is
the two's-complement image of the centered integer ĉ ∈ [−q/2, q/2). The
raise re-embeds ĉ into [0, q') by sign-extending the limb array — an
EXACT operation on the decoded view. Decryption at q' then yields
t = m + e + q·I(X) with ‖I‖_∞ ≤ (h+1)/2 + 1 (bx plus h signed rotations
of ax, each bounded by q/2, plus message/noise slack) — the q·I term is
what EvalMod removes.
"""

from __future__ import annotations

from repro_torch.core.params import HEParams
from repro_torch.hserve.circuit import CircuitOp

__all__ = ["mod_raise_op", "raise_target", "interval_bound"]


def raise_target(params: HEParams, logq_in: int) -> int:
    """Where mod-raise lifts to: the top of the modulus chain. The
    bootstrap wants every level it can get — the pipeline consumes
    7 + r levels and whatever is left is the refreshed depth."""
    if not 0 < logq_in < params.logQ:
        raise ValueError(
            f"cannot mod-raise from logq={logq_in} "
            f"(need 0 < logq_in < logQ={params.logQ})")
    return params.logQ


def interval_bound(params: HEParams, msg_bound: float) -> float:
    """Bound on |t|/q after the raise (in units of q): bx contributes
    q/2, ax·s contributes h·q/2 (h signed rotations), plus the message
    and noise slack — the I(X) interval EvalMod's sine must cover."""
    return (params.h + 1) / 2.0 + 1.0 + msg_bound


def mod_raise_op(arg, logq2: int) -> CircuitOp:
    """The mod-raise circuit node (arg: input name or node index)."""
    return CircuitOp("mod_raise", (arg,), logq2=logq2)
