"""repro_torch.boot — batched CKKS bootstrapping as a first-class circuit.

Bootstrapping (HEAAN's Cheon-Han-Kim-Kim-Song pipeline; the paper's
§III-A names running out of modulus as THE depth limit this removes)
refreshes a level-exhausted ciphertext in four stages:

    mod-raise      →  lift the mod-q limbs into a wider modulus q'
                      (exact centered lift; introduces q·I(X))
    CoeffToSlot    →  homomorphic inverse embedding: slots now hold the
                      raw polynomial coefficients t = m + q·I (as
                      complex pairs), a BSGS diagonal linear transform
    EvalMod        →  approximate t mod q via the scaled sine
                      (complex-exponential Taylor + repeated squaring),
                      removing the q·I term
    SlotToCoeff    →  homomorphic embedding back to coefficient form —
                      the refreshed ciphertext, at a HIGHER level

The whole pipeline is expressed as a validated `CircuitOp` DAG
(:func:`repro_torch.boot.pipeline.bootstrap_circuit`) that rides the
serving stack: every stage batches through `HEServer.submit_circuit`,
co-batches ACROSS concurrent bootstraps via the circuit scheduler, and
ships its CoeffToSlot/SlotToCoeff diagonals through the (hash, level)
plaintext cache — hash-only on every repeat bootstrap.

Unlike every other served circuit (held bit for bit against the core
ops), bootstrap is APPROXIMATE by construction: its contract is the
slot-error bound `BootstrapPlan.error_bound`.

This is the JAX package's ``boot`` package; its plans equal the
reference's node for node, its diagonals encoded as the port's int32
words on the serving device.
"""

from repro_torch.boot.evalmod import (  # noqa: F401
    eval_mod, exp_taylor_coeffs, poly_eval,
)
from repro_torch.boot.linear import (  # noqa: F401
    bsgs_matvec, coeff_to_slot_matrix, slot_to_coeff_matrix,
)
from repro_torch.boot.modraise import mod_raise_op, raise_target  # noqa: F401
from repro_torch.boot.pipeline import (  # noqa: F401
    BOOT_STAGES, BootConfig, BootstrapPlan, boot_params, bootstrap_circuit,
)

__all__ = [
    "BOOT_STAGES", "BootConfig", "BootstrapPlan", "boot_params",
    "bootstrap_circuit", "bsgs_matvec", "coeff_to_slot_matrix",
    "slot_to_coeff_matrix", "eval_mod", "exp_taylor_coeffs",
    "poly_eval", "mod_raise_op", "raise_target",
]
