"""Named example circuits for the analyzer's CLI (`python -m
repro_torch.analysis`).

Each builder returns ``(kwargs, note)`` where kwargs feed
:func:`repro_torch.analysis.analyzer.analyze_circuit` directly. The
registry spans both frontends — hand-built `CircuitOp` lists AND a
traced `CipherHandle` expression lowered through the client compile
pass — because the analyzer's contract is that the two meet the same
dataflow engine.

These are the JAX package's four examples (``analysis/examples.py``),
built from the port's objects; their reports are the reference's. The
CLI runs on the CPU: nothing is served, and the plaintext operands a
lowering materializes (the traced example's scalars, the bootstrap's
diagonals) are encoded on the CPU. Builders import lazily, so
``import repro_torch.analysis`` stays light.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["EXAMPLES", "build"]


def _degree4():
    """The repo's acceptance circuit conj(x⁴)+x at test params —
    exercises mul/rescale/mod_down/conjugate and the full §III-A level
    discipline."""
    from repro_torch.core.params import test_params
    from repro_torch.hserve.circuit import degree4_demo_circuit
    params = test_params()
    ops, _ = degree4_demo_circuit(params)
    return dict(ops=ops, input_meta={"x": (params.logQ, params.logp)},
                params=params, input_bounds=1.0,
                input_nslots={"x": params.n_slots_max}), \
        "hand-built degree-4 demo (conj(x^4) + x)"


def _affine_sigmoid():
    """The examples/he_inference.py workload as a TRACE: encrypted
    logistic-regression scoring — affine Σ wⱼ·ctⱼ + b, then the
    degree-3 sigmoid 0.5 + 0.197·x − 0.004·x³."""
    import numpy as np
    import torch

    from repro_torch.client.compile import compile_handle
    from repro_torch.client.handles import CipherHandle
    from repro_torch.core.cipher import Ciphertext
    from repro_torch.core.params import test_params

    params = test_params(logN=7, logQ=144, logp=24)
    session = object()                 # trace-only: never submitted
    n = params.n_slots_max

    def leaf():
        # the meta device: shapes, no storage (the words are never read)
        z = torch.zeros((params.N, params.qlimbs(params.logQ)),
                        dtype=torch.int32, device="meta")
        ct = Ciphertext(ax=z, bx=z, logq=params.logQ,
                        logp=params.logp, n_slots=n)
        return CipherHandle(session, "input", ct=ct)

    rng = np.random.default_rng(0)
    feats = [leaf() for _ in range(3)]
    weights = rng.uniform(-0.5, 0.5, size=3)
    x = feats[0] * weights[0]
    for ct, w in zip(feats[1:], weights[1:]):
        x = x + ct * w
    x = x + 0.25                       # bias
    score = x * x * x * (-0.004) + x * 0.197 + 0.5
    cc = compile_handle(score, params, device="cpu")
    return dict(ops=cc.ops, params=params,
                input_meta={k: (c.logq, c.logp)
                            for k, c in cc.inputs.items()},
                input_nslots={k: c.n_slots
                              for k, c in cc.inputs.items()},
                input_bounds=1.0, pt_bounds=cc.pt_bounds), \
        "traced logistic-regression scoring (he_inference.py)"


def _rotation_average():
    """A neighborhood average over 5 offsets at a generous logQ —
    a composite rotation (r=5 → 1+4) and depth headroom, the
    performance-smell rules' bread and butter."""
    from repro_torch.core.params import test_params
    from repro_torch.hserve.circuit import CircuitOp
    params = test_params(logN=6, logQ=120, logp=24)
    ops = [
        CircuitOp("rotate", ("x",), r=1),
        CircuitOp("rotate", ("x",), r=5),
        CircuitOp("add", (0, 1)),
        CircuitOp("add", (2, "x")),
    ]
    return dict(ops=ops, params=params,
                input_meta={"x": (params.logQ, params.logp)},
                input_nslots={"x": params.n_slots_max},
                input_bounds=1.0,
                provisioned_rotations={1, 2, 4, 8, 16}), \
        "rotation neighborhood sum (composite r=5, pow2 keys only)"


def _bootstrap():
    """The full `repro_torch.boot` pipeline at the reference small-param
    bootstrap config, as the analyzer sees it: a mod_raise head, two
    BSGS DFT stages, and the complex-exponential EvalMod between them —
    the deepest circuit in the registry, linted like any other."""
    from repro_torch.boot.pipeline import boot_params, bootstrap_circuit

    params = boot_params()
    plan = bootstrap_circuit(params, logq_in=params.logp, device="cpu")
    return dict(ops=plan.ops, params=params,
                input_meta={plan.in_name: (plan.logq_in, plan.logp)},
                input_nslots={plan.in_name: plan.n_slots},
                input_bounds=plan.msg_bound,
                pt_bounds=plan.pt_bounds), \
        "CKKS bootstrap pipeline (mod_raise + CtS + EvalMod + StC)"


EXAMPLES: Dict[str, Callable[[], Tuple[dict, str]]] = {
    "degree4": _degree4,
    "affine_sigmoid": _affine_sigmoid,
    "rotation_average": _rotation_average,
    "bootstrap": _bootstrap,
}


def build(name: str) -> Tuple[dict, str]:
    if name not in EXAMPLES:
        raise ValueError(f"unknown example {name!r}; one of "
                         f"{sorted(EXAMPLES)}")
    return EXAMPLES[name]()
