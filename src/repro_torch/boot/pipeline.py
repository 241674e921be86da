"""The bootstrap pipeline: four stages, one validated CircuitOp DAG.

:func:`bootstrap_circuit` builds the whole pipeline as a plan the
serving stack treats like any other circuit — `HEServer.submit_circuit`
walks it, nodes co-batch across concurrent bootstraps via the circuit
scheduler, diagonals ride the plaintext cache. Construction is
compile-pass-driven: each post-raise stage is TRACED through the client
handle API against a sentinel session (an input on the meta device:
shapes, no storage), lowered with `compile_handle` (auto level alignment,
CSE, plain-operand hashing, diagonals encoded on `device`), and the three
lowered stages are stitched behind the `mod_raise` node with argument
renumbering. The stitched DAG is then re-validated end-to-end through
the shared dataflow engine.

Level budget (with Taylor degree d and r squarings):

    1 (CtS) + 1 (arg) + ⌈log₂(d+1)⌉ (Taylor) + r (squarings)
    + 1 (Im) + 1 (StC)   —   11 levels at the d=7, r=4 default

so the refreshed ciphertext lands at logQ − 11·logp: the reference
small-param config (:func:`boot_params`: logN=4, logQ=336, logp=24,
h=2) leaves 3 fresh levels — enough for two further muls.

Error contract (the JAX package's docs/BOOTSTRAP.md): bootstrap is
approximate. For inputs at q_s = 1 (logq_in == logp — where
auto-insertion fires) with per-slot message magnitude ≤ `msg_bound`, the
decrypted slot error is bounded by :meth:`BootstrapPlan.error_bound` —
the sine-vs-identity cubic term + the Taylor remainder (amplified
linearly by the squarings) + fixed-point slack, times a safety factor
of 4.

This is the JAX package's ``boot/pipeline.py``: the same parameters give
the same plan node for node (op, args, r, dlogp, logq2, pt_hash) and the
same plaintext words, held as the port's int32 tensors on `device`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from repro_torch.analysis.dataflow import propagate
from repro_torch.boot.evalmod import eval_mod
from repro_torch.boot.linear import (bsgs_matvec, coeff_to_slot_matrix,
                                     default_giant_step,
                                     slot_to_coeff_matrix)
from repro_torch.boot.modraise import interval_bound, raise_target
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.context import resolve_device
from repro_torch.core.params import HEParams
from repro_torch.hserve.circuit import CircuitOp

__all__ = ["BOOT_STAGES", "BootConfig", "BootstrapPlan", "boot_params",
           "bootstrap_circuit", "DEFAULT_MSG_BOUND"]

BOOT_STAGES = ("mod_raise", "coeff_to_slot", "eval_mod",
               "slot_to_coeff")

# the per-slot message-magnitude contract: the cubic sine deviation
# grows as |z|³, so bootstrap inputs keep |z| small
DEFAULT_MSG_BOUND = 2.0 ** -5


def boot_params(logN: int = 4, logQ: int = 336, logp: int = 24,
                beta_bits: int = 32) -> HEParams:
    """The reference small-param bootstrap config (NOT secure): h = 2
    keeps the mod-raise interval |I| ≤ 2.5 so r = 4 squarings cover it,
    and L = 14 leaves 3 levels after the 11 the pipeline consumes."""
    return HEParams(logN=logN, logQ=logQ, logp=logp, log_delta=logp,
                    beta_bits=beta_bits, h=2)


@dataclasses.dataclass(frozen=True)
class BootConfig:
    """Pipeline knobs.

    degree: Taylor degree for exp(iθ/2^r).
    r:      squaring count; 0 → smallest r with θ_max/2^r ≤ 1.
    giant_step: BSGS baby count for the linear stages (0 → ≈√n).
    logq_top: raise target (0 → params.logQ).
    """

    degree: int = 7
    r: int = 0
    giant_step: int = 0
    logq_top: int = 0


@dataclasses.dataclass
class BootstrapPlan:
    """One ready-to-submit bootstrap circuit + its contract metadata.

    ops/meta are the stitched, validated DAG over the single input
    `in_name`; stages labels each node with its pipeline stage (the
    obs plane's boot.* span attribution reads it); requires /
    plain_registers / pt_bounds mirror `CompiledCircuit`'s fields so
    sessions provision keys and the analyzer bounds noise the same way
    as for any compiled trace.
    """

    ops: List[CircuitOp]
    meta: List[Tuple[int, int]]
    stages: List[str]
    requires: Set[Tuple]
    plain_registers: Set[Tuple[str, int]]
    pt_bounds: Dict[int, float]
    params: HEParams
    config: BootConfig
    logq_in: int
    logp: int
    n_slots: int
    msg_bound: float
    in_name: str = "x"

    @property
    def out_logq(self) -> int:
        return self.meta[-1][0]

    @property
    def out_logp(self) -> int:
        return self.meta[-1][1]

    @property
    def levels_gained(self) -> int:
        return (self.out_logq - self.logq_in) // self.params.logp

    @property
    def r(self) -> int:
        return self.config.r or _auto_r(self.params, self.msg_bound)

    def error_bound(self, msg_bound: Optional[float] = None) -> float:
        """The |decrypted slot − message| bound (absolute, per slot) for
        inputs within `msg_bound`. Three terms, each from the
        construction, times a safety factor of 4:

        - cubic sine-vs-identity deviation (2π/q_s)²·mb³/6 — the
          dominant term at the contract boundary;
        - Taylor remainder of exp at |w| ≤ θ_max/2^r, amplified
          linearly by the r squarings (d exp(w)^(2^r) ≈ 2^r on |v|=1);
        - fixed-point slack: encode/rescale rounding across the
          pipeline's ~N-coefficient working set at scale 2^−logp.
        """
        mb = self.msg_bound if msg_bound is None else msg_bound
        p, cfg = self.params, self.config
        q_s = 2.0 ** (self.logq_in - self.logp)
        theta_max = 2.0 * math.pi * interval_bound(p, mb)
        w_max = theta_max / 2.0 ** self.r
        eps_taylor = w_max ** (cfg.degree + 1) \
            / math.factorial(cfg.degree + 1)
        cubic = (2.0 * math.pi / q_s) ** 2 * mb ** 3 / 6.0
        taylor = (q_s / (2.0 * math.pi)) * 2.0 ** self.r * eps_taylor
        fixed = p.N * 2.0 ** -self.logp
        return 4.0 * (cubic + taylor + fixed)

    def resolved_ops(self) -> List[CircuitOp]:
        """ops with every hash-only plaintext operand backfilled from
        its materialized first occurrence — for the cacheless reference
        path (`execute_circuit_reference`); `submit_circuit` resolves
        the same way through the server's plaintext cache."""
        def in_lq(a):
            return self.logq_in if isinstance(a, str) else self.meta[a][0]
        store: Dict[Tuple[str, int], object] = {}
        out = []
        for node in self.ops:
            if node.pt_hash is not None:
                key = (node.pt_hash, in_lq(node.args[0]))
                if node.pt is None:
                    node = dataclasses.replace(node, pt=store[key])
                else:
                    store[key] = node.pt
            out.append(node)
        return out


def _auto_r(params: HEParams, msg_bound: float) -> int:
    """Smallest squaring count putting the Taylor argument inside the
    unit disc: θ_max/2^r ≤ 1."""
    theta_max = 2.0 * math.pi * interval_bound(params, msg_bound)
    return max(1, math.ceil(math.log2(theta_max)))


class _Sentinel:
    """Trace-only session object: handles check identity, nothing else."""

    def __repr__(self):                        # pragma: no cover
        return "<boot trace session>"


def _stage_input(session, params: HEParams, logq: int, logp: int,
                 n_slots: int):
    """A metadata-only input handle for one stage's trace: its words lie
    on the meta device, which allocates nothing (stitching replaces the
    input with a node ref, so they are never read), in the params' word
    type, as the reference's placeholder is."""
    from repro_torch.client.handles import CipherHandle
    z = torch.zeros((params.N, params.qlimbs(logq)),
                    dtype=torch.int32 if params.beta_bits == 32
                    else torch.int64, device="meta")
    return CipherHandle(session, "input",
                        ct=Ciphertext(ax=z, bx=z, logq=logq, logp=logp,
                                      n_slots=n_slots))


def bootstrap_circuit(params: HEParams, *, logq_in: int,
                      logp: Optional[int] = None,
                      n_slots: Optional[int] = None,
                      config: Optional[BootConfig] = None,
                      msg_bound: float = DEFAULT_MSG_BOUND,
                      plain_lookup: Optional[Callable[[str, int], bool]]
                      = None,
                      device: str | torch.device = "cuda") -> BootstrapPlan:
    """Build the four-stage bootstrap plan for one input shape.

    logq_in/logp: the exhausted ciphertext's position (logq_in == logp
        — q_s = 1 — is the contract point auto-insertion targets;
        larger q_s is allowed and widens the error bound by q_s²).
    n_slots: must be the FULL slot count N/2 (see `repro_torch.boot.linear`).
    plain_lookup: the server's plaintext-cache membership test —
        matching diagonals ship hash-only (repeat bootstraps encode
        nothing).
    device: where the materialized diagonals are encoded (default the
        card; raises when CUDA is absent) — the serving device of the
        server the plan is submitted to.

    Raises `repro_torch.analysis.dataflow.CircuitError` when the modulus
    chain cannot fit the pipeline (logQ < (7 + r + L_in)·logp), and
    ValueError on sparse slots.
    """
    from repro_torch.client.compile import compile_handle

    dev = resolve_device(device)
    logp = params.logp if logp is None else logp
    n = params.n_slots_max if n_slots is None else n_slots
    if n != params.n_slots_max:
        raise ValueError(
            f"bootstrap needs full slots (n = N/2 = "
            f"{params.n_slots_max}, got {n}): with gap > 1 the unused "
            f"coefficients carry mod-raise junk that ring muls would "
            f"mix into the message")
    cfg = config or BootConfig()
    r = cfg.r or _auto_r(params, msg_bound)
    theta_max = 2.0 * math.pi * interval_bound(params, msg_bound)
    if theta_max / 2.0 ** r > 1.1:
        raise ValueError(
            f"r={r} squarings leave the Taylor argument at "
            f"{theta_max / 2.0 ** r:.2f} > 1.1 (h={params.h} is too "
            f"heavy for this r; raise r or use a lighter boot key)")
    cfg = dataclasses.replace(cfg, r=r)
    logq_top = cfg.logq_top or raise_target(params, logq_in)
    g = cfg.giant_step or default_giant_step(n)

    Ei = coeff_to_slot_matrix(n, params.N)
    E = slot_to_coeff_matrix(n, params.N)

    # trace + lower each post-raise stage separately: exact per-stage
    # node attribution (the obs plane's boot.* spans) with the compile
    # pass still owning levels/CSE/plain hashing inside each stage
    regs: Set[Tuple[str, int]] = set()

    def lookup(h: str, lq: int) -> bool:
        return (h, lq) in regs or (plain_lookup is not None
                                   and plain_lookup(h, lq))

    session = _Sentinel()
    stage_ccs = []
    in_lq, in_lp = logq_top, logp
    builders = (
        ("coeff_to_slot", lambda x: bsgs_matvec(x, Ei, giant_step=g)),
        ("eval_mod", lambda x: eval_mod(
            x, q_s_bits=logq_in - logp, degree=cfg.degree, r=cfg.r)),
        ("slot_to_coeff", lambda x: bsgs_matvec(x, E, giant_step=g)),
    )
    for name, build in builders:
        x = _stage_input(session, params, in_lq, in_lp, n)
        cc = compile_handle(build(x), params, plain_lookup=lookup,
                            device=dev)
        regs |= cc.plain_registers
        stage_ccs.append((name, cc))
        in_lq, in_lp = cc.out_logq, cc.out_logp

    # stitch: [mod_raise] ++ stages, renumbering each stage's local
    # refs (+offset) and grafting its single input onto the previous
    # stage's output node
    in_name = "x"
    ops: List[CircuitOp] = [CircuitOp("mod_raise", (in_name,),
                                      logq2=logq_top)]
    stages: List[str] = ["mod_raise"]
    requires: Set[Tuple] = set()
    pt_bounds: Dict[int, float] = {}
    prev_out = 0
    for name, cc in stage_ccs:
        off = len(ops)
        for node in cc.ops:
            args = tuple(prev_out if isinstance(a, str) else a + off
                         for a in node.args)
            ops.append(dataclasses.replace(node, args=args))
            stages.append(name)
        for i, b in cc.pt_bounds.items():
            pt_bounds[i + off] = b
        requires |= cc.requires
        prev_out = len(ops) - 1

    # end-to-end re-validation through the shared dataflow engine (the
    # level schedule the scheduler and the server will both see)
    meta = propagate(ops, {in_name: (logq_in, logp)}, params)
    return BootstrapPlan(ops=ops, meta=meta, stages=stages,
                         requires=requires, plain_registers=regs,
                         pt_bounds=pt_bounds, params=params, config=cfg,
                         logq_in=logq_in, logp=logp, n_slots=n,
                         msg_bound=msg_bound, in_name=in_name)
