"""The hslint rule registry: stable IDs, severities, and checkers.

Every diagnostic the analyzer emits carries a stable rule ID (HS001…)
so CI greps, suppressions, and docs can reference findings precisely.
Severity semantics:

  error    the circuit cannot run (admission would reject it);
  warning  it runs but almost certainly not as intended;
  info     it runs correctly but leaves performance on the table.

The catalog (the JAX package's, rule for rule):

  HS001  modulus-exhaustion      error    dataflow violation — the
         shared engine rejected the circuit (exhausted modulus, level/
         scale mismatch, malformed node).
  HS002  precision-below-waterline warning  estimated output precision
         below the waterline (default 8 fractional bits).
  HS003  dead-node               warning  a node's output is never
         consumed (and it is not the circuit output) — wasted device
         time every submission.
  HS004  redundant/composite-rotation warning/info  rotate by a
         multiple of n_slots is a no-op; a non-power-of-two r needs a
         dedicated key where a pow2 decomposition (r = Σ 2^i) reuses
         provisioned hoisting keys.
  HS005  eager-rescale           info     a rescale with no downstream
         (plain-)mul — the scale discipline gains nothing, the limb
         drop could be deferred or dropped (lazy rescaling, cf.
         ROADMAP's EVA item).
  HS006  depth-headroom          info     the output retains ≥ 2 unused
         levels — a smaller logQ would shrink every limb array the
         device touches (the paper's §II point that q sizing is THE
         throughput lever).
  HS007  bootstrappable-exhaustion info   companion to an exhaustion
         HS001: names the node whose level-exhausted output a
         `repro_torch.boot` bootstrap would refresh
         (run(bootstrap="auto") inserts it there automatically; the
         reference's message, naming the port's package).

The HS1xx series is the reference's shardlint (its `analysis/xla.py`,
which checks XLA's compiled HLO and has no counterpart in the port):
findings about
the COMPILED serving engines' HLO, not about circuits — emitted by the
xla pass directly (check=None here, like HS001), against the analytic
collective/memory expectations `dist.sharding` exports:

  HS101  unexpected-collective   error    a collective kind the
         sharding rules never predict for that (op, level, mesh) cell —
         an implicit resharding crept into the lowered program.
  HS102  collective-bytes-drift  error    measured all-reduce wire
         bytes off the analytic ring-model prediction beyond tolerance.
  HS103  layout-churn            error    replica groups over the wrong
         mesh axis, or a collective count off the predicted schedule.
  HS104  peak-memory-over-budget error    the backend's peak-live-
         buffer estimate exceeds the per-device HBM budget.
  HS105  fusion-break            warning  fused-kernel count drifted
         from the committed SHARD_MANIFEST.json baseline.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

from repro_torch.analysis.dataflow import Meta, OpNode
from repro_torch.analysis.noise import NodeNoise
from repro_torch.core.params import HEParams

__all__ = ["Diagnostic", "Rule", "RULES", "RuleContext", "run_rules",
           "DEFAULT_WATERLINE_BITS"]

DEFAULT_WATERLINE_BITS = 8.0    # fractional bits the output must keep

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: rule ID, severity, human message, node index (None
    for whole-circuit findings)."""

    rule: str
    severity: str
    message: str
    node: Optional[int] = None

    def format(self) -> str:
        where = f"node {self.node}: " if self.node is not None else ""
        return f"{self.severity.upper():7s} {self.rule} {where}{self.message}"


@dataclasses.dataclass(frozen=True)
class RuleContext:
    """Everything a rule may inspect — computed once by the analyzer."""

    ops: Sequence[OpNode]
    input_meta: Dict[str, Meta]
    params: HEParams
    meta: Sequence[Meta]
    noise: Sequence[NodeNoise]
    # rotation amounts with provisioned keys; None = unknown (don't
    # flag missing keys, only structural rotation smells)
    provisioned_rotations: Optional[Set[int]] = None
    waterline_bits: float = DEFAULT_WATERLINE_BITS


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    severity: str          # the DEFAULT severity; checkers may demote
    title: str
    check: Optional[Callable[[RuleContext], List[Diagnostic]]]


def _check_waterline(ctx: RuleContext) -> List[Diagnostic]:
    out = ctx.noise[-1]
    if out.precision_bits < ctx.waterline_bits:
        return [Diagnostic(
            "HS002", "warning",
            f"estimated output precision {out.precision_bits:.1f} bits "
            f"is below the {ctx.waterline_bits:.0f}-bit waterline "
            f"(predicted |slot error| 2^{out.error_bits:.1f} at "
            f"logp={out.logp}); shrink the circuit depth or raise logp",
            node=len(ctx.ops) - 1)]
    return []


def _check_dead_nodes(ctx: RuleContext) -> List[Diagnostic]:
    used = [False] * len(ctx.ops)
    used[len(ctx.ops) - 1] = True                   # the output
    for node in ctx.ops:
        for a in node.args:
            if isinstance(a, int):
                used[a] = True
    return [Diagnostic(
        "HS003", "warning",
        f"{ctx.ops[i].op} result is never consumed and is not the "
        f"circuit output — dead device work every submission",
        node=i) for i, u in enumerate(used) if not u]


def _pow2_terms(r: int) -> List[int]:
    return [1 << b for b in range(r.bit_length()) if r >> b & 1]


def _check_rotations(ctx: RuleContext) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    for i, node in enumerate(ctx.ops):
        if node.op != "rotate":
            continue
        n = ctx.noise[i].n_slots
        if node.r % n == 0:
            diags.append(Diagnostic(
                "HS004", "warning",
                f"rotate by {node.r} is a no-op on {n} slots "
                f"(r ≡ 0 mod n_slots) — drop the node", node=i))
            continue
        r = node.r % n
        terms = _pow2_terms(r)
        if len(terms) > 1:
            have = ctx.provisioned_rotations
            missing = have is not None and r not in have
            covered = have is None or all(t in have for t in terms)
            diags.append(Diagnostic(
                "HS004", "warning" if (missing and covered) else "info",
                f"rotate by {r} is composite: " + (
                    f"no key is provisioned for r={r} but the pow2 "
                    if missing else "a pow2 ") +
                f"decomposition {'+'.join(map(str, terms))} reuses "
                f"{len(terms)} hoisting keys", node=i))
    return diags


def _check_eager_rescale(ctx: RuleContext) -> List[Diagnostic]:
    # transitive "feeds a future mul" reachability, computed backwards
    feeds_mul = [False] * len(ctx.ops)
    for i in range(len(ctx.ops) - 1, -1, -1):
        node = ctx.ops[i]
        hot = node.op in ("mul", "mul_plain") or feeds_mul[i]
        if hot:
            for a in node.args:
                if isinstance(a, int):
                    feeds_mul[a] = True
    return [Diagnostic(
        "HS005", "info",
        "rescale feeds no later (plain-)mul — the scale drop buys "
        "nothing here; defer it (lazy rescaling) or drop it if the "
        "consumer accepts the higher scale",
        node=i) for i, node in enumerate(ctx.ops)
        if node.op == "rescale" and not feeds_mul[i]]


def _check_depth_headroom(ctx: RuleContext) -> List[Diagnostic]:
    out_logq = ctx.meta[-1][0]
    spare = max(0, (out_logq - 1) // ctx.params.logp)
    if spare >= 2:
        return [Diagnostic(
            "HS006", "info",
            f"output sits at logq={out_logq}: {spare} unused levels of "
            f"headroom — a smaller logQ (≈{ctx.params.logQ - spare * ctx.params.logp}) "
            f"would shrink every limb array the device touches "
            f"(paper §II)", node=len(ctx.ops) - 1)]
    return []


RULES: Dict[str, Rule] = {r.id: r for r in (
    Rule("HS001", "error", "modulus-exhaustion / dataflow violation",
         None),                       # emitted by the analyzer itself
    Rule("HS002", "warning", "precision-below-waterline",
         _check_waterline),
    Rule("HS003", "warning", "dead-node", _check_dead_nodes),
    Rule("HS004", "warning", "redundant/composite-rotation",
         _check_rotations),
    Rule("HS005", "info", "eager-rescale", _check_eager_rescale),
    Rule("HS006", "info", "depth-headroom", _check_depth_headroom),
    # companion to a modulus-exhaustion HS001: names the node whose
    # output is the level-exhausted — and bootstrappable — ciphertext
    # (emitted by the analyzer itself, alongside the HS001)
    Rule("HS007", "info", "bootstrappable-exhaustion", None),
    # HS1xx: the reference's shardlint emits these directly over
    # compiled-HLO cells; registered here so IDs/severities/titles stay
    # one catalog with stable references for CI greps and docs
    Rule("HS101", "error", "unexpected-collective", None),
    Rule("HS102", "error", "collective-bytes-drift", None),
    Rule("HS103", "error", "layout-churn", None),
    Rule("HS104", "error", "peak-memory-over-budget", None),
    Rule("HS105", "warning", "fusion-break", None),
)}


def run_rules(ctx: RuleContext) -> List[Diagnostic]:
    """Run every registered checker; diagnostics sorted by severity
    (errors first), then node order."""
    diags: List[Diagnostic] = []
    for rule in RULES.values():
        if rule.check is not None:
            diags.extend(rule.check(ctx))
    rank = {s: i for i, s in enumerate(SEVERITIES)}
    diags.sort(key=lambda d: (rank[d.severity],
                              -1 if d.node is None else d.node))
    return diags
