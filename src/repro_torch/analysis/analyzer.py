"""The analyzer facade: circuit (or traced handle) in, report out.

`analyze_circuit` is the one entry point everything shares:
`HESession.run(check=...)`, `launch.serve --check` and tests. It never
raises on a bad circuit — dataflow violations become HS001 diagnostics —
so callers decide policy (`check="error"` raises; `check="warn"` warns).

This is the JAX package's ``analysis/analyzer.py``; its report renders
and serializes the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Set, Union

from repro_torch.analysis.cost import CostModel
from repro_torch.analysis.dataflow import CircuitError, Meta, OpNode, propagate
from repro_torch.analysis.noise import NodeNoise, estimate_noise
from repro_torch.analysis.rules import (DEFAULT_WATERLINE_BITS, Diagnostic,
                                  RuleContext, run_rules)
from repro_torch.core.params import HEParams

__all__ = ["AnalysisReport", "analyze_circuit", "analyze_handle"]


@dataclasses.dataclass
class AnalysisReport:
    """Everything the static analyzer learned about one circuit."""

    diagnostics: List[Diagnostic]
    n_ops: int
    meta: List[Meta] = dataclasses.field(default_factory=list)
    noise: List[NodeNoise] = dataclasses.field(default_factory=list)
    cost_s: Optional[float] = None
    cost_per_node: List[float] = dataclasses.field(default_factory=list)
    calibrated_from: Optional[str] = None

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def out_precision_bits(self) -> Optional[float]:
        return self.noise[-1].precision_bits if self.noise else None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "ok": self.ok,
            "n_ops": self.n_ops,
            "diagnostics": [dataclasses.asdict(x)
                            for x in self.diagnostics],
        }
        if self.meta:
            nn = self.noise[-1]
            d["out"] = {"logq": self.meta[-1][0],
                        "logp": self.meta[-1][1],
                        "error_bits": round(nn.error_bits, 2),
                        "precision_bits": round(nn.precision_bits, 2)}
        if self.cost_s is not None:
            d["cost"] = {"est_device_s": self.cost_s,
                         "calibrated_from": self.calibrated_from}
        return d

    def render(self, name: str = "circuit") -> str:
        """Pretty multi-line report for terminals."""
        lines = [f"{name}: {self.n_ops} op(s), "
                 + ("OK" if self.ok else
                    f"{len(self.errors)} error(s)")]
        if self.meta:
            nn = self.noise[-1]
            lines.append(
                f"  out (logq={self.meta[-1][0]}, "
                f"logp={self.meta[-1][1]}), predicted |slot error| "
                f"2^{nn.error_bits:.1f} "
                f"({nn.precision_bits:.1f} bits of precision)")
        if self.cost_s is not None:
            us = self.cost_s * 1e6
            lines.append(f"  est. device time {us:,.0f} µs "
                         f"(κ from {self.calibrated_from})")
        for diag in self.diagnostics:
            lines.append("  " + diag.format())
        if not self.diagnostics:
            lines.append("  no findings")
        return "\n".join(lines)


def analyze_circuit(ops: Sequence[OpNode],
                    input_meta: Dict[str, Meta],
                    params: HEParams, *,
                    input_bounds: Union[float, Dict[str, float]] = 1.0,
                    pt_bounds: Optional[Dict[int, float]] = None,
                    input_nslots: Optional[Dict[str, int]] = None,
                    provisioned_rotations: Optional[Set[int]] = None,
                    waterline_bits: float = DEFAULT_WATERLINE_BITS,
                    cost_model: Optional[CostModel] = None
                    ) -> AnalysisReport:
    """Run the full static analysis over one circuit.

    Dataflow violations do NOT raise: they come back as a single HS001
    error diagnostic citing the offending node (the same CircuitError
    admission would have raised).
    """
    try:
        meta = propagate(ops, input_meta, params)
    except CircuitError as e:
        diags = [Diagnostic("HS001", "error", str(e), node=e.node)]
        if "needs bootstrapping" in str(e) and e.node is not None:
            # the exhausted ciphertext is the offending node's operand:
            # a bootstrap spliced in front of it would refresh the
            # level and let the rest of the circuit proceed
            args = [a for a in ops[e.node].args if isinstance(a, int)]
            at = args[0] if args else e.node
            diags.append(Diagnostic(
                "HS007", "info",
                f"the level-exhausted ciphertext (node {at}'s output) "
                f"is bootstrappable: insert the repro_torch.boot pipeline "
                f"there — run(bootstrap=\"auto\") does this "
                f"automatically (docs/BOOTSTRAP.md)", node=at))
        return AnalysisReport(diagnostics=diags, n_ops=len(ops))
    noise = estimate_noise(ops, input_meta, params,
                           input_bounds=input_bounds,
                           pt_bounds=pt_bounds,
                           input_nslots=input_nslots, meta=meta)
    ctx = RuleContext(ops=ops, input_meta=input_meta, params=params,
                      meta=meta, noise=noise,
                      provisioned_rotations=provisioned_rotations,
                      waterline_bits=waterline_bits)
    report = AnalysisReport(diagnostics=run_rules(ctx), n_ops=len(ops),
                            meta=list(meta), noise=list(noise))
    if cost_model is not None:
        total, per = cost_model.estimate_circuit(ops, input_meta, meta)
        report.cost_s = total
        report.cost_per_node = per
        report.calibrated_from = cost_model.calibrated_from
    return report


def analyze_handle(root, params: HEParams, *, compiled=None,
                   input_bounds: Union[float, Dict[str, float], None]
                   = None, **kw) -> AnalysisReport:
    """Analyze a traced `CipherHandle` expression: lower it with the
    client compile pass (or reuse a pre-compiled circuit via
    ``compiled=``), then run :func:`analyze_circuit` with the lowered
    circuit's own input metadata, slot counts, and recorded plaintext
    bounds.

    input_bounds defaults to the conservative 1.0 per input; pass the
    real max |slot value| per input name ("in0", "in1", … in trace
    order) for tight noise predictions.
    """
    if compiled is None:
        from repro_torch.client.compile import compile_handle
        compiled = compile_handle(root, params)
    cc = compiled
    if not cc.ops:                       # a bare input: nothing to run
        return AnalysisReport(diagnostics=[], n_ops=0)
    input_meta = {n: (ct.logq, ct.logp) for n, ct in cc.inputs.items()}
    input_nslots = {n: ct.n_slots for n, ct in cc.inputs.items()}
    return analyze_circuit(
        ops=cc.ops, input_meta=input_meta, params=params,
        input_bounds=1.0 if input_bounds is None else input_bounds,
        pt_bounds=cc.pt_bounds, input_nslots=input_nslots, **kw)
