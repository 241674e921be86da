"""Static analysis of encrypted circuits (the JAX package's hslint).

  - dataflow: the (logq, logp) transfer function and its forward
              propagation over a circuit, with the op tables (OPS,
              PLAIN_OPS, LEVEL_OPS) and CircuitError.
  - noise:    a CKKS noise-budget estimator, per-op worst-case growth in
              the canonical embedding.
  - rules:    the lint rule registry (stable IDs HS001–HS007, each with
              a severity) and its checkers.
  - cost:     a bench-calibrated cost model (device-seconds per (op,
              level)) that the circuit-aware scheduler consults.
  - analyzer: ties them together into an AnalysisReport;
              `HESession.run(check=...)` runs it before submitting.
  - examples: the reference's four named example circuits (degree4,
              affine_sigmoid, rotation_average, bootstrap); `python -m
              repro_torch.analysis` is the CLI over them.
  - manifest: SHARD_MANIFEST.json's schema and drift diff (stdlib only;
              not imported here), which `python -m repro_torch.dist
              --record` writes to.
"""

from repro_torch.analysis import dataflow  # noqa: F401
from repro_torch.analysis.analyzer import (  # noqa: F401
    AnalysisReport, analyze_circuit, analyze_handle,
)
from repro_torch.analysis.cost import CostModel, op_units  # noqa: F401
from repro_torch.analysis.dataflow import (  # noqa: F401
    OPS, PLAIN_OPS, CircuitError, propagate, transfer,
)
from repro_torch.analysis.noise import NodeNoise, estimate_noise  # noqa: F401
from repro_torch.analysis.rules import RULES, Diagnostic, Rule  # noqa: F401

__all__ = [
    "AnalysisReport", "analyze_circuit", "analyze_handle",
    "CostModel", "op_units",
    "OPS", "PLAIN_OPS", "CircuitError", "propagate", "transfer",
    "NodeNoise", "estimate_noise",
    "RULES", "Diagnostic", "Rule", "dataflow",
]
