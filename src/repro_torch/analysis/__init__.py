"""Static analysis of encrypted circuits.

  - dataflow: the (logq, logp) transfer function and its forward
              propagation over a circuit, with the op tables (OPS,
              PLAIN_OPS, LEVEL_OPS) and CircuitError.
"""

from repro_torch.analysis import dataflow  # noqa: F401

__all__ = ["dataflow"]
