"""Assigned architecture configs (--arch <id>) + the paper's HE workload.

Each module exposes CONFIG (full size) and the shared shape set, as the
JAX package's ``configs`` package does; repro_torch.configs.registry
resolves ids.
"""

from repro_torch.configs.registry import ARCHS, SHAPES, get_arch, get_shapes

__all__ = ["ARCHS", "SHAPES", "get_arch", "get_shapes"]
