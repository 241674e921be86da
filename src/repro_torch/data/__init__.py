"""Data pipeline: deterministic synthetic token streams and sharding."""

from repro_torch.data.synthetic import SyntheticLM, make_batch_specs

__all__ = ["SyntheticLM", "make_batch_specs"]
