"""Optimizer substrate: AdamW, clipping, schedules, gradient compression.

The JAX package's ``optim`` package on tensors: AdamW's moments are held
per parameter name, and an update writes the parameters and moments in
place.
"""

from repro_torch.optim.adamw import OptState, adamw_init, adamw_update
from repro_torch.optim.compress import compress_int8, decompress_int8
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["adamw_init", "adamw_update", "OptState", "warmup_cosine",
           "compress_int8", "decompress_int8"]
