"""Carry keys and ciphertexts between the JAX package and the port.

The port's dataclasses (:mod:`repro_torch.core.cipher`) have the JAX
package's field names and shapes. :func:`from_numpy` builds one from numpy
arrays — for example ``np.asarray(evk.ax_ev)`` for each field of a JAX
``EvalKey`` — on a device; :func:`to_numpy` gives the arrays back, uint32
words as uint32. Both sides can then run HE Mul on the same operands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.context import resolve_device

__all__ = ["from_numpy", "to_numpy"]


def from_numpy(cls, fields: dict, device: str | torch.device = "cuda"):
    """An instance of dataclass `cls` from {field name: value}; numpy
    arrays become tensors on `device` (uint32 as int32 bit patterns)."""
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            v = torch.from_numpy(np.array(v)).to(dev)   # a writable copy
        kwargs[f.name] = v
    return cls(**kwargs)


def to_numpy(obj) -> dict:
    """{field name: value} of a port dataclass; int32 words come back as
    uint32 arrays, other tensors keep their dtype."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            a = v.cpu().numpy()
            v = a.view(np.uint32) if a.dtype == np.int32 else a
        out[f.name] = v
    return out
