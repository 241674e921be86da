"""Carry keys and ciphertexts between the JAX package and the port.

The port's dataclasses (:mod:`repro_torch.core.cipher`) have the JAX
package's field names and shapes. :func:`from_numpy` builds one from numpy
arrays — for example ``np.asarray(evk.ax_ev)`` for each field of a JAX
``EvalKey`` — on a device; :func:`to_numpy` gives the arrays back, words
as uint32 or uint64. Both sides can then run HE Mul on the same operands.
A uint64 array is a β = 2^64 word array and becomes int64 bit patterns;
on the way back an int64 tensor is a word only at β = 2^64, so
:func:`to_numpy` takes the word size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.context import resolve_device

__all__ = ["from_numpy", "to_numpy"]


def from_numpy(cls, fields: dict, device: str | torch.device = "cuda"):
    """An instance of dataclass `cls` from {field name: value}; numpy
    arrays become tensors on `device` (uint32 and uint64 as int32 and
    int64 bit patterns)."""
    dev = resolve_device(device)
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            elif v.dtype == np.uint64:
                v = v.view(np.int64)
            v = torch.from_numpy(np.array(v)).to(dev)   # a writable copy
        kwargs[f.name] = v
    return cls(**kwargs)


def to_numpy(obj, beta_bits: int = 32) -> dict:
    """{field name: value} of a port dataclass; int32 words come back as
    uint32 arrays, and at ``beta_bits=64`` int64 words as uint64 arrays;
    other tensors keep their dtype."""
    if beta_bits not in (32, 64):
        raise ValueError(f"beta_bits is 32 or 64; got {beta_bits}")
    words = {np.dtype(np.int32): np.uint32}
    if beta_bits == 64:
        words[np.dtype(np.int64)] = np.uint64
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            a = v.cpu().numpy()
            v = a.view(words[a.dtype]) if a.dtype in words else a
        out[f.name] = v
    return out
