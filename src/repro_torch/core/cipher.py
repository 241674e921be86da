"""Ciphertext / key containers as dataclasses of tensors.

Limb and residue tensors are the port's stored words: ``torch.int32``
holding u32 bit patterns at β = 2^32, ``torch.int64`` holding u64 bit
patterns at β = 2^64. The field names and shapes are the JAX package's, so
:mod:`repro_torch.convert` carries values across field by field.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Ciphertext:
    """HEAAN ciphertext: a pair of mod-q polynomials (paper §III-A).

    ax/bx: (N, qlimbs) little-endian limbs, coefficients in [0, q).
    """
    ax: torch.Tensor
    bx: torch.Tensor
    logq: int
    logp: int
    n_slots: int

    def to(self, device) -> "Ciphertext":
        """This ciphertext on `device` (itself when it lies there already)."""
        if self.ax.device == torch.device(device):
            return self
        return dataclasses.replace(self, ax=self.ax.to(device),
                                   bx=self.bx.to(device))


@dataclasses.dataclass
class PublicKey:
    """pk = (bx, ax) with bx = -ax·s + e mod Q."""
    ax: torch.Tensor   # (N, QLimbs)
    bx: torch.Tensor


@dataclasses.dataclass
class EvalKey:
    """evk over Q², stored CRT'd + NTT'd at the maximal region-2 prime set,
    with Shoup companions. ax_ev/bx_ev: (np2_max, N); *_shoup alongside.
    """
    ax_ev: torch.Tensor
    ax_ev_shoup: torch.Tensor
    bx_ev: torch.Tensor
    bx_ev_shoup: torch.Tensor


@dataclasses.dataclass
class SecretKey:
    """Ternary secret with Hamming weight h."""
    s: torch.Tensor    # (N,) int8 in {-1, 0, 1}
