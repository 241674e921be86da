"""Plain torch versions of the carry kernels: the BigInt functions they
compute, limb by limb (``core.bigint``)."""

from __future__ import annotations

from repro_torch.core import bigint

__all__ = ["shift_round_ref", "add_mask_ref"]


def shift_round_ref(x, s, out_limbs=None):
    """round(x / 2^s), two's complement, as `out_limbs` limbs."""
    return bigint.shift_right_round(x, s, arithmetic=True,
                                    out_limbs=out_limbs)


def add_mask_ref(a, b, bits):
    """(a + b) mod 2^bits."""
    return bigint.mask_bits(bigint.add(a, b), bits)
