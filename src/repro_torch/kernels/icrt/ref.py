"""Plain torch version of the iCRT kernel (column sums, f64 quotient)."""

from __future__ import annotations

from repro_torch.core.context import GlobalTables, IcrtTables
from repro_torch.core.crt import icrt

__all__ = ["icrt_ref"]


def icrt_ref(r, tabs: IcrtTables, g: GlobalTables, out_limbs: int):
    """(np, N) residues -> (N, out_limbs) centered two's complement.
    `tabs` and `g` hold tensors on r's device."""
    npn = r.shape[0]
    return icrt(r, g.primes[:npn], tabs.inv_P, tabs.inv_P_shoup, tabs.pdivp,
                tabs.P_limbs, tabs.P_half_limbs, g.p_inv_f64[:npn],
                out_limbs)
