"""Plain torch version of the iCRT kernel (column sums, f64 quotient)."""

from __future__ import annotations

from repro_torch.core.context import GlobalTables, IcrtTables
from repro_torch.core.crt import _accum_columns, _icrt

__all__ = ["icrt_ref", "icrt_inputs"]


def icrt_inputs(tabs: IcrtTables, g: GlobalTables) -> dict:
    """The tables one iCRT consumes, keyed as a region table of
    :mod:`repro_torch.dist.he_pipeline` (tensors of `tabs`' np)."""
    npn = tabs.np_count
    return {"primes": g.primes[:npn], "inv_P": tabs.inv_P,
            "inv_P_shoup": tabs.inv_P_shoup, "pdivp": tabs.pdivp,
            "P_limbs": tabs.P_limbs, "P_half_limbs": tabs.P_half_limbs,
            "p_inv_f64": g.p_inv_f64[:npn]}


def icrt_ref(r, t: dict, out_limbs: int):
    """(np, N) residues -> (N, out_limbs) centered two's complement; `t`
    holds the tables of :func:`icrt_inputs` on r's device."""
    return _icrt(r, t["primes"], t["inv_P"], t["inv_P_shoup"], t["pdivp"],
                 t["P_limbs"], t["P_half_limbs"], t["p_inv_f64"], out_limbs,
                 _accum_columns)
