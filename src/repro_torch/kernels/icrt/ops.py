"""Wrapper of the iCRT CUDA kernel (csrc/icrt.cu).

The kernel includes the JAX package's plain tail (−s·P, the ±1 ladder and
the center-lift, ``finalize_accum``), so one launch gives the result.
"""

from __future__ import annotations

import torch

from repro_torch.core.context import GlobalTables, IcrtTables
from repro_torch.kernels import common
from repro_torch.kernels.icrt.ref import icrt_ref

__all__ = ["icrt_op"]


def icrt_op(r, tabs: IcrtTables, g: GlobalTables, out_limbs: int):
    """(np, N) eval residues -> (N, out_limbs) centered two's complement.
    `tabs` and `g` hold tensors on r's device."""
    if common.plain(r):
        return icrt_ref(r, tabs, g, out_limbs)
    npn, N = r.shape
    PL, A = tabs.plimbs, tabs.accum_limbs
    if N & (N - 1) or npn != tabs.np_count:
        raise ValueError(f"need N a power of two and {tabs.np_count} "
                         f"primes; got N={N}, {npn} primes")
    dev = r.device
    scratch = torch.empty((A, N), dtype=torch.int32, device=dev)
    out = torch.empty((N, out_limbs), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, t, shape, dev, dtype) for name, t, shape, dtype
            in (("r", r, (npn, N), torch.int32),
                ("inv_P", tabs.inv_P, (npn,), torch.int32),
                ("inv_P_shoup", tabs.inv_P_shoup, (npn,), torch.int32),
                ("primes", g.primes[:npn], (npn,), torch.int32),
                ("p_inv_f64", g.p_inv_f64[:npn], (npn,), torch.float64),
                ("pdivp", tabs.pdivp, (npn, PL), torch.int32),
                ("P_limbs", tabs.P_limbs, (A,), torch.int32),
                ("P_half_limbs", tabs.P_half_limbs, (A,), torch.int32),
                ("scratch", scratch, (A, N), torch.int32),
                ("out", out, (N, out_limbs), torch.int32))]
    common.launch("icrt", "icrt_launch", *ptrs, N, npn, PL, A, out_limbs)
    return out
