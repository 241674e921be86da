"""Wrapper of the iCRT CUDA kernel (csrc/icrt.cu).

The kernel includes the JAX package's plain tail (−s·P, the ±1 ladder and
the center-lift, ``finalize_accum``), so one launch gives the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.icrt.ref import icrt_ref

__all__ = ["icrt_op"]

_BLOCK = 64         # coefficients per block of icrt_launch


def icrt_op(r, t: dict, out_limbs: int):
    """(np, N) eval residues -> (N, out_limbs) centered two's complement.
    `t` holds the tables of :func:`~repro_torch.kernels.icrt.ref.icrt_inputs`
    (a region table has them) on r's device."""
    if common.plain(r):
        return icrt_ref(r, t, out_limbs)
    npn, N = r.shape
    PL, A = t["pdivp"].shape[1], t["P_limbs"].shape[0]
    if N % min(N, _BLOCK) or npn != t["pdivp"].shape[0]:
        raise ValueError(
            f"need N a multiple of {_BLOCK} or at most {_BLOCK} (the "
            f"launcher runs N/min(N, {_BLOCK}) blocks of min(N, {_BLOCK}) "
            f"coefficients) and {t['pdivp'].shape[0]} primes; got N={N}, "
            f"{npn} primes")
    dev = r.device
    scratch = torch.empty((A, N), dtype=torch.int32, device=dev)
    out = torch.empty((N, out_limbs), dtype=torch.int32, device=dev)
    ptrs = [common.check(name, v, shape, dev, dtype) for name, v, shape, dtype
            in (("r", r, (npn, N), torch.int32),
                ("inv_P", t["inv_P"], (npn,), torch.int32),
                ("inv_P_shoup", t["inv_P_shoup"], (npn,), torch.int32),
                ("primes", t["primes"], (npn,), torch.int32),
                ("p_inv_f64", t["p_inv_f64"], (npn,), torch.float64),
                ("pdivp", t["pdivp"], (npn, PL), torch.int32),
                ("P_limbs", t["P_limbs"], (A,), torch.int32),
                ("P_half_limbs", t["P_half_limbs"], (A,), torch.int32),
                ("scratch", scratch, (A, N), torch.int32),
                ("out", out, (N, out_limbs), torch.int32))]
    common.launch("icrt", "icrt_launch", *ptrs, N, npn, PL, A, out_limbs)
    return out

