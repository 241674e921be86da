"""RNS pipeline composition: the paper's Fig. 2 stages as reusable pieces.

    limbs --CRT--> residues --NTT--> eval domain
    eval  --iNTT--> residues --iCRT--> centered limbs

Strategy flags select the paper's optimization ladder (see core.crt and
core.ntt), routed as the JAX package routes them:

  - ``use_kernels=True`` (the port's default): CRT, NTT, iNTT, iCRT and
    the Montgomery product go through their wrappers in
    :mod:`repro_torch.kernels` with the kernels' defaults (acc3 CRT,
    unmodified Shoup), whatever the strategy fields say. A wrapper
    launches the CUDA kernel for a CUDA tensor and runs its plain version
    for a CPU tensor.
  - ``use_kernels=False``: the plain torch stages on any device, honouring
    ``crt_strategy``, ``icrt_strategy`` and ``modified_shoup``. It is how a
    run on the card is compared with the plain path.
  - The evk Shoup product (:func:`eval_mul_shoup`) is plain torch on
    either path and honours ``modified_shoup``.

Tables come from the device caches of :mod:`repro_torch.core.context`.
Words are the stored words of the tables' β: int32 bit patterns at
β = 2^32, int64 bit patterns at β = 2^64. The kernels take β = 2^32 only,
as the reference's do, so at β = 2^64 ``use_kernels=True`` raises
ValueError (:func:`kernels_on`): the caller asks for the plain path with
``PipelineConfig(use_kernels=False)``, and nothing switches to it quietly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.context import GlobalTables, device_icrt_tables
from repro_torch.core.crt import crt, icrt
from repro_torch.core.ntt import intt, ntt, pointwise_shoup_scale
from repro_torch.core.params import HEParams
from repro_torch.core.wordops import (
    M32, modadd, modsub, narrow, wide, word_bits,
)
from repro_torch.kernels.crt.ops import crt_op
from repro_torch.kernels.icrt.ops import icrt_op
from repro_torch.kernels.icrt.ref import icrt_inputs
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.modmul.ref import pointwise_mont_ref
from repro_torch.kernels.ntt.ops import intt_op, ntt_op
from repro_torch.nt.residue import limbs_to_int

__all__ = ["PipelineConfig", "DEFAULT", "kernels_on", "to_eval",
           "to_eval_small", "from_eval", "eval_mul", "eval_add", "eval_sub",
           "eval_mul_shoup", "poly_mul", "small_ints_to_limbs",
           "limbs_to_centered_ints"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Paper optimization toggles (§V), as in the JAX package; only the
    default of use_kernels differs (the port runs on its kernels)."""
    crt_strategy: str = "matmul"      # matmul | shoup | mod2 | mod4 | acc3
    icrt_strategy: str = "matmul"     # matmul | acc3 | naive
    modified_shoup: bool = False      # paper's 3-half-mul Shoup variant
    use_kernels: bool = True          # route stages through the kernels


DEFAULT = PipelineConfig()


def kernels_on(use_kernels: bool, params: HEParams) -> bool:
    """`use_kernels`, refused at β = 2^64 (the kernels are β = 2^32, as
    the reference's Pallas kernels are)."""
    if use_kernels and params.beta_bits != 32:
        raise ValueError(
            f"the CUDA kernels take β = 2^32 words; at β = "
            f"2^{params.beta_bits} pass PipelineConfig(use_kernels=False) "
            f"for the plain torch path")
    return use_kernels


def to_eval(x: torch.Tensor, npn: int, g: GlobalTables,
            cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """(N, K) limbs -> (npn, N) eval-domain residues (CRT then NTT)."""
    cols = max(x.shape[1], 3)           # the CRT fold reads β^k, k < 3
    tb = g.crt_tb[:npn, :cols].contiguous()
    tb_sh = g.crt_tb_shoup[:npn, :cols].contiguous()
    primes = g.primes[:npn]
    psi = (g.psi_rev[:npn], g.psi_rev_shoup[:npn], primes)
    if kernels_on(cfg.use_kernels, g.params):
        return ntt_op(crt_op(x, tb, tb_sh, primes), *psi)
    res = crt(x, tb, tb_sh, primes, strategy=cfg.crt_strategy)
    return ntt(res, *psi, modified=cfg.modified_shoup)


def to_eval_small(s: torch.Tensor, npn: int, g: GlobalTables,
                  cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """Small signed ints (N,) (e.g. ternary secrets) -> eval domain."""
    p = wide(g.primes[:npn])[:, None]
    s64 = s.long()[None, :]
    res = torch.where(s64 >= 0, s64 % p, p - ((-s64) % p))
    res = narrow(torch.where(res == p, 0, res), g.params.beta_bits)
    psi = (g.psi_rev[:npn], g.psi_rev_shoup[:npn], g.primes[:npn])
    if kernels_on(cfg.use_kernels, g.params):
        return ntt_op(res, *psi)
    return ntt(res, *psi, modified=cfg.modified_shoup)


def from_eval(ev: torch.Tensor, params: HEParams, out_limbs: int,
              g: GlobalTables, cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """(npn, N) eval residues -> (N, out_limbs) centered two's complement."""
    npn = ev.shape[0]
    tabs = device_icrt_tables(params, npn, ev.device)
    ipsi = (g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn], g.n_inv[:npn],
            g.n_inv_shoup[:npn], g.primes[:npn])
    if kernels_on(cfg.use_kernels, g.params):
        return icrt_op(intt_op(ev, *ipsi), icrt_inputs(tabs, g), out_limbs)
    res = intt(ev, *ipsi, modified=cfg.modified_shoup)
    return icrt(res, g.primes[:npn], tabs.inv_P, tabs.inv_P_shoup,
                tabs.pdivp, tabs.P_limbs, tabs.P_half_limbs,
                g.p_inv_f64[:npn], out_limbs, strategy=cfg.icrt_strategy)


def eval_mul(a: torch.Tensor, b: torch.Tensor, g: GlobalTables,
             cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """Pointwise a⊙b mod p (unknown×unknown → Montgomery)."""
    npn = a.shape[0]
    mul = pointwise_mont_op if kernels_on(cfg.use_kernels, g.params) \
        else pointwise_mont_ref
    return mul(a, b, g.primes[:npn], g.pprime[:npn], g.r2[:npn])


def eval_mul_shoup(a: torch.Tensor, b: torch.Tensor, b_shoup: torch.Tensor,
                   g: GlobalTables, cfg: PipelineConfig = DEFAULT
                   ) -> torch.Tensor:
    """Pointwise a⊙b mod p where b has precomputed Shoup companions (evk)."""
    return pointwise_shoup_scale(a, b, b_shoup, g.primes[:a.shape[0]],
                                 modified=cfg.modified_shoup)


def eval_add(a, b, g: GlobalTables):
    p = wide(g.primes[:a.shape[0]])[:, None]
    return narrow(modadd(wide(a), wide(b), p), g.params.beta_bits)


def eval_sub(a, b, g: GlobalTables):
    p = wide(g.primes[:a.shape[0]])[:, None]
    return narrow(modsub(wide(a), wide(b), p), g.params.beta_bits)


def poly_mul(x: torch.Tensor, y: torch.Tensor, x_bits: int, y_bits: int,
             params: HEParams, g: GlobalTables, out_limbs: int,
             cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """General negacyclic poly product of two canonical limb polys.

    Chooses np from the exact coefficient bound |c| < N·2^(x_bits+y_bits).
    Returns centered two's complement at out_limbs.
    """
    npn = params.np_for_bits(
        params.primes, x_bits + y_bits + params.logN + 2)
    ex = to_eval(x, npn, g, cfg)
    ey = to_eval(y, npn, g, cfg)
    return from_eval(eval_mul(ex, ey, g, cfg), params, out_limbs, g, cfg)


# ---- host/limb conversions -------------------------------------------------

def small_ints_to_limbs(v: np.ndarray, n_limbs: int,
                        device: torch.device, beta_bits: int = 32
                        ) -> torch.Tensor:
    """Signed small ints (N,) -> (N, L) two's complement limb tensor."""
    x = torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
    if beta_bits == 64:                 # limb 0 is the int64; sign fill
        return torch.stack([x] + [x >> 63] * (n_limbs - 1), dim=-1)
    out = []
    for _ in range(n_limbs):
        out.append(x & M32)
        x = x >> 32                     # arithmetic: sign fill
    return narrow(torch.stack(out, dim=-1))


def limbs_to_centered_ints(a: torch.Tensor, logq: int) -> list:
    """(N, L) mod-q limbs of either β -> centered python ints in
    [-q/2, q/2)."""
    q = 1 << logq
    beta = word_bits(a)
    out = []
    for row in a.cpu().numpy().view(np.uint32 if beta == 32 else np.uint64):
        v = limbs_to_int(row, beta) % q
        out.append(v - q if v >= q // 2 else v)
    return out
