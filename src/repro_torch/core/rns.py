"""RNS pipeline composition: the paper's Fig. 2 stages as reusable pieces.

    limbs --CRT--> residues --NTT--> eval domain
    eval  --iNTT--> residues --iCRT--> centered limbs

With ``PipelineConfig(use_kernels=True)`` (the default) each stage goes
through its wrapper in :mod:`repro_torch.kernels`, which launches the CUDA
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
``use_kernels=False`` runs the plain versions on any device; it is how a
run on the card is compared with the plain path.

Tables come from the device caches of :mod:`repro_torch.core.context`;
words are int32 bit patterns throughout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.context import GlobalTables, device_icrt_tables
from repro_torch.core.ntt import pointwise_shoup_scale
from repro_torch.core.params import HEParams
from repro_torch.core.wordops import M32, modadd, modsub, narrow, wide
from repro_torch.kernels.crt.ops import crt_op
from repro_torch.kernels.crt.ref import crt_ref
from repro_torch.kernels.icrt.ops import icrt_op
from repro_torch.kernels.icrt.ref import icrt_ref
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.modmul.ref import pointwise_mont_ref
from repro_torch.kernels.ntt.ops import intt_op, ntt_op
from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref
from repro_torch.nt.residue import limbs_to_int

__all__ = ["PipelineConfig", "DEFAULT", "to_eval", "to_eval_small",
           "from_eval", "eval_mul", "eval_add", "eval_sub", "eval_mul_shoup",
           "small_ints_to_limbs", "limbs_to_centered_ints"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """use_kernels: route the stages through the kernel wrappers."""
    use_kernels: bool = True


DEFAULT = PipelineConfig()


def to_eval(x: torch.Tensor, npn: int, g: GlobalTables,
            cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """(N, K) limbs -> (npn, N) eval-domain residues (CRT then NTT)."""
    cols = max(x.shape[1], 3)           # the CRT fold reads β^k, k < 3
    tb = g.crt_tb[:npn, :cols].contiguous()
    tb_sh = g.crt_tb_shoup[:npn, :cols].contiguous()
    primes = g.primes[:npn]
    crt, ntt = (crt_op, ntt_op) if cfg.use_kernels else (crt_ref, ntt_ref)
    res = crt(x, tb, tb_sh, primes)
    return ntt(res, g.psi_rev[:npn], g.psi_rev_shoup[:npn], primes)


def to_eval_small(s: torch.Tensor, npn: int, g: GlobalTables,
                  cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """Small signed ints (N,) (e.g. ternary secrets) -> eval domain."""
    p = wide(g.primes[:npn])[:, None]
    s64 = s.long()[None, :]
    res = torch.where(s64 >= 0, s64 % p, p - ((-s64) % p))
    res = narrow(torch.where(res == p, 0, res))
    ntt = ntt_op if cfg.use_kernels else ntt_ref
    return ntt(res, g.psi_rev[:npn], g.psi_rev_shoup[:npn], g.primes[:npn])


def from_eval(ev: torch.Tensor, params: HEParams, out_limbs: int,
              g: GlobalTables, cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """(npn, N) eval residues -> (N, out_limbs) centered two's complement."""
    npn = ev.shape[0]
    tabs = device_icrt_tables(params, npn, ev.device)
    intt, icrt = (intt_op, icrt_op) if cfg.use_kernels else (intt_ref,
                                                               icrt_ref)
    res = intt(ev, g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn], g.n_inv[:npn],
               g.n_inv_shoup[:npn], g.primes[:npn])
    return icrt(res, tabs, g, out_limbs)


def eval_mul(a: torch.Tensor, b: torch.Tensor, g: GlobalTables,
             cfg: PipelineConfig = DEFAULT) -> torch.Tensor:
    """Pointwise a⊙b mod p (unknown×unknown → Montgomery)."""
    npn = a.shape[0]
    mul = pointwise_mont_op if cfg.use_kernels else pointwise_mont_ref
    return mul(a, b, g.primes[:npn], g.pprime[:npn], g.r2[:npn])


def eval_mul_shoup(a: torch.Tensor, b: torch.Tensor, b_shoup: torch.Tensor,
                   g: GlobalTables) -> torch.Tensor:
    """Pointwise a⊙b mod p where b has precomputed Shoup companions (evk)."""
    return pointwise_shoup_scale(a, b, b_shoup, g.primes[:a.shape[0]])


def eval_add(a, b, g: GlobalTables):
    p = wide(g.primes[:a.shape[0]])[:, None]
    return narrow(modadd(wide(a), wide(b), p))


def eval_sub(a, b, g: GlobalTables):
    p = wide(g.primes[:a.shape[0]])[:, None]
    return narrow(modsub(wide(a), wide(b), p))


# ---- host/limb conversions -------------------------------------------------

def small_ints_to_limbs(v: np.ndarray, n_limbs: int,
                        device: torch.device) -> torch.Tensor:
    """Signed small ints (N,) -> (N, L) two's complement limb tensor."""
    x = torch.from_numpy(np.asarray(v, dtype=np.int64)).to(device)
    out = []
    for _ in range(n_limbs):
        out.append(x & M32)
        x = x >> 32                     # arithmetic: sign fill
    return narrow(torch.stack(out, dim=-1))


def limbs_to_centered_ints(a: torch.Tensor, logq: int) -> list:
    """(N, L) mod-q limbs -> centered python ints in [-q/2, q/2)."""
    q = 1 << logq
    out = []
    for row in a.cpu().numpy().view(np.uint32):
        v = limbs_to_int(row, 32) % q
        out.append(v - q if v >= q // 2 else v)
    return out
