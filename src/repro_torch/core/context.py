"""Precomputed tables for the HE Mul pipeline (paper Table V).

The paper's functions consume precomputed data:
  - CRT:  TB_CRT[j,k] = β^k mod p_j, plus Shoup companions.
  - NTT:  TB_W = powers of the 2N-th root ψ in bit-reversed order (+Shoup).
  - iNTT: inverse-ψ powers (+Shoup) and N⁻¹ mod p.
  - iCRT: (P/p_j)⁻¹ mod p_j (+Shoup), limbs of P/p_j, and P itself.

Tables are built host-side with exact arithmetic and the same values as
the JAX package's tables, then moved to a device once per (params, device)
by :func:`device_tables` and :func:`device_icrt_tables`. At β = 2^32 they
are numpy on 64-bit products, as in the reference. At β = 2^64 the
reference loops over python ints entry by entry; here the power tables
double a block at a time with the port's exact Shoup product and the
Shoup companions are the port's long division
(:func:`repro_torch.core.wordops.shoup_companion`), both vectorized on
CPU tensors (the tests hold them equal to the reference's).

  - :class:`GlobalTables` — everything that depends only on the prime pool
    (built once per parameter set; sliced per level).
  - :class:`IcrtTables` — everything that depends on P = ∏ first-np primes
    (cached per np, shared between regions/levels that use the same np).
  - :class:`HEContext` — a cheap per-(params, logq, device) view bundling
    both regions' device tables.

On a device every uint32 table is a ``torch.int32`` tensor holding the u32
bit pattern and every uint64 table a ``torch.int64`` tensor holding the
u64 bit pattern (the port's word storage, see
:mod:`repro_torch.core.wordops`).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.params import HEParams
from repro_torch.core.wordops import shoup_companion, shoup_modmul
from repro_torch.nt.primes import bit_reverse_indices, primitive_2nth_root
from repro_torch.nt.residue import int_to_limbs

__all__ = ["GlobalTables", "IcrtTables", "HEContext", "build_global_tables",
           "build_icrt_tables", "device_tables", "device_icrt_tables",
           "make_context", "resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for
    and absent, so nothing falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "torch versions on the CPU")
        if dev.index is None:           # tensors report an indexed device
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _np_dtype(beta_bits: int):
    return np.uint32 if beta_bits == 32 else np.uint64


def _t64(a: np.ndarray) -> torch.Tensor:
    """uint64 numpy words -> a CPU int64 tensor of their bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64)
                            .view(np.int64))


def _np64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _pow_table_vec(bases: np.ndarray, primes: np.ndarray, n: int,
                   beta_bits: int = 32) -> np.ndarray:
    """powers[j, k] = bases[j]^k mod primes[j], k in [0, n). Exact."""
    if beta_bits == 64:
        return _pow_table64(bases, primes, n)
    b = bases.astype(np.uint64)
    p = primes.astype(np.uint64)
    col = np.ones(len(primes), dtype=np.uint64)
    res = np.empty((len(primes), n), dtype=np.uint64)
    for k in range(n):                  # products < 2^60 fit u64
        res[:, k] = col
        col = (col * b) % p
    return res.astype(np.uint32)


def _pow_table64(bases: np.ndarray, primes: np.ndarray, n: int
                 ) -> np.ndarray:
    """:func:`_pow_table_vec` for 64-bit words: columns [m, 2m) are
    columns [0, m) times b^m, one exact Shoup product per doubling."""
    p = _t64(primes)[:, None]
    res = torch.ones((len(primes), n), dtype=torch.int64)
    m = 1
    while m < n:
        w = min(m, n - m)
        y = np.array([pow(int(b), m, int(q)) for b, q in zip(bases, primes)],
                     dtype=np.uint64)
        res[:, m: m + w] = shoup_modmul(
            res[:, :w], _t64(y)[:, None],
            _t64(_shoup_vec(y, primes, 64))[:, None], p, 64)
        m *= 2
    return _np64(res)


def _shoup_vec(vals: np.ndarray, primes: np.ndarray, beta_bits: int = 32
               ) -> np.ndarray:
    """floor(vals·β / p); vals is (np,) or (np, K), primes is (np,). Exact."""
    if beta_bits == 64:
        return _np64(shoup_companion(_t64(vals), _t64(primes), 64))
    p_b = primes.reshape(-1, *([1] * (vals.ndim - 1)))
    return ((vals.astype(np.uint64) << np.uint64(32))
            // p_b.astype(np.uint64)).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class GlobalTables:
    """Prime-pool-wide tables; slice rows [:np] for a given level/region.

    Arrays are numpy on the host; :func:`device_tables` gives the same
    tables as tensors.
    """

    params: HEParams
    primes: np.ndarray            # (np_max,)
    psi_rev: np.ndarray           # (np_max, N)   ψ^brv(k)
    psi_rev_shoup: np.ndarray
    ipsi_rev: np.ndarray          # (np_max, N)   ψ^-brv(k)
    ipsi_rev_shoup: np.ndarray
    n_inv: np.ndarray             # (np_max,)     N⁻¹ mod p
    n_inv_shoup: np.ndarray
    pprime: np.ndarray            # (np_max,)     -p⁻¹ mod β  (Montgomery)
    r2: np.ndarray                # (np_max,)     β² mod p    (Montgomery)
    crt_tb: np.ndarray            # (np_max, max_in_limbs)  β^k mod p
    crt_tb_shoup: np.ndarray
    p_inv_f64: np.ndarray         # (np_max,)     1/p as float64

    @property
    def max_in_limbs(self) -> int:
        return self.crt_tb.shape[1]


@lru_cache(maxsize=8)
def build_global_tables(params: HEParams) -> GlobalTables:
    beta = params.beta_bits
    dt = _np_dtype(beta)
    N = params.N
    primes_py = params.primes[:params.max_np]
    primes = np.array(primes_py, dtype=dt)

    # --- NTT twiddles ------------------------------------------------------
    psis = np.array(
        [primitive_2nth_root(p, N) for p in primes_py], dtype=dt)
    ipsis = np.array(
        [pow(int(w), int(p) - 2, int(p)) for w, p in zip(psis, primes_py)],
        dtype=dt)
    brv = np.array(bit_reverse_indices(N), dtype=np.int64)
    psi_rev = np.ascontiguousarray(
        _pow_table_vec(psis, primes, N, beta)[:, brv])
    ipsi_rev = np.ascontiguousarray(
        _pow_table_vec(ipsis, primes, N, beta)[:, brv])
    n_inv = np.array(
        [pow(N, int(p) - 2, int(p)) for p in primes_py], dtype=dt)

    # --- Montgomery constants ---------------------------------------------
    R = 1 << beta
    pprime = np.array([(-pow(p, -1, R)) % R for p in primes_py], dtype=dt)
    r2 = np.array([(R * R) % p for p in primes_py], dtype=dt)

    # --- CRT table: β^k mod p ---------------------------------------------
    max_in_limbs = params.limbs_for_bits(2 * params.logQ) + 1
    beta_mod = np.array([R % p for p in primes_py], dtype=dt)
    crt_tb = _pow_table_vec(beta_mod, primes, max_in_limbs, beta)

    return GlobalTables(
        params=params,
        primes=primes,
        psi_rev=psi_rev,
        psi_rev_shoup=_shoup_vec(psi_rev, primes, beta),
        ipsi_rev=ipsi_rev,
        ipsi_rev_shoup=_shoup_vec(ipsi_rev, primes, beta),
        n_inv=n_inv,
        n_inv_shoup=_shoup_vec(n_inv, primes, beta),
        pprime=pprime,
        r2=r2,
        crt_tb=crt_tb,
        crt_tb_shoup=_shoup_vec(crt_tb, primes, beta),
        p_inv_f64=1.0 / primes.astype(np.float64),
    )


@dataclasses.dataclass(frozen=True)
class IcrtTables:
    """Tables depending on P = ∏_{j<np} p_j (paper Algo 5/6 inputs)."""

    np_count: int
    P_int: int                    # exact P (host-side)
    P_bits: int
    plimbs: int                   # limbs of the largest P/p_j
    accum_limbs: int              # limbs covering np·P (the accumulator)
    inv_P: np.ndarray             # (np,)  (P/p_j)⁻¹ mod p_j
    inv_P_shoup: np.ndarray
    pdivp: np.ndarray             # (np, plimbs)  limbs of P/p_j
    P_limbs: np.ndarray           # (accum_limbs,)
    P_half_limbs: np.ndarray      # (accum_limbs,)  floor(P/2)


@lru_cache(maxsize=None)
def build_icrt_tables(params: HEParams, np_count: int) -> IcrtTables:
    beta = params.beta_bits
    dt = _np_dtype(beta)
    primes_py = params.primes[:np_count]
    P = math.prod(primes_py)
    P_bits = P.bit_length()
    plimbs = params.limbs_for_bits((P // min(primes_py)).bit_length())
    # +2 limbs of assembly headroom (the JAX kernel places 3-word
    # accumulators at limb offsets 0..2; the width is kept for parity).
    accum_limbs = params.limbs_for_bits(
        P_bits + math.ceil(math.log2(np_count)) + 1) + 2

    inv_P = np.array([pow(P // p, -1, p) for p in primes_py], dtype=dt)
    primes = np.array(primes_py, dtype=dt)
    pdivp = np.stack([int_to_limbs(P // p, plimbs, beta)
                      for p in primes_py])

    return IcrtTables(
        np_count=np_count,
        P_int=P,
        P_bits=P_bits,
        plimbs=plimbs,
        accum_limbs=accum_limbs,
        inv_P=inv_P,
        inv_P_shoup=_shoup_vec(inv_P, primes, beta),
        pdivp=pdivp,
        P_limbs=int_to_limbs(P, accum_limbs, beta),
        P_half_limbs=int_to_limbs(P // 2, accum_limbs, beta),
    )


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _on_device(tables, device: torch.device):
    """The same tables with every array as a tensor on `device` (uint32
    and uint64 arrays become int32 and int64 bit patterns)."""
    return dataclasses.replace(tables, **{
        f.name: _tensor(getattr(tables, f.name), device)
        for f in dataclasses.fields(tables)
        if isinstance(getattr(tables, f.name), np.ndarray)})


@lru_cache(maxsize=8)
def device_tables(params: HEParams, device: torch.device) -> GlobalTables:
    """:func:`build_global_tables` as tensors on `device`, moved once."""
    return _on_device(build_global_tables(params), device)


@lru_cache(maxsize=None)
def device_icrt_tables(params: HEParams, np_count: int,
                       device: torch.device) -> IcrtTables:
    """:func:`build_icrt_tables` as tensors on `device`, moved once."""
    return _on_device(build_icrt_tables(params, np_count), device)


@dataclasses.dataclass(frozen=True)
class HEContext:
    """Per-(params, logq, device) bundle: region-1 and region-2 tables.

    Region 1 multiplies two log q-bit polys (P₁ > 2N·q²); region 2 multiplies
    a log q-bit poly with the log Q²-bit evk (P₂ > 2N·q·Q²). Paper Fig. 2.
    `tables`, `icrt1` and `icrt2` hold tensors on `device`.
    """

    params: HEParams
    logq: int
    device: torch.device
    tables: GlobalTables
    np1: int
    np2: int
    icrt1: IcrtTables
    icrt2: IcrtTables

    @property
    def qlimbs(self) -> int:
        return self.params.qlimbs(self.logq)

    @property
    def N(self) -> int:
        return self.params.N


def make_context(params: HEParams, logq: int,
                 device: str | torch.device = "cuda") -> HEContext:
    dev = resolve_device(device)
    np1 = params.np_region1(logq)
    np2 = params.np_region2(logq)
    return HEContext(
        params=params,
        logq=logq,
        device=dev,
        tables=device_tables(params, dev),
        np1=np1,
        np2=np2,
        icrt1=device_icrt_tables(params, np1, dev),
        icrt2=device_icrt_tables(params, np2, dev),
    )
