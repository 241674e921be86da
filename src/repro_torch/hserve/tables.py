"""Level-aware resident table cache for the HE serving runtime.

A multi-level circuit touches many moduli logq < logQ. Almost everything
in a region-table dict is prime-pool state (twiddles, Montgomery/Shoup
constants, CRT rows), and at level logq those tensors are row slices of
the top level's — the table set Medha keeps resident on chip. So this
cache:

  - holds ONE resident prime-pool table set on the device
    (``core.context.device_tables``: every row at logQ's widths, moved
    once), and serves every level's region-1/2 tables as views of it,
    built by ``dist.he_pipeline.region_tables`` and cached per level:
    row slices ``[:np]``, plus the CRT rows' first max(K, 3) limb columns
    made contiguous once per level (the kernels take contiguous operands;
    CRT's fold reads β^k for k < 3 even below 3 limbs);
  - shares the per-np iCRT entries (``core.context.device_icrt_tables``,
    which depend on P = ∏ first-np primes) across every level and region
    that lands on the same prime count;
  - holds the evaluation key, any rotation keys, and the conjugation key
    on the device as ``dist.he_pipeline.evk_tables`` dicts (the steps
    slice key rows ``[:np2]`` per level). Every Galois key is just
    another evk-shaped dict riding the same region-2 machinery.

The level views are value-identical to ``region_tables(make_context(
params, logq))`` at every level, so serving from the cache cannot change
a single output bit.

This is the JAX package's ``hserve/tables.py``. It has no ``quot_fix``
(the port's iCRT takes its quotient from f64, see ``dist/he_pipeline.py``)
and takes max(K, 3) CRT columns where the reference slices K.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.cipher import EvalKey
from repro_torch.core.context import (
    device_icrt_tables, device_tables, make_context, resolve_device,
)
from repro_torch.core.params import HEParams
from repro_torch.dist.he_pipeline import evk_tables, region_tables

__all__ = ["PlainCache", "TableCache"]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class PlainCache:
    """LRU cache of encoded plaintext operands keyed by (hash, logq), on
    one device.

    The plaintext-operand caching story: affine-layer weights encode
    once, every later request references the hash. LRU-bounded (cap_mib;
    None = unbounded): a server fed per-request one-shot operands must
    not grow without limit.
    """

    def __init__(self, device: torch.device,
                 cap_mib: Optional[float] = 256.0):
        self.device = device
        self._plain: "OrderedDict[Tuple[str, int], torch.Tensor]" = \
            OrderedDict()
        self._cap = None if cap_mib is None else int(cap_mib * 2**20)
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def put(self, h: str, logq: int, pt: torch.Tensor) -> torch.Tensor:
        """Cache an encoded operand under (hash, logq); returns the
        resident copy. An existing entry wins (and counts a hit — the
        client re-sent an operand the server already held). The resident
        tensor is the cache's own copy on its device, so the request
        queue can alias it instead of copying the (N, qlimbs) words on
        every submit that resolves from the cache."""
        key = (h, int(logq))
        if key in self._plain:
            self.hits += 1
            self._plain.move_to_end(key)
        else:
            self.misses += 1
            if pt.device != self.device:
                raise ValueError(f"plaintext lies on {pt.device}; this "
                                 f"cache holds {self.device}")
            arr = pt.clone()
            self._plain[key] = arr
            self._bytes += _nbytes((arr,))
            # LRU eviction (never the entry just inserted). In-flight
            # circuits resolved their operands at submit and keep their
            # own references, so eviction cannot break queued work —
            # only a LATER hash-only reference to an evicted key fails
            # (and re-registering it is always legal).
            while self._cap is not None and len(self._plain) > 1 \
                    and self._bytes > self._cap:
                _, old = self._plain.popitem(last=False)
                self._bytes -= _nbytes((old,))
                self.evictions += 1
        return self._plain[key]

    def get(self, h: str, logq: int) -> torch.Tensor:
        """The cached encoded operand for (hash, logq); KeyError (before
        anything is enqueued) when the client references a hash the
        server never saw at this level."""
        key = (h, int(logq))
        if key not in self._plain:
            raise KeyError(
                f"no cached plaintext for hash {h!r} at logq={logq}; "
                f"send the encoded operand once (pt=..., pt_hash=...) "
                f"before referencing it by hash alone")
        self.hits += 1
        self._plain.move_to_end(key)
        return self._plain[key]

    def has(self, h: str, logq: int) -> bool:
        return (h, int(logq)) in self._plain

    def __len__(self) -> int:
        return len(self._plain)

    @property
    def nbytes(self) -> int:
        return self._bytes


def _on(key: EvalKey, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in evk_tables(key).items()}


class TableCache:
    """One resident device table set; per-level views by slicing."""

    def __init__(self, params: HEParams, evk: Optional[EvalKey] = None,
                 rot_keys: Optional[Dict[int, EvalKey]] = None,
                 conj_key: Optional[EvalKey] = None,
                 plain_cache_mib: Optional[float] = 256.0,
                 device: str | torch.device = "cuda"):
        self.params = params
        self.device = resolve_device(device)
        self._resident = device_tables(params, self.device)
        self._levels: Dict[int, Tuple[Dict, Dict]] = {}
        self._np_sets: set = set()
        self._ek = _on(evk, self.device) if evk is not None else None
        self._rot = {int(r): _on(rk, self.device)
                     for r, rk in (rot_keys or {}).items()}
        self._conj = _on(conj_key, self.device) \
            if conj_key is not None else None
        self.hits = 0
        self.misses = 0
        # repro_torch.obs.Tracer (optional): cold level_tables misses emit
        # "tables.level_slice" engine spans — the table build the
        # scheduler's prefetch hides behind the in-flight batch.
        self.tracer = None
        # encoded plaintext operands keyed by (message hash, logq)
        self.plain = PlainCache(self.device, cap_mib=plain_cache_mib)

    # ---- per-level region tables ----------------------------------------

    def level_tables(self, logq: int) -> Tuple[Dict, Dict]:
        """(t1, t2) region-table dicts for modulus 2^logq, as views of the
        resident set. Cached per level; cheap on miss (no rebuild of the
        pool tables, no re-upload)."""
        if logq in self._levels:
            self.hits += 1
            return self._levels[logq]
        self.misses += 1
        span = self.tracer.span("tables.level_slice", cat="engine",
                                lane="engine", args={"logq": logq}) \
            if self.tracer is not None else None
        ctx = make_context(self.params, logq, self.device)
        self._levels[logq] = (region_tables(ctx, 1), region_tables(ctx, 2))
        self._np_sets |= {ctx.np1, ctx.np2}
        if span is not None:
            span.end()
        return self._levels[logq]

    def has_level(self, logq: int) -> bool:
        """Whether 2^logq's views are already materialized — the
        circuit-aware scheduler's prefetch asks before warming a level
        behind the in-flight batch (`CircuitScheduler.prefetch_levels`)."""
        return logq in self._levels

    # ---- plaintext operands ----------------------------------------------

    def put_plain(self, h: str, logq: int, pt) -> torch.Tensor:
        """Cache an encoded plaintext operand under (hash, logq); see
        :meth:`PlainCache.put`."""
        return self.plain.put(h, logq, pt)

    def get_plain(self, h: str, logq: int) -> torch.Tensor:
        """The cached encoded operand for (hash, logq); see
        :meth:`PlainCache.get`."""
        return self.plain.get(h, logq)

    def has_plain(self, h: str, logq: int) -> bool:
        return self.plain.has(h, logq)

    @property
    def plain_hits(self) -> int:
        return self.plain.hits

    @property
    def plain_misses(self) -> int:
        return self.plain.misses

    @property
    def plain_evictions(self) -> int:
        return self.plain.evictions

    # ---- keys ------------------------------------------------------------

    def evk(self) -> Dict[str, torch.Tensor]:
        if self._ek is None:
            raise ValueError("no evaluation key loaded (mul unavailable)")
        return self._ek

    def rot_key(self, r: int) -> Dict[str, torch.Tensor]:
        try:
            return self._rot[int(r)]
        except KeyError:
            raise KeyError(
                f"no rotation key for r={r}; loaded: "
                f"{sorted(self._rot)}") from None

    def add_rot_key(self, r: int, rk: EvalKey) -> None:
        self._rot[int(r)] = _on(rk, self.device)

    def conj_key(self) -> Dict[str, torch.Tensor]:
        if self._conj is None:
            raise ValueError(
                "no conjugation key loaded (conjugate unavailable)")
        return self._conj

    def add_conj_key(self, ck: EvalKey) -> None:
        self._conj = _on(ck, self.device)

    @property
    def has_conj_key(self) -> bool:
        return self._conj is not None

    @property
    def rotation_amounts(self):
        return sorted(self._rot)

    # ---- accounting ------------------------------------------------------

    def stats(self) -> dict:
        res = self._resident
        res_b = _nbytes(getattr(res, k) for k in vars(res)
                        if isinstance(getattr(res, k), torch.Tensor))
        icrt_b = 0
        for npn in self._np_sets:
            tabs = device_icrt_tables(self.params, npn, self.device)
            icrt_b += _nbytes(getattr(tabs, k) for k in vars(tabs)
                              if isinstance(getattr(tabs, k), torch.Tensor))
        keys = ([self._ek] if self._ek else []) \
            + ([self._conj] if self._conj else []) + list(self._rot.values())
        key_b = _nbytes(v for d in keys for v in d.values())
        return {
            "levels_materialized": sorted(self._levels),
            "np_sets": sorted(self._np_sets),
            "rot_keys": self.rotation_amounts,
            "conj_key": self.has_conj_key,
            "hits": self.hits,
            "misses": self.misses,
            "plain_entries": len(self.plain),
            "plain_hits": self.plain_hits,
            "plain_misses": self.plain_misses,
            "plain_evictions": self.plain_evictions,
            "resident_mib": round(res_b / 2**20, 3),
            "icrt_mib": round(icrt_b / 2**20, 3),
            "keys_mib": round(key_b / 2**20, 3),
            "plain_mib": round(self.plain.nbytes / 2**20, 3),
        }
