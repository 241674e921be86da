"""The HE placement rules on a grid of ranks, with the reference's names.

This is the HE half of the JAX package's ``dist/sharding.py``. There a rule
is a ``NamedSharding`` the partitioner follows; here it is the rows a rank
holds, and the rank computes on those rows itself:

  - "data":  the batch — ciphertext pairs of a step
    (:func:`he_limb_sharding`);
  - "model": the np CRT primes of each Fig. 2 region, the paper's §V-A
    pinning of primes to threads (:func:`he_eval_sharding`).

The prime split follows GSPMD's padding of a dimension of np rows on a
"model" axis of g ranks: with c = ⌈np_max/g⌉ (np_max the region's np at
logQ), rank r holds rows [r·c, min((r+1)·c, np_max)) of the region's
primes, and at a level logq it works on their intersection with
[:np(logq)]. So no rank ever needs another rank's table rows (the port
issues no collective-permute), and a shard can be empty; an empty shard
still joins each of iCRT's all-reduces, with zeros.

:func:`he_expected_collectives` is the reference's prediction of a served
op's collective schedule, over the port's own iCRT tables.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["data_axes", "he_limb_sharding", "he_eval_sharding",
           "prime_rows", "mesh_collective_groups",
           "he_expected_collectives"]


def data_axes(grid) -> Tuple[str, ...]:
    """Batch axes of a grid: ("data",) (a grid has no "pod" axis)."""
    return ("data",)


def he_limb_sharding(grid, batch: Optional[int] = None) -> slice:
    """This rank's rows of a (B, N, qlimbs) ciphertext batch: its block of
    the data axis. When `batch` does not divide across the data axis,
    every rank takes every row (the reference's replicated fallback)."""
    if batch is None:
        raise ValueError("he_limb_sharding needs the batch size")
    d = grid.data
    if batch % d:
        return slice(0, batch)
    per = batch // d
    return slice(grid.data_rank * per, (grid.data_rank + 1) * per)


def prime_rows(np_max: int, g: int, r: int, npn: Optional[int] = None
               ) -> slice:
    """Rows of model rank `r` of `g` in a region of `np_max` primes at
    logQ, cut to the first `npn` (the region's np at a level; default
    np_max). Empty where the rank holds nothing there."""
    c = -(-np_max // g)
    top = np_max if npn is None else min(npn, np_max)
    lo = min(r * c, top)
    return slice(lo, max(lo, min((r + 1) * c, top)))


def he_eval_sharding(grid, np_max: int, npn: Optional[int] = None
                     ) -> slice:
    """This rank's prime rows of a region of `np_max` primes at logQ, at a
    level of `npn` (see :func:`prime_rows`)."""
    return prime_rows(np_max, grid.model, grid.model_rank, npn)


def mesh_collective_groups(grid) -> dict:
    """Rank groups of a collective over each axis, as the reference's
    device-id groups for the same shape: rank ids laid out row-major over
    (data, model), grouped along each axis, sorted."""
    D, M = grid.shape
    return {
        "data": sorted(tuple(d * M + m for d in range(D))
                       for m in range(M)),
        "model": sorted(tuple(d * M + m for m in range(M))
                        for d in range(D)),
    }


# iCRT cross-prime reductions per served op, split by Fig. 2 region:
# (region-1 reductions at np1 primes, region-2 reductions at np2 primes).
# mul: from_eval for d0/d1/d2 in region 1 + the key switch's ks_ax/ks_bx
# in region 2; rotate/conjugate: the key switch only; slot_sum: one key
# switch (2 outputs) per doubling round; mul_plain: region 1 only (da,
# db); the limb-linear ops never leave the coefficient domain.
_HE_ICRT_REDUCTIONS = {
    "mul": (3, 2),
    "rotate": (0, 2),
    "conjugate": (0, 2),
    "mul_plain": (2, 0),
}


def _slot_sum_rounds(n_slots: int) -> int:
    """Doubling rounds of the slot_sum ladder (1, 2, 4, … < n_slots)."""
    rounds, r = 0, 1
    while r < n_slots:
        rounds += 1
        r *= 2
    return rounds


def he_expected_collectives(op: str, grid, params, logq: int, *,
                            batch: int, n_slots: Optional[int] = None
                            ) -> dict:
    """Predicted collective schedule of one served (op, level) cell, with
    the default "matmul" iCRT strategy: the reference's function over the
    port's ``core.context.build_icrt_tables``.

    Only iCRT's cross-prime accumulation communicates, as EXACTLY three
    all-reduces over the model groups per reduction:

      2 × int64[B_local·N, plimbs]   the column-sum halves lo and hi of
                                     Σ_j temp_j·(P/p_j) (the reference's
                                     two u64 accumulator halves);
      1 × f64[B_local·N]             the quotient estimate Σ temp_j/p_j.

    Wire bytes follow the ring model (all-reduce = 2·S·(g−1)/g per rank);
    B_local is the per-data-rank batch (the full batch when it does not
    divide). With model size 1 nothing is reduced across ranks. The
    ``allowed`` block is the reference's tolerance of its partitioner's
    collective-permutes below logQ; the port's split issues none.
    """
    from repro_torch.core.context import build_icrt_tables
    g = grid.model
    dsize = grid.data
    b_local = batch // dsize if dsize and batch % dsize == 0 else batch
    rounds = _slot_sum_rounds(n_slots if n_slots else params.n_slots_max)
    if op == "slot_sum":
        red = (0, 2 * rounds)
    else:
        red = _HE_ICRT_REDUCTIONS.get(op, (0, 0))
    n_red = sum(red)
    n_keys = {"mul": 1, "rotate": 1, "conjugate": 1,
              "slot_sum": rounds}.get(op, 0)
    np2, np2_max = params.np_region2(logq), params.np_region2(params.logQ)
    allowed = {}
    if n_keys and g > 1 and np2 < np2_max:
        limb_bytes = 4 if params.beta_bits <= 32 else 8
        allowed["collective-permute"] = {
            "max_count": 4 * n_keys,
            "max_bytes_each": -(-np2 // g) * params.N * limb_bytes,
        }
    if g <= 1 or n_red == 0:
        return {"kinds": [], "counts": {}, "wire_bytes": 0.0,
                "n_reductions": n_red, "axis": "model", "group_size": g,
                "allowed": {}}

    def ring(size: float) -> float:
        return 2.0 * size * (g - 1) / g

    per_region = []
    total = 0.0
    for n_r, npn in zip(red, (params.np_region1(logq),
                              params.np_region2(logq))):
        if not n_r:
            continue
        plimbs = build_icrt_tables(params, npn).plimbs
        one = 2 * ring(b_local * params.N * plimbs * 8) \
            + ring(b_local * params.N * 8)
        per_region.append({"reductions": n_r, "np": npn,
                           "plimbs": plimbs, "bytes_per_reduction": one})
        total += n_r * one
    return {"kinds": ["all-reduce"], "counts": {"all-reduce": 3 * n_red},
            "wire_bytes": total, "n_reductions": n_red, "axis": "model",
            "group_size": g, "per_region": per_region, "allowed": allowed}
