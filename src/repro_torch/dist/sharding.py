"""The placement rules on a grid of ranks, with the reference's names.

This is the JAX package's ``dist/sharding.py``. There a rule is a
``NamedSharding`` the partitioner follows; here it is the rows a rank
holds, and the rank computes on those rows itself. The HE rules place:

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
op's collective schedule, over the port's own iCRT tables, for iCRT's
"matmul" form; for the column form of the other strategies and of
β = 2^64 (:func:`icrt_form`) the prediction is the port's own.

The LM rules (:func:`batch_spec`, :func:`param_sharding_rules`,
:func:`cache_sharding_rules`, :func:`zero1_opt_sharding`) return one spec
tuple a leaf — ``(None, None, "model")`` — in the reference's
``PartitionSpec`` order, over a tree of the reference's leaves (nested, as
``convert.lm_tree`` gives it, or flat under dotted paths, as
``convert.lm_stack`` does); they read only shapes, so meta tensors serve.
Their grid is anything with ``axis_size("data")`` and
``axis_size("model")``: a ``launch.mesh.HostGrid`` or a
``launch.mesh.GridShape``. :func:`batch_rows` is a rank's rows of an LM
batch by :func:`batch_spec`. :func:`shard_lm` places a model by them for
tensor-parallel serving (``fsdp_params=False``, as the reference's
``launch/serve.py`` does): each rank keeps only its chunk of every leaf
the rules split over "model", marked with the dim it is split along
(``models.layers.held_dim``), and the models' ``grid=`` path runs on it.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

__all__ = ["data_axes", "he_limb_sharding", "he_eval_sharding",
           "prime_rows", "mesh_collective_groups", "icrt_form",
           "he_expected_collectives", "batch_spec", "batch_rows",
           "param_sharding_rules", "cache_sharding_rules",
           "zero1_opt_sharding", "lm_param_specs", "shard_lm",
           "load_lm_shard"]


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


def icrt_form(icrt_strategy: str, beta_bits: int,
              use_kernels: bool = False) -> str:
    """The form of iCRT's partial sums across ranks
    (``core.crt.icrt_partial``): "matmul" (lo and hi, the split kernels'
    form, which every strategy name takes on the kernel path) or
    "columns" (one tensor of 32-bit column sums: acc3, naive, and every
    strategy at β = 2^64)."""
    if icrt_strategy not in ("matmul", "acc3", "naive"):
        raise ValueError(f"unknown iCRT strategy {icrt_strategy!r}")
    if beta_bits == 32 and (use_kernels or icrt_strategy == "matmul"):
        return "matmul"
    return "columns"


def he_expected_collectives(op: str, grid, params, logq: int, *,
                            batch: int, n_slots: Optional[int] = None,
                            icrt_strategy: str = "matmul",
                            use_kernels: bool = False) -> dict:
    """Predicted collective schedule of one served (op, level) cell: with
    the default "matmul" iCRT strategy at β = 2^32, the reference's
    function over the port's ``core.context.build_icrt_tables``.

    Only iCRT's cross-prime accumulation communicates. In the matmul form
    (:func:`icrt_form`) it is EXACTLY three all-reduces over the model
    groups per reduction:

      2 × int64[B_local·N, plimbs]   the column-sum halves lo and hi of
                                     Σ_j temp_j·(P/p_j) (the reference's
                                     two u64 accumulator halves);
      1 × f64[B_local·N]             the quotient estimate Σ temp_j/p_j.

    In the column form (iCRT "acc3" or "naive" off the kernel path, and
    every strategy at β = 2^64) it is two, and this part of the
    prediction is the port's own (the reference's partitioner issues
    other collectives for those strategies):

      1 × int64[B_local·N, A·β/2^32] the 32-bit column sums of the
                                     accumulator of A = accum_limbs words;
      1 × f64[B_local·N]             the quotient estimate.

    Wire bytes follow the ring model (all-reduce = 2·S·(g−1)/g per rank);
    B_local is the per-data-rank batch (the full batch when it does not
    divide). With model size 1 nothing is reduced across ranks. The
    ``allowed`` block is the reference's tolerance of its partitioner's
    collective-permutes below logQ; the port's split issues none.
    """
    from repro_torch.core.context import build_icrt_tables
    form = icrt_form(icrt_strategy, params.beta_bits, use_kernels)
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
        tabs = build_icrt_tables(params, npn)
        plimbs = tabs.plimbs
        row = b_local * params.N * 8
        if form == "matmul":
            one = 2 * ring(row * plimbs) + ring(row)
            per_region.append({"reductions": n_r, "np": npn,
                               "plimbs": plimbs,
                               "bytes_per_reduction": one})
        else:
            columns = tabs.accum_limbs * params.beta_bits // 32
            one = ring(row * columns) + ring(row)
            per_region.append({"reductions": n_r, "np": npn,
                               "plimbs": plimbs, "columns": columns,
                               "bytes_per_reduction": one})
        total += n_r * one
    per_red = 3 if form == "matmul" else 2
    out = {"kinds": ["all-reduce"], "counts": {"all-reduce": per_red * n_red},
           "wire_bytes": total, "n_reductions": n_red, "axis": "model",
           "group_size": g, "per_region": per_region, "allowed": allowed}
    if form != "matmul":
        out["icrt_form"] = form
    return out


def batch_spec(grid) -> tuple:
    """LM batch placement: the leading (batch) dim over the data axes."""
    return ("data",) if data_axes(grid) else (None,)


def batch_rows(grid, batch: int) -> slice:
    """This rank's rows of an LM batch of `batch` rows: its block of the
    data axis where :func:`batch_spec` puts the batch on "data" and the
    data size divides `batch` (the reference's "when it divides"), else
    every row."""
    d = grid.axis_size("data")
    if batch_spec(grid) != ("data",) or batch % d:
        return slice(0, batch)
    n = batch // d
    return slice(grid.data_rank * n, (grid.data_rank + 1) * n)


# --------------------------------------------------------------------------
# LM parameter / cache / optimizer placements
# --------------------------------------------------------------------------

# Leaf or parent names whose weights are column-parallel (output dim on
# "model") vs row-parallel (input dim on "model", megatron-style so the
# matmul pair needs one collective, not two).
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "wi", "wg", "in_proj", "in_x", "in_y", "x_proj",
    "dt_proj", "gate_a", "gate_x", "router", "lm_head",
})
_ROW_PARALLEL = frozenset({"wo", "out_proj", "out"})
_EMBED = frozenset({"tok_embed"})


def _model_dim(names: list, shape: Tuple[int, ...]) -> Optional[int]:
    """Which dim of this leaf carries the tensor-parallel "model" axis."""
    if len(shape) < 2:
        return None
    tagged = [n for n in names if n in _COL_PARALLEL | _ROW_PARALLEL
              | _EMBED]
    if tagged:
        tag = tagged[-1]
        if tag in _ROW_PARALLEL:
            return len(shape) - 2
        if tag in _EMBED:
            return len(shape) - 2      # vocab dim of (V, D)
        return len(shape) - 1          # column-parallel: output dim
    # Unknown ≥2-d leaf (conv filters, SSM A_log, ...): largest dim.
    return max(range(len(shape)), key=lambda d: shape[d])


def _map_with_path(fn, tree, names=()):
    """`fn(path names, leaf)` over a tree of dicts and lists; a dict key
    holding dots contributes each of its parts to the path."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, names + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, names + (str(i),))
                for i, v in enumerate(tree)]
    return fn(list(names), tree)


def _divides(n: int, size: int) -> bool:
    return n % size == 0 and n >= size and n > 1


def param_sharding_rules(params: Any, grid, *,
                         fsdp_params: bool = True) -> Any:
    """The tree of spec tuples for model params.

    Tensor-parallel dim (by name orientation, falling back to largest-dim)
    goes on "model"; with `fsdp_params`, the largest remaining divisible
    dim goes on "data" (FSDP). Scalars, vectors, and non-divisible dims
    stay replicated — placement never fails, it only degrades.
    """
    msize = grid.axis_size("model")
    dsize = grid.axis_size("data")

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        if len(shape) >= 2:
            md = _model_dim(names, shape)
            if md is not None and _divides(shape[md], msize):
                spec[md] = "model"
            if fsdp_params:
                free = [d for d in range(len(shape)) if spec[d] is None
                        and _divides(shape[d], dsize)]
                if free:
                    spec[max(free, key=lambda d: shape[d])] = "data"
        return tuple(spec)

    return _map_with_path(rule, params)


def cache_sharding_rules(cache: Any, grid) -> Any:
    """The tree of spec tuples for KV / recurrent decode caches.

    The batch dim (0, or 1 under a stacked/scanned layer axis) goes on
    "data"; of the remaining dims, prefer the head dim (-2) and otherwise
    the largest divisible dim for "model".
    """
    msize = grid.axis_size("model")
    dsize = grid.axis_size("data")

    def rule(names, leaf):
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)
        bdim = 1 if names and names[0] in ("stacked", "groups") else 0
        if len(shape) > bdim and _divides(shape[bdim], dsize):
            spec[bdim] = "data"
        cands = [d for d in range(bdim + 1, len(shape))
                 if spec[d] is None and _divides(shape[d], msize)]
        if cands:
            head = len(shape) - 2
            spec[head if head in cands else
                 max(cands, key=lambda d: shape[d])] = "model"
        return tuple(spec)

    return _map_with_path(rule, cache)


def zero1_opt_sharding(p_specs: Any, params: Any, grid) -> Any:
    """ZeRO-1 moment placement: params' sharding plus the "data" axis on
    the largest still-unsharded divisible dim (optimizer state is never
    needed unsharded, so moments can always be FSDP'd even when params
    are kept gathered for compute)."""
    dsize = grid.axis_size("data")

    def rule(spec, leaf):
        shape = tuple(leaf.shape)
        spec = list(spec) + [None] * (len(shape) - len(spec))
        used = {a for s in spec if s is not None
                for a in ((s,) if isinstance(s, str) else s)}
        if "data" not in used:
            free = [d for d in range(len(shape)) if spec[d] is None
                    and _divides(shape[d], dsize)]
            if free:
                spec[max(free, key=lambda d: shape[d])] = "data"
        return tuple(spec)

    def zip_map(specs, leaves):
        if isinstance(specs, dict):
            return {k: zip_map(specs[k], leaves[k]) for k in specs}
        if isinstance(specs, list):
            return [zip_map(a, b) for a, b in zip(specs, leaves)]
        return rule(specs, leaves)

    return zip_map(p_specs, params)


# ---- placing a model for tensor-parallel serving ---------------------------

def lm_param_specs(model, cfg, grid) -> dict:
    """{parameter name of `model`: its spec} by
    ``param_sharding_rules(fsdp_params=False)`` on the reference's leaves
    at `cfg`'s whole shapes; a stacked leaf's spec is each layer's with
    its layer dim dropped (no rule puts "model" there)."""
    from repro_torch import convert
    from repro_torch.models import init_params
    shapes = dict(init_params(cfg, device="meta").named_parameters())
    names = [n for n, _ in model.named_parameters()]
    if set(names) != set(shapes):
        raise ValueError(f"{cfg.name}: the model's parameters are not "
                         f"the config's")
    flat = convert.lm_stack({n: shapes[n] for n in names}, cfg)
    specs = param_sharding_rules(flat, grid, fsdp_params=False)
    out = {}
    for ref, owner in convert.lm_leaves(names, cfg).items():
        spec = specs[ref]
        if isinstance(owner, list):
            if spec[0] is not None:
                raise ValueError(f"{ref}: {spec} splits the layer dim")
            out.update({n: spec[1:] for n in owner})
        else:
            out[owner] = spec
    return out


def _chunk(t: torch.Tensor, dim: int, grid) -> torch.Tensor:
    n = t.shape[dim] // grid.model
    return t.narrow(dim, grid.model_rank * n, n)


def _place(model, name: str, value: torch.Tensor, dim) -> None:
    """Parameter `name` of `model` replaced by `value`, marked as held
    split along `dim` (or whole)."""
    owner, _, leaf = name.rpartition(".")
    param = torch.nn.Parameter(value)
    param.model_dim = dim
    setattr(model.get_submodule(owner) if owner else model, leaf, param)


def shard_lm(model, cfg, grid):
    """`model` placed on this rank of `grid` for tensor-parallel serving
    (``jax.device_put(params, param_sharding_rules(params, mesh,
    fsdp_params=False))`` in the reference): every leaf the rules split
    over "model" is cut to this rank's contiguous chunk (a copy, so the
    whole leaf is freed) and marked; the others stay whole. In place;
    returns `model`. With a model size of 1 nothing changes."""
    if grid.model == 1:
        return model
    specs = lm_param_specs(model, cfg, grid)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            spec = specs[name]
            dim = spec.index("model") if "model" in spec else None
            value = p.detach() if dim is None \
                else _chunk(p.detach(), dim, grid).clone()
            _place(model, name, value, dim)
    return model


def load_lm_shard(tree: dict, cfg, grid, device=None):
    """This rank's shard of the JAX package's parameter tree `tree` (numpy
    arrays in any of its layouts) on `device` (default the grid's): the
    model is loaded and cut on the host (``convert.lm_params_from_numpy``,
    :func:`shard_lm`), and only the shard goes to the device."""
    from repro_torch import convert
    from repro_torch.core.context import resolve_device
    from repro_torch.models.layers import held_dim
    dev = resolve_device(device if device is not None else grid.device)
    model = shard_lm(convert.lm_params_from_numpy(tree, cfg, "cpu"), cfg,
                     grid)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            _place(model, name, p.detach().to(dev), held_dim(p))
    return model
