"""The paper's Fig. 2 two-region HE Mul over a batch, as one step.

This is `core.heaan.he_mul` restructured for a batch of ciphertext pairs
(the unit a serving system schedules), the one-device counterpart of the
JAX package's ``dist/he_pipeline.py``:

  - operands are (B, N, qlimbs) limb batches, outputs likewise;
  - every table is passed as an argument (dicts of tensors from
    :func:`runtime_tables`), so one step serves any batch;
  - the strategy keywords select the paper's optimization ladder per stage
    (CRT strategy, iCRT strategy, modified Shoup), with the reference's
    names and defaults; ``use_kernels=True`` routes CRT, NTT, iNTT, iCRT
    and the Montgomery product through the CUDA kernels
    (:mod:`repro_torch.kernels`), whose CRT strategies are acc3, mod2 and
    mod4 and whose transforms honour ``modified_shoup``.

Bitwise contract: the step runs the same stages as `core.heaan.he_mul` in
the same order, and every stage is exact, so each output equals he_mul on
that pair bit for bit, whatever the strategies.

The batched stage wrappers are factored into a :class:`StageFns` bundle
(:func:`make_stage_fns`) plus a region-2 key-switch factory
(:func:`make_keyswitch_step`), as in the reference, so that rotations and
serving can reuse them.

Across ranks: with ``grid=`` a :class:`~repro_torch.launch.mesh.HostGrid`
whose model axis has g > 1 ranks, the step is one rank's SPMD program, as
the reference's is under GSPMD with np on "model" and the batch on "data":

  - it takes and returns this rank's batch rows (``he_limb_sharding``;
    :func:`scatter_batch` / :func:`gather_batch` move a whole batch, booked
    in the grid's feed log) and this rank's prime rows of every table
    (:func:`shard_tables`; ``dist.sharding.he_eval_sharding``);
  - every stage before iCRT (CRT, NTT, the Montgomery and Shoup products,
    iNTT) runs on the rank's primes through the same kernels; an empty
    shard skips them without a launch;
  - ``from_eval`` runs ``icrt_partial`` on the folded batch, then ONE
    all-reduce each of ``lo``, ``hi`` and ``qsum`` over the model group
    (three per reduction, as ``he_expected_collectives`` counts), then
    ``icrt_finish``; the glue after iCRT runs on every model rank on the
    same words (replicated, as under GSPMD). With ``reduce_scatter_icrt``
    ``lo``/``hi`` are reduce-scattered over their column axis and
    all-gathered before the finish (``qsum`` all-reduced): the same words.
  - Only iCRT "matmul" at β = 2^32 is additive in that form: across ranks
    ``acc3``/``naive`` and β = 2^64 raise ValueError (ROADMAP A7c).

The words equal the one-rank step's bit for bit. With no grid, or a grid
of model size 1, the code path is the one-device step's exactly.

Differences from the reference:

  - :func:`make_stage_fns` and :func:`make_he_mul_step` take a ``device``
    (default ``"cuda"``, through ``resolve_device``) and an optional
    ``grid`` in place of ``mesh``; the step refuses operands elsewhere;
    make_stage_fns needs no HEStatic. The ``ev``/``out``/``limbs``
    placements are dropped: under GSPMD they are
    ``with_sharding_constraint`` hints, here the rank's rows are what it
    is given. :func:`he_table_specs` and :func:`he_input_specs` give meta
    tensors in place of ``ShapeDtypeStruct``s.
  - ``stage_timer`` (a :class:`repro_torch.obs.StageTimer`) times each
    stage call eagerly, as the reference's does, with no per-stage jit
    blocks: PyTorch issues every stage as it comes.
  - No ``quot_fix`` in :func:`region_tables`: the port's iCRT kernel takes
    its quotient from f64 (``p_inv_f64``); ``quot_fix`` is the TPU
    kernel's fixed-point stand-in. :class:`HEStatic` holds no iCRT tables:
    the accumulator width is read from the region table's ``P_limbs``.
  - With kernels, ``_icrt_b`` launches the iCRT kernel on the (np, B·N)
    fold; that launch includes ``finalize_accum``, which the reference
    calls after ``icrt_accum_pallas``. Across ranks the split kernels
    (``icrt_partial_op``, ``icrt_finish_op``) take its place.
  - Twiddles by row index: with kernels, ``_ntt_b``/``_intt_b`` hand the
    kernel (B·np, N) rows and the (np, N) tables, and row r takes twiddle
    row r mod np, where the reference tiles the tables B times.
    ``_mont_mul_b`` hands the kernel (B·np, N) rows with the three
    per-prime constants repeated B times, where the reference folds the
    batch into the coefficient axis. The products are the same.
  - Plain paths: ``vmap`` becomes a batch dimension (NTT, iNTT, the
    pointwise products) or a Python loop over B (iCRT).
  - :attr:`HEStatic.dtype` is the torch type of a stored word
    (``torch.int32`` at β = 2^32, ``torch.int64`` at β = 2^64) where the
    reference's is ``np.uint32``/``np.uint64``. At β = 2^64 the step runs
    the plain path; ``use_kernels=True`` raises, as the reference's
    assert does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import bigint
from repro_torch.core.cipher import EvalKey
from repro_torch.core.context import (
    HEContext, build_icrt_tables, resolve_device,
)
from repro_torch.core.crt import crt, icrt, icrt_finish, icrt_partial
from repro_torch.core.ntt import intt, ntt, pointwise_shoup_scale
from repro_torch.core.params import HEParams
from repro_torch.core.rns import kernels_on
from repro_torch.core.wordops import (
    modadd, modsub, mont_modmul, narrow, wide, word_bits,
)
from repro_torch.kernels.crt.ops import crt_op
from repro_torch.dist import comm
from repro_torch.dist.sharding import he_eval_sharding, he_limb_sharding
from repro_torch.kernels.icrt.ops import (
    icrt_finish_op, icrt_op, icrt_partial_op,
)
from repro_torch.kernels.modmul.ops import pointwise_mont_op
from repro_torch.kernels.ntt.ops import intt_op, ntt_op

__all__ = [
    "HEStatic", "he_static", "region_tables", "evk_tables",
    "runtime_tables", "shard_tables", "scatter_batch", "gather_batch",
    "he_table_specs", "he_input_specs", "StageFns", "make_stage_fns",
    "check_operands", "check_grid", "make_keyswitch_step",
    "make_he_mul_step",
]

# Keys of a region-table dict, in the order region_tables emits them (the
# reference's, without quot_fix).
REGION_TABLE_KEYS = (
    "primes", "psi_rev", "psi_rev_shoup", "ipsi_rev", "ipsi_rev_shoup",
    "n_inv", "n_inv_shoup", "pprime", "r2", "crt_tb", "crt_tb_shoup",
    "inv_P", "inv_P_shoup", "pdivp", "P_limbs", "P_half_limbs", "p_inv_f64",
)

EVK_TABLE_KEYS = ("ax_ev", "ax_ev_shoup", "bx_ev", "bx_ev_shoup")

# CRT strategies the kernel has; the others run as acc3 on the kernel path,
# as the reference's _crt_b does
_KERNEL_CRT = ("acc3", "mod2", "mod4")

# Entries of a region table with one row per prime (a shard holds its
# rows); P_limbs and P_half_limbs belong to the whole product P.
PRIME_ROW_KEYS = tuple(k for k in REGION_TABLE_KEYS
                       if k not in ("P_limbs", "P_half_limbs"))

# the ROADMAP item of what does not run across ranks yet
_GRID_TODO = ("across ranks only iCRT \"matmul\" at β = 2^32 is additive "
              "in the split form; {what} is ROADMAP A7c")


@dataclasses.dataclass(frozen=True)
class HEStatic:
    """Everything shape-static about one HE-Mul level: prime counts and
    limb widths."""

    params: HEParams
    logq: int
    qlimbs: int
    np1: int
    np2: int
    np2_max: int          # rows of the stored evk (region 2 at logQ)
    ks_limbs: int         # key-switch product width before ÷Q

    @property
    def N(self) -> int:
        return self.params.N

    @property
    def dtype(self) -> torch.dtype:
        """The stored word: int32 bit patterns at β = 2^32, int64 at 2^64."""
        return torch.int32 if self.params.beta_bits == 32 else torch.int64


def he_static(params: HEParams, logq: int) -> HEStatic:
    """Static shape metadata for an HE Mul at modulus 2^logq."""
    return HEStatic(
        params=params,
        logq=logq,
        qlimbs=params.qlimbs(logq),
        np1=params.np_region1(logq),
        np2=params.np_region2(logq),
        np2_max=params.np_region2(params.logQ),
        ks_limbs=params.limbs_for_bits(logq + params.logQ) + 1,
    )


# --------------------------------------------------------------------------
# table dicts
# --------------------------------------------------------------------------

def region_tables(ctx: HEContext, region: int) -> Dict[str, torch.Tensor]:
    """All tables one region's CRT→NTT→iNTT→iCRT chain consumes, as a flat
    dict of contiguous tensors on ``ctx.device``."""
    if region not in (1, 2):
        raise ValueError(f"region must be 1 or 2, got {region}")
    g = ctx.tables
    npn = ctx.np1 if region == 1 else ctx.np2
    tabs = ctx.icrt1 if region == 1 else ctx.icrt2
    K = ctx.qlimbs
    return {
        "primes": g.primes[:npn],
        "psi_rev": g.psi_rev[:npn],
        "psi_rev_shoup": g.psi_rev_shoup[:npn],
        "ipsi_rev": g.ipsi_rev[:npn],
        "ipsi_rev_shoup": g.ipsi_rev_shoup[:npn],
        "n_inv": g.n_inv[:npn],
        "n_inv_shoup": g.n_inv_shoup[:npn],
        "pprime": g.pprime[:npn],
        "r2": g.r2[:npn],
        # the CRT fold reads β^k for k < 3, so a level of fewer than 3
        # limbs still takes 3 columns (as rns.to_eval does)
        "crt_tb": g.crt_tb[:npn, :max(K, 3)].contiguous(),
        "crt_tb_shoup": g.crt_tb_shoup[:npn, :max(K, 3)].contiguous(),
        "inv_P": tabs.inv_P,
        "inv_P_shoup": tabs.inv_P_shoup,
        "pdivp": tabs.pdivp,
        "P_limbs": tabs.P_limbs,
        "P_half_limbs": tabs.P_half_limbs,
        "p_inv_f64": g.p_inv_f64[:npn],
    }


def evk_tables(evk: EvalKey) -> Dict[str, torch.Tensor]:
    """The evaluation key as a flat dict (already eval-domain + Shoup; the
    step slices rows [:np2] for the current level)."""
    return {k: getattr(evk, k) for k in EVK_TABLE_KEYS}


def runtime_tables(ctx: HEContext, evk: EvalKey) -> Tuple[Dict, Dict, Dict]:
    """(t1, t2, ek) dicts for running the step, all on ``ctx.device``."""
    ek = {k: v.to(ctx.device) for k, v in evk_tables(evk).items()}
    return region_tables(ctx, 1), region_tables(ctx, 2), ek


def aligned(v: torch.Tensor) -> torch.Tensor:
    """`v` contiguous and 16-byte aligned, as the kernels take their
    operands: a view that starts inside a row of a per-prime vector (or of
    pdivp) is copied; the (rows, N) twiddle tables are not (a row of N
    words starts 16-byte aligned)."""
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _shard_region(t: Dict, rows: slice) -> Dict[str, torch.Tensor]:
    """A region table cut to the prime rows `rows` (P_limbs and
    P_half_limbs whole)."""
    return {k: aligned(v[rows]) if k in PRIME_ROW_KEYS else v
            for k, v in t.items()}


def shard_tables(t1: Dict, t2: Dict, ek: Optional[Dict], grid,
                 params: Optional[HEParams] = None) -> Tuple:
    """This rank's prime rows of (t1, t2, ek), a level's region tables and
    a key: the GSPMD split of ``dist.sharding.he_eval_sharding``, with
    np_max the region's np at logQ (from `params`; without it the tables'
    own np, right at logQ) and the key's own rows. Any split gives the
    same words; this one matches the reference's layout and the
    TableCache's. `ek` may be None."""
    np1, np2 = t1["primes"].shape[0], t2["primes"].shape[0]
    np1_max = params.np_region1(params.logQ) if params else np1
    np2_max = params.np_region2(params.logQ) if params else (
        ek["ax_ev"].shape[0] if ek else np2)
    s1 = _shard_region(t1, he_eval_sharding(grid, np1_max, np1))
    s2 = _shard_region(t2, he_eval_sharding(grid, np2_max, np2))
    if ek is not None:
        rows = he_eval_sharding(grid, ek["ax_ev"].shape[0])
        ek = {k: aligned(v[rows]) for k, v in ek.items()}
    return s1, s2, ek


def scatter_batch(grid, *xs: torch.Tensor) -> list:
    """This rank's rows (``he_limb_sharding``) of each full (B, N, qlimbs)
    batch that rank 0 of its data column holds: the batch is broadcast
    over the data axis, booked in the grid's feed log."""
    out = []
    for x in xs:
        x = comm.broadcast(grid, x.contiguous(), axis="data", book="feed")
        out.append(x[he_limb_sharding(grid, x.shape[0])].contiguous())
    return out


def gather_batch(grid, *xs: torch.Tensor, batch: int) -> list:
    """The full (batch, …) tensors from every data rank's rows of each (the
    inverse of :func:`scatter_batch`; booked in the feed log). Rows that
    were replicated (a batch that does not divide) come back as they
    are."""
    if batch % grid.data:
        return list(xs)
    return [comm.all_gather(grid, x.contiguous(), axis="data", book="feed")
            for x in xs]


def _region_spec(st: HEStatic, npn: int) -> Dict[str, torch.Tensor]:
    dt = st.dtype
    N = st.N
    tabs = build_icrt_tables(st.params, npn)

    def meta(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {
        "primes": meta((npn,)),
        "psi_rev": meta((npn, N)),
        "psi_rev_shoup": meta((npn, N)),
        "ipsi_rev": meta((npn, N)),
        "ipsi_rev_shoup": meta((npn, N)),
        "n_inv": meta((npn,)),
        "n_inv_shoup": meta((npn,)),
        "pprime": meta((npn,)),
        "r2": meta((npn,)),
        "crt_tb": meta((npn, st.qlimbs)),
        "crt_tb_shoup": meta((npn, st.qlimbs)),
        "inv_P": meta((npn,)),
        "inv_P_shoup": meta((npn,)),
        "pdivp": meta((npn, tabs.plimbs)),
        "P_limbs": meta((tabs.accum_limbs,)),
        "P_half_limbs": meta((tabs.accum_limbs,)),
        "p_inv_f64": meta((npn,), torch.float64),
    }


def he_table_specs(st: HEStatic) -> Tuple[Dict, Dict, Dict]:
    """(t1, t2, ek) as meta tensors: the reference's abstract table
    pytrees, shape for shape (the reference's ``crt_tb`` width, K; the
    port's :func:`region_tables` keeps max(K, 3) columns for CRT's fold),
    without ``quot_fix``."""
    t1 = _region_spec(st, st.np1)
    t2 = _region_spec(st, st.np2)
    ek = {k: torch.empty((st.np2_max, st.N), dtype=st.dtype, device="meta")
          for k in EVK_TABLE_KEYS}
    return t1, t2, ek


def he_input_specs(st: HEStatic, batch: int) -> Tuple:
    """(ax1, bx1, ax2, bx2) ciphertext-batch operands as meta tensors."""
    return tuple(torch.empty((batch, st.N, st.qlimbs), dtype=st.dtype,
                             device="meta") for _ in range(4))


# --------------------------------------------------------------------------
# batched stage wrappers (value-identical to the per-item core stages)
# --------------------------------------------------------------------------
#
# Kernel routing puts the batch where the kernel has independent rows:
# CRT/iCRT are per coefficient (the batch folds into N), NTT/iNTT and the
# Montgomery product are per row (the batch stacks the rows, the kernel
# reads the prime of row r from r mod np).

def _fold_np(x: torch.Tensor) -> torch.Tensor:
    """(B, np, N) -> (np, B·N): concatenate the batch into the coefficient
    axis (legal wherever the op is per-coefficient)."""
    B, npn, N = x.shape
    return x.transpose(0, 1).reshape(npn, B * N)


def _unfold_np(x: torch.Tensor, B: int) -> torch.Tensor:
    """(np, B·N) -> contiguous (B, np, N)."""
    return x.reshape(x.shape[0], B, -1).transpose(0, 1).contiguous()


def _crt_b(x: torch.Tensor, t: Dict, strategy: str,
           use_kernels: bool = False) -> torch.Tensor:
    """(B, N, K) limbs -> (B, np, N) residues. CRT rows are independent
    per coefficient, so batching folds into the row dimension exactly."""
    B, N, K = x.shape
    args = (x.reshape(B * N, K), t["crt_tb"], t["crt_tb_shoup"], t["primes"])
    if use_kernels:
        res = crt_op(*args, strategy=strategy if strategy in _KERNEL_CRT
                     else "acc3")
    else:
        res = crt(*args, strategy=strategy)
    return _unfold_np(res, B)


def _ntt_b(r: torch.Tensor, t: Dict, modified: bool,
           use_kernels: bool = False) -> torch.Tensor:
    tw = (t["psi_rev"], t["psi_rev_shoup"], t["primes"])
    if use_kernels:
        B, npn, N = r.shape
        return ntt_op(r.reshape(B * npn, N), *tw,
                      modified=modified).reshape(B, npn, N)
    return ntt(r, *tw, modified=modified)


def _intt_b(r: torch.Tensor, t: Dict, modified: bool,
            use_kernels: bool = False) -> torch.Tensor:
    tw = (t["ipsi_rev"], t["ipsi_rev_shoup"], t["n_inv"], t["n_inv_shoup"],
          t["primes"])
    if use_kernels:
        B, npn, N = r.shape
        return intt_op(r.reshape(B * npn, N), *tw,
                       modified=modified).reshape(B, npn, N)
    return intt(r, *tw, modified=modified)


def _icrt_b(r: torch.Tensor, t: Dict, out_limbs: int, strategy: str,
            use_kernels: bool = False) -> torch.Tensor:
    """(B, np, N) residues -> (B, N, out_limbs) centered limbs."""
    B = r.shape[0]
    if use_kernels:
        return icrt_op(_fold_np(r), t, out_limbs).reshape(
            B, -1, out_limbs)
    return torch.stack([icrt(
        rr, t["primes"], t["inv_P"], t["inv_P_shoup"], t["pdivp"],
        t["P_limbs"], t["P_half_limbs"], t["p_inv_f64"], out_limbs,
        strategy=strategy) for rr in r])


def _mont_mul_b(a: torch.Tensor, b: torch.Tensor, t: Dict,
                use_kernels: bool = False) -> torch.Tensor:
    consts = [t[k] for k in ("primes", "pprime", "r2")]
    if use_kernels:
        B, npn, N = a.shape
        return pointwise_mont_op(
            a.reshape(B * npn, N), b.reshape(B * npn, N),
            *[c.repeat(B) for c in consts]).reshape(B, npn, N)
    bits = word_bits(a)
    return narrow(mont_modmul(wide(a), wide(b),
                              *[wide(c)[:, None] for c in consts], bits),
                  bits)


# --------------------------------------------------------------------------
# stage bundles and the steps built from them
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageFns:
    """Batched stage bundle for one parameter level on one device.

    `to_eval`/`from_eval` are the paper's CRT→NTT and iNTT→iCRT chains
    over (B, ·, ·) batches; `mont_mul` is the region-1 pointwise product,
    `shoup_mul` the region-2 product against a key; `timer` the Fig. 3
    StageTimer the stages book into (None when not profiling).
    """

    to_eval: Callable[[torch.Tensor, Dict], torch.Tensor]
    from_eval: Callable[[torch.Tensor, Dict, int], torch.Tensor]
    mont_mul: Callable[[torch.Tensor, torch.Tensor, Dict], torch.Tensor]
    shoup_mul: Callable[..., torch.Tensor]
    device: torch.device
    timer: Optional[object] = None
    grid: Optional[object] = None     # a HostGrid of model size > 1


def make_stage_fns(device: str | torch.device = "cuda", *,
                   grid=None,
                   crt_strategy: str = "matmul",
                   icrt_strategy: str = "matmul",
                   modified_shoup: bool = False,
                   reduce_scatter_icrt: bool = False,
                   use_kernels: bool = False,
                   stage_timer=None) -> StageFns:
    """Bind the strategy knobs into a reusable stage bundle on `device`.

    `use_kernels` routes CRT/NTT/iNTT/iCRT/pointwise through the CUDA
    kernels (their plain versions for CPU tensors).

    `grid` (a HostGrid on `device`) of model size g > 1 makes the bundle
    one rank's part: the stages take the rank's prime rows, and iCRT sums
    its partial sums across the model group (see the module docstring);
    `reduce_scatter_icrt` moves lo/hi as reduce-scatter + all-gather. With
    no grid, or g = 1, both are ignored and the bundle is the one-device
    one.

    `stage_timer` (a `repro_torch.obs.StageTimer`) fences and clocks
    every stage call in the paper's Fig. 3 taxonomy — crt, ntt (forward
    and inverse), modmul (Montgomery and Shoup pointwise), icrt. The
    stages compute the same words either way."""
    dev = resolve_device(device)
    if stage_timer is None:
        def timed(stage, thunk):
            return thunk()
    else:
        timed = stage_timer.timed
    if grid is not None and grid.model > 1:
        if grid.device != dev:
            raise ValueError(f"grid rank on {grid.device}, stages on {dev}")
        if icrt_strategy != "matmul":
            raise ValueError(_GRID_TODO.format(
                what=f"iCRT {icrt_strategy!r}"))
    else:
        grid = None

    # On a grid the tables `t` a stage is given are the rank's prime rows,
    # possibly none: an empty shard launches nothing and still joins iCRT's
    # all-reduces. One device never sees an empty table.

    def to_eval(x, t):
        if not t["primes"].numel():
            return x.new_empty((x.shape[0], 0, x.shape[1]))
        r = timed("crt", lambda: _crt_b(x, t, crt_strategy, use_kernels))
        return timed("ntt", lambda: _ntt_b(r, t, modified_shoup,
                                           use_kernels))

    def icrt_across(r, t, out_limbs):
        if word_bits(r) != 32:
            raise ValueError(_GRID_TODO.format(what="β = 2^64"))
        B, _, N = r.shape
        f = _fold_np(r)
        if use_kernels:
            lo, hi, qsum = icrt_partial_op(f, t)
        else:
            lo, hi, qsum = icrt_partial(f, t["primes"], t["inv_P"],
                                        t["inv_P_shoup"], t["pdivp"],
                                        t["p_inv_f64"])
        if reduce_scatter_icrt:
            lo, hi = _rs_ag(grid, lo), _rs_ag(grid, hi)
        else:
            comm.all_reduce(grid, lo)
            comm.all_reduce(grid, hi)
        comm.all_reduce(grid, qsum)
        if use_kernels:
            out = icrt_finish_op(lo, hi, qsum, t, out_limbs)
        else:
            out = icrt_finish(lo, hi, qsum, t["P_limbs"],
                              t["P_half_limbs"], out_limbs)
        return out.reshape(B, N, out_limbs)

    def from_eval(e, t, out_limbs):
        # iNTT books under "ntt": Fig. 3 plots one transform bucket
        if e.shape[1]:
            e = timed("ntt", lambda: _intt_b(e, t, modified_shoup,
                                             use_kernels))
        if grid is not None:
            return timed("icrt", lambda: icrt_across(e, t, out_limbs))
        return timed("icrt", lambda: _icrt_b(e, t, out_limbs, icrt_strategy,
                                             use_kernels))

    def mont_mul(a, b, t):
        if not a.shape[1]:
            return a
        return timed("modmul", lambda: _mont_mul_b(a, b, t, use_kernels))

    def shoup_mul(e, w, w_shoup, primes):
        if not e.shape[1]:
            return e
        return timed("modmul", lambda: pointwise_shoup_scale(
            e, w, w_shoup, primes, modified=modified_shoup))

    return StageFns(to_eval=to_eval, from_eval=from_eval, mont_mul=mont_mul,
                    shoup_mul=shoup_mul, device=dev, timer=stage_timer,
                    grid=grid)


def _rs_ag(grid, x: torch.Tensor) -> torch.Tensor:
    """(BN, PL) summed over the model group as a reduce-scatter of its
    column axis (padded to a multiple of g) and an all-gather."""
    g = grid.model
    cols = x.t().contiguous()
    PL = cols.shape[0]
    pad = -(-PL // g) * g - PL
    if pad:
        cols = torch.cat([cols, cols.new_zeros((pad, cols.shape[1]))])
    part = comm.reduce_scatter(grid, cols)
    return comm.all_gather(grid, part)[:PL].t().contiguous()


def _region(sf: StageFns, name: str):
    """Fig. 2 region scope when the bundle carries a StageTimer; free
    (nullcontext) otherwise."""
    return sf.timer.region(name) if sf.timer is not None \
        else contextlib.nullcontext()


def check_operands(st: HEStatic, device: torch.device,
                   *xs: torch.Tensor) -> None:
    """Refuse a step's operands unless each is (B, N, qlimbs) of
    ``st.dtype`` on `device`."""
    for x in xs:
        if (x.device != device or x.shape[1:] != (st.N, st.qlimbs)
                or x.dtype != st.dtype):
            raise ValueError(
                f"operands must be (B, {st.N}, {st.qlimbs}) {st.dtype} on "
                f"{device}; got {tuple(x.shape)} {x.dtype} on {x.device}")


def make_keyswitch_step(st: HEStatic, sf: StageFns):
    """Region-2 key switch: ks(t2, ek, d) -> (ks_ax, ks_bx) at qlimbs.

    The shared tail of HE Mul (d = d2) and every Galois operation
    (d = σ_k(ax)) — paper Fig. 2's region 2: CRT→NTT at np₂ primes,
    two Shoup pointwise products against the (rotation/evaluation) key,
    iNTT→iCRT at ks_limbs, then the ÷Q rounding shift.
    """
    ks_limbs = st.ks_limbs
    logQ, qlimbs = st.params.logQ, st.qlimbs

    def ks(t2, ek, d):
        with _region(sf, "region2"):
            e2 = sf.to_eval(d, t2)
            p2 = t2["primes"]
            # the key's rows of this level's primes: [:np2], or across
            # ranks the first of the rank's rows that the level keeps
            n2 = p2.shape[0]
            out = []
            for key in ("ax_ev", "bx_ev"):
                prod = sf.shoup_mul(e2, ek[key][:n2],
                                    ek[key + "_shoup"][:n2], p2)
                out.append(bigint.shift_right_round(
                    sf.from_eval(prod, t2, ks_limbs), logQ,
                    out_limbs=qlimbs))
        return out[0], out[1]

    return ks


def check_grid(st: HEStatic, grid) -> None:
    """Refuse a word mode that does not run across ranks yet."""
    if grid is not None and grid.model > 1 and st.params.beta_bits != 32:
        raise ValueError(_GRID_TODO.format(what="β = 2^64"))


def make_he_mul_step(st: HEStatic, device: str | torch.device = "cuda", *,
                     grid=None,
                     crt_strategy: str = "matmul",
                     icrt_strategy: str = "matmul",
                     modified_shoup: bool = False,
                     reduce_scatter_icrt: bool = False,
                     use_kernels: bool = False,
                     stage_timer=None):
    """Build step(t1, t2, ek, ax1, bx1, ax2, bx2) -> (ax3, bx3).

    Operands are contiguous (B, N, qlimbs) limb batches on `device`;
    outputs likewise. The strategy knobs select the paper's optimization
    ladder per stage; `use_kernels` routes every stage through the CUDA
    kernels, keeping the bitwise contract (β = 2^32 only: at β = 2^64 it
    raises ValueError); `stage_timer` books each stage and both regions
    into a StageTimer (same words).

    With `grid` of model size g > 1 the step is this rank's part: it takes
    the rank's batch rows and the rank's rows of the tables
    (:func:`shard_tables`), and gives the rank's rows of the result, equal
    to the one-rank step's bit for bit; `reduce_scatter_icrt` as in
    :func:`make_stage_fns`.
    """
    kernels_on(use_kernels, st.params)
    check_grid(st, grid)
    logq, qlimbs = st.logq, st.qlimbs
    bits = st.params.beta_bits
    sf = make_stage_fns(device, grid=grid, crt_strategy=crt_strategy,
                        icrt_strategy=icrt_strategy,
                        modified_shoup=modified_shoup,
                        reduce_scatter_icrt=reduce_scatter_icrt,
                        use_kernels=use_kernels, stage_timer=stage_timer)
    keyswitch = make_keyswitch_step(st, sf)

    def step(t1, t2, ek, ax1, bx1, ax2, bx2):
        check_operands(st, sf.device, ax1, bx1, ax2, bx2)
        p1 = wide(t1["primes"])[:, None]
        # ---- region 1: 4×(CRT→NTT), 3 pointwise, 3×(iNTT→iCRT) ----------
        with _region(sf, "region1"):
            ea1 = sf.to_eval(ax1, t1)
            eb1 = sf.to_eval(bx1, t1)
            ea2 = sf.to_eval(ax2, t1)
            eb2 = sf.to_eval(bx2, t1)

            d0_ev = sf.mont_mul(eb1, eb2, t1)
            d2_ev = sf.mont_mul(ea1, ea2, t1)
            d1_ev = sf.mont_mul(
                narrow(modadd(wide(ea1), wide(eb1), p1), bits),
                narrow(modadd(wide(ea2), wide(eb2), p1), bits), t1)
            d1_ev = narrow(modsub(modsub(wide(d1_ev), wide(d0_ev), p1),
                                  wide(d2_ev), p1), bits)

            d0 = sf.from_eval(d0_ev, t1, qlimbs)
            d1 = sf.from_eval(d1_ev, t1, qlimbs)
            d2 = bigint.mask_bits(sf.from_eval(d2_ev, t1, qlimbs), logq)

        # ---- region 2: key switching against the evk --------------------
        ks_ax, ks_bx = keyswitch(t2, ek, d2)

        # ---- combine ----------------------------------------------------
        ax3 = bigint.mask_bits(bigint.add(d1, ks_ax), logq)
        bx3 = bigint.mask_bits(bigint.add(d0, ks_bx), logq)
        return ax3, bx3

    return step
