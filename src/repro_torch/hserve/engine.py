"""The batched per-op steps: every ciphertext op a served circuit uses.

One step per op and level, each built from
:mod:`repro_torch.dist.he_pipeline`'s stage bundle (``make_stage_fns``)
and, where the op key-switches, its region-2 chain
(``make_keyswitch_step``), so every op runs the same stages on (B, ·, ·)
batches:

  - ``rotate``    — σ_{5^r} as one indexed assignment along the
    coefficient axis of the (B, N, qlimbs) batch, then the region-2 key
    switch HE Mul uses (paper Fig. 2).
  - ``conjugate`` — σ₋₁ (k = 2N−1) through the same step with the
    conjugation key; the automorphism index is the only difference.
  - ``slot_sum``  — the log₂(n)-rotation all-slots sum: each round
    rotates by doubling powers and adds in place.
  - ``rescale`` / ``mod_down`` / ``mod_raise`` — the §III-A level ops.
    q is a power of two, so each is limb arithmetic over the limb axis
    (no NTT, no key switch), the core functions themselves
    (`rescale_poly`, `mod_down_poly`, `mod_raise_poly`: leading batch
    axes pass through).
  - ``add`` / ``sub`` — §III-B limb adds with mod-q masking.
  - ``mul_plain`` / ``add_plain`` — the plaintext-operand ops: the
    operand is an encoded polynomial riding the batch, so mul_plain is
    Fig. 2's region 1 alone (CRT→NTT, one pointwise product per
    component, iNTT→iCRT) and add_plain a limb add into bx.

Every step equals its single-ciphertext counterpart in
:mod:`repro_torch.core.heaan` / :mod:`repro_torch.core.rotate` on each
item, bit for bit: the stages are the same and exact.

:class:`OpEngine` executes assembled batches (:mod:`.queue`) through
those steps: one step per (op, level, extra), tables from the level-aware
:class:`~repro_torch.hserve.tables.TableCache`, and asynchronous
``dispatch``/``wait`` for double buffering: dispatch issues a step and
records a CUDA event behind it; wait synchronizes that event.

This is the JAX package's ``hserve/engine.py``. Each ``make_*_step``
takes ``(st, device, **knobs)`` where the reference takes
``(st, mesh, **knobs)``, as ``make_he_mul_step`` does; knobs are
``make_stage_fns``'s (``use_kernels``, ``crt_strategy``, …,
``stage_timer``). The reference's ``_glue_jit`` and ``sf.out`` placements
carry no arithmetic and are dropped, and so is its jit: PyTorch issues
every step eagerly, so ``profile_stages`` changes only the StageTimer
threaded through the knobs. Operands are (B, N, qlimbs) at the step's
level on its device; a step refuses others.

Across ranks, as the reference's steps take the mesh: the knob ``grid``
(a HostGrid of model size > 1) makes each stage step one rank's part —
rotate, conjugate, slot_sum and mul_plain run the sharded stages on the
rank's prime rows of the tables and keys, with iCRT's partial sums
all-reduced over the model group (``dist.he_pipeline``); the limb steps
(rescale, mod_down, mod_raise, add/sub, add_plain) run on the rank's
batch rows with no collective. ``OpEngine(grid=)`` threads it through
every step; its table cache then holds the rank's rows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import bigint
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.context import resolve_device
from repro_torch.core.heaan import mod_down_poly, mod_raise_poly, rescale_poly
from repro_torch.core.params import HEParams
from repro_torch.core.rotate import (
    automorphism_poly, conjugation_k, rotation_k,
)
from repro_torch.dist.he_pipeline import (
    HEStatic, check_operands, he_static, make_he_mul_step,
    make_keyswitch_step, make_stage_fns,
)
from repro_torch.obs.stages import StageTimer
from repro_torch.obs.trace import device_range

if TYPE_CHECKING:
    from repro_torch.hserve.queue import Batch
    from repro_torch.hserve.tables import TableCache

__all__ = ["STAGE_OPS", "slot_sum_rotations", "make_he_rotate_step",
           "make_slot_sum_step", "make_rescale_step", "make_mod_down_step",
           "make_mod_raise_step", "make_addsub_step", "make_mul_plain_step",
           "make_add_plain_step", "Inflight", "OpEngine"]


# Ops whose steps run the Fig. 3 stage chain (CRT/NTT/modmul/iCRT); the
# rest are limb shifts, slices and adds.
STAGE_OPS = frozenset(
    {"mul", "rotate", "conjugate", "slot_sum", "mul_plain"})


def slot_sum_rotations(n_slots: int) -> Tuple[int, ...]:
    """Doubling rotation amounts (1, 2, 4, …) that sum n_slots slots."""
    out, r = [], 1
    while r < n_slots:
        out.append(r)
        r *= 2
    return tuple(out)


def _make_automorphism_b(st: HEStatic, k: int) -> Callable:
    """Batched σ_k on (B, N, qlimbs) mod-q limb polynomials: exactly
    core.rotate.automorphism_poly, which indexes the coefficient axis of
    the whole batch at once."""
    params, logq = st.params, st.logq

    def auto_b(x: torch.Tensor) -> torch.Tensor:
        return automorphism_poly(x, params, k, logq)

    return auto_b


def _galois_b(st: HEStatic, sf, keyswitch, auto_b, t2, rk, ax, bx):
    """One Galois operation on a batch: σ_k, then the key switch against
    rk (core.rotate._apply_galois); bx's combine is sf.add_mask."""
    ks_ax, ks_bx = keyswitch(t2, rk, auto_b(ax))
    return (bigint.mask_bits(ks_ax, st.logq),
            sf.add_mask(auto_b(bx), ks_bx, st.logq))


def make_he_rotate_step(st: HEStatic, device: str | torch.device, k: int,
                        **knobs):
    """Build step(t2, rk, ax, bx) -> (ax', bx') for the automorphism σ_k.

    Serves both "rotate" (k = 5^r) and "conjugate" (k = 2N−1); rk is the
    Galois key as a table dict (``he_pipeline.evk_tables``). The step runs
    inside the profiler range ``repro_torch/step/<op>`` while
    torch.profiler records."""
    sf = make_stage_fns(device, **knobs)
    keyswitch = make_keyswitch_step(st, sf)
    auto_b = _make_automorphism_b(st, k)
    op = "conjugate" if k == conjugation_k(st.params) else "rotate"

    def step(t2, rk, ax, bx):
        with device_range(op, "step"):
            check_operands(st, sf.device, ax, bx)
            return _galois_b(st, sf, keyswitch, auto_b, t2, rk, ax, bx)

    return step


def make_slot_sum_step(st: HEStatic, device: str | torch.device,
                       n_slots: int, **knobs):
    """Build step(t2, rks, ax, bx) summing all n_slots slots into every
    slot: acc ← acc + rotate(acc, r) for r = 1, 2, 4, … — log₂(n) rounds,
    one key switch each. `rks` is a tuple of rotation-key dicts in
    slot_sum_rotations(n_slots) order."""
    sf = make_stage_fns(device, **knobs)
    keyswitch = make_keyswitch_step(st, sf)
    autos = [_make_automorphism_b(st, rotation_k(st.params, r))
             for r in slot_sum_rotations(n_slots)]
    logq = st.logq

    def step(t2, rks, ax, bx):
        check_operands(st, sf.device, ax, bx)
        for auto_b, rk in zip(autos, rks, strict=True):
            rot_ax, rot_bx = _galois_b(st, sf, keyswitch, auto_b, t2, rk,
                                       ax, bx)
            ax = sf.add_mask(ax, rot_ax, logq)
            bx = sf.add_mask(bx, rot_bx, logq)
        return ax, bx

    return step


def _limb_step(st: HEStatic, device, fn: Callable):
    """step(ax, bx) -> (fn(ax), fn(bx)) for a per-polynomial limb op."""
    dev = resolve_device(device)

    def step(ax, bx):
        check_operands(st, dev, ax, bx)
        return fn(ax), fn(bx)

    return step


def make_rescale_step(st: HEStatic, device: str | torch.device, dlogp: int,
                      **knobs):
    """Build step(ax, bx) -> (ax', bx') dividing by 2^dlogp (§III-A):
    `core.heaan.rescale_poly` on the batch; outputs are (B, N, qlimbs')
    at logq' = logq − dlogp. No stage runs, so knobs change nothing."""
    params, logq = st.params, st.logq
    return _limb_step(st, device,
                      lambda x: rescale_poly(x, params, logq, dlogp))


def make_mod_down_step(st: HEStatic, device: str | torch.device, logq2: int,
                       **knobs):
    """Build step(ax, bx) -> (ax', bx') switching to modulus 2^logq2:
    mask + slice to qlimbs(logq2) limbs (`core.heaan.mod_down_poly`)."""
    params = st.params
    return _limb_step(st, device,
                      lambda x: mod_down_poly(x, params, logq2))


def make_mod_raise_step(st: HEStatic, device: str | torch.device,
                        logq2: int, **knobs):
    """Build step(ax, bx) -> (ax', bx') raising to modulus 2^logq2, the
    bootstrap's first stage (`core.heaan.mod_raise_poly`): zero-pad to
    qlimbs(logq2) limbs, center at the old logq, re-mask at logq2."""
    params, logq = st.params, st.logq
    return _limb_step(st, device,
                      lambda x: mod_raise_poly(x, params, logq, logq2))


def make_addsub_step(st: HEStatic, device: str | torch.device, op: str,
                     **knobs):
    """Build step(ax1, bx1, ax2, bx2) for "add"/"sub" — §III-B limb
    arithmetic + mod-q masking."""
    if op not in ("add", "sub"):             # not assert: gone under -O
        raise ValueError(f"addsub step takes op 'add' or 'sub', "
                         f"got {op!r}")
    dev = resolve_device(device)
    fn = bigint.add if op == "add" else bigint.sub
    logq = st.logq

    def step(ax1, bx1, ax2, bx2):
        check_operands(st, dev, ax1, bx1, ax2, bx2)
        return (bigint.mask_bits(fn(ax1, ax2), logq),
                bigint.mask_bits(fn(bx1, bx2), logq))

    return step


def make_mul_plain_step(st: HEStatic, device: str | torch.device, **knobs):
    """Build step(t1, ax, bx, pt) -> (ax', bx') for ciphertext ×
    plaintext — paper Fig. 2's region 1 only, no key switch.

    The encoded operand pt is batch data ((B, N, qlimbs) mod-q limbs),
    taken to the region-1 eval domain once and multiplied pointwise into
    both components. np₁ covers 2N·q², the bound `core.heaan.he_mul_plain`
    uses, and iCRT reconstructs the exact product, so each item equals
    he_mul_plain bit for bit."""
    sf = make_stage_fns(device, **knobs)
    logq, qlimbs = st.logq, st.qlimbs

    def step(t1, ax, bx, pt):
        check_operands(st, sf.device, ax, bx, pt)
        ept = sf.to_eval(pt, t1)
        da = sf.from_eval(sf.mont_mul(sf.to_eval(ax, t1), ept, t1), t1,
                          qlimbs)
        db = sf.from_eval(sf.mont_mul(sf.to_eval(bx, t1), ept, t1), t1,
                          qlimbs)
        return bigint.mask_bits(da, logq), bigint.mask_bits(db, logq)

    return step


def make_add_plain_step(st: HEStatic, device: str | torch.device, **knobs):
    """Build step(ax, bx, pt) -> (ax, bx') adding an encoded plaintext into
    bx (mask at logq); ax passes through untouched
    (`core.heaan.he_add_plain` batched)."""
    dev = resolve_device(device)
    logq = st.logq

    def step(ax, bx, pt):
        check_operands(st, dev, ax, bx, pt)
        return ax, bigint.mask_bits(bigint.add(bx, pt), logq)

    return step


# --------------------------------------------------------------------------
# the executor
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Inflight:
    """A dispatched-but-not-awaited engine step (double-buffer handle).

    ax/bx are the step's output tensors, still being computed on the card;
    `event` was recorded behind the step's launches (None for CPU tensors,
    which are complete when the step returns). The host is free to
    assemble the next batch while the device works.
    """

    batch: "Batch"
    ax: torch.Tensor
    bx: torch.Tensor
    t0: float
    event: Optional[torch.cuda.Event]


class OpEngine:
    """Executor for assembled batches, one step per signature.

    Steps are cached by batch bucket key; tables come from the level-aware
    TableCache, so a new level costs one step build + views, never a table
    rebuild. `dispatch` issues the step without waiting for the card;
    `wait` synchronizes its event, re-wraps the valid rows as Ciphertexts
    with the op's output level metadata, and returns the host-observed
    wall time. `run` = wait(dispatch(batch)).

    With `grid` (model size > 1) every step is this rank's part and
    `cache` holds this rank's rows. `relay(key, arrays)` (the serving
    leader's ``relay_batch``) hands each step's signature and operands to
    the followers just before the step runs here, so every rank of the
    model group runs the same steps in the same order.
    """

    def __init__(self, params: HEParams, device: str | torch.device,
                 cache: "TableCache", *, use_kernels: bool = True,
                 crt_strategy: str = "matmul",
                 icrt_strategy: str = "matmul",
                 modified_shoup: bool = False, tracer=None,
                 profile_stages: bool = False, grid=None, relay=None):
        self.params = params
        self.device = resolve_device(device)
        self.cache = cache
        self.grid = grid if grid is not None and grid.model > 1 else None
        self.relay = relay
        self.profile_stages = profile_stages
        # Fig. 3 attribution: the timer rides the stage bundle's knobs and
        # fences every stage; the steps are the same otherwise
        self.stage_timer = StageTimer(tracer=tracer) if profile_stages \
            else None
        self._tracer = tracer
        self._knobs = dict(use_kernels=use_kernels,
                           crt_strategy=crt_strategy,
                           icrt_strategy=icrt_strategy,
                           modified_shoup=modified_shoup)
        if profile_stages:
            self._knobs["stage_timer"] = self.stage_timer
        if self.grid is not None:
            self._knobs["grid"] = self.grid
        self._steps: Dict[Tuple, Callable] = {}
        self._static: Dict[int, HEStatic] = {}
        self._warmed: set = set()
        self.compile_s = 0.0

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, t) -> None:
        """Re-pointable after construction; the stage timer follows the
        engine's tracer."""
        self._tracer = t
        if self.stage_timer is not None:
            self.stage_timer.tracer = t

    def _st(self, logq: int) -> HEStatic:
        if logq not in self._static:
            self._static[logq] = he_static(self.params, logq)
        return self._static[logq]

    def _step_for(self, key: Tuple) -> Callable:
        """The runner(arrays) -> (ax, bx) for (op, logq, extra), built
        once and closing over the right tables and keys."""
        if key in self._steps:
            return self._steps[key]
        op, logq, extra = key
        st, dev, kw = self._st(logq), self.device, self._knobs
        t1, t2 = self.cache.level_tables(logq)
        if op == "mul":
            step = make_he_mul_step(st, dev, **kw)
            ek = self.cache.evk()

            def runner(a):
                return step(t1, t2, ek, a["ax1"], a["bx1"], a["ax2"],
                            a["bx2"])
        elif op in ("rotate", "conjugate"):
            k = rotation_k(self.params, extra) if op == "rotate" \
                else conjugation_k(self.params)
            step = make_he_rotate_step(st, dev, k, **kw)
            rk = self.cache.rot_key(extra) if op == "rotate" \
                else self.cache.conj_key()

            def runner(a):
                return step(t2, rk, a["ax1"], a["bx1"])
        elif op == "slot_sum":
            step = make_slot_sum_step(st, dev, extra, **kw)
            rks = tuple(self.cache.rot_key(r)
                        for r in slot_sum_rotations(extra))

            def runner(a):
                return step(t2, rks, a["ax1"], a["bx1"])
        elif op in ("rescale", "mod_down", "mod_raise"):
            make = {"rescale": make_rescale_step,
                    "mod_down": make_mod_down_step,
                    "mod_raise": make_mod_raise_step}[op]
            step = make(st, dev, extra, **kw)

            def runner(a):
                return step(a["ax1"], a["bx1"])
        elif op in ("add", "sub"):
            step = make_addsub_step(st, dev, op, **kw)

            def runner(a):
                return step(a["ax1"], a["bx1"], a["ax2"], a["bx2"])
        elif op == "mul_plain":
            step = make_mul_plain_step(st, dev, **kw)

            def runner(a):
                return step(t1, a["ax1"], a["bx1"], a["pt"])
        elif op == "add_plain":
            step = make_add_plain_step(st, dev, **kw)

            def runner(a):
                return step(a["ax1"], a["bx1"], a["pt"])
        else:
            raise ValueError(f"unknown op {op!r}")
        self._steps[key] = runner
        return runner

    @property
    def knobs(self) -> dict:
        """The strategy knobs every step is built with (what a follower's
        engine must match)."""
        return {k: self._knobs[k] for k in ("use_kernels", "crt_strategy",
                                            "icrt_strategy",
                                            "modified_shoup")}

    def run_step(self, key: Tuple, arrays: Dict[str, torch.Tensor]):
        """Run the step of signature `key` on `arrays` (relayed to the
        followers first on a serving leader); returns (ax, bx)."""
        if self.relay is not None:
            self.relay(key, arrays)
        return self._step_for(key)(arrays)

    @property
    def n_compiled(self) -> int:
        """Steps built (one per signature; the reference's count of
        compiled steps)."""
        return len(self._steps)

    def _place(self, batch: "Batch") -> Dict[str, torch.Tensor]:
        """The batch's operands on the engine's device: host tensors move
        (asynchronously, under an "h2d" span), device tensors stay."""
        if all(v.device == self.device for v in batch.arrays.values()):
            return batch.arrays
        span = self._tracer.span(
            "h2d", cat="engine", lane="engine",
            args={"op": batch.op, "batch": batch.size}) \
            if self._tracer is not None else None
        out = {k: v.to(self.device, non_blocking=True)
               for k, v in batch.arrays.items()}
        if span is not None:
            span.end()
        return out

    def warm_batch(self, batch: "Batch") -> None:
        """Build the batch's step and run it once, unmetered (no-op once
        warm); the elapsed time lands in `compile_s`, so steady-state
        metrics never include a signature's first run (there is no
        compile: it is the step build, its table views, and the first
        launches). The first batch of a signature therefore runs twice —
        one extra batch per (op, level) over the server's lifetime."""
        if batch.key in self._warmed:
            return
        span = self._tracer.span(
            "warm_compile", cat="engine", lane="engine",
            args={"op": batch.op, "logq": batch.logq}) \
            if self._tracer is not None else None
        t0 = time.perf_counter()
        self._step_for(batch.key)
        arrays = self._place(batch)
        if self.stage_timer is not None:
            # warm runs must not pollute the Fig. 3 attribution
            with self.stage_timer.pause():
                self.run_step(batch.key, arrays)
        else:
            self.run_step(batch.key, arrays)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.compile_s += time.perf_counter() - t0
        if span is not None:
            span.end()
        self._warmed.add(batch.key)

    # ---- async execution (double buffering) ------------------------------

    def dispatch(self, batch: "Batch") -> Inflight:
        """Place + issue one batch WITHOUT waiting for the card.

        A cold signature is warmed first (`warm_batch`), so steady-state
        metrics never include it. The returned handle's tensors are still
        being computed — the caller overlaps the next batch's assembly
        against this step, then `wait`s.
        """
        self.warm_batch(batch)
        arrays = self._place(batch)
        t0 = time.perf_counter()
        if self.stage_timer is not None:
            with self.stage_timer.op(batch.op):
                ax, bx = self.run_step(batch.key, arrays)
        else:
            ax, bx = self.run_step(batch.key, arrays)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return Inflight(batch=batch, ax=ax, bx=bx, t0=t0, event=event)

    def wait(self, inflight: Inflight
             ) -> Tuple[List[Ciphertext], float]:
        """Wait for a dispatched batch; returns (outputs, wall_s) with the
        n_valid outputs in request order (padded lanes computed and
        discarded) and the dispatch→ready wall time AS OBSERVED BY THE
        HOST. On the synchronous run() path that is the step's wall; on
        the overlapped path it also includes any host time between
        dispatch and this wait (an upper bound on device time), so use
        drain walls to quantify the overlap win.

        The traced "device_wall" event is this wall: a host-clock span
        from dispatch (after placement) to the event's completion, which
        includes the host's time launching the step and any time the card
        spends on earlier work, so it is at least the batch's own device
        time, never a device measurement."""
        if inflight.event is not None:
            inflight.event.synchronize()
        wall = time.perf_counter() - inflight.t0
        if self._tracer is not None:
            b = inflight.batch
            self._tracer.event(
                "device_wall", cat="lifecycle", lane="engine",
                ts=inflight.t0, dur=wall,
                args={"op": b.op, "logq": b.logq, "batch": b.size,
                      "n_valid": b.n_valid})
        return self._wrap(inflight.batch, inflight.ax, inflight.bx), wall

    def run(self, batch: "Batch") -> List[Ciphertext]:
        """Synchronous dispatch→wait; returns the n_valid outputs in
        request order."""
        outs, _ = self.wait(self.dispatch(batch))
        return outs

    def _wrap(self, batch: "Batch", ax, bx) -> List[Ciphertext]:
        """Re-wrap step outputs as Ciphertexts with each op's output
        level metadata (the server-side level tracking contract):

          mul          logq,          logp₁ + logp₂
          mul_plain    logq,          logp + pt_logp
          add/sub/add_plain           logq, logp (equality checked at
                                      submit)
          rotate/conjugate/slot_sum   unchanged
          rescale      logq − dlogp,  logp − dlogp
          mod_down     logq2,         logp
          mod_raise    logq2,         logp
        """
        op = batch.op
        out = []
        for i, req in enumerate(batch.requests):
            c0 = req.cts[0]
            logq, logp = batch.logq, c0.logp
            if op == "mul":
                logp = c0.logp + req.cts[1].logp
            elif op == "mul_plain":
                logp = c0.logp + req.pt_logp
            elif op == "rescale":
                logq -= req.dlogp
                logp -= req.dlogp
            elif op in ("mod_down", "mod_raise"):
                logq = req.logq2
            out.append(Ciphertext(ax=ax[i], bx=bx[i], logq=logq,
                                  logp=logp, n_slots=c0.n_slots))
        return out
