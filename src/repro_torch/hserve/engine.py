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

This is lines 82–276 of the JAX package's ``hserve/engine.py``. Each
``make_*_step`` takes ``(st, device, **knobs)`` where the reference takes
``(st, mesh, **knobs)``, as ``make_he_mul_step`` does; knobs are
``make_stage_fns``'s (``use_kernels``, ``crt_strategy``, …). The
reference's ``_glue_jit`` and ``sf.out`` placements carry no arithmetic
and are dropped. Operands are (B, N, qlimbs) at the step's level on its
device; a step refuses others.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.core import bigint
from repro_torch.core.context import resolve_device
from repro_torch.core.heaan import mod_down_poly, mod_raise_poly, rescale_poly
from repro_torch.core.rotate import automorphism_poly, rotation_k
from repro_torch.dist.he_pipeline import (
    HEStatic, check_operands, make_keyswitch_step, make_stage_fns,
)

__all__ = ["STAGE_OPS", "slot_sum_rotations", "make_he_rotate_step",
           "make_slot_sum_step", "make_rescale_step", "make_mod_down_step",
           "make_mod_raise_step", "make_addsub_step", "make_mul_plain_step",
           "make_add_plain_step"]


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


def _galois_b(st: HEStatic, keyswitch, auto_b, t2, rk, ax, bx):
    """One Galois operation on a batch: σ_k, then the key switch against
    rk (core.rotate._apply_galois)."""
    ks_ax, ks_bx = keyswitch(t2, rk, auto_b(ax))
    return (bigint.mask_bits(ks_ax, st.logq),
            bigint.mask_bits(bigint.add(auto_b(bx), ks_bx), st.logq))


def make_he_rotate_step(st: HEStatic, device: str | torch.device, k: int,
                        **knobs):
    """Build step(t2, rk, ax, bx) -> (ax', bx') for the automorphism σ_k.

    Serves both "rotate" (k = 5^r) and "conjugate" (k = 2N−1); rk is the
    Galois key as a table dict (``he_pipeline.evk_tables``)."""
    sf = make_stage_fns(device, **knobs)
    keyswitch = make_keyswitch_step(st, sf)
    auto_b = _make_automorphism_b(st, k)

    def step(t2, rk, ax, bx):
        check_operands(st, sf.device, ax, bx)
        return _galois_b(st, keyswitch, auto_b, t2, rk, ax, bx)

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
            rot_ax, rot_bx = _galois_b(st, keyswitch, auto_b, t2, rk, ax,
                                         bx)
            ax = bigint.mask_bits(bigint.add(ax, rot_ax), logq)
            bx = bigint.mask_bits(bigint.add(bx, rot_bx), logq)
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
