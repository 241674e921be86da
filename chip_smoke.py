#!/usr/bin/env python3
"""Smoke run of repro_torch on one NVIDIA card, at the paper's parameters.

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result:

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and print
   the card's name and power limit.
2. At every shape that HE Mul and the B = 4 batched step give a kernel at
   logN=16, logQ=1200, β=2^32 (``paper_params()``), hold the kernel and
   each of its variants (CRT Mod-2/Mod-4, modified-Shoup NTT/iNTT) against
   its plain torch version on the same seeded inputs, bit for bit, and time
   both with CUDA events (the L2 cache is flushed before each timed
   launch). A variant's bound is that of the function it computes, the
   same as its kernel's at that shape. The kernels alone are held and
   timed so too at the shapes of the levels the circuit path descends to
   (logq 1170, 1140, 1110: CRT K 37–35, np₁ 79–75, np₂ 121–119, iCRT
   out 76–74) and of Galois keygen (CRT K 75 into np 81 and 122, iCRT np
   81 → 75), at B = 1 and 4. iCRT is also held bit for bit
   against its plain version, at each of its shapes, on the inputs that
   decide its carries, its ±1 ladder and its center-lift (every residue
   p_j − 1, every residue 0, and X = ⌊P/2⌋, ⌊P/2⌋ + 1, P − 1, 1); CRT and
   its variants on every limb 0xFFFFFFFF (the largest three-word and
   two-word sums) and every limb 0. NTT and iNTT rows also carry the bytes
   of a design of two passes over device memory (the data twice in and
   twice out, the tables once); the time those bytes take at the bound's
   memory rate is printed on a line of its own. Then the two
   launch-geometry repairs: the batched step at ``test_params()``
   (N = 32) for B = 3, 5 and 9, widths that iCRT's launch cannot tile (and
   at B = 9 CRT's), equals per-pair he_mul; NTT → iNTT of 70000 rows of
   16 words (beyond gridDim.y's 65535) equals the plain versions.
3. Drive the main path: keygen → encrypt_message ×2 (2^15 slots) → he_mul →
   rescale → he_mod_down + he_add → decrypt_message. The launch counts are
   set to 0 just before and read just after; every kernel must have
   launched, he_mul alone must launch each kernel as often as the Fig. 2
   pipeline says, the decrypted product must be within 1e-3 of numpy's (the
   product plus the first message within 2e-3), and he_mul with
   ``use_kernels=False`` must give the same words.
4. Drive the batched step (``repro_torch.dist.he_pipeline``) at
   ``paper_params()`` with B = 4 ciphertext pairs encrypted from seeds, on
   three rungs of the paper's ladder through the kernels: "default" (acc3
   CRT, exact Shoup), "mod2+modified" and "mod4". The launch counts are set
   to 0 just before and read just after; every kernel and variant must have
   launched, each rung its own variants. Every output must equal the
   single-ciphertext he_mul of its pair bit for bit, the "default" rung
   also the plain batched step; the "default" rung runs once more at B = 3.
   Then each rung is timed (median of 5, host clock around the step and
   ``torch.cuda.synchronize()``).
5. Time HE Mul (median of several runs) through the kernels and through
   the plain versions, and trace one HE Mul and one batched step with
   torch.profiler: device time by kernel and the device's busy share.
6. The circuit path (``repro_torch.hserve``) on phase 3's keys: Galois
   keygen for r ∈ CIRCUIT_ROTATIONS and conjugation; circuit A (the
   degree-4 demo circuit on N/4 slots), circuit B (an affine layer on 64
   slots: mul_plain → rescale → add_plain → rotate(1) → sub → slot_sum)
   and circuit C (B's first two nodes, then mod_raise 1170 → 1200) through
   ``execute_circuit_reference`` on the kernels and on the plain path,
   equal bit for bit, with the launches derived in OP_LAUNCHES; A within
   0.3 of conj(z⁴) + z, B within 1e-2 of its numpy value. Each op alone
   (launches, median of 5) and each batched step of ``hserve.engine`` at
   B = 4 (equal to the single op on every item, launching what one op
   does; median of 5), and a torch.profiler split of one he_rotate.
7. Serving (``repro_torch.hserve.HEServer``) at ``paper_params()`` on phase
   3's keys and phase 6's Galois keys, batch 4, the circuit-aware
   scheduler on: a stream of SERVE_REQUESTS requests over logq 1200, 1170
   and 1140 (mul; mul_plain and add_plain, a quarter of the mul share,
   one plaintext registered by hash and reused; rotate(1) and conjugate),
   two staggered degree-4 circuits and one circuit B. The launch counts
   are set to 0 just before the stream and read just after its drain;
   every kernel must have launched. Every result must equal the
   single-ciphertext op on the kernels and every circuit
   ``execute_circuit_reference``, bit for bit, and decrypt within phase
   6's limits (muls, rescaled, within 1e-2). Then the stream is served in
   turns without and with ``overlap`` (off, on, on, off), each equal to
   the first bit for bit with nothing left queued, with
   ``torch.cuda.set_sync_debug_mode("error")`` around every dispatch (a
   step that synchronizes the host fails the phase), and timed: drain
   wall, results and ops per second, per-op p50/p99 latency and ms per
   batch, flush causes, co-batching, cache hits. Then 4 mul batches and a
   rotate batch with ``profile_stages=True``: the Fig. 3 split and the
   four stages' coverage of the op's metered wall (printed, not gated).
   Last, ``launch.serve.serve_he`` at its SMOKE parameters on the card.
8. The multi-host tier (``repro_torch.hserve.HEFrontend``) at
   ``paper_params()`` on the same keys, serving phase 7's stream
   (``serve_stream``): a frontend on the host with MULTIHOST_WORKERS worker
   processes on the card (``transport="subprocess"``) whose worker 0 is
   killed after its 2nd batch (``FailureInjector``): every result equals
   phase 7's ``HEServer`` result bit for bit, with one death and its batch
   requeued; ``revive_workers()`` respawns it (the 1 GB init frame
   replayed) and its batches are bit for bit; then a timed drain with the
   workers' launch counts set to 0 just before and read just after (every
   kernel launched inside the workers). A traced ``HESession`` over that
   frontend runs TRACED_EXPRS of serve_he's expressions at 64 slots: the
   analyzer's reports are printed; when they flag a finding,
   ``check="error"`` must refuse the run with nothing enqueued, and the run
   goes on under ``check="warn"``; every result equals
   ``execute_circuit_reference`` of its compiled ops bit for bit and
   decrypts within 1e-2. Then one subprocess worker, and in-process
   workers on the card (launches counted in this process), each bit for
   bit. Printed: drain walls beside phase 7's, each mul batch's frame
   bytes and seconds, each worker's busy share, init seconds and bytes,
   and kernel launches.

9. Bootstrapping (``repro_torch.boot``), served. 9a, the reference config
   ``boot_params()`` (logN 4, logQ 336, logp 24, h 2): an HEServer
   (batch BOOT_BATCH, the scheduler on, a Tracer) holding only the evk,
   an HESession over it that mints the plan's Galois keys; with the launch
   counts set to 0 just before and read just after, two concurrent
   ``session.bootstrap`` calls on exhausted ciphertexts (logq = logp) and
   one ``session.run([x * x], bootstrap="auto")``, all in one drain; every
   kernel must have launched. Each refreshed ciphertext equals
   ``execute_circuit_reference`` of the plan on the plain path bit for
   bit and decrypts within ``plan.error_bound()``; x·x equals the plain
   path's bootstrap → he_mul → rescale and decrypts within 4 ·
   msg_bound · bound; the bootstraps co-batch across circuits; the
   ``boot.*`` spans cover the four stages; the refreshed ciphertext runs
   mul → rescale → mul served bit for bit against the core ops; a warm
   pair is traced by torch.profiler (device busy share). 9b,
   ``boot_params(logN=10)`` (3251 nodes, 46 rotation keys + conj): plan
   build and key minting timed; one bootstrap alone, then a concurrent
   pair (the lone input again beside a second) with every dispatch
   under ``torch.cuda.set_sync_debug_mode("error")``, each drain with
   the counts set to 0 before and read after (every kernel launched) and
   its ``_submit_ready`` scan timed;
   all three equal the plain path bit for bit and decrypt below
   BOOT_USABLE (the reference's ``error_bound()`` is reported beside:
   at this ring it does not hold); printed: drains, batches, co-batch
   rate, plaintext-cache entries and MiB, launches. 9c: every kernel and
   variant against its plain version at every level the two plans visit
   (N = 16 and 1024, logq 24..336, B = 1 and BATCH), at keygen's shapes,
   and iCRT's and CRT's edge inputs there; the top level's kernel shapes
   timed.
10. The paper's β = 2^64 word mode at ``paper_params(beta_bits=64)``
   (qlimbs 19, np₁ 41, np₂ 61) on the card, through the plain path: the
   kernels take β = 2^32 words, as the reference's do, so this phase
   launches none. 10a: the tables built and moved, timed; sampled entries
   of every table against python ints. 10b: keygen, the rotation-by-1 and
   conjugation keys, two encryptions (phase 3's messages and seeds);
   he_mul + rescale decrypts within 1e-3, the rotation and the
   conjugation within serve_he's 1e-2 (phase 3's first ciphertext
   rotated and conjugated under phase 6's keys gives the β = 2^32 errors
   beside); no port kernel launched; he_mul at β = 2^64 timed (median of 5,
   host clock, and device ms and events from one profiled call) beside
   phase 3's he_mul at β = 2^32 on the plain path and on the kernels.
   10c: ``make_he_mul_step`` at B = BETA64_BATCH equals per-pair he_mul
   bit for bit; ms a step and the step's peak memory. 10d: every key and
   ciphertext word of the same run at logN BETA64_CPU_LOGN equals the
   CPU's bit for bit, and sampled coefficients of region 1's bx1·bx2 at
   paper params equal the python-int negacyclic product. 10e:
   ``use_kernels=True`` is refused by he_mul and by the step.
11. The HE pipeline across ranks (``repro_torch.dist``): GRID_RANKS ranks
   of a model grid on this one card (``launch.mesh.spawn_grid``; gloo, as
   NCCL refuses two ranks on one GPU), at ``paper_params()`` uncut,
   batch BATCH. This is not a scaling measurement: the ranks share the
   card's SMs and gloo moves CUDA tensors through the host. 11a: iCRT
   split at the cross-prime sum, ``icrt_partial`` and ``icrt_finish``
   (``csrc/icrt.cu``), against their plain twins bit for bit (lo, hi and
   the f64 qsum) at the shards of np₁ and np₂ into ICRT_SPLITS ranks
   (41/40, 61/61, 21/20/20/20, 31/31/30/30), one prime, and an empty shard
   (which launches nothing), B = 1 and BATCH, on random residues and on
   iCRT's edge inputs; the partials of each split summed and finished ==
   the fused ``icrt_op`` bit for bit; both timed (CUDA events, median of
   20, L2 flushed) against their bounds. 11b: ``make_he_mul_step`` on the
   2-rank grid, tables and keys from each rank's ``TableCache(grid=)``,
   on the rungs of GRID_RUNGS at logQ and the default rung one level
   down: every output == the one-rank kernel step's bit for bit; the
   schedule each rank records == ``he_expected_collectives`` (counts and
   ring wire bytes), with no collective-permute; the launch counts set to
   0 before and read after (the split kernels must launch); on rank 0 the
   step's wall (median of 5), the collectives' share of it (gloo takes the
   CUDA tensors, so the port stages nothing), device ms from one profiled
   call, and each
   rank's resident table bytes beside one rank's. 11c: phase 7's stream
   through ``HEServer(grid=)`` on rank 0 with ``serve_follower`` on rank
   1 (the machinery of ``serve_he --model-shards``): every result ==
   phase 7's HEServer result bit for bit, the drain wall beside phase
   7's first; then ``serve_he(model_shards=2)`` at SMOKE, its max_err ==
   phase 7's SMOKE run's.

Before the last line it prints the nvidia-smi line, one JSON line of
per-kernel numbers (``{"kernels": [...]}``: the headline times are those
of ``headline_shape``, HE Mul's region 1 for a kernel and the batched
step's first shape for a variant; every shape is under ``shapes``) and JSON
lines for HE Mul's times, the batched step's and their traces;
the circuit path's JSON line, the serving JSON line
(``{"serving": {...}}``), the multi-host JSON line (``{"multihost":
{...}}``), the bootstrap JSON line (``{"bootstrap": {...}}``), the
β = 2^64 JSON line (``{"beta64": {...}}``), the grid JSON line
(``{"grid": {...}}``) and the nvidia-smi line again; the last line
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
# 32-bit integer multiplies per second: Hopper has 64 INT32 lanes per SM,
# half its 128 FP32 lanes, so a quarter of the 67 TFLOP/s float32 figure
# (which counts an FMA as two operations).
INT32_MUL_PER_S = 67e12 / 4
# launches per HE Mul (Fig. 2) at each shape kernel_cases() gives, region 1
# then region 2: 4× CRT→NTT at np₁ and 1× at np₂, 3× modmul at np₁, 3×
# iNTT→iCRT at np₁ and 2× at np₂
HE_MUL_SHAPE_LAUNCHES = {"modmul": (3,), "ntt": (4, 1), "intt": (3, 2),
                         "crt": (4, 1), "icrt": (3, 2)}
HE_MUL_LAUNCHES = {k: sum(v) for k, v in HE_MUL_SHAPE_LAUNCHES.items()}
BATCH = 4                       # ciphertext pairs per batched step
# rungs of the paper's ladder the batched step runs through the kernels:
# keywords of make_he_mul_step, and the launches of one step (Fig. 2:
# 5 CRT, 5 NTT, 5 iNTT, 5 iCRT, 3 Montgomery products)
RUNGS = {
    "default": ({}, {"crt": 5, "ntt": 5, "intt": 5, "icrt": 5,
                     "modmul": 3}),
    "mod2+modified": ({"crt_strategy": "mod2", "modified_shoup": True},
                      {"crt_mod2": 5, "ntt_modified": 5, "intt_modified": 5,
                       "icrt": 5, "modmul": 3}),
    "mod4": ({"crt_strategy": "mod4"}, {"crt_mod4": 5, "ntt": 5, "intt": 5,
                                        "icrt": 5, "modmul": 3}),
}
# Phase 6, the circuit path: the rotation keys it makes (circuit B's
# rotate(1) and slot sum over AFFINE_SLOTS slots, the slot-sum step), and
# the launches of one single-ciphertext op, read off the code: a Galois
# op is region 2 alone (core/rotate.py _apply_galois: 1 CRT→NTT, 2
# iNTT→iCRT), he_mul_plain region 1 alone (core/heaan.py: 3 CRT→NTT, 2
# Montgomery products, 2 iNTT→iCRT); the limb ops launch nothing. A
# batched step launches what one op does: the batch folds into each launch.
CIRCUIT_ROTATIONS = (1, 2, 4, 8, 16, 32)
AFFINE_SLOTS = 64
GALOIS_LAUNCHES = {"crt": 1, "ntt": 1, "intt": 2, "icrt": 2}
OP_LAUNCHES = {
    "mul": HE_MUL_LAUNCHES, "rotate": GALOIS_LAUNCHES,
    "conjugate": GALOIS_LAUNCHES,
    "mul_plain": {"crt": 3, "ntt": 3, "modmul": 2, "intt": 2, "icrt": 2},
    **{op: {} for op in ("add", "sub", "rescale", "mod_down", "mod_raise",
                         "add_plain")},
}
# Phase 7, serving: the stream's shape (serve_he's, at paper_params()) and
# the kernels a served stream launches (the default variants)
SERVE_BATCH = 4
SERVE_LEVELS = 3
SERVE_REQUESTS = 24
SERVE_ROTATIONS, SERVE_CONJUGATIONS = 4, 2
SERVE_PLAIN_FRAC = 0.25
SERVE_KERNELS = ("modmul", "ntt", "intt", "crt", "icrt")
# Phase 8, the multi-host tier: workers a frontend runs, and the traced
# client expressions
MULTIHOST_WORKERS = 2
TRACED_EXPRS = 2
# Phase 9, bootstrapping: the reference config's server batch (its tests'),
# and the error line at logN 10. There the reference's error_bound() does
# not hold (it leaves out the noise the dense BSGS transforms add), so the
# served results are held to the reference's own line for a contract that
# still promises usable precision (tests/test_boot.py: above 2^-6 a
# contract "promises no precision"), and the bound is reported beside it.
BOOT_BATCH = 2
BOOT_USABLE = 2.0 ** -6
# Phase 10, the paper's β = 2^64 word mode on the plain path: the batched
# step's batch, the ring of the card-against-CPU check (the largest whose
# CPU run of keygen, two Galois keys, two encryptions, he_mul, rotate and
# conjugate takes under about 30 s), and the sampled table entries and
# product coefficients held against python ints
BETA64_BATCH = 4
BETA64_CPU_LOGN = 12
BETA64_SAMPLES = 8
# Phase 11, the HE pipeline across ranks: the model ranks sharing the
# card, the rungs of the 2-rank step (make_he_mul_step keywords), and the
# splits of iCRT's primes over ranks that 11a holds the split kernels at
GRID_RANKS = 2
GRID_RUNGS = {
    "default": {},
    "mod2+modified": {"crt_strategy": "mod2", "modified_shoup": True},
    "reduce_scatter_icrt": {"reduce_scatter_icrt": True},
}
ICRT_SPLITS = (2, 4)
SOURCES = {
    "modmul": ("kernels/csrc/modmul.cu",
               "src/repro/kernels/modmul/modmul.py:33"),
    "ntt": ("kernels/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:93"),
    "intt": ("kernels/csrc/ntt.cu", "src/repro/kernels/ntt/ntt.py:113"),
    "crt": ("kernels/csrc/crt.cu", "src/repro/kernels/crt/crt.py:96"),
    "icrt": ("kernels/csrc/icrt.cu", "src/repro/kernels/icrt/icrt.py:98"),
    "crt_mod2": ("kernels/csrc/crt.cu", "src/repro/kernels/crt/crt.py:49"),
    "crt_mod4": ("kernels/csrc/crt.cu", "src/repro/kernels/crt/crt.py:49"),
    "ntt_modified": ("kernels/csrc/ntt.cu",
                     "src/repro/kernels/ntt/ntt.py:32"),
    "intt_modified": ("kernels/csrc/ntt.cu",
                      "src/repro/kernels/ntt/ntt.py:54"),
    "icrt_partial": ("kernels/csrc/icrt.cu",
                     "src/repro/kernels/icrt/icrt.py:98"),
    "icrt_finish": ("kernels/csrc/icrt.cu",
                    "src/repro/kernels/icrt/icrt.py:98"),
}


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def circuit_levels(params) -> tuple[int, ...]:
    """The levels below logQ that the circuit path runs kernels at: the
    degree-4 circuit's second mul (logQ − logp), then down to its
    conjugate (logQ − 3·logp)."""
    return tuple(params.logQ - i * params.logp for i in (1, 2, 3))


def scaled(counts: dict, n: int) -> dict:
    return {k: n * v for k, v in counts.items()}


def summed(*counts: dict) -> dict:
    out: dict = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def launched(torch, common, fn):
    """(fn(), the launches fn made by kernel)."""
    before = dict(common.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in common.LAUNCHES.items()
                 if v - before[k]}


def median_ms(torch, fn, reps: int = 5) -> tuple[float, list]:
    """Median host time of fn() + synchronize over reps runs, after one
    warm-up run."""
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms), ms


def random_ciphertexts(torch, np, params, pk, dev, seeds, cfg=None
                       ) -> list:
    """Ciphertexts at logQ of random plaintexts below Q, encrypted from
    `seeds` (encode's host-side big-integer work would only cost time);
    words of params.beta_bits."""
    from repro_torch.core import bigint
    from repro_torch.core import heaan as H
    from repro_torch.core.rns import DEFAULT
    qlimbs = params.qlimbs(params.logQ)
    rng = np.random.default_rng(8)
    cts = []
    for seed in seeds:
        if params.beta_bits == 64:
            words = rng.integers(0, 1 << 64, size=(params.N, qlimbs),
                                 dtype=np.uint64).view(np.int64)
        else:
            words = rng.integers(0, 1 << 32, size=(params.N, qlimbs),
                                 dtype=np.uint64).astype(np.uint32
                                                         ).view(np.int32)
        pt = torch.from_numpy(words).to(dev)
        cts.append(H.encrypt_coeffs(bigint.mask_bits(pt, params.logQ), pk,
                                    params, params.N // 2, seed,
                                    cfg or DEFAULT))
    return cts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, nmul: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nmul / INT32_MUL_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of fn() over reps runs, each after an L2 flush."""
    fn()                                     # warm-up
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def level_shapes(params, logq: int) -> tuple[int, int, int, int]:
    """(qlimbs, np₁, np₂, ks_limbs) of a level: CRT's K, the region-1 and
    region-2 prime counts (np₁ is also he_mul_plain's) and the width iCRT
    writes in region 2."""
    return (params.qlimbs(logq), params.np_region1(logq),
            params.np_region2(logq),
            params.limbs_for_bits(logq + params.logQ) + 1)


def kernel_cases(torch, np, params, dev, logq=None, variants=True):
    """(kernel, shape label, kernel call, plain call, bytes, multiplies,
    bytes of a two-pass design or None) for every shape HE Mul (B = 1)
    and the batched step (B = BATCH) give a kernel or variant at level
    `logq` (default logQ) of `params`; without `variants` the kernels
    alone. A batch stacks B·np rows for the per-row kernels (row r takes
    the tables of prime r mod np) and B·N coefficients for CRT and iCRT."""
    K, np1, np2, ks_limbs = level_shapes(params, logq or params.logQ)
    return _shape_cases(torch, np, params, dev, modmul=(np1,),
                        ntt=(np1, np2), crt=((K, np1), (K, np2)),
                        icrt=((np1, K), (np2, ks_limbs)), variants=variants)


def keygen_kernel_cases(torch, np, params, dev):
    """The shapes keygen gives CRT and iCRT beyond those of the levels:
    the 2·logQ-bit key words (K = limbs of Q²) into the key-product primes
    and into region 2's, and the key product back to those limbs."""
    q2 = params.limbs_for_bits(2 * params.logQ)
    np_kk = params.np_for_bits(params.primes,
                               2 * params.logQ + params.logN + 3)
    return _shape_cases(torch, np, params, dev, modmul=(), ntt=(),
                        crt=((q2, np_kk), (q2, params.np_region2(
                            params.logQ))),
                        icrt=((np_kk, q2),), variants=False)


def _shape_cases(torch, np, params, dev, modmul, ntt, crt, icrt,
                 variants):
    """kernel_cases at the given shapes: modmul and NTT/iNTT at each np,
    CRT at each (K, np), iCRT at each (np, out limbs); B = 1 and BATCH."""
    from repro_torch.core.context import device_icrt_tables, device_tables
    from repro_torch.kernels.crt.ops import crt_op
    from repro_torch.kernels.crt.ref import crt_ref
    from repro_torch.kernels.icrt.ops import icrt_op
    from repro_torch.kernels.icrt.ref import icrt_inputs, icrt_ref
    from repro_torch.kernels.modmul.ops import pointwise_mont_op
    from repro_torch.kernels.modmul.ref import pointwise_mont_ref
    from repro_torch.kernels.ntt.ops import intt_op, ntt_op
    from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref

    g = device_tables(params, dev)
    N, logN = params.N, params.logN
    rng = np.random.default_rng(2024)
    primes = g.primes.cpu().numpy().view(np.uint32).astype(np.uint64)

    def words(a):
        return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)

    def residues(npn, B=1):
        r = rng.integers(0, 1 << 62, size=(B * npn, N), dtype=np.uint64)
        return words(r % np.tile(primes[:npn], B)[:, None])

    cases = []
    for B in (1, BATCH):
        tag = "" if B == 1 else f" B={B}"
        for npn in modmul:
            rows = B * npn
            a, b = residues(npn, B), residues(npn, B)
            mm = tuple(v[:npn].repeat(B) for v in (g.primes, g.pprime, g.r2))
            cases.append(("modmul", f"np={npn}{tag}",
                          lambda a=a, b=b, m=mm: pointwise_mont_op(a, b, *m),
                          lambda a=a, b=b, m=mm: pointwise_mont_ref(a, b, *m),
                          4 * (3 * rows * N + 3 * rows), 6 * rows * N, None))
        for npn in ntt:
            rows = B * npn
            x = residues(npn, B)
            fwd = (g.psi_rev[:npn], g.psi_rev_shoup[:npn], g.primes[:npn])
            inv = (g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn], g.n_inv[:npn],
                   g.n_inv_shoup[:npn], g.primes[:npn])
            ev = ntt_ref(x, *fwd)
            butterflies = rows * (N // 2) * logN
            # x and out once per row, the twiddle tables once per prime;
            # two passes over device memory move the rows twice
            nbytes = 4 * (2 * rows * N + 2 * npn * N + npn)
            floor = nbytes + 4 * 2 * rows * N
            for mod in ((False, True) if variants else (False,)):
                # one bound for the function, whatever the variant: 3
                # multiplies per Shoup product (quotient, w·x, q·p)
                per = 3
                sfx = "_modified" if mod else ""
                cases.append((
                    "ntt" + sfx, f"np={npn}{tag}",
                    lambda x=x, f=fwd, m=mod: ntt_op(x, *f, modified=m),
                    lambda x=x, f=fwd, m=mod: ntt_ref(x, *f, modified=m),
                    nbytes, per * butterflies, floor))
                cases.append((
                    "intt" + sfx, f"np={npn}{tag}",
                    lambda e=ev, i=inv, m=mod: intt_op(e, *i, modified=m),
                    lambda e=ev, i=inv, m=mod: intt_ref(e, *i, modified=m),
                    nbytes + 8 * npn, per * (butterflies + rows * N),
                    floor + 8 * npn))
        n = B * N
        for K, npn in crt:
            limbs = words(rng.integers(0, 1 << 32, size=(n, K),
                                       dtype=np.uint64))
            tb = g.crt_tb[:npn, :max(K, 3)].contiguous()
            tbs = g.crt_tb_shoup[:npn, :max(K, 3)].contiguous()
            args = (limbs, tb, tbs, g.primes[:npn])
            nbytes = 4 * (n * K + 2 * npn * K + npn + npn * n)
            # what the function needs, whatever the strategy: K products
            # and one fold of 3 Shoup products (the acc3 count)
            nmul = npn * n * (K + 9)
            for name, strategy in (
                    (("crt", "acc3"), ("crt_mod2", "mod2"),
                     ("crt_mod4", "mod4")) if variants
                    else (("crt", "acc3"),)):
                cases.append((
                    name, f"K={K} np={npn}{tag}",
                    lambda a=args, s=strategy: crt_op(*a, strategy=s),
                    lambda a=args, s=strategy: crt_ref(*a, strategy=s),
                    nbytes, nmul, None))
        for npn, out_limbs in icrt:
            tabs = device_icrt_tables(params, npn, dev)
            t = icrt_inputs(tabs, g)
            r = words(rng.integers(0, 1 << 62, size=(npn, n), dtype=np.uint64)
                      % primes[:npn, None])
            PL, A = tabs.plimbs, tabs.accum_limbs
            cases.append(("icrt", f"np={npn} out={out_limbs}{tag}",
                          lambda r=r, t=t, o=out_limbs: icrt_op(r, t, o),
                          lambda r=r, t=t, o=out_limbs: icrt_ref(r, t, o),
                          4 * (npn * n + npn * (3 + PL) + 2 * A
                               + n * out_limbs) + 8 * npn,
                          npn * n * (3 + PL), None))
    return cases


def edge_shapes(params, levels=None) -> tuple[list, list]:
    """The iCRT shapes (np, out limbs) and CRT shapes (K, np) of every
    level phase 2 checks (kernel_cases at logQ and each of
    circuit_levels(), or at `levels`) and of keygen
    (keygen_kernel_cases)."""
    icrt, crt = [], []
    for logq in levels or (params.logQ, *circuit_levels(params)):
        K, np1, np2, ks_limbs = level_shapes(params, logq)
        icrt += [(np1, K), (np2, ks_limbs)]
        crt += [(K, np1), (K, np2)]
    q2 = params.limbs_for_bits(2 * params.logQ)
    np_kk = params.np_for_bits(params.primes,
                               2 * params.logQ + params.logN + 3)
    icrt.append((np_kk, q2))
    crt += [(q2, np_kk), (q2, params.np_region2(params.logQ))]
    return icrt, crt


def icrt_edge_cases(torch, np, params, dev, shapes):
    """(label, kernel call, plain call) of iCRT on the inputs that decide
    its carries, its ±1 ladder and its center-lift, at every shape
    (np, out limbs) of `shapes`: every residue p_j − 1 (the largest column
    sums), every residue 0, and the residues of X = ⌊P/2⌋, ⌊P/2⌋ + 1,
    P − 1 and 1 in turn along N (P the product of the np primes, built
    with Python ints)."""
    from repro_torch.core.context import device_icrt_tables, device_tables
    from repro_torch.kernels.icrt.ops import icrt_op
    from repro_torch.kernels.icrt.ref import icrt_inputs, icrt_ref

    g = device_tables(params, dev)
    N = params.N
    primes = [int(v) for v in g.primes.cpu().numpy().view(np.uint32)]
    cases = []
    for B in (1, BATCH):
        n = B * N
        for npn, out_limbs in shapes:
            t = icrt_inputs(device_icrt_tables(params, npn, dev), g)
            P = 1
            for p in primes[:npn]:
                P *= p
            xs = (P // 2, P // 2 + 1, P - 1, 1)
            inputs = {
                "p-1": np.array(primes[:npn], np.uint64)[:, None] - 1,
                "zero": np.zeros((npn, 1), np.uint64),
                "P/2,P/2+1,P-1,1": np.array(
                    [[x % p for x in xs] for p in primes[:npn]], np.uint64),
            }
            for label, cols in inputs.items():
                r = torch.from_numpy(np.ascontiguousarray(
                    np.tile(cols, (1, n // cols.shape[1])).astype(np.uint32)
                ).view(np.int32)).to(dev)
                cases.append((f"np={npn} out={out_limbs}"
                               f"{'' if B == 1 else f' B={B}'} {label}",
                               lambda r=r, t=t, o=out_limbs: icrt_op(r, t, o),
                               lambda r=r, t=t, o=out_limbs: icrt_ref(r, t,
                                                                      o)))
    return cases


def crt_edge_cases(torch, np, params, dev, shapes):
    """(kernel, label, kernel call, plain call) of CRT and its variants at
    every shape (K, np) of `shapes`, on every limb 0xFFFFFFFF (the largest
    three-word sum, and the largest two-word sum of Mod-4, below 2^64) and
    every limb 0."""
    from repro_torch.core.context import device_tables
    from repro_torch.kernels.crt.ops import crt_op
    from repro_torch.kernels.crt.ref import crt_ref

    g = device_tables(params, dev)
    N = params.N
    cases = []
    for B in (1, BATCH):
        for label, word in (("all 0xFFFFFFFF", -1), ("all 0", 0)):
            for K, npn in shapes:
                x = torch.full((B * N, K), word, dtype=torch.int32,
                               device=dev)
                args = (x, g.crt_tb[:npn, :max(K, 3)].contiguous(),
                        g.crt_tb_shoup[:npn, :max(K, 3)].contiguous(),
                        g.primes[:npn])
                for name, strategy in (("crt", "acc3"), ("crt_mod2", "mod2"),
                                       ("crt_mod4", "mod4")):
                    cases.append((
                        name, f"K={K} np={npn}{'' if B == 1 else f' B={B}'}"
                        f" {label}",
                        lambda a=args, s=strategy: crt_op(*a, strategy=s),
                        lambda a=args, s=strategy: crt_ref(*a, strategy=s)))
    return cases


def check_edges(torch, np, params, dev, levels=None,
                verbose=True) -> dict:
    """Phase 2 (and 9c, at `levels`), the edge inputs of iCRT and of CRT
    and its variants at every shape of edge_shapes(): each kernel equals
    its plain version. Returns kernel -> rows."""
    icrt_shapes, crt_shapes = edge_shapes(params, levels)
    cases = [("icrt", *c) for c in icrt_edge_cases(torch, np, params, dev,
                                                   icrt_shapes)]
    rows: dict = {}
    for name, label, kern, plain in cases + crt_edge_cases(
            torch, np, params, dev, crt_shapes):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        require(got.shape == want.shape and torch.equal(got, want),
                f"{name} {label}: kernel differs from its plain version "
                f"(max abs err {err})")
        rows.setdefault(name, []).append({"input": label,
                                          "max_abs_err": err})
        if verbose:
            print(f"kernel {name} edge {label}: bitwise ok", flush=True)
    return rows


def check_kernels(torch, np, params, dev, flush) -> dict:
    """Phase 2: every kernel against its plain version, and their times,
    at every shape of the top level (variants too), of the levels the
    circuit path descends to and of keygen. A row's `level` is its logq,
    or "keygen"."""
    per_kernel = {}
    cases = [(params.logQ, c) for c in kernel_cases(torch, np, params, dev)]
    for logq in circuit_levels(params):
        cases += [(logq, c) for c in kernel_cases(torch, np, params, dev,
                                                  logq, variants=False)]
    cases += [("keygen", c) for c in keygen_kernel_cases(torch, np, params,
                                                         dev)]
    for level, (name, shape, kern, plain, nbytes, nmul, floor) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        require(got.shape == want.shape and torch.equal(got, want),
                f"{name} {shape}: kernel differs from its plain version "
                f"(max abs err {err})")
        b_ms, b_by = bound_ms(nbytes, nmul)
        row = {"shape": shape, "level": level,
               "batch": BATCH if "B=" in shape else 1,
               "max_abs_err": err,
               "ms": time_ms(torch, kern, 20, flush),
               "plain_ms": time_ms(torch, plain, 3, flush),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "int32_muls": nmul,
               **({} if floor is None else {"two_pass_bytes": floor})}
        per_kernel.setdefault(name, []).append(row)
        print(f"kernel {name:13s} {level!s:6s} {shape:20s} bitwise ok  "
              f"{row['ms']:.4f} ms  plain {row['plain_ms']:.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return per_kernel


def check_geometry_repairs(torch, np, dev) -> dict:
    """Phase 2, the two launch-geometry repairs: the batched step at
    test_params() for B = 3, 5 and 9 (B·N = 96, 160 and 288 are above one
    iCRT block and not a multiple of it, 288 also so for CRT's block)
    equals per-pair he_mul, through the kernels; NTT → iNTT of 70000 rows of 16 words (beyond gridDim.y's
    65535) equals the plain versions bit for bit."""
    from repro_torch.core import heaan as H
    from repro_torch.core.context import make_context
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import test_params
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.kernels.ntt.ops import intt_op, ntt_op
    from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref

    p = test_params()
    sk, pk, evk = keygen(p, seed=3, device=dev)
    rng = np.random.default_rng(4)
    cts = [H.encrypt_message(rng.random(8) + 1j * rng.random(8), pk, p,
                             seed=20 + i) for i in range(18)]
    st = hp.he_static(p, p.logQ)
    tabs = hp.runtime_tables(make_context(p, p.logQ, dev), evk)
    step = hp.make_he_mul_step(st, dev, use_kernels=True)
    for B in (3, 5, 9):
        ax, bx = step(*tabs, *[torch.stack([getattr(c, f) for c in
                                            cts[s:2 * B:2]])
                               for s, f in ((0, "ax"), (0, "bx"), (1, "ax"),
                                            (1, "bx"))])
        for i in range(B):
            ref = H.he_mul(cts[2 * i], cts[2 * i + 1], evk, p)
            require(torch.equal(ax[i], ref.ax) and torch.equal(bx[i], ref.bx),
                    f"batched step at test_params(), B={B}: pair {i} "
                    f"differs from he_mul")
        print(f"batched step at test_params() B={B} (B·N={B * p.N}) == "
              f"he_mul per pair", flush=True)

    p4 = test_params(logN=4, logQ=96)
    g = make_context(p4, p4.logQ, dev).tables
    npn, rows = 2, 70000
    p_rows = np.tile(g.primes[:npn].cpu().numpy().view(np.uint32),
                     rows // npn).astype(np.uint64)
    x = torch.from_numpy((rng.integers(0, 1 << 62, size=(rows, 16),
                                       dtype=np.uint64) % p_rows[:, None])
                         .astype(np.uint32).view(np.int32)).to(dev)
    fwd = (g.psi_rev[:npn], g.psi_rev_shoup[:npn], g.primes[:npn])
    inv = (g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn], g.n_inv[:npn],
           g.n_inv_shoup[:npn], g.primes[:npn])
    ev = ntt_op(x, *fwd)
    back = intt_op(ev, *inv)
    torch.cuda.synchronize()
    require(torch.equal(ev, ntt_ref(x, *fwd))
            and torch.equal(back, intt_ref(ev, *inv))
            and torch.equal(back, x),
            f"NTT → iNTT of {rows} rows differs from the plain versions")
    print(f"NTT → iNTT of {rows} rows of 16 words == plain versions",
          flush=True)
    return {"batched_step_test_params": [3, 5, 9], "ntt_rows": rows}


def drive_main_path(torch, np, params, dev, common) -> dict:
    """Phase 3: the user's path through the scheme API, on the kernels."""
    from repro_torch.core import heaan as H
    from repro_torch.core.keys import keygen
    from repro_torch.core.rns import PipelineConfig

    n_slots = params.N // 4
    rng = np.random.default_rng(7)
    # real and imaginary parts uniform in [0, 1), as HEAAN's own tests
    # draw them (randomComplexArray)
    z1, z2 = (rng.random(n_slots) + 1j * rng.random(n_slots)
              for _ in range(2))

    common.reset_launches()
    t0 = time.perf_counter()
    sk, pk, evk = keygen(params, seed=0, device=dev)
    c1 = H.encrypt_message(z1, pk, params, seed=11)
    c2 = H.encrypt_message(z2, pk, params, seed=12)
    c3, mul_launches = launched(torch, common,
                                lambda: H.he_mul(c1, c2, evk, params))
    c4 = H.rescale(c3, params)
    c5 = H.he_add(c4, H.he_mod_down(c1, params, c4.logq))
    prod = H.decrypt_message(c4, sk, params)
    total = H.decrypt_message(c5, sk, params)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)

    require(all(launches[k] > 0 for k in HE_MUL_LAUNCHES),
            f"a kernel never launched on the main path: {launches}")
    require(mul_launches == HE_MUL_LAUNCHES,
            f"he_mul launched {mul_launches}, expected {HE_MUL_LAUNCHES}")
    err_mul = float(np.abs(prod - z1 * z2).max())
    err_sum = float(np.abs(total - (z1 * z2 + z1)).max())
    require(np.isfinite(prod).all() and prod.shape == (n_slots,),
            "decrypted product is not finite or has the wrong shape")
    # 1e-3 is tests/test_heaan.py's he_mul tolerance; a sum of two
    # ciphertexts gets twice its operands' tolerance, as there
    require(err_mul < 1e-3 and err_sum < 2e-3,
            f"decryption error {err_mul:.3e} (limit 1e-3) / {err_sum:.3e} "
            f"(limit 2e-3)")
    plain = H.he_mul(c1, c2, evk, params, PipelineConfig(use_kernels=False))
    require(torch.equal(plain.ax, c3.ax) and torch.equal(plain.bx, c3.bx),
            "he_mul through the kernels differs from the plain path")
    print(f"main path ok in {path_s:.2f} s: max |err| product {err_mul:.3e}"
          f", product+z1 {err_sum:.3e}; launches {launches}; he_mul "
          f"{mul_launches}; kernel he_mul == plain he_mul", flush=True)
    return {"launches": launches, "he_mul_launches": mul_launches,
            "err_mul": err_mul, "err_sum": err_sum, "path_s": path_s,
            "operands": (c1, c2, evk), "pk": pk, "sk": sk}


def drive_batched_step(torch, np, params, dev, common, pk, evk) -> dict:
    """Phase 4: the batched HE Mul step on three rungs of the paper's
    ladder."""
    from repro_torch.core import heaan as H
    from repro_torch.core.context import make_context
    from repro_torch.dist import he_pipeline as hp

    cts = random_ciphertexts(torch, np, params, pk, dev,
                             range(100, 100 + 2 * BATCH))
    refs = [H.he_mul(cts[2 * i], cts[2 * i + 1], evk, params)
            for i in range(BATCH)]
    st = hp.he_static(params, params.logQ)
    tabs = hp.runtime_tables(make_context(params, params.logQ, dev), evk)

    def args(B):
        return [torch.stack([getattr(c, f) for c in cts[s:2 * B:2]])
                for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]

    def check(out, B, what):
        for i in range(B):
            require(torch.equal(out[0][i], refs[i].ax)
                    and torch.equal(out[1][i], refs[i].bx),
                    f"batched step {what}: pair {i} differs from he_mul")

    steps = {name: hp.make_he_mul_step(st, dev, use_kernels=True, **kw)
             for name, (kw, _) in RUNGS.items()}
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    outs, rung_launches = {}, {}
    for name, step in steps.items():
        outs[name], rung_launches[name] = launched(
            torch, common, lambda s=step: s(*tabs, *args(BATCH)))
    out3 = steps["default"](*tabs, *args(3))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)

    require(all(launches[k] > 0 for _, want in RUNGS.values()
                for k in want),
            f"a kernel never launched in the batched step: {launches}")
    for name, (_, want) in RUNGS.items():
        require(rung_launches[name] == want,
                f"rung {name} launched {rung_launches[name]}, expected "
                f"{want}")
        check(outs[name], BATCH, name)
    check(out3, 3, "default at B=3")
    plain = hp.make_he_mul_step(st, dev, crt_strategy="acc3",
                                icrt_strategy="acc3")(*tabs, *args(BATCH))
    require(torch.equal(plain[0], outs["default"][0])
            and torch.equal(plain[1], outs["default"][1]),
            "batched step through the kernels differs from the plain step")

    times = {}
    for name, step in steps.items():
        a = args(BATCH)
        med, ms = median_ms(torch, lambda s=step, a=a: s(*tabs, *a))
        times[name] = {"ms_per_step": med, "ms_per_he_mul": med / BATCH,
                       "ms": ms}
        print(f"batched step {name:14s} B={BATCH}: {med:.2f} ms per step, "
              f"{med / BATCH:.2f} ms per HE Mul; == he_mul per pair; "
              f"launches {rung_launches[name]}", flush=True)
    print(f"batched step ok in {path_s:.2f} s: launches {launches}; B=3 ok; "
          f"default rung == plain batched step", flush=True)
    return {"launches": launches, "rung_launches": rung_launches,
            "path_s": path_s, "times": times,
            "profile_step": lambda: steps["default"](*tabs, *args(BATCH))}


def drive_circuit_path(torch, np, params, dev, common, sk, pk, evk
                       ) -> dict:
    """Phase 6: the circuit path at `params` on phase 3's keys.

    Galois keygen (rotations CIRCUIT_ROTATIONS and conjugation); circuit A
    (the degree-4 demo circuit, N/4 slots), circuit B (the affine layer,
    AFFINE_SLOTS slots) and circuit C (B's first two nodes, then mod_raise
    from logQ − logp to logQ) through execute_circuit_reference on the
    kernels, each with its launches as OP_LAUNCHES derives them, then on
    the plain path: the words must agree; A and B decrypt within the
    reference tests' limits. The launch counts are set to 0 just before
    and read just after the keygen and the circuits' kernel runs. Then
    each op alone (its launches as derived, its time). Then each batched
    step of hserve.engine at B = BATCH and logQ (the level ops at their
    natural targets; rotate on the "mod2+modified" rung too), run once
    with the counts set to 0 just before and read just after; each must
    equal the single-ciphertext op on every item and launch what one op
    does, and is then timed."""
    from repro_torch.core import heaan as H
    from repro_torch.core import rotate as R
    from repro_torch.core.context import make_context
    from repro_torch.core.rns import PipelineConfig
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.hserve import circuit as C
    from repro_torch.hserve import engine as E

    phase_t0 = time.perf_counter()
    logQ, logp = params.logQ, params.logp
    logq1 = logQ - logp
    rng = np.random.default_rng(9)
    n_a = params.N // 4
    # drawn as phase 3 draws: real and imaginary parts uniform in [0, 1)
    z_a = rng.random(n_a) + 1j * rng.random(n_a)
    z_b, w, b = (rng.random(AFFINE_SLOTS) + 1j * rng.random(AFFINE_SLOTS)
                 for _ in range(3))

    def same(x, y):
        return (x.logq, x.logp) == (y.logq, y.logp) and torch.equal(
            x.ax, y.ax) and torch.equal(x.bx, y.bx)

    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    mem0 = torch.cuda.memory_allocated()
    rks = {r: R.rot_keygen(params, sk, r, device=dev)
           for r in CIRCUIT_ROTATIONS}
    ck = R.conj_keygen(params, sk, device=dev)
    torch.cuda.synchronize()
    key_bytes = torch.cuda.memory_allocated() - mem0
    keygen_s = time.perf_counter() - t0
    keys = {"evk": evk, "rot_keys": rks, "conj_key": ck}
    x_a = H.encrypt_message(z_a, pk, params, seed=31)
    x_b = H.encrypt_message(z_b, pk, params, seed=32)
    ops_b = C.affine_demo_circuit(params, w, b, device=dev)
    circuits = {
        "A": (C.degree4_demo_circuit(params)[0], x_a),
        "B": (ops_b, x_b),
        "C": (ops_b[:2] + [C.CircuitOp("mod_raise", (1,), logq2=logQ)], x_b),
    }
    kern, plain = PipelineConfig(use_kernels=True), PipelineConfig(
        use_kernels=False)
    outs, circuit_launches, circuit_ms = {}, {}, {}
    for name, (ops, x) in circuits.items():
        t1 = time.perf_counter()
        outs[name], circuit_launches[name] = launched(
            torch, common, lambda o=ops, x=x: C.execute_circuit_reference(
                o, {"x": x}, params, **keys, cfg=kern))
        circuit_ms[name] = (time.perf_counter() - t1) * 1e3
        _, _, nslots = C.circuit_schedule(ops, {"x": (x.logq, x.logp)},
                                          {"x": x.n_slots}, params)
        want = summed(*[
            scaled(OP_LAUNCHES["rotate"],
                   len(E.slot_sum_rotations(nslots[i])))
            if node.op == "slot_sum" else OP_LAUNCHES[node.op]
            for i, node in enumerate(ops)])
        require(circuit_launches[name] == want,
                f"circuit {name} launched {circuit_launches[name]}, "
                f"expected {want}")
    path_s = time.perf_counter() - t0
    launches = dict(common.LAUNCHES)
    require(all(launches[k] > 0 for k in HE_MUL_LAUNCHES),
            f"a kernel never launched on the circuit path: {launches}")
    require(key_bytes < 1.5e9, f"Galois keys take {key_bytes} bytes")

    for name, (ops, x) in circuits.items():
        ref = C.execute_circuit_reference(ops, {"x": x}, params, **keys,
                                          cfg=plain)
        require(same(outs[name], ref),
                f"circuit {name} through the kernels differs from the "
                f"plain path")
        print(f"circuit {name}: kernels == plain path bit for bit; "
              f"launches {circuit_launches[name]}", flush=True)
    require(outs["C"].logq == logQ, "circuit C did not end at logQ")
    got_a = H.decrypt_message(outs["A"], sk, params)
    got_b = H.decrypt_message(outs["B"], sk, params)
    want_b = (np.roll(w * z_b + b, -1) - z_b).sum()
    err = {"A": float(np.abs(got_a - (np.conj(z_a ** 4) + z_a)).max()),
           "B": float(np.abs(got_b - want_b).max())}
    # the reference tests' limits: tests/test_hserve.py:498 (degree-4
    # circuit) and tests/test_rotate.py:60 (slot sum)
    limits = {"A": 0.3, "B": 1e-2}
    for name in err:
        print(f"circuit {name}: max |err| {err[name]:.3e} (limit "
              f"{limits[name]})", flush=True)
        require(err[name] < limits[name],
                f"circuit {name} decrypts {err[name]:.3e} off (limit "
                f"{limits[name]})")

    # ---- each op alone: launches as derived, time -----------------------
    x_low = H.he_mod_down(x_b, params, logq1)
    pt = ops_b[0].pt
    single = {
        "rotate": lambda: R.he_rotate(x_b, 1, rks[1], params),
        "conjugate": lambda: R.he_conjugate(x_b, ck, params),
        "mul_plain": lambda: H.he_mul_plain(x_b, pt, params,
                                            pt_logp=logp),
        "rescale": lambda: H.rescale(x_b, params),
        "mod_raise": lambda: H.he_mod_raise(x_low, params, logQ),
        "add": lambda: H.he_add(x_b, x_a),
    }
    op_ms, op_launches = {}, {}
    for op, fn in single.items():
        _, op_launches[op] = launched(torch, common, fn)
        require(op_launches[op] == OP_LAUNCHES[op],
                f"{op} launched {op_launches[op]}, expected "
                f"{OP_LAUNCHES[op]}")
        op_ms[op] = median_ms(torch, fn)
        print(f"op {op:10s} {op_ms[op][0]:.3f} ms (median of 5); launches "
              f"{op_launches[op]}", flush=True)

    # ---- the batched steps at B = BATCH and logQ -------------------------
    cts = random_ciphertexts(torch, np, params, pk, dev,
                             range(200, 200 + 2 * BATCH))
    pts = [H.encode_plain(rng.random(AFFINE_SLOTS), params, logQ,
                          device=dev) for _ in range(BATCH)]
    low = [H.he_mod_down(c, params, logq1) for c in cts[:BATCH]]
    st, st1 = hp.he_static(params, logQ), hp.he_static(params, logq1)
    t1, t2, _ = hp.runtime_tables(make_context(params, logQ, dev), evk)
    tk = {r: hp.evk_tables(k) for r, k in rks.items()}
    tk["conj"] = hp.evk_tables(ck)
    ax, bx = (torch.stack([getattr(c, f) for c in cts[:BATCH]])
              for f in ("ax", "bx"))
    ax2, bx2 = (torch.stack([getattr(c, f) for c in cts[BATCH:]])
                for f in ("ax", "bx"))
    ptb = torch.stack(pts)
    lax, lbx = (torch.stack([getattr(c, f) for c in low])
                for f in ("ax", "bx"))
    ss = E.slot_sum_rotations(AFFINE_SLOTS)
    on = {"use_kernels": True}
    mod2 = {"use_kernels": True, "crt_strategy": "mod2",
            "modified_shoup": True}

    def slot_sum(c):
        for r in ss:
            c = H.he_add(c, R.he_rotate(c, r, rks[r], params))
        return c

    steps = {
        "rotate": (E.make_he_rotate_step(st, dev, R.rotation_k(params, 1),
                                         **on),
                   (t2, tk[1], ax, bx),
                   lambda i: R.he_rotate(cts[i], 1, rks[1], params),
                   GALOIS_LAUNCHES),
        "rotate mod2+modified": (
            E.make_he_rotate_step(st, dev, R.rotation_k(params, 1), **mod2),
            (t2, tk[1], ax, bx),
            lambda i: R.he_rotate(cts[i], 1, rks[1], params),
            {"crt_mod2": 1, "ntt_modified": 1, "intt_modified": 2,
             "icrt": 2}),
        "conjugate": (E.make_he_rotate_step(st, dev, R.conjugation_k(params),
                                            **on),
                      (t2, tk["conj"], ax, bx),
                      lambda i: R.he_conjugate(cts[i], ck, params),
                      GALOIS_LAUNCHES),
        "slot_sum": (E.make_slot_sum_step(st, dev, AFFINE_SLOTS, **on),
                     (t2, tuple(tk[r] for r in ss), ax, bx),
                     lambda i: slot_sum(cts[i]),
                     scaled(GALOIS_LAUNCHES, len(ss))),
        "rescale": (E.make_rescale_step(st, dev, logp, **on), (ax, bx),
                    lambda i: H.rescale(cts[i], params), {}),
        "mod_down": (E.make_mod_down_step(st, dev, logq1, **on), (ax, bx),
                     lambda i: H.he_mod_down(cts[i], params, logq1), {}),
        "mod_raise": (E.make_mod_raise_step(st1, dev, logQ, **on),
                      (lax, lbx),
                      lambda i: H.he_mod_raise(low[i], params, logQ), {}),
        "add": (E.make_addsub_step(st, dev, "add", **on), (ax, bx, ax2, bx2),
                lambda i: H.he_add(cts[i], cts[BATCH + i]), {}),
        "sub": (E.make_addsub_step(st, dev, "sub", **on), (ax, bx, ax2, bx2),
                lambda i: H.he_sub(cts[i], cts[BATCH + i]), {}),
        "mul_plain": (E.make_mul_plain_step(st, dev, **on),
                      (t1, ax, bx, ptb),
                      lambda i: H.he_mul_plain(cts[i], pts[i], params),
                      OP_LAUNCHES["mul_plain"]),
        "add_plain": (E.make_add_plain_step(st, dev, **on), (ax, bx, ptb),
                      lambda i: H.he_add_plain(cts[i], pts[i], params), {}),
    }
    torch.cuda.synchronize()
    common.reset_launches()
    step_outs, step_launches = {}, {}
    for name, (step, args, _, _) in steps.items():
        step_outs[name], step_launches[name] = launched(
            torch, common, lambda s=step, a=args: s(*a))
    steps_path_launches = dict(common.LAUNCHES)
    require(all(steps_path_launches[k] > 0
                for k in summed(*(want for *_, want in steps.values()))),
            f"a kernel or variant of the per-op steps never launched: "
            f"{steps_path_launches}")
    step_ms = {}
    for name, (step, args, ref, want) in steps.items():
        out = step_outs[name]
        require(step_launches[name] == want,
                f"step {name} launched {step_launches[name]}, expected "
                f"{want}")
        for i in range(BATCH):
            r = ref(i)
            require(torch.equal(out[0][i], r.ax)
                    and torch.equal(out[1][i], r.bx),
                    f"step {name}: item {i} differs from the "
                    f"single-ciphertext op")
        med, ms = median_ms(torch, lambda s=step, a=args: s(*a))
        step_ms[name] = {"ms_per_step": med, "ms_per_ct": med / BATCH,
                         "ms": ms}
        print(f"step {name:20s} B={BATCH}: {med:.3f} ms per step, "
              f"{med / BATCH:.3f} ms per ciphertext; == single op per item; "
              f"launches {step_launches[name]}", flush=True)
    return {"phase_s": time.perf_counter() - phase_t0,
            "launches": launches, "steps_launches": steps_path_launches,
            "circuit_launches": circuit_launches,
            "circuit_ms": circuit_ms, "path_s": path_s,
            "keygen_s": keygen_s, "key_bytes": key_bytes,
            "err": err, "limits": limits,
            "op_ms": {k: {"median": v[0], "ms": v[1]}
                      for k, v in op_ms.items()},
            "op_launches": op_launches, "step_ms": step_ms,
            "step_launches": step_launches,
            "profile_rotate": lambda: R.he_rotate(x_b, 1, rks[1], params),
            "keys": (rks, ck)}


def moved(x, device):
    """A ciphertext or tensor on `device` (itself when it lies there)."""
    import torch
    from repro_torch.core.cipher import Ciphertext
    if isinstance(x, (Ciphertext, torch.Tensor)):
        return x.to(device)
    return x


def same_ct(x, y) -> bool:
    """Whether two ciphertexts are equal word for word (compared on y's
    device) at the same level and scale."""
    import torch
    return (x.logq, x.logp) == (y.logq, y.logp) and torch.equal(
        x.ax.to(y.ax.device), y.ax) and torch.equal(x.bx.to(y.bx.device),
                                                     y.bx)


def sync(torch, dev) -> None:
    """Wait for the card (nothing to wait for on the CPU, where phase 11's
    ranks rehearse)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_stream(torch, server, reqs, circs) -> tuple:
    """Phase 7's stream on `server` (an HEServer or an HEFrontend): the
    requests, the first circuit, one flush (the two degree-4 circuits run
    out of phase), the rest, a drain. Operands are moved to the server's
    device first, outside the timed span. Returns the results in submit
    order and the drain wall."""
    import dataclasses
    dev = server.device
    calls = [(getattr(server, meth), [moved(a, dev) for a in args],
              {k: moved(v, dev) for k, v in kw.items()})
             for _, meth, args, kw, _, _ in reqs]
    cins = [([dataclasses.replace(o, pt=moved(o.pt, dev)) for o in ops],
             moved(x, dev)) for _, ops, x, _, _ in circs]
    sync(torch, dev)
    t0 = time.perf_counter()
    rids = [f(*a, **kw) for f, a, kw in calls]
    cids = [server.submit_circuit(cins[0][0], {"x": cins[0][1]})]
    res = dict(server.poll(flush=True))
    cids += [server.submit_circuit(ops, {"x": x}) for ops, x in cins[1:]]
    res.update(server.drain())
    sync(torch, dev)
    wall = time.perf_counter() - t0
    require(not server.queue.depth and not server._work_pending()
            and not server._circuits, "a request was left queued")
    return [res[r] for r in rids + cids], wall


def drive_serving_path(torch, np, params, dev, common, sk, pk, evk, rks,
                       ck) -> dict:
    """Phase 7: HEServer at `params` on phase 3's and phase 6's keys (see
    the module docstring)."""
    from repro_torch.core import heaan as H
    from repro_torch.core import rotate as R
    from repro_torch.core.encoding import message_hash
    from repro_torch.hserve import HEServer
    from repro_torch.hserve import circuit as C
    from repro_torch.launch.serve import serve_he

    phase_t0 = time.perf_counter()
    logQ, logp = params.logQ, params.logp
    logqs = [logQ - i * logp for i in range(SERVE_LEVELS)]
    rng = np.random.default_rng(17)
    n = AFFINE_SLOTS

    def msg():
        # drawn as phase 3 draws: real and imaginary parts uniform in [0, 1)
        return rng.random(n) + 1j * rng.random(n)

    # a pool of 4 ciphertexts a level, which the requests share
    pool = []
    for lvl, logq in enumerate(logqs):
        row = []
        for k in range(4):
            z = msg()
            ct = H.encrypt_message(z, pk, params, seed=500 + 4 * lvl + k)
            row.append((z, H.he_mod_down(ct, params, logq)
                        if logq < logQ else ct))
        pool.append(row)
    ws = [msg() for _ in logqs]
    pts = [H.encode_plain(w, params, logq, device=dev)
           for w, logq in zip(ws, logqs)]
    h0 = message_hash(ws[0], params.log_delta)
    n_mul = SERVE_REQUESTS - SERVE_ROTATIONS - SERVE_CONJUGATIONS
    n_plain = int(round(SERVE_PLAIN_FRAC * n_mul))
    # (label, HEServer submit method, its operands and keywords, the single
    #  op on the kernels, expected slots)
    reqs = []
    for i in range(SERVE_REQUESTS):
        lvl = i % SERVE_LEVELS
        a = (i // SERVE_LEVELS) % 4
        (za, ca), (zb, cb) = pool[lvl][a], pool[lvl][(a + 1) % 4]
        if i < n_plain:
            # level 0 registers w₀ by hash (a mul_plain), then serves an
            # add_plain by hash alone; the other levels send their operand
            op = "mul_plain" if i % 2 == 0 else "add_plain"
            kw = ({"pt": pts[0], "pt_hash": h0} if i == 0 else
                  {"pt_hash": h0} if lvl == 0 else {"pt": pts[lvl]})
            ref = (H.he_mul_plain(ca, pts[lvl], params) if op == "mul_plain"
                   else H.he_add_plain(ca, pts[lvl], params))
            want = za * ws[lvl] if op == "mul_plain" else za + ws[lvl]
            reqs.append((f"{op}@{logqs[lvl]}", f"submit_{op}", (ca,), kw,
                         ref, want))
        elif i < n_mul:
            reqs.append((f"mul@{logqs[lvl]}", "submit_mul", (ca, cb), {},
                         H.he_mul(ca, cb, evk, params), za * zb))
        elif i < n_mul + SERVE_ROTATIONS:
            reqs.append((f"rotate@{logqs[lvl]}", "submit_rotate", (ca, 1),
                         {}, R.he_rotate(ca, 1, rks[1], params),
                         np.roll(za, -1)))
        else:
            reqs.append((f"conjugate@{logqs[lvl]}", "submit_conjugate",
                         (ca,), {}, R.he_conjugate(ca, ck, params),
                         np.conj(za)))
    keys = {"evk": evk, "rot_keys": rks, "conj_key": ck}
    ops_a = C.degree4_demo_circuit(params)[0]
    w_b, b_b = msg(), msg()
    ops_b = C.affine_demo_circuit(params, w_b, b_b, device=dev)
    circs = []
    for name, ops, seed in (("A1", ops_a, 601), ("A2", ops_a, 602),
                            ("B", ops_b, 603)):
        z = msg()
        x = H.encrypt_message(z, pk, params, seed=seed)
        want = (np.conj(z ** 4) + z if ops is ops_a
                else (np.roll(w_b * z + b_b, -1) - z).sum())
        circs.append((name, ops, x, want,
                      C.execute_circuit_reference(ops, {"x": x}, params,
                                                  **keys)))

    def serve(server):
        return serve_stream(torch, server, reqs, circs)

    same = same_ct

    server = HEServer(params, evk, rks, ck, device=dev, batch=SERVE_BATCH,
                      schedule=True)
    common.reset_launches()
    outs, first_wall = serve(server)
    launches = dict(common.LAUNCHES)
    require(all(launches[k] > 0 for k in SERVE_KERNELS),
            f"a kernel never launched on the served path: {launches}")
    refs = [r[4] for r in reqs] + [c[4] for c in circs]
    labels = [r[0] for r in reqs] + [f"circuit {c[0]}" for c in circs]
    for label, got, ref in zip(labels, outs, refs):
        require(same(got, ref), f"served {label} differs from the "
                f"single-ciphertext op (or execute_circuit_reference)")
    errs = {}
    for label, got, want in zip(labels, outs, [r[5] for r in reqs]
                                + [c[3] for c in circs]):
        if label.startswith("mul"):
            got = H.rescale(got, params)
        err = float(np.abs(H.decrypt_message(got, sk, params) - want).max())
        kind = label.split("@")[0]
        errs[kind] = max(errs.get(kind, 0.0), err)
    # serve_he's limit for every request; phase 6's for the circuits
    limits = {k: (0.3 if k.startswith("circuit A") else 1e-2) for k in errs}
    for k, err in errs.items():
        require(err < limits[k], f"served {k} decrypts {err:.3e} off "
                f"(limit {limits[k]})")
    print(f"serving: {len(outs)} results == single ops and "
          f"execute_circuit_reference bit for bit; launches {launches}; "
          f"max |err| {errs}", flush=True)

    # ---- steady state, in turns: no overlap, overlap, overlap, none ------
    dispatch = server.engine.dispatch
    sync_checked = [0]

    def strict(batch):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            sync_checked[0] += 1

    server.engine.dispatch = strict
    runs = []
    for overlap in (False, True, True, False):
        server.overlap = overlap
        server.reset_metrics()
        again, wall = serve(server)
        require(all(same(a, b) for a, b in zip(again, outs)),
                f"overlap={overlap} differs from the first drain")
        st = server.stats()
        n_ops = sum(d["requests"] for d in st["per_op"].values())
        runs.append({
            "overlap": overlap, "drain_s": wall,
            "results_per_s": len(again) / wall, "ops_per_s": n_ops / wall,
            "per_op": {op: {"requests": d["requests"],
                            "batches": d["batches"],
                            "pad_frac": d["pad_frac"],
                            "ms_per_batch": 1e3 * d["wall_s"] / d["batches"],
                            "p50_ms": d["latency_ms"]["p50"],
                            "p99_ms": d["latency_ms"]["p99"]}
                       for op, d in st["per_op"].items()},
            "flushes": st["flushes"], "cobatch": st["cobatch"],
            "scheduler": {k: st["scheduler"][k] for k in
                          ("deferrals", "prefetches", "prefetched_levels")},
            "cache": {k: st["cache"][k] for k in
                      ("hits", "misses", "plain_hits", "plain_misses")}})
        print(f"serving overlap={overlap}: drain {wall * 1e3:.1f} ms, "
              f"{len(again) / wall:.1f} results/s, {n_ops / wall:.1f} ops/s;"
              f" == first drain bit for bit; mul ms/batch "
              f"{runs[-1]['per_op']['mul']['ms_per_batch']:.2f}", flush=True)
    server.engine.dispatch = dispatch
    require(sync_checked[0] > 0, "no dispatch ran under the sync check")
    walls = {ov: [r["drain_s"] for r in runs if r["overlap"] == ov]
             for ov in (False, True)}

    # ---- Fig. 3: 4 mul batches and a rotate batch, stages fenced ----------
    prof = HEServer(params, evk, rks, ck, device=dev, batch=SERVE_BATCH,
                    profile_stages=True)
    row = [c for _, c in pool[0]]
    for k in range(4 * SERVE_BATCH):
        prof.submit_mul(row[k % 4], row[(k // 4) % 4])
    for k in range(SERVE_BATCH):
        prof.submit_rotate(row[k], 1)
    prof.drain()
    st = prof.stats()
    stages = st["stages"]
    fig3 = {}
    for op in ("mul", "rotate"):
        wall = st["per_op"][op]["wall_s"]
        total = prof.engine.stage_timer.stage_total(op)
        fig3[op] = {"batches": st["per_op"][op]["batches"],
                    "metered_wall_s": wall,
                    "stage_s": stages["stages"][op],
                    "calls": stages["calls"][op],
                    "regions_s": stages["regions"][op],
                    "stage_total_s": total, "coverage": total / wall}
        print(f"fig3[{op}]: " + " ".join(
            f"{k} {1e3 * v:.2f} ms" for k, v in stages["stages"][op].items())
            + f"; coverage {total / wall:.1%} of {1e3 * wall:.2f} ms "
            f"metered wall over {fig3[op]['batches']} batches", flush=True)

    # ---- serve_he at SMOKE, through the normal entry point --------------
    t0 = time.perf_counter()
    smoke = serve_he(SERVE_BATCH, levels=3, rotations=2, conjugations=1,
                     plain_frac=0.25, circuit=True, schedule=True,
                     device="cuda")
    smoke_s = time.perf_counter() - t0
    require(smoke["max_err"] < 1e-2,
            f"serve_he decrypts {smoke['max_err']:.3e} off (limit 1e-2)")
    print(f"serve_he at SMOKE on {smoke['device']}: max_err "
          f"{smoke['max_err']:.2e} in {smoke_s:.1f} s", flush=True)
    return {"phase_s": time.perf_counter() - phase_t0,
            "stream": (reqs, circs, outs, labels),
            "launches": launches, "first_drain_s": first_wall,
            "requests": len(reqs), "circuits": [c[0] for c in circs],
            "batch": SERVE_BATCH, "levels": logqs, "max_abs_err": errs,
            "limits": limits, "runs": runs,
            "drain_s_median": {str(ov).lower(): statistics.median(w)
                               for ov, w in walls.items()},
            "dispatches_sync_checked": sync_checked[0], "fig3": fig3,
            "serve_he_smoke": {"max_err": smoke["max_err"], "s": smoke_s,
                               "per_op": {op: d["requests"] for op, d in
                                          smoke["per_op"].items()},
                               "cobatch": smoke["cobatch"]}}


def drive_multihost_path(torch, np, params, dev, common, sk, pk, evk, rks,
                         ck, stream) -> dict:
    """Phase 8: the multi-host tier at `params` on phase 3's and phase 6's
    keys, serving phase 7's stream (see the module docstring)."""
    import warnings
    from repro_torch.analysis import analyze_handle
    from repro_torch.client import HESession, compile_handle
    from repro_torch.hserve import HEFrontend
    from repro_torch.hserve import circuit as C
    from repro_torch.runtime import FailureInjector

    phase_t0 = time.perf_counter()
    reqs, circs, outs, labels = stream
    kw = dict(workers=MULTIHOST_WORKERS, worker_device=str(dev),
              batch=SERVE_BATCH, schedule=True)

    def check_same(got, what):
        for label, a, b in zip(labels, got, outs):
            require(same_ct(a, b), f"{what}: {label} differs from phase "
                    f"7's HEServer result")

    def frames(fe):
        """Per mul batch: frame bytes and seconds (frontend and worker
        side)."""
        return [{"wid": w.wid, **f} for w in fe.workers
                for f in w.frame_log if f["op"] == "mul"]

    def transport(fe, wall):
        """The frontend thread's seconds on frames over a drain, summed
        from every batch's frame_log entry: send.* and recv.* but the wait
        for a reply's first bytes (the worker's own time)."""
        s, nbytes, n = {}, 0, 0
        for w in fe.workers:
            for f in w.frame_log:
                n += 1
                for side in ("send", "recv"):
                    nbytes += f[side]["bytes"]
                    for k, v in f[side].items():
                        if k != "bytes":
                            s[f"{side}.{k}"] = s.get(f"{side}.{k}", 0.0) + v
        framed = sum(v for k, v in s.items() if k != "recv.wait_s")
        return {"batches": n, "bytes": nbytes, "s": s, "framed_s": framed,
                "share": framed / wall}

    def workers_of(fe, wall):
        return [{"wid": w.wid, "batches": w.batches,
                 "served_requests": w.served_requests, "busy_s": w.busy_s,
                 "busy_share": w.busy_s / wall, "init_s": w.init_s,
                 "init_bytes": w.init_bytes, "init_send_s": w.init_send_s}
                for w in fe.workers]

    # ---- subprocess workers: a kill mid-batch, requeue, revive, timed ----
    t0 = time.perf_counter()
    fe = HEFrontend(params, evk, rks, ck, transport="subprocess",
                    injector=FailureInjector(kill_worker_at={0: 2}), **kw)
    sub = {"start_s": time.perf_counter() - t0,
           "init": workers_of(fe, 1.0)}
    try:
        dead = fe.workers[0].transport.proc
        got, sub["kill_drain_s"] = serve_stream(torch, fe, reqs, circs)
        check_same(got, "subprocess frontend, worker 0 killed")
        fr = fe.stats()["frontend"]
        require(fr["deaths"] == 1 and fr["requeued_requests"] > 0
                and fr["alive"] == MULTIHOST_WORKERS - 1
                and dead.poll() is not None,
                f"the kill did not take one worker down: {fr}")
        sub["kill"] = {k: fr[k] for k in ("deaths", "requeued_requests")}
        fe.injector = None
        t0 = time.perf_counter()
        fe.revive_workers()
        sub["revive_s"] = time.perf_counter() - t0
        sub["revive_init"] = workers_of(fe, 1.0)[0]
        require(fe.stats()["frontend"]["alive"] == MULTIHOST_WORKERS
                and fe.workers[0].transport.proc is not dead,
                "revive_workers did not restore the worker")
        got, sub["revived_drain_s"] = serve_stream(torch, fe, reqs, circs)
        check_same(got, "subprocess frontend after revive_workers")
        require(bool(fe.workers[0].keys_warm),
                "the respawned worker took no batch")
        print(f"multihost subprocess: worker 0 killed at its 2nd batch, "
              f"{sub['kill']['requeued_requests']} requests requeued, "
              f"results == phase 7 bit for bit; revived in "
              f"{sub['revive_s']:.2f} s (init frame "
              f"{sub['revive_init']['init_bytes'] / 1e6:.1f} MB), its "
              f"batches == phase 7", flush=True)

        # the timed run: the workers' counts set to 0 just before it and
        # read just after
        fe.reset_metrics()
        fe.worker_stats(reset_launches=True)
        got, sub["drain_s"] = serve_stream(torch, fe, reqs, circs)
        snaps = fe.worker_stats()
        check_same(got, "subprocess frontend")
        sub["launches"] = {wid: {k: v for k, v in snap["kernels"].items()
                                 if v} for wid, snap in snaps.items()}
        sub_total = summed(*sub["launches"].values())
        require(all(sub_total.get(k, 0) > 0 for k in SERVE_KERNELS),
                f"a kernel never launched inside the workers: "
                f"{sub['launches']}")
        sub["workers"] = workers_of(fe, sub["drain_s"])
        sub["transport"] = transport(fe, sub["drain_s"])
        sub["mul_frames"] = frames(fe)
        sub["per_op"] = {op: {"batches": d["batches"],
                              "ms_per_batch": 1e3 * d["wall_s"]
                              / d["batches"]}
                         for op, d in fe.stats()["per_op"].items()}

        # ---- a traced client over the subprocess frontend ----------------
        session = HESession(params, sk, pk, evk, server=fe, device=dev)
        rng = np.random.default_rng(29)
        n = AFFINE_SLOTS
        wz = 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        handles, wants = [], []
        for j in range(TRACED_EXPRS):
            zt = 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
            x = session.encrypt(zt, seed=5555 + j)
            handles.append(((x * x) * wz + x).rotate(1).conj().slot_sum())
            wants.append(np.full(n, np.conj(np.roll(zt * zt * wz + zt,
                                                    -1)).sum()))
        reports = [analyze_handle(h, params, compiled=session.compile(h))
                   for h in handles]
        for j, r in enumerate(reports):
            print(r.render(f"traced expression {j}"), flush=True)
        flagged = any(r.errors or r.warnings for r in reports)
        refused = None
        if flagged:
            # check="error" must refuse before anything is enqueued
            try:
                session.run(handles, check="error")
            except ValueError as e:
                refused = str(e)
            require(refused is not None and not fe.queue.depth
                    and not fe._circuits,
                    "check='error' let a flagged run through")
            print(f"check='error' refused the run, nothing enqueued: "
                  f"{refused[:160]}", flush=True)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            futs = session.run(handles,
                               check="warn" if flagged else "error")
        t_err = []
        for h, fut, want in zip(handles, futs, wants):
            got_ct = fut.result()
            cc = compile_handle(h, params, device=dev)
            ref = C.execute_circuit_reference(cc.ops, cc.inputs, params,
                                              evk=evk, rot_keys=rks,
                                              conj_key=ck)
            require(same_ct(got_ct, ref), "a traced result differs from "
                    "execute_circuit_reference of its compiled ops")
            t_err.append(float(np.abs(session.decrypt(got_ct)
                                      - want).max()))
        require(max(t_err) < 1e-2,
                f"traced results decrypt {max(t_err):.3e} off (limit 1e-2)")
        traced = {"expressions": TRACED_EXPRS, "slots": n,
                  "reports": [r.to_dict() for r in reports],
                  "check_error_refused": refused, "max_abs_err": t_err}
        print(f"traced client over the subprocess frontend: "
              f"{TRACED_EXPRS} expressions == execute_circuit_reference "
              f"bit for bit, max |err| {max(t_err):.2e}", flush=True)
    finally:
        fe.close()

    # ---- one subprocess worker, for the comparison ----------------------
    fe1 = HEFrontend(params, evk, rks, ck, transport="subprocess",
                     **{**kw, "workers": 1})
    try:
        serve_stream(torch, fe1, reqs, circs)                 # warm
        got, one_wall = serve_stream(torch, fe1, reqs, circs)
        check_same(got, "one subprocess worker")
    finally:
        fe1.close()

    # ---- in-process workers on the card --------------------------------
    fe2 = HEFrontend(params, evk, rks, ck, transport="inproc", **kw)
    try:
        got, _ = serve_stream(torch, fe2, reqs, circs)        # warm
        check_same(got, "in-process frontend, first drain")
        fe2.reset_metrics()
        common.reset_launches()
        got, inproc_wall = serve_stream(torch, fe2, reqs, circs)
        inproc_launches = {k: v for k, v in common.LAUNCHES.items() if v}
        check_same(got, "in-process frontend")
        require(all(inproc_launches.get(k, 0) > 0 for k in SERVE_KERNELS),
                f"a kernel never launched in the in-process workers: "
                f"{inproc_launches}")
        inproc = {"drain_s": inproc_wall, "launches": inproc_launches,
                  "workers": workers_of(fe2, inproc_wall),
                  "transport": transport(fe2, inproc_wall),
                  "mul_frames": frames(fe2)}
    finally:
        fe2.close()
    return {"phase_s": time.perf_counter() - phase_t0,
            "subprocess": sub, "one_worker_drain_s": one_wall,
            "inproc": inproc, "traced": traced,
            "launches": summed(sub_total, inproc_launches)}


def print_multihost(mh: dict, serving: dict) -> None:
    """Phase 8's summary lines: drain walls, the mul batches' frames, the
    workers."""
    sub = mh["subprocess"]
    print(f"multihost drain: subprocess {MULTIHOST_WORKERS} workers "
          f"{sub['drain_s'] * 1e3:.1f} ms, 1 worker "
          f"{mh['one_worker_drain_s'] * 1e3:.1f} ms, in-process "
          f"{mh['inproc']['drain_s'] * 1e3:.1f} ms; phase 7's HEServer "
          f"{serving['drain_s_median']['false'] * 1e3:.1f} ms (median, no "
          f"overlap)", flush=True)
    for kind, rows in (("subprocess", sub["mul_frames"]),
                       ("in-process", mh["inproc"]["mul_frames"])):
        for r in rows:
            print(f"multihost {kind} mul batch (worker {r['wid']}): "
                  f"frame out {r['send']['bytes'] / 1e6:.1f} MB, in "
                  f"{r['recv']['bytes'] / 1e6:.1f} MB; "
                  + ", ".join(f"{side}.{k} {v * 1e3:.2f} ms"
                              for side in ("send", "recv", "worker")
                              for k, v in r[side].items() if k != "bytes"),
                  flush=True)
    for kind, d in (("subprocess", sub), ("in-process", mh["inproc"])):
        t = d["transport"]
        print(f"multihost {kind} transport: {t['batches']} batches, "
              f"{t['bytes'] / 1e6:.1f} MB framed; "
              + ", ".join(f"{k} {v * 1e3:.1f} ms"
                          for k, v in sorted(t["s"].items()))
              + f"; framing {t['framed_s'] * 1e3:.1f} ms = "
              f"{t['share']:.1%} of the {d['drain_s'] * 1e3:.1f} ms drain",
              flush=True)
    for kind, ws in (("subprocess", sub["workers"]),
                     ("in-process", mh["inproc"]["workers"])):
        for w in ws:
            print(f"multihost {kind} worker {w['wid']}: busy "
                  f"{w['busy_share']:.1%} of the drain, "
                  f"{w['served_requests']} requests; init "
                  f"{w['init_s']:.2f} s from spawn to ack, its frame "
                  f"{w['init_bytes'] / 1e6:.1f} MB written in "
                  f"{w['init_send_s']:.2f} s", flush=True)
    for wid, counts in sub["launches"].items():
        print(f"multihost subprocess worker {wid} kernel launches: {counts}",
              flush=True)
    print(f"multihost in-process kernel launches: "
          f"{mh['inproc']['launches']}; phase 8 took {mh['phase_s']:.1f} s",
          flush=True)


def boot_levels(plan) -> list:
    """Every level a bootstrap plan visits: its input's and each node's
    output's, from logq_in up to the raise target."""
    return sorted({plan.logq_in} | {lq for lq, _ in plan.meta})


def check_boot_kernels(torch, np, params, dev, levels, flush) -> dict:
    """Phase 9c: every kernel and variant against its plain version at
    each level of `levels` of a bootstrap ring (B = 1 and BATCH), at
    keygen's shapes, and on iCRT's and CRT's edge inputs at all of them;
    the top level's kernel shapes are also timed."""
    rows, n_cases = {}, 0
    cases = [(logq, c) for logq in levels
             for c in kernel_cases(torch, np, params, dev, logq)]
    cases += [("keygen", c) for c in keygen_kernel_cases(torch, np, params,
                                                         dev)]
    for level, (name, shape, kern, plain, nbytes, nmul, _) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        require(got.shape == want.shape and torch.equal(got, want),
                f"logN={params.logN} logq={level} {name} {shape}: kernel "
                f"differs from its plain version (max abs err {err})")
        n_cases += 1
        if level == params.logQ and "_" not in name:
            b_ms, b_by = bound_ms(nbytes, nmul)
            rows.setdefault(name, []).append({
                "shape": shape, "level": level,
                "batch": BATCH if "B=" in shape else 1, "max_abs_err": err,
                "ms": time_ms(torch, kern, 20, flush),
                "plain_ms": time_ms(torch, plain, 3, flush),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "int32_muls": nmul})
    edges = check_edges(torch, np, params, dev, levels=levels, verbose=False)
    n_edges = sum(len(v) for v in edges.values())
    print(f"bootstrap kernels at logN={params.logN}: {n_cases} shapes over "
          f"logq {levels[0]}..{levels[-1]} ({len(levels)} levels, every "
          f"strategy and Shoup form) and keygen, {n_edges} edge inputs: "
          f"bit for bit", flush=True)
    return {"logN": params.logN, "levels": levels, "cases": n_cases,
            "edge_cases": n_edges, "timed": rows}


def drive_bootstrap_path(torch, np, dev, common, flush) -> dict:
    """Phase 9: bootstrapping (``repro_torch.boot``) served on the card (see
    the module docstring)."""
    from repro_torch.boot import BOOT_STAGES, boot_params, bootstrap_circuit
    from repro_torch.client import HESession
    from repro_torch.core import heaan as H
    from repro_torch.core.keys import keygen
    from repro_torch.core.rns import PipelineConfig
    from repro_torch.core.rotate import conj_keygen, rot_keygen
    from repro_torch.hserve import HEServer
    from repro_torch.hserve.circuit import execute_circuit_reference
    from repro_torch.obs import Tracer

    phase_t0 = time.perf_counter()
    plain = PipelineConfig(use_kernels=False)
    rng = np.random.default_rng(31)

    def exhausted(params, pk, bound, seed):
        """(message, its ciphertext walked down to logq = logp)."""
        n = params.n_slots_max
        z = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        z *= bound / np.max(np.abs(z))
        ct = H.encrypt_message(z, pk, params, seed=seed)
        return z, H.he_mod_down(ct, params, params.logp)

    def galois(params, sk, plan):
        """The plan's Galois keys, as HESession.ensure_keys mints them
        (seeded per amount, so the same keys)."""
        return ({req[1]: rot_keygen(params, sk, req[1], device=dev)
                 for req in plan.requires if req[0] == "rot"},
                conj_keygen(params, sk, device=dev))

    def reference(params, evk, keys, plan, ct):
        return execute_circuit_reference(
            plan.resolved_ops(), {"x": ct}, params, evk=evk,
            rot_keys=keys[0], conj_key=keys[1], cfg=plain)

    def decrypt_err(params, sk, ct, z):
        return float(np.abs(H.decrypt_message(ct, sk, params) - z).max())

    # ---- 9a: boot_params() through the session, two bootstraps + auto ----
    p4 = boot_params()
    sk, pk, evk = keygen(p4, seed=0, device=dev)
    tracer = Tracer()
    server = HEServer(p4, evk, device=dev, batch=BOOT_BATCH, schedule=True,
                      tracer=tracer)
    session = HESession(p4, sk, pk, evk, server=server, device=dev)
    ref_plan = bootstrap_circuit(p4, logq_in=p4.logp, device=dev)
    session.ensure_keys(ref_plan.requires)       # minted before the count
    msgs = [exhausted(p4, pk, ref_plan.msg_bound, 40 + i) for i in range(3)]
    common.reset_launches()
    t0 = time.perf_counter()
    futs = [session.bootstrap(ct) for _, ct in msgs[:2]]
    x = session.input(msgs[2][1])
    futs += session.run([x * x], bootstrap="auto")
    outs = [f.result() for f in futs]
    torch.cuda.synchronize()
    drain_a = time.perf_counter() - t0
    launches_a = dict(common.LAUNCHES)
    require(all(launches_a[k] > 0 for k in SERVE_KERNELS),
            f"a kernel never launched on the bootstrap path: {launches_a}")
    require(len(session._boot_plans) == 1, "the session built its plan "
            f"{len(session._boot_plans)} times")
    plan = next(iter(session._boot_plans.values()))
    st = server.stats()
    keys4 = galois(p4, sk, plan)
    bound4 = plan.error_bound()
    errs_a = []
    for (z, ct), out in zip(msgs[:2], outs[:2]):
        require(same_ct(out, reference(p4, evk, keys4, plan, ct)),
                "9a: a served bootstrap differs from the plain path")
        errs_a.append(decrypt_err(p4, sk, out, z))
    r3 = reference(p4, evk, keys4, plan, msgs[2][1])
    require(same_ct(outs[2], H.rescale(H.he_mul(r3, r3, evk, p4, plain),
                                       p4)),
            "9a: run([x*x], bootstrap='auto') differs from the plain path")
    z3 = msgs[2][0]
    err_auto = decrypt_err(p4, sk, outs[2], z3 * z3)
    tol_auto = 4.0 * plan.msg_bound * bound4
    require(max(errs_a) <= bound4, f"9a: bootstrap decrypts "
            f"{max(errs_a):.3e} off, above its bound {bound4:.3e}")
    require(err_auto <= tol_auto, f"9a: x*x past native depth decrypts "
            f"{err_auto:.3e} off (limit {tol_auto:.3e})")
    cb_a = st["cobatch"]
    require(cb_a["cross_circuit_batches"] > 0,
            f"9a: the bootstraps never co-batched: {cb_a}")
    spans = {e["name"] for e in tracer.events if e.get("cat") == "boot"}
    require(spans == {f"boot.{s}" for s in BOOT_STAGES},
            f"9a: boot.* spans {sorted(spans)}")
    # the refreshed ciphertext is an ordinary one: mul → rescale → mul
    def served(submit, *args):
        rid = submit(*args)
        return server.drain()[rid]
    r = outs[0]
    ref = H.he_mul(r, r, evk, p4)
    got = served(server.submit_mul, r, r)
    require(same_ct(got, ref), "9a: mul of the refreshed ciphertext")
    ref = H.rescale(ref, p4)
    got = served(server.submit_rescale, got)
    require(same_ct(got, ref), "9a: rescale of its square")
    ref = H.he_mul(ref, ref, evk, p4)
    got = served(server.submit_mul, got, got)
    require(same_ct(got, ref), "9a: mul of the rescaled square")
    # one more pair on the warm server, traced by torch.profiler
    more = [exhausted(p4, pk, plan.msg_bound, 50 + i) for i in range(2)]

    def pair4():
        cids = [server.submit_bootstrap(ct, plan=plan) for _, ct in more]
        res = server.drain()
        return [res[c] for c in cids]
    prof4 = profile(torch, pair4)
    prof4.pop("top")
    print(f"bootstrap 9a (logN 4): 2 bootstraps + x*x past native depth "
          f"drained in {drain_a:.2f} s, == plain path bit for bit; errors "
          f"{max(errs_a):.3e} (bound {bound4:.3e}), x*x {err_auto:.3e} "
          f"(limit {tol_auto:.3e}); {cb_a}; launches {launches_a}; a warm "
          f"pair {prof4['wall_ms']:.0f} ms wall, device busy "
          f"{prof4['busy_share']:.1%}", flush=True)

    # ---- 9b: boot_params(logN=10), 3251 nodes, 46 rotation keys ----------
    p10 = boot_params(logN=10)
    sk, pk, evk = keygen(p10, seed=0, device=dev)
    server = HEServer(p10, evk, device=dev, batch=SERVE_BATCH, schedule=True)
    session = HESession(p10, sk, pk, evk, server=server, device=dev)
    t0 = time.perf_counter()
    plan = bootstrap_circuit(p10, logq_in=p10.logp,
                             plain_lookup=server.cache.has_plain, device=dev)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    session.ensure_keys(plan.requires)
    torch.cuda.synchronize()
    keys_s = time.perf_counter() - t0
    n_rot = len(server.cache.rotation_amounts)
    # the pair repeats the lone bootstrap's input beside a second one, so
    # two plain-path references (≈ 70 s each) cover all three results
    msgs = [exhausted(p10, pk, plan.msg_bound, 60 + i) for i in range(2)]
    scan = [0.0]
    submit_ready = server._submit_ready

    def timed_scan(circ):
        t = time.perf_counter()
        submit_ready(circ)
        scan[0] += time.perf_counter() - t
    server._submit_ready = timed_scan

    def drain10(items):
        scan[0] = 0.0
        server.reset_metrics()
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cids = [server.submit_bootstrap(ct, plan=plan) for _, ct in items]
        submit_s = time.perf_counter() - t0
        res = server.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = server.stats()
        run = {"bootstraps": len(items), "drain_s": wall,
               "submit_s": submit_s, "scan_s": scan[0],
               "scan_share": scan[0] / wall,
               "batches": sum(d["batches"] for d in st["per_op"].values()),
               "per_op": {op: {"requests": d["requests"],
                               "batches": d["batches"],
                               "ms_per_batch":
                                   1e3 * d["wall_s"] / d["batches"]}
                          for op, d in st["per_op"].items()},
               "cobatch": st["cobatch"],
               "plain_entries": st["cache"]["plain_entries"],
               "plain_mib": st["cache"]["plain_mib"],
               "launches": dict(common.LAUNCHES)}
        require(all(run["launches"][k] > 0 for k in SERVE_KERNELS),
                f"9b: a kernel never launched: {run['launches']}")
        return [res[c] for c in cids], run

    alone, run1 = drain10(msgs[:1])
    # warm now: the pair's dispatches run under the sync check
    dispatch = server.engine.dispatch
    sync_checked = [0]

    def strict(batch):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return dispatch(batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            sync_checked[0] += 1
    server.engine.dispatch = strict
    pair, run2 = drain10(msgs)
    server.engine.dispatch = dispatch
    server._submit_ready = submit_ready
    require(sync_checked[0] == run2["batches"],
            "9b: not every dispatch ran under the sync check")
    require(run2["cobatch"]["cross_circuit_batches"] > 0,
            f"9b: the pair never co-batched: {run2['cobatch']}")
    keys10 = galois(p10, sk, plan)
    bound10 = plan.error_bound()
    t0 = time.perf_counter()
    errs_b = []
    for (z, ct), outs10 in zip(msgs, (alone + pair[:1], pair[1:])):
        ref = reference(p10, evk, keys10, plan, ct)
        for out in outs10:
            require(same_ct(out, ref),
                    "9b: a served bootstrap differs from the plain path")
            errs_b.append(decrypt_err(p10, sk, out, z))
    ref_s = time.perf_counter() - t0
    require(max(errs_b) < BOOT_USABLE, f"9b: bootstrap decrypts "
            f"{max(errs_b):.3e} off, above the usable-precision line "
            f"{BOOT_USABLE:.3e}")
    for name, run in (("alone", run1), ("pair", run2)):
        print(f"bootstrap 9b (logN 10) {name}: drain {run['drain_s']:.2f} s "
              f"(submit {run['submit_s']:.2f} s, _submit_ready scan "
              f"{run['scan_s']:.2f} s = {run['scan_share']:.1%}), "
              f"{run['batches']} batches, cross-circuit "
              f"{run['cobatch']['cross_circuit_rate']}, plaintext cache "
              f"{run['plain_entries']} entries {run['plain_mib']} MiB, "
              f"launches {run['launches']}", flush=True)
    holds = "holds" if max(errs_b) <= bound10 else "does not hold"
    print(f"bootstrap 9b: plan {len(plan.ops)} nodes built in "
          f"{plan_s:.1f} s, {n_rot} rotation keys + conj in {keys_s:.2f} s; "
          f"3 results == 2 plain-path references bit for bit "
          f"({ref_s:.1f} s), errors "
          f"{max(errs_b):.3e} (< {BOOT_USABLE:.3e}; the reference's bound "
          f"{bound10:.3e} {holds}); {sync_checked[0]} dispatches "
          f"sync-checked", flush=True)

    # ---- 9c: the kernels at the new shapes ---------------------------------
    kernels = [check_boot_kernels(torch, np, params, dev, boot_levels(pl),
                                  flush)
               for params, pl in ((p4, ref_plan), (p10, plan))]
    launches = summed(launches_a, run1["launches"], run2["launches"])
    return {
        "phase_s": time.perf_counter() - phase_t0, "launches": launches,
        "reference": {"params": "boot_params(): logN=4 logQ=336 logp=24 h=2",
                      "nodes": len(ref_plan.ops), "drain_s": drain_a,
                      "launches": launches_a, "cobatch": cb_a,
                      "max_abs_err": errs_a, "error_bound": bound4,
                      "auto_err": err_auto, "auto_limit": tol_auto,
                      "out_logq": ref_plan.out_logq,
                      "warm_pair_profile": prof4},
        "dense": {"params": "boot_params(logN=10): logN=10 logQ=336 logp=24 "
                            "h=2", "nodes": len(plan.ops),
                  "rotation_keys": n_rot, "plan_s": plan_s,
                  "keygen_s": keys_s, "runs": [run1, run2],
                  "reference_s": ref_s, "max_abs_err": errs_b,
                  "error_bound": bound10, "usable_line": BOOT_USABLE,
                  "within_error_bound": max(errs_b) <= bound10,
                  "dispatches_sync_checked": sync_checked[0]},
        "kernels": kernels}


def check_beta64_tables(torch, np, params, dev) -> dict:
    """10a: the β = 2^64 tables at `params`, built (host) and moved to the
    card, timed; sampled entries of every table on the card against
    python ints."""
    from repro_torch.core.context import make_context
    from repro_torch.nt.primes import bit_reverse_indices, primitive_2nth_root
    from repro_torch.nt.residue import limbs_to_int
    t0 = time.perf_counter()
    ctx = make_context(params, params.logQ, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def host(t):
        return t.cpu().numpy().view(np.uint64)

    g = ctx.tables
    primes, N = [int(p) for p in host(g.primes)], params.N
    tab = {k: host(getattr(g, k)) for k in (
        "psi_rev", "psi_rev_shoup", "ipsi_rev", "ipsi_rev_shoup", "crt_tb",
        "crt_tb_shoup", "n_inv", "n_inv_shoup", "pprime", "r2")}
    brv = bit_reverse_indices(N)
    rng = np.random.default_rng(64)
    checked = 0
    for _ in range(BETA64_SAMPLES):
        j = int(rng.integers(len(primes)))
        p, k = primes[j], int(rng.integers(N))
        psi = primitive_2nth_root(p, N)
        kt = int(rng.integers(tab["crt_tb"].shape[1]))
        want = {("psi_rev", k): pow(psi, brv[k], p),
                ("ipsi_rev", k): pow(psi, -brv[k], p),
                ("crt_tb", kt): pow(2, 64 * kt, p)}
        for (name, col), v in want.items():
            got = int(tab[name][j, col])
            require(got == v, f"β=2^64 {name}[{j}, {col}] = {got}, not {v}")
            require(int(tab[name + "_shoup"][j, col]) == (v << 64) // p,
                    f"β=2^64 {name}_shoup[{j}, {col}]")
        require(int(tab["n_inv"][j]) * N % p == 1
                and int(tab["n_inv_shoup"][j]) ==
                (int(tab["n_inv"][j]) << 64) // p
                and int(tab["pprime"][j]) * p % 2**64 == 2**64 - 1
                and int(tab["r2"][j]) == 2**128 % p,
                f"β=2^64 N⁻¹, Montgomery constants of prime {j}")
        checked += 8
    for tabs in (ctx.icrt1, ctx.icrt2):
        P = tabs.P_int
        require(limbs_to_int(host(tabs.P_limbs), 64) == P
                and limbs_to_int(host(tabs.P_half_limbs), 64) == P // 2,
                f"β=2^64 P limbs of np {tabs.np_count}")
        for j in rng.integers(tabs.np_count, size=BETA64_SAMPLES // 2):
            p = primes[int(j)]
            inv = int(host(tabs.inv_P)[j])
            require(inv == pow(P // p, -1, p) and int(
                host(tabs.inv_P_shoup)[j]) == (inv << 64) // p
                and limbs_to_int(host(tabs.pdivp)[j], 64) == P // p,
                f"β=2^64 iCRT tables of prime {j} at np {tabs.np_count}")
            checked += 3
    return {"build_s": build_s, "entries_checked": checked, "ctx": ctx}


def beta64_ops(torch, np, params, dev, n_slots: int) -> dict:
    """Keygen (seed 0), the rotation-by-1 and conjugation keys, two
    encryptions, he_mul, he_rotate and he_conjugate at β = 2^64 on the
    plain path on `dev`, with the seeds and messages of phase 3."""
    from repro_torch.core import heaan as H
    from repro_torch.core import rotate as R
    from repro_torch.core.keys import keygen
    from repro_torch.core.rns import PipelineConfig
    plain = PipelineConfig(use_kernels=False)
    rng = np.random.default_rng(7)
    z1, z2 = (rng.random(n_slots) + 1j * rng.random(n_slots)
              for _ in range(2))
    sk, pk, evk = keygen(params, seed=0, cfg=plain, device=dev)
    rk = R.rot_keygen(params, sk, 1, cfg=plain, device=dev)
    ck = R.conj_keygen(params, sk, cfg=plain, device=dev)
    c1 = H.encrypt_message(z1, pk, params, seed=11, cfg=plain)
    c2 = H.encrypt_message(z2, pk, params, seed=12, cfg=plain)
    return {"z": (z1, z2), "sk": sk, "pk": pk, "evk": evk, "rk": rk,
            "ck": ck, "c1": c1, "c2": c2,
            "mul": H.he_mul(c1, c2, evk, params, plain),
            "rot": R.he_rotate(c1, 1, rk, params, plain),
            "conj": R.he_conjugate(c1, ck, params, plain)}


def words64(run: dict) -> list:
    """(name, tensor) of every key and ciphertext word of a beta64_ops
    run."""
    out = [("pk." + f, getattr(run["pk"], f)) for f in ("ax", "bx")]
    for key in ("evk", "rk", "ck"):
        out += [(f"{key}.{f}", getattr(run[key], f)) for f in (
            "ax_ev", "ax_ev_shoup", "bx_ev", "bx_ev_shoup")]
    for ct in ("c1", "c2", "mul", "rot", "conj"):
        out += [(f"{ct}.{f}", getattr(run[ct], f)) for f in ("ax", "bx")]
    return out


def negacyclic_coeff(a: list, b: list, n: int) -> int:
    """Coefficient n of a·b mod X^N + 1 over the integers."""
    N = len(a)
    return (sum(a[i] * b[n - i] for i in range(n + 1))
            - sum(a[i] * b[N + n - i] for i in range(n + 1, N)))


def drive_beta64_path(torch, np, dev, common, mul32, galois32=None
                      ) -> dict:
    """Phase 10: the paper's β = 2^64 word mode at paper_params(beta_bits=
    64) on the card, through the plain path (the kernels take β = 2^32
    words, as the reference's do). `mul32` is (params, c1, c2, evk, sk) of
    phase 3, timed beside it; `galois32`, phase 6's (rotation keys,
    conjugation key), gives the β = 2^32 rotation errors beside."""
    from repro_torch.core import rotate as R
    from repro_torch.core import rns
    from repro_torch.core import heaan as H
    from repro_torch.core.params import HEParams, paper_params
    from repro_torch.core.rns import PipelineConfig
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.nt.residue import limbs_to_int
    plain = PipelineConfig(use_kernels=False)
    t_phase = time.perf_counter()
    params = paper_params(beta_bits=64)

    # ---- 10a: tables -----------------------------------------------------
    tables = check_beta64_tables(torch, np, params, dev)
    ctx = tables.pop("ctx")
    print(f"β=2^64 tables (qlimbs {ctx.qlimbs}, np1 {ctx.np1}, np2 "
          f"{ctx.np2}) built and moved in {tables['build_s']:.2f} s; "
          f"{tables['entries_checked']} sampled entries == python ints",
          flush=True)

    # ---- 10b: keys, two encryptions, he_mul, rotate, conjugate ----------
    common.reset_launches()
    t0 = time.perf_counter()
    run = beta64_ops(torch, np, params, dev, params.N // 4)
    torch.cuda.synchronize()
    ops_s = time.perf_counter() - t0
    require(sum(common.LAUNCHES.values()) == 0,
            f"the β=2^64 path launched a port kernel: {common.LAUNCHES}")
    z1, z2 = run["z"]
    c1, c2, evk = run["c1"], run["c2"], run["evk"]
    require(c1.ax.dtype == torch.int64 and c1.ax.device == dev
            and c1.ax.shape == (params.N, ctx.qlimbs),
            "β=2^64 ciphertexts are not int64 words on the card")
    errs = {
        "mul": np.abs(H.decrypt_message(H.rescale(run["mul"], params),
                                        run["sk"], params, plain)
                      - z1 * z2).max(),
        "rotate": np.abs(H.decrypt_message(run["rot"], run["sk"], params,
                                           plain) - np.roll(z1, -1)).max(),
        "conjugate": np.abs(H.decrypt_message(run["conj"], run["sk"], params,
                                              plain) - np.conj(z1)).max()}
    errs = {k: float(v) for k, v in errs.items()}
    # tests/test_heaan.py's he_mul tolerance; a rotation at paper params
    # is held to serve_he's line for every served request (phase 7), as
    # it keeps the fresh scale and the key switch's noise of N = 2^16
    limits = {"mul": 1e-3, "rotate": 1e-2, "conjugate": 1e-2}
    require(all(np.isfinite(v) and v < limits[k] for k, v in errs.items()),
            f"β=2^64 decryption errors {errs} (limits {limits})")
    p32, a32, b32, evk32, sk32 = mul32
    errs32 = {}
    if galois32 is not None:
        rks32, ck32 = galois32
        errs32 = {k: float(np.abs(H.decrypt_message(ct, sk32, p32) - want)
                           .max()) for k, ct, want in (
            ("rotate", R.he_rotate(a32, 1, rks32[1], p32), np.roll(z1, -1)),
            ("conjugate", R.he_conjugate(a32, ck32, p32), np.conj(z1)))}
    print(f"β=2^64 keygen + 2 Galois keys + 2 encryptions + he_mul + "
          f"rotate + conjugate in {ops_s:.2f} s, no port kernel launched; "
          f"max |err| {errs} (limits {limits}); the same message at "
          f"β=2^32 {errs32}", flush=True)

    timed = {
        "beta64_plain": lambda: H.he_mul(c1, c2, evk, params, plain),
        "beta32_plain": lambda: H.he_mul(a32, b32, evk32, p32, plain),
        "beta32_kernels": lambda: H.he_mul(a32, b32, evk32, p32)}
    he_mul = {}
    for name, fn in timed.items():
        med, ms = median_ms(torch, fn, 5)
        prof = profile(torch, fn)
        he_mul[name] = {
            "ms_median": med, "ms": ms, "device_ms": prof["device_ms"],
            "busy_share": prof["busy_share"],
            "device_events": prof["device_events"],
            "port_kernel_launches": prof["port_kernel_launches"]}
    require(he_mul["beta64_plain"]["port_kernel_launches"] == 0,
            "the β=2^64 he_mul launched a port kernel")
    print("he_mul, median of 5 (wall) and one profiled call (device): "
          + "; ".join(f"{k} {v['ms_median']:.1f} ms wall, "
                      f"{v['device_ms']:.1f} ms device in "
                      f"{v['device_events']} events"
                      for k, v in he_mul.items()), flush=True)

    # ---- 10c: the batched step at B = BETA64_BATCH -----------------------
    st = hp.he_static(params, params.logQ)
    require(st.dtype == torch.int64, f"HEStatic.dtype {st.dtype}")
    t1, t2, ek = hp.runtime_tables(ctx, evk)
    cts = random_ciphertexts(torch, np, params, run["pk"], dev,
                             range(40, 40 + 2 * BETA64_BATCH), plain)
    args = [torch.stack([getattr(c, f) for c in cts[s::2]])
            for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
    step = hp.make_he_mul_step(st, dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ax3, bx3 = step(t1, t2, ek, *args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    for i in range(BETA64_BATCH):
        ref = H.he_mul(cts[2 * i], cts[2 * i + 1], evk, params, plain)
        require(torch.equal(ax3[i], ref.ax) and torch.equal(bx3[i], ref.bx),
                f"β=2^64 step item {i} differs from he_mul of its pair")
    step_med, step_ms = median_ms(
        torch, lambda: step(t1, t2, ek, *args), 5)
    print(f"β=2^64 step, B = {BETA64_BATCH}: == per-pair he_mul bit for "
          f"bit; {step_med:.1f} ms a step ({step_med / BETA64_BATCH:.1f} "
          f"a HE Mul); peak {peak / 2**20:.0f} MiB above the "
          f"{base / 2**30:.2f} GiB held", flush=True)

    # ---- 10d: the card against the CPU, and against python ints ---------
    small = HEParams(logN=BETA64_CPU_LOGN, logQ=params.logQ,
                     logp=params.logp, log_delta=params.log_delta,
                     beta_bits=64)
    t0 = time.perf_counter()
    cpu = beta64_ops(torch, np, small, torch.device("cpu"), small.N // 4)
    cpu_s = time.perf_counter() - t0
    card = beta64_ops(torch, np, small, dev, small.N // 4)
    compared = 0
    for (name, x), (_, y) in zip(words64(cpu), words64(card)):
        require(torch.equal(x, y.cpu()),
                f"β=2^64 {name} at logN {small.logN}: card != CPU")
        compared += x.numel()
    g = ctx.tables
    a, b = c1.bx.contiguous(), c2.bx.contiguous()
    out_limbs = ctx.icrt1.accum_limbs
    prod = rns.from_eval(rns.eval_mul(rns.to_eval(a, ctx.np1, g, plain),
                                      rns.to_eval(b, ctx.np1, g, plain), g,
                                      plain),
                         params, out_limbs, g, plain)
    a_int = [limbs_to_int(r, 64) for r in a.cpu().numpy().view(np.uint64)]
    b_int = [limbs_to_int(r, 64) for r in b.cpu().numpy().view(np.uint64)]
    rows = prod.cpu().numpy().view(np.uint64)
    width = 64 * out_limbs
    coeffs = sorted({0, params.N - 1, *map(int, np.random.default_rng(
        10).integers(params.N, size=BETA64_SAMPLES - 2))})
    for n in coeffs:
        v = limbs_to_int(rows[n], 64)
        v = v - (1 << width) if v >> (width - 1) else v
        require(v == negacyclic_coeff(a_int, b_int, n),
                f"β=2^64 region-1 product coefficient {n} != python int")
    print(f"β=2^64 card == CPU bit for bit at logN {small.logN} "
          f"({compared} words of keys and ciphertexts; the CPU run "
          f"{cpu_s:.1f} s); {len(coeffs)} coefficients of region 1's "
          f"bx1·bx2 at paper params == python-int negacyclic product",
          flush=True)

    # ---- 10e: the kernels refuse β = 2^64 --------------------------------
    for what, fn in (("he_mul", lambda: H.he_mul(c1, c2, evk, params)),
                     ("make_he_mul_step",
                      lambda: hp.make_he_mul_step(st, dev,
                                                  use_kernels=True))):
        try:
            fn()
        except ValueError as exc:
            require("use_kernels=False" in str(exc), f"{what}: {exc}")
        else:
            raise SmokeFailure(f"{what} ran use_kernels=True at β=2^64")
    phase_s = time.perf_counter() - t_phase
    print(f"β=2^64 use_kernels=True refused by he_mul and the step; phase "
          f"10 took {phase_s:.1f} s", flush=True)
    return {
        "params": "paper_params(beta_bits=64): logN=16 logQ=1200 beta=2^64",
        "qlimbs": ctx.qlimbs, "np1": ctx.np1, "np2": ctx.np2,
        "tables": tables, "ops_s": ops_s, "errors": errs,
        "limits": limits, "beta32_errors": errs32, "he_mul": he_mul,
        "step": {"batch": BETA64_BATCH, "ms_median": step_med,
                 "ms": step_ms, "peak_bytes": peak, "held_bytes": base},
        "cpu_check": {"logN": small.logN, "words": compared,
                      "cpu_s": cpu_s},
        "product_coeffs": coeffs, "phase_s": phase_s}


def icrt_split_inputs(np, primes: list, npn: int, n: int, rng) -> dict:
    """The residues 11a holds the split iCRT at: random, and iCRT's edge
    inputs (every residue p_j − 1, every residue 0, and X = ⌊P/2⌋,
    ⌊P/2⌋ + 1, P − 1, 1 in turn along the coefficients: X/P within 1/P of
    an integer, where the f64 quotient is decided by the ±1 ladder)."""
    P = 1
    for p in primes[:npn]:
        P *= p
    xs = (P // 2, P // 2 + 1, P - 1, 1)
    ps = np.array(primes[:npn], np.uint64)[:, None]
    cols = {"random": rng.integers(0, 1 << 62, size=(npn, n),
                                   dtype=np.uint64) % ps,
            "p-1": ps - 1, "zero": np.zeros((npn, 1), np.uint64),
            "P/2,P/2+1,P-1,1": np.array([[x % p for x in xs]
                                         for p in primes[:npn]], np.uint64)}
    return {k: np.ascontiguousarray(np.tile(v, (1, n // v.shape[1])))
            for k, v in cols.items()}


def check_split_icrt(torch, np, params, dev, flush) -> dict:
    """Phase 11a (see the module docstring). Returns kernel -> rows (the
    timed shapes) and the count of bitwise checks."""
    from repro_torch.core.context import device_icrt_tables, device_tables
    from repro_torch.dist.sharding import prime_rows
    from repro_torch.kernels import common
    from repro_torch.kernels.icrt.ops import (
        icrt_finish_op, icrt_op, icrt_partial_op,
    )
    from repro_torch.kernels.icrt.ref import (
        icrt_finish_ref, icrt_inputs, icrt_partial_ref,
    )

    g = device_tables(params, dev)
    N = params.N
    K, np1, np2, ks_limbs = level_shapes(params, params.logQ)
    primes = [int(v) for v in g.primes.cpu().numpy().view(np.uint32)]
    rng = np.random.default_rng(2027)
    rows: dict = {"icrt_partial": [], "icrt_finish": []}
    checks = 0

    def same(a, b):
        return all(x.shape == y.shape and torch.equal(x, y)
                   for x, y in zip(a, b))

    def shard(t, s):
        return {k: (v[s].clone() if k not in ("P_limbs", "P_half_limbs")
                    else v) for k, v in t.items()}

    def timed(name, label, kern, plain, nbytes, nmul):
        b_ms, b_by = bound_ms(nbytes, nmul)
        row = {"shape": label, "ms": time_ms(torch, kern, 20, flush),
               "plain_ms": time_ms(torch, plain, 3, flush),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "int32_muls": nmul, "max_abs_err": 0}
        rows[name].append(row)
        print(f"kernel {name:13s} {label:24s} bitwise ok  {row['ms']:.4f} ms"
              f"  plain {row['plain_ms']:.3f} ms  bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)

    for npn, out_limbs in ((np1, K), (np2, ks_limbs)):
        t = icrt_inputs(device_icrt_tables(params, npn, dev), g)
        PL = t["pdivp"].shape[1]
        for B in (1, BATCH):
            n = B * N
            for label, res in icrt_split_inputs(np, primes, npn, n,
                                                rng).items():
                r = torch.from_numpy(res.astype(np.uint32).view(np.int32)
                                     ).to(dev)
                whole = icrt_op(r, t, out_limbs)
                for s in (slice(0, 1), slice(0, 0)):
                    before = dict(common.LAUNCHES)
                    got = icrt_partial_op(r[s], shard(t, s))
                    want = icrt_partial_ref(r[s], shard(t, s))
                    torch.cuda.synchronize()
                    require(same(got, want), f"icrt_partial np={s.stop} "
                            f"B={B} {label}: differs from its twin")
                    require(s.stop or common.LAUNCHES == before,
                            "an empty shard launched a kernel")
                    checks += 1
                for gsz in ICRT_SPLITS:
                    parts = []
                    for rk in range(gsz):
                        s = prime_rows(npn, gsz, rk)
                        got = icrt_partial_op(r[s], shard(t, s))
                        want = icrt_partial_ref(r[s], shard(t, s))
                        torch.cuda.synchronize()
                        require(same(got, want), f"icrt_partial "
                                f"np={s.stop - s.start} B={B} {label}: "
                                f"differs from its twin")
                        parts.append(got)
                        checks += 1
                    summed = [sum(p[i] for p in parts) for i in range(3)]
                    got = icrt_finish_op(*summed, t, out_limbs)
                    want = icrt_finish_ref(*summed, t, out_limbs)
                    torch.cuda.synchronize()
                    require(same([got], [want]), f"icrt_finish np={npn} "
                            f"split {gsz} B={B} {label}: differs from its "
                            f"twin")
                    require(same([got], [whole]), f"iCRT split over {gsz} "
                            f"at np={npn} B={B} {label}: differs from the "
                            f"fused icrt_op")
                    checks += 2
            print(f"icrt split np={npn} out={out_limbs} B={B}: partial and "
                  f"finish == twins (np 1 and empty shards too), splits "
                  f"{ICRT_SPLITS} == fused icrt_op on random and edge "
                  f"inputs", flush=True)
            # timed at the 2-rank grid's shard (the larger) and the finish
            s = prime_rows(npn, GRID_RANKS, 0)
            ns = s.stop - s.start
            r = torch.from_numpy(icrt_split_inputs(np, primes, npn, n, rng)[
                "random"].astype(np.uint32).view(np.int32)).to(dev)
            ts = shard(t, s)
            lo, hi, qsum = icrt_partial_op(r[s], ts)
            tag = f" B={B}" if B > 1 else ""
            timed("icrt_partial", f"np={ns} of {npn}{tag}",
                  lambda r=r[s], ts=ts: icrt_partial_op(r, ts),
                  lambda r=r[s], ts=ts: icrt_partial_ref(r, ts),
                  4 * ns * n + 16 * n * PL + 8 * n, n * ns * (PL + 3))
            timed("icrt_finish", f"np={npn} out={out_limbs}{tag}",
                  lambda a=(lo, hi, qsum), o=out_limbs: icrt_finish_op(
                      *a, t, o),
                  lambda a=(lo, hi, qsum), o=out_limbs: icrt_finish_ref(
                      *a, t, o),
                  (16 * PL + 8 + 4 * out_limbs) * n, 0)
    return {"rows": rows, "checks": checks}


def grid_step_rank(grid, params, evk, operands, refs) -> dict:
    """Phase 11b in one rank of the grid: the 2-rank step on each rung
    (see the module docstring). Every rank runs the same calls."""
    import torch
    from repro_torch.dist import comm
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.dist.sharding import he_expected_collectives
    from repro_torch.hserve.tables import TableCache
    from repro_torch.kernels import common

    dev = grid.device
    t0 = time.perf_counter()
    cache = TableCache(params, evk, device=dev, grid=grid)
    out = {"rank": grid.rank, "tables_s": time.perf_counter() - t0,
           "cases": []}
    launches: dict = {}
    for (logq, rung), want in refs.items():
        t1, t2 = cache.level_tables(logq)
        st = hp.he_static(params, logq)
        xs = [x.to(dev) for x in operands[logq]]
        step = hp.make_he_mul_step(st, dev, grid=grid, use_kernels=True,
                                   **GRID_RUNGS[rung])

        def run(step=step, t1=t1, t2=t2, xs=xs):
            return step(t1, t2, cache.evk(), *xs)

        sync(torch, dev)
        comm.reset(grid)
        common.reset_launches()
        got = run()
        sync(torch, dev)
        counts = {k: v for k, v in common.LAUNCHES.items() if v}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        sched = comm.summary(grid, "step")
        exp = he_expected_collectives("mul", grid, params, logq,
                                      batch=xs[0].shape[0])
        case = {"logq": logq, "rung": rung, "launches": counts,
                "bitwise": all(torch.equal(a.cpu(), b)
                               for a, b in zip(got, want)),
                "schedule": sched, "expected": {
                    "counts": exp["counts"],
                    "wire_bytes": exp["wire_bytes"]}}
        if (logq, rung) == (params.logQ, "default"):
            ms = []
            comm.reset(grid)
            for _ in range(5):
                sync(torch, dev)
                t0 = time.perf_counter()
                run()
                sync(torch, dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            timed = comm.summary(grid, "step")
            case.update(ms_per_step=statistics.median(ms), ms=ms,
                        collective_s=timed["seconds"],
                        collective_share=timed["seconds"] * 1e3 / sum(ms))
            if dev.type == "cuda":
                if grid.rank == 0:
                    case["profile"] = {k: v for k, v in profile(
                        torch, run).items() if k != "top"}
                else:
                    run()
        out["cases"].append(case)
    out["launches"] = launches
    out["cache"] = cache.stats()
    return out


def grid_serve_rank(grid, params, keys, reqs, circs, want) -> dict:
    """Phase 11c in one rank: rank 0 serves phase 7's stream through
    HEServer(grid=) and holds every result against phase 7's; rank 1
    follows."""
    import torch
    from repro_torch.hserve import HEServer, serve_follower
    from repro_torch.kernels import common

    if grid.model_rank:
        return serve_follower(grid, params)
    server = HEServer(params, keys["evk"], keys["rot_keys"],
                      keys["conj_key"], device=grid.device,
                      batch=SERVE_BATCH, schedule=True, grid=grid)
    try:
        common.reset_launches()
        outs, wall = serve_stream(torch, server, reqs, circs)
        launches = {k: v for k, v in common.LAUNCHES.items() if v}
        same = [same_ct(a, b) for a, b in zip(outs, want)]
        st = server.stats()
    finally:
        server.close()
    return {"bitwise": same, "drain_s": wall, "launches": launches,
            "grid": st["grid"], "cache": st["cache"],
            "batches": {op: d["batches"] for op, d in st["per_op"].items()}}


def drive_grid_path(torch, np, params, dev, common, flush, pk, evk, keys,
                    stream, serving) -> dict:
    """Phase 11 (see the module docstring)."""
    phase_t0 = time.perf_counter()
    out = drive_grid_step(torch, np, params, dev, flush, pk, evk)
    served = drive_grid_serving(torch, params, dev, evk, keys, stream,
                                serving)
    out["launches"] = summed(out.pop("step_launches"),
                             served.pop("launches"))
    return {"phase_s": time.perf_counter() - phase_t0, **out, **served}


def drive_grid_step(torch, np, params, dev, flush, pk, evk) -> dict:
    """Phase 11a and 11b."""
    from repro_torch.core import heaan as H
    from repro_torch.core.cipher import EvalKey
    from repro_torch.core.context import make_context
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.hserve.tables import TableCache
    from repro_torch.launch.mesh import spawn_grid

    def on_host(key):
        return EvalKey(*(getattr(key, f).cpu() for f in hp.EVK_TABLE_KEYS))

    split = check_split_icrt(torch, np, params, dev, flush)

    # ---- 11b: the step on the grid against the one-rank kernel step ------
    lower = params.logQ - params.logp
    cts = random_ciphertexts(torch, np, params, pk, dev,
                             range(300, 300 + 2 * BATCH))
    operands, refs = {}, {}
    for logq in (params.logQ, lower):
        cs = cts if logq == params.logQ else [
            H.he_mod_down(c, params, logq) for c in cts]
        xs = [torch.stack([getattr(c, f) for c in cs[s::2]])
              for s, f in ((0, "ax"), (0, "bx"), (1, "ax"), (1, "bx"))]
        operands[logq] = [x.cpu() for x in xs]
        tabs = hp.runtime_tables(make_context(params, logq, dev), evk)
        st = hp.he_static(params, logq)
        for rung, kw in GRID_RUNGS.items():
            if logq != params.logQ and rung != "default":
                continue
            one = {k: v for k, v in kw.items() if k != "reduce_scatter_icrt"}
            refs[(logq, rung)] = [o.cpu() for o in hp.make_he_mul_step(
                st, dev, use_kernels=True, **one)(*tabs, *xs)]
    one_rank = TableCache(params, evk, device=dev)
    for logq in (params.logQ, lower):
        one_rank.level_tables(logq)
    one_stats = one_rank.stats()
    del one_rank
    t0 = time.perf_counter()
    ranks = spawn_grid(grid_step_rank, model=GRID_RANKS, device=dev.type,
                       args=(params, on_host(evk), operands, refs))
    step_s = time.perf_counter() - t0
    launches: dict = {}
    for res in ranks:
        for case in res["cases"]:
            what = f"rank {res['rank']} {case['rung']} at logq {case['logq']}"
            require(case["bitwise"], f"2-rank step {what}: differs from "
                    f"the one-rank kernel step")
            sch, exp = case["schedule"], case["expected"]
            # reduce_scatter_icrt moves lo and hi as a reduce-scatter and
            # an all-gather each, qsum by an all-reduce: per reduction
            n_red = exp["counts"]["all-reduce"] // 3
            want = exp["counts"] if case["rung"] != "reduce_scatter_icrt" \
                else {"all-reduce": n_red, "reduce-scatter": 2 * n_red,
                      "all-gather": 2 * n_red}
            require(sch["counts"] == want,
                    f"2-rank step {what}: schedule {sch['counts']} against "
                    f"{want} (he_expected_collectives {exp['counts']})")
            require(case["rung"] == "reduce_scatter_icrt"
                    or sch["total_bytes"] == exp["wire_bytes"],
                    f"2-rank step {what}: {sch['total_bytes']} wire bytes "
                    f"against {exp['wire_bytes']}")
            require("collective-permute" not in sch["counts"],
                    f"2-rank step {what}: a collective-permute")
            # (a rehearsal on the CPU launches nothing)
            require(dev.type != "cuda" or (
                case["launches"].get("icrt_partial", 0) > 0
                and case["launches"].get("icrt_finish", 0) > 0
                and "icrt" not in case["launches"]),
                    f"2-rank step {what}: launches {case['launches']}")
        if res["rank"] == 0:
            launches = res["launches"]
    r0 = ranks[0]
    card_res = {k: round(one_stats[k], 3) for k in
                ("resident_mib", "icrt_mib", "keys_mib")}
    for res in ranks:
        c = res["cache"]
        print(f"grid rank {res['rank']}: resident {c['resident_mib']:.1f} "
              f"MiB, icrt {c['icrt_mib']:.2f} MiB, keys {c['keys_mib']:.1f} "
              f"MiB (one rank: {card_res}); rows {c['stored_rows']}",
              flush=True)
    for case in r0["cases"]:
        if "ms_per_step" in case:
            print(f"grid step {case['rung']:20s} B={BATCH} on "
                  f"{GRID_RANKS} ranks of one card: {case['ms_per_step']:.1f}"
                  f" ms (median of 5), collectives "
                  f"{case['collective_share']:.1%} of the wall; schedule "
                  f"{case['schedule']['counts']} "
                  f"{case['schedule']['total_bytes']:.0f} B == expected; "
                  f"== one-rank kernel step", flush=True)
    for prof in (c["profile"] for c in r0["cases"] if "profile" in c):
        print(f"grid step default under torch.profiler on rank 0: "
              f"{prof['device_ms']:.2f} ms of device time in "
              f"{prof['device_events']} events, wall {prof['wall_ms']:.1f} "
              f"ms", flush=True)

    return {"ranks": GRID_RANKS, "split_icrt": split,
            "step_launches": launches,
            "step": {"cases": r0["cases"], "spawn_and_run_s": step_s,
                     "tables_s": [r["tables_s"] for r in ranks],
                     "resident": [r["cache"] for r in ranks],
                     "one_rank_resident": card_res}}


def drive_grid_serving(torch, params, dev, evk, keys, stream,
                       serving) -> dict:
    """Phase 11c: phase 7's stream across the ranks, and serve_he at
    SMOKE with model_shards."""
    import dataclasses
    from repro_torch.core.cipher import EvalKey
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.launch.mesh import spawn_grid
    from repro_torch.launch.serve import serve_he

    def on_host(key):
        return EvalKey(*(getattr(key, f).cpu() for f in hp.EVK_TABLE_KEYS))

    reqs, circs, outs, _ = stream
    host = torch.device("cpu")
    reqs_h = [(lb, m, [moved(a, host) for a in args],
               {k: moved(v, host) for k, v in kw.items()}, None, None)
              for lb, m, args, kw, _, _ in reqs]
    circs_h = [(nm, [dataclasses.replace(o, pt=moved(o.pt, host))
                     for o in ops], moved(x, host), None, None)
               for nm, ops, x, _, _ in circs]
    keys_h = {"evk": on_host(evk),
              "rot_keys": {r: on_host(k) for r, k in keys[0].items()},
              "conj_key": on_host(keys[1])}
    want = [moved(o, host) for o in outs]
    t0 = time.perf_counter()
    served = spawn_grid(grid_serve_rank, model=GRID_RANKS, device=dev.type,
                        args=(params, keys_h, reqs_h, circs_h, want))
    serve_s = time.perf_counter() - t0
    s0 = served[0]
    require(all(s0["bitwise"]) and len(s0["bitwise"]) == len(outs),
            f"served across ranks: results {s0['bitwise']} differ from "
            f"phase 7's HEServer")
    require(dev.type != "cuda" or s0["launches"].get("icrt_partial", 0),
            f"served across ranks: launches {s0['launches']}")
    print(f"grid serving: {len(outs)} results == phase 7's HEServer bit for "
          f"bit; drain {s0['drain_s'] * 1e3:.1f} ms on {GRID_RANKS} ranks of "
          f"one card (phase 7's first drain "
          f"{serving['first_drain_s'] * 1e3:.1f} ms); rank 0 launches "
          f"{s0['launches']}; follower ran "
          f"{served[1]['steps']} steps", flush=True)
    t0 = time.perf_counter()
    smoke = serve_he(SERVE_BATCH, levels=3, rotations=2, conjugations=1,
                     plain_frac=0.25, circuit=True, schedule=True,
                     model_shards=GRID_RANKS, device=dev.type)
    smoke_s = time.perf_counter() - t0
    require(smoke["max_err"] == serving["serve_he_smoke"]["max_err"],
            f"serve_he --model-shards {GRID_RANKS} decrypts "
            f"{smoke['max_err']!r}, one rank {serving['serve_he_smoke']}")
    print(f"serve_he --model-shards {GRID_RANKS} at SMOKE on "
          f"{smoke['grid']['device']}: max_err {smoke['max_err']:.2e} == one "
          f"rank's, in {smoke_s:.1f} s", flush=True)
    return {"backend": s0["grid"]["backend"],
            # rank 0's launches in 11c's drain (11b's join them)
            "launches": s0["launches"],
            "serving": {"drain_s": s0["drain_s"],
                        "phase7_first_drain_s": serving["first_drain_s"],
                        "spawn_and_run_s": serve_s,
                        "launches": s0["launches"],
                        "follower_steps": served[1]["steps"],
                        "feed": s0["grid"]["feed"],
                        "step": s0["grid"]["step"],
                        "batches": s0["batches"]},
            "serve_he_smoke": {"max_err": smoke["max_err"], "s": smoke_s,
                               "grid": {k: smoke["grid"][k] for k in
                                        ("data", "model", "backend")}}}


def profile(torch, fn) -> dict:
    """Device time by kernel name over one call of fn, the busy share, and
    the device time of the port's kernels (in all and by kernel) against
    PyTorch's own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            ms, n = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3,
                                 n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    # the .cu sources keep every kernel in a top-level anonymous namespace;
    # PyTorch's own kernels are named void at::native::...
    ours: dict = {}
    for name, (ms, n) in by_name.items():
        short = name.removeprefix("void ")
        if short.startswith("(anonymous namespace)::"):
            short = short.split("::", 1)[1].split("(")[0]
            prev_ms, prev_n = ours.get(short, (0.0, 0))
            ours[short] = (prev_ms + ms, prev_n + n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "device_events": sum(n for _, n in by_name.values()),
            "port_kernel_ms": sum(ms for ms, _ in ours.values()),
            "port_kernel_launches": sum(n for _, n in ours.values()),
            "port_kernels": dict(sorted(ours.items())),
            "top": [[name[:80], ms, n] for name, (ms, n) in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import heaan as H
    from repro_torch.core.params import paper_params
    from repro_torch.core.rns import PipelineConfig
    from repro_torch.kernels import common

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    lib_path = common.build()
    common.library()
    build_s = time.perf_counter() - t0
    print(f"built {lib_path.relative_to(ROOT)} in {build_s:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line.lower():
            print("ptxas:", line.strip())
    card = card_line()
    print(card, flush=True)

    params = paper_params()
    t0 = time.perf_counter()
    from repro_torch.core.context import make_context
    ctx = make_context(params, params.logQ, dev)
    print(f"paper params: N={params.N} logQ={params.logQ} "
          f"qlimbs={ctx.qlimbs} np1={ctx.np1} np2={ctx.np2} "
          f"(tables in {time.perf_counter() - t0:.1f} s)", flush=True)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)  # 256 MiB

    per_kernel = check_kernels(torch, np, params, dev, flush)
    edges = check_edges(torch, np, params, dev)
    repairs = check_geometry_repairs(torch, np, dev)
    path = drive_main_path(torch, np, params, dev, common)
    c1, c2, evk = path["operands"]
    batched = drive_batched_step(torch, np, params, dev, common, path["pk"],
                                 evk)
    mul_ms = median_ms(torch, lambda: H.he_mul(c1, c2, evk, params), 5)[1]
    plain = PipelineConfig(use_kernels=False)
    plain_ms = median_ms(
        torch, lambda: H.he_mul(c1, c2, evk, params, plain), 2)[1]
    circuit = drive_circuit_path(torch, np, params, dev, common, path["sk"],
                                 path["pk"], evk)
    serving = drive_serving_path(torch, np, params, dev, common, path["sk"],
                                 path["pk"], evk, *circuit["keys"])
    stream = serving.pop("stream")
    multihost = drive_multihost_path(torch, np, params, dev, common,
                                     path["sk"], path["pk"], evk,
                                     *circuit["keys"], stream)
    print_multihost(multihost, serving)
    boot = drive_bootstrap_path(torch, np, dev, common, flush)
    beta64 = drive_beta64_path(torch, np, dev, common,
                               (params, c1, c2, evk, path["sk"]),
                               circuit["keys"])
    grid = drive_grid_path(torch, np, params, dev, common, flush,
                           path["pk"], evk, circuit["keys"], stream, serving)
    per_he_mul = {key: sum(n * r[key] for k, counts in
                           HE_MUL_SHAPE_LAUNCHES.items()
                           for n, r in zip(counts, per_kernel[k]))
                  for key in ("ms", "bound_ms")}

    kernels = []
    for name, rows in per_kernel.items():
        # the headline shape: region 1 of HE Mul (B = 1); a variant runs
        # only in the batched step, so its first B = BATCH shape
        main_row = next(r for r in rows if r["batch"] == (
            1 if path["launches"][name] else BATCH))
        src, tpu = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/{src}", "replaces": tpu,
            # on every path: phase 3 (one HE Mul and its neighbours),
            # phase 4 (the batched step's rungs), phase 6 (Galois keygen
            # and the circuits; the batched per-op steps), phase 7 (the
            # served stream's first drain), phase 8 (the timed drains of
            # the subprocess workers, counted inside them, and of the
            # in-process workers), phase 9 (the served bootstraps at
            # logN 4 and 10)
            "launches": path["launches"][name] + batched["launches"][name]
            + circuit["launches"][name] + circuit["steps_launches"][name]
            + serving["launches"][name]
            + multihost["launches"].get(name, 0)
            + boot["launches"].get(name, 0),
            "main_path_launches": path["launches"][name],
            "batched_step_launches": batched["launches"][name],
            "circuit_path_launches": circuit["launches"][name],
            "per_op_steps_launches": circuit["steps_launches"][name],
            "serving_path_launches": serving["launches"][name],
            "multihost_path_launches": multihost["launches"].get(name, 0),
            "bootstrap_path_launches": boot["launches"].get(name, 0),
            # phase 11's ranks, counted in rank 0
            "grid_path_launches": grid["launches"].get(name, 0),
            "he_mul_launches": path["he_mul_launches"].get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               + edges.get(name, [])),
            "bitwise": True, "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "headline_shape": main_row["shape"],
            "bytes": main_row["bytes"], "shapes": rows,
            **({"edge_inputs": edges[name]} if name in edges else {})})
    for name, rows in grid["split_icrt"]["rows"].items():
        # the headline: the 2-rank grid's shard of region 1 at B = BATCH
        main_row = next(r for r in rows if "B=" in r["shape"])
        src, tpu = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/{src}", "replaces": tpu,
            # the main path of these two: phase 11's 2-rank step (11b) and
            # served stream (11c), counted in rank 0
            "launches": grid["launches"].get(name, 0),
            "grid_path_launches": grid["launches"].get(name, 0),
            "max_abs_err": 0, "bitwise": True,
            "bitwise_checks": grid["split_icrt"]["checks"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"], "library_ms": None,
            "headline_shape": main_row["shape"],
            "bytes": main_row["bytes"], "shapes": rows})
    print(json.dumps({"kernels": kernels}))
    # computed, not measured: the two-pass design's bytes at the bound's
    # memory rate, beside each NTT/iNTT shape's measured time
    print(json.dumps({"two_pass_floor_computed": [
        {"name": name, "shape": r["shape"], "bytes": r["two_pass_bytes"],
         "floor_ms": bound_ms(r["two_pass_bytes"], 0)[0], "ms": r["ms"]}
        for name, rows in per_kernel.items() for r in rows
        if "two_pass_bytes" in r]}))
    print(json.dumps({"he_mul": {
        "params": "paper_params(): logN=16 logQ=1200 beta=2^32",
        "ms_median": statistics.median(mul_ms), "ms": mul_ms,
        "plain_ms": plain_ms, "kernel_ms_sum": per_he_mul["ms"],
        "kernel_bound_ms_sum": per_he_mul["bound_ms"],
        "main_path_s": path["path_s"], "err_mul": path["err_mul"],
        "err_sum": path["err_sum"], "geometry_repairs": repairs,
        "card": card}}))
    print(json.dumps({"batched_step": {
        "params": "paper_params(): logN=16 logQ=1200 beta=2^32",
        "batch": BATCH, "rungs": batched["times"],
        "rung_launches": batched["rung_launches"],
        "path_s": batched["path_s"], "card": card}}))
    print(json.dumps({"he_mul_profile": profile(
        torch, lambda: H.he_mul(c1, c2, evk, params))}))
    print(json.dumps({"batched_step_profile": profile(
        torch, batched["profile_step"])}))
    rot = profile(torch, circuit["profile_rotate"])
    rot["glue_ms"] = rot["device_ms"] - rot["port_kernel_ms"]
    print(f"one he_rotate under torch.profiler: {rot['device_ms']:.3f} ms "
          f"of device time in {rot['device_events']} events, the port's "
          f"kernels {rot['port_kernel_ms']:.3f} ms in "
          f"{rot['port_kernel_launches']} launches, the glue "
          f"{rot['glue_ms']:.3f} ms; wall {rot['wall_ms']:.3f} ms; phase 6 "
          f"took {circuit['phase_s']:.1f} s", flush=True)
    print(json.dumps({"circuit_path": {
        "params": "paper_params(): logN=16 logQ=1200 beta=2^32",
        "batch": BATCH, **{k: v for k, v in circuit.items()
                           if k not in ("profile_rotate", "keys")},
        "he_rotate_profile": rot, "card": card}}))
    print(json.dumps({"serving": {
        "params": "paper_params(): logN=16 logQ=1200 beta=2^32",
        **serving, "card": card}}))
    print(json.dumps({"multihost": {
        "params": "paper_params(): logN=16 logQ=1200 beta=2^32",
        **multihost, "card": card}}))
    print(json.dumps({"bootstrap": {**boot, "card": card}}))
    print(json.dumps({"beta64": {**beta64, "card": card}}))
    print(json.dumps({"grid": {
        "params": "paper_params(): logN=16 logQ=1200 beta=2^32",
        "note": f"{GRID_RANKS} ranks share one card over gloo: not a "
                f"scaling measurement", **grid, "card": card}}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
