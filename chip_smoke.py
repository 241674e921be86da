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
   81 → 75), at B = 1 and 4. The carry kernels (``csrc/carry.cu``), which
   only the batched steps launch, are held and timed so at a step's rows
   at B = 4 and 16 (CARRY_BATCHES): the ÷Q shift of 76 limbs to 38 and the
   combine's add and mask at 38 limbs, against ``core.bigint`` run on the
   card; their bound counts the limbs the function reads (the shift's from
   its rounding bit up) and writes. iCRT is also held bit for bit
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
   beside); no port kernel launched; he_mul at β = 2^64 timed (median of 3,
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
   (41/40, 61/61, 21/21/21/18, 31/31/31/29), one prime, and an empty shard
   (which launches nothing), B = 1 and BATCH, on random residues and on
   iCRT's edge inputs; the partials of each split summed and finished ==
   the fused ``icrt_op`` bit for bit; both timed (CUDA events, median of
   20, L2 flushed) against their bounds, the partial at rank 0's shard of
   each split (2 ranks, the grid's, and 4), the finish on each split's
   sums, each row with its achieved bytes per ms. 11b:
   ``make_he_mul_step`` on the 2-rank grid, tables and keys from each
   rank's ``TableCache(grid=)``,
   on the rungs of GRID_RUNGS at logQ and the default rung one level
   down: every output == the one-rank kernel step's bit for bit; the
   schedule each rank records == ``he_expected_collectives`` (counts and
   ring wire bytes), with no collective-permute; the launch counts set to
   0 before and read after (the split kernels must launch); on rank 0 the
   step's wall (median of 3), the collectives' share of it (gloo takes the
   CUDA tensors, so the port stages nothing), device ms from one profiled
   call, and each
   rank's resident table bytes beside one rank's. 11c: phase 7's stream
   through ``HEServer(grid=)`` on rank 0 with ``serve_follower`` on rank
   1 (the machinery of ``serve_he --model-shards``): every result ==
   phase 7's HEServer result bit for bit, the drain wall beside phase
   7's first; then ``serve_he(model_shards=2)`` at SMOKE, its max_err ==
   phase 7's SMOKE run's.
12. The HE side's last modules: workers on model grids and β = 2^64
   served (12b's servers at batch BETA64_SERVE_BATCH). 12a: phase 7's
   requests at logq 1200 (8 of its 24; cut: no
   circuit, the other levels left out, as every step crosses gloo's host
   path) through ``HEFrontend(transport="subprocess",
   worker_devices=GRID_RANKS)``: one worker process, rank 0 of its own
   2-rank grid on the card with its follower spawned beside it, killed at
   its 2nd batch (``FailureInjector``): the poll that finds no worker
   leaves its batch queued, ``revive_workers()`` respawns the group and
   every result equals phase 7's HEServer result bit for bit; the killed
   worker's follower must end; then a timed pass with the group's counts
   set to 0 before and read after (the split iCRT kernels launch inside
   it, the fused one does not), its drain wall, the collectives' share of
   the worker's busy time and the frame bytes printed beside phases 7, 8
   and 11's drains. 12b: ``paper_params(beta_bits=64)`` uncut on phase
   10's keys: mul, rotate and conjugate through HEServer and through
   HEFrontend with a worker process, equal to phase 10's single ops word
   for word (int64 (N, qlimbs) from the frontend); one ``HESession.run``
   of ((x·x) + x).rotate(1).conj() equal to ``execute_circuit_reference``
   of its compiled ops and within 1e-2; the B = BETA64_BATCH step on the
   2-rank grid equal to phase 10c's words, its schedule (the column form)
   == ``he_expected_collectives``. 12c: one bootstrap at
   ``boot_params(logN=4, beta_bits=64)`` served through an HESession,
   equal to the plain ``execute_circuit_reference`` and within
   ``error_bound()``. No kernel launches at β = 2^64 (checked). 12d: the
   2-rank kernel step at ``paper_params()`` with ``icrt_strategy="acc3"``
   (every strategy name takes the split kernels on a grid) equal to 11b's
   default words at logQ, its schedule the matmul form's. 12b's grid step
   and 12d share one spawn of the grid.
13. The LM serving path (``repro_torch.models``, ``configs``, ``data``,
   ``launch.serve.generate``), which reaches no kernel of the port (the
   reference's reaches no ``pallas_call``; checked: the launch counts do
   not move). 13a: LM_ARCH at its full published size in bf16, weights
   and a random prompt from LM_SEED, through ``generate`` at batch
   LM_BATCH, prompt LM_PROMPT, gen LM_GEN, twice (the first run and a
   warm one, tokens/s from the warm); prefill timed (median of 5) and
   generate's decode steps one by one (median), LM_PROFILED_STEPS steps
   traced by torch.profiler (device ms, busy share), peak
   ``max_memory_allocated``, all beside the card's name and power limit.
   13b, TF32 off: the same config in f32: the prompt decoded step by step
   from an empty cache ends within 2e-2 of prefill's logits
   (tests/test_arch_smoke.py's limit), and at B = 1, L = LM_CPU_PROMPT the
   card's prefill logits are within 1e-3 of the same weights' on the CPU.
   13c: every arch's ``reduced()`` config in f32, a ``SyntheticLM`` batch
   on the card: decode from an empty cache within 2e-2 of prefill, and
   ``generate``'s logits along its tokens within 1e-4 of the CPU's, its
   tokens the CPU's wherever the CPU's top-2 gap exceeds 1e-3.

14. The LM training path (``repro_torch.optim``, ``ckpt``,
   ``dist.collectives``, ``launch.train``), which reaches no kernel of the
   port either (the reference's reaches no ``pallas_call``; checked: the
   launch counts do not move). The Trainer runs under
   ``torch.use_deterministic_algorithms(True)``, so this script sets
   ``CUBLAS_WORKSPACE_CONFIG`` before torch is imported. 14a: LM_ARCH at
   its full published size (bf16 parameters, f32 moments, weights from
   LM_SEED) through ``Trainer(TrainConfig(batch=TRAIN_BATCH,
   seq_len=TRAIN_SEQ, steps=TRAIN_STEPS, warmup_steps=2))``: every loss
   finite, every leaf's first moment nonzero, every parameter changed but
   the bf16 norm scales still at 1.0 (bf16's spacing there is over ten
   times AdamW's largest step at peak_lr, so the update rounds away, as in
   the reference); the step wall (median of steps 3–6,
   host clock + sync), tokens/s, peak memory above what earlier phases
   hold, one more step traced by torch.profiler (device ms, events, busy
   share) and one split into forward+backward and the optimizer (host
   clock + sync). 14b: the same config in f32, TF32 off, at B
   GRAD_CHECK_BATCH, L GRAD_CHECK_SEQ: the central difference of the loss
   along the normalized gradient, ε = GRAD_CHECK_DELTA / ‖∇L‖ (a
   first-order loss change of GRAD_CHECK_DELTA either way), within 1e-2
   of ‖∇L‖ (two more δ printed beside it). 14c: tests/
   test_fault_tolerance.py's reduced config (TRAIN_REDUCED): an
   uninterrupted run and one through ``run_with_restarts`` with failures
   at steps 3 and 6 end with equal parameters and moments bit for bit on
   the card; the same Trainer on the CPU from the card's initial weights
   gives losses within 1e-4 of the card's (TF32 off). 14d: a (2, 1) data
   grid through ``spawn_grid`` (both ranks share the card over gloo: not a
   scaling measurement), TRAIN_DP_STEPS ``compress_dp`` steps of the
   reduced config: both ranks' parameters equal bit for bit, step 0's
   compressed gradient within 3·max|g|/127 of the exact mean of the two
   shards' gradients, and the all-gathered bytes (``grid.log``) beside the
   f32 all-reduce they replace.

15. The LM across TP_RANKS model ranks (``dist.sharding.shard_lm``, the
   models' ``grid=`` path, ``generate(grid=)``), which reaches no kernel of
   the port (checked in this process and in each rank). The ranks are one
   ``spawn_grid`` sharing the card over gloo (NCCL refuses two ranks on
   one GPU), so their walls measure the gloo host path, not scaling. Each
   rank builds every model from LM_SEED and keeps its shard; this process
   runs one rank's references first, TF32 off. 15a: llama3.2-1b
   ``reduced(n_kv_heads=2)`` (the Megatron attention) and falcon-mamba-7b
   ``reduced()`` (the gathered SSM) in f32, B 2, prompt 16: the logits of
   prefill and TP_DECODE_STEPS decode steps within 1e-4 of one rank's and
   the tokens equal. 15b: LM_ARCH at its full published size in f32, B
   LM_BATCH, prompt LM_PROMPT, the same check; each rank holds exactly
   its chunk of every split leaf and every whole one (≈ half the model).
   15c: the same model in bf16 at phase 13's shape (gen LM_GEN): tokens/s
   (warm run), prefill ms (median of 5), each decode step timed (host
   clock + sync; median) with its collectives from ``comm.summary`` (count
   by kind, ring wire bytes, seconds, their share of the step), peak
   memory a rank, and the first position where the tokens leave one
   rank's, where one rank's top-2 logit gap must be at most 0.1.

16. The recurrent families at full width (``models/ssm.py`` and
   ``models/rglru.py``: their scans run in chunks, each rematerialized
   while gradients are recorded), which reach no kernel of the port
   (checked: the launch counts do not move). 16a falcon-mamba-7b and 16b
   recurrentgemma-2b at their full published sizes in bf16, weights and a
   random prompt from LM_SEED, through ``generate`` at batch REC_BATCH,
   prompt REC_PROMPT, gen REC_GEN (tokens/s of that run); prefill timed
   REC_PREFILL_RUNS times (median), generate's decode steps one by one
   (median), REC_PROFILED_STEPS steps traced by torch.profiler (device
   events, busy share), peak memory above what earlier phases hold; then
   the same config in f32, TF32 off: the prompt's first row decoded step
   by step from an empty cache ends within 2e-2 of prefill's logits. 16c,
   TF32 off: each at full width and cut depth (REC_ARCHS: falcon-mamba-7b
   2 layers, recurrentgemma-2b one whole pattern of 3) in f32, B 1, prompt
   REC_PROMPT: prefill's logits and REC_CPU_DECODE decode steps' within
   1e-4 of the same weights' on the CPU. 16d: falcon-mamba-7b at
   REC_TRAIN_LAYERS layers, remat "full", B 1, L REC_TRAIN_SEQ: one
   ``loss_fn`` forward and backward with ``ssm_chunk`` 128 and one with a
   single chunk, under deterministic algorithms; their gradients equal bit
   for bit, the 128-step chunks peaking lower above what is held; each
   run's peak and wall printed.

Before the last line it prints the nvidia-smi line, one JSON line of
per-kernel numbers (``{"kernels": [...]}``: the headline times are those
of ``headline_shape``, HE Mul's region 1 for a kernel and the batched
step's first shape for a variant; every shape is under ``shapes``) and JSON
lines for HE Mul's times, the batched step's and their traces;
the circuit path's JSON line, the serving JSON line
(``{"serving": {...}}``), the multi-host JSON line (``{"multihost":
{...}}``), the bootstrap JSON line (``{"bootstrap": {...}}``), the
β = 2^64 JSON line (``{"beta64": {...}}``), the grid JSON line
(``{"grid": {...}}``), the phase 12 JSON line (``{"finish": {...}}``),
the LM JSON line (``{"lm": {...}}``), the training JSON line
(``{"train": {...}}``), the tensor-parallel JSON line (``{"tp":
{...}}``), the recurrent families' JSON line (``{"recurrent": {...}}``)
and the nvidia-smi line again; the
last line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# phase 14's deterministic training needs cuBLAS's deterministic workspace,
# which torch sizes at this process's first cuBLAS call (the spawned ranks
# inherit it)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# the carry kernels a batched step launches, which the single ops leave to
# core.bigint: the ÷Q shift of the key switch's two polynomials, and the
# combine's add and mask of each output polynomial (a Galois step combines
# bx only)
STEP_CARRY = {"carry_shift": 2, "carry_add": 2}
GALOIS_STEP_CARRY = {"carry_shift": 2, "carry_add": 1}
# the batches of phase 2's carry rows: the batched step's and the
# benchmark's B 16 step
CARRY_BATCHES = (BATCH, 16)
# rungs of the paper's ladder the batched step runs through the kernels:
# keywords of make_he_mul_step, and the launches of one step (Fig. 2:
# 5 CRT, 5 NTT, 5 iNTT, 5 iCRT, 3 Montgomery products; the carries)
RUNGS = {
    "default": ({}, {"crt": 5, "ntt": 5, "intt": 5, "icrt": 5,
                     "modmul": 3, **STEP_CARRY}),
    "mod2+modified": ({"crt_strategy": "mod2", "modified_shoup": True},
                      {"crt_mod2": 5, "ntt_modified": 5, "intt_modified": 5,
                       "icrt": 5, "modmul": 3, **STEP_CARRY}),
    "mod4": ({"crt_strategy": "mod4"}, {"crt_mod4": 5, "ntt": 5, "intt": 5,
                                        "icrt": 5, "modmul": 3,
                                        **STEP_CARRY}),
}
# Phase 6, the circuit path: the rotation keys it makes (circuit B's
# rotate(1) and slot sum over AFFINE_SLOTS slots, the slot-sum step), and
# the launches of one single-ciphertext op, read off the code: a Galois
# op is region 2 alone (core/rotate.py _apply_galois: 1 CRT→NTT, 2
# iNTT→iCRT), he_mul_plain region 1 alone (core/heaan.py: 3 CRT→NTT, 2
# Montgomery products, 2 iNTT→iCRT); the limb ops launch nothing. A
# batched step launches what one op does (the batch folds into each
# launch) and, where it key-switches, the carry kernels (GALOIS_STEP_CARRY
# a Galois op; a slot sum's round adds its two accumulations).
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
SERVE_KERNELS = ("modmul", "ntt", "intt", "crt", "icrt", "carry_shift",
                 "carry_add")
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
# Phase 12b: the batch of the β = 2^64 servers (a plain step at B = 4
# takes ≈ 3 s; one item a batch keeps the served stream to a few seconds)
BETA64_SERVE_BATCH = 1
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
# Phase 13, the LM serving path: the served model at full size, its batch,
# prompt and generated tokens, the seed of its weights and prompt, the
# decode steps one trace covers, the card-against-CPU prompt of 13b, and
# 13c's batch, prompt and generated tokens at reduced() size
LM_ARCH = "llama3.2-1b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 128, 32
LM_SEED = 0
LM_PROFILED_STEPS = 8
LM_CPU_PROMPT = 16
LM_REDUCED_BATCH, LM_REDUCED_PROMPT, LM_REDUCED_GEN = 2, 16, 4
# Phase 14, the LM training path: 14a's batch, sequence and steps at full
# size, 14b's batch, sequence and first-order loss change, 14c's reduced
# config (tests/test_fault_tolerance.py's) and its run, 14d's steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 128, 6
GRAD_CHECK_BATCH, GRAD_CHECK_SEQ = 2, 64
GRAD_CHECK_DELTA = 1e-2
TRAIN_REDUCED = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                     head_dim=32, d_ff=128, vocab_size=256)
TRAIN_REDUCED_RUN = dict(batch=2, seq_len=16, steps=8, ckpt_every=2,
                         warmup_steps=2)
TRAIN_DP_STEPS = 4
# Phase 15, the LM across model ranks: the ranks sharing the card, the
# decode steps 15a and 15b hold against one rank, and 15a's reduced
# configs (the Megatron attention; the gathered SSM)
TP_RANKS = 2
TP_DECODE_STEPS = 8
TP_REDUCED = (("llama3.2-1b", {"n_kv_heads": 2}), ("falcon-mamba-7b", {}))
# Phase 16, the recurrent families at full width: each arch with 16c's
# depth (one layer pattern at least), the serving shape, the timed
# prefills, the traced decode steps, 16c's decode steps, and 16d's depth,
# length and chunks (128-step chunks against one chunk)
REC_ARCHS = (("falcon-mamba-7b", 2), ("recurrentgemma-2b", 3))
REC_BATCH, REC_PROMPT, REC_GEN = 4, 128, 16
REC_PREFILL_RUNS = 3
REC_PROFILED_STEPS = 4
REC_CPU_DECODE = 4
REC_TRAIN_LAYERS, REC_TRAIN_SEQ = 2, 2048
REC_TRAIN_CHUNKS = (128, 2048)
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
    # no Pallas kernel: the JAX package leaves these chains to XLA
    "carry_shift": ("kernels/csrc/carry.cu", None),
    "carry_add": ("kernels/csrc/carry.cu", None),
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


def carry_cases(torch, params, dev):
    """kernel_cases for the carry kernels at the top level: the ÷Q shift
    (ks_limbs → qlimbs) and the combine's add and mask (qlimbs, mask logQ)
    at each of CARRY_BATCHES' B·N rows. The shift's bytes are the limbs
    from its rounding bit's up and its output; the add's its two inputs'
    limbs below the mask and its output."""
    from repro_torch.kernels.carry.ops import add_mask_op, shift_round_op
    from repro_torch.kernels.carry.ref import add_mask_ref, shift_round_ref

    K, _, _, ks = level_shapes(params, params.logQ)
    s = bits = params.logQ
    g = torch.Generator(device=dev).manual_seed(2025)
    cases = []
    for B in CARRY_BATCHES:
        n = B * params.N

        def words(L):
            return torch.randint(-2**31, 2**31 - 1, (n, L), device=dev,
                                 dtype=torch.int32, generator=g)

        x, a, b = words(ks), words(K), words(K)
        c0 = (s - 1) // 32
        cases.append(("carry_shift", f"L={ks}->{K} B={B}",
                      lambda x=x: shift_round_op(x, s, K),
                      lambda x=x: shift_round_ref(x, s, K),
                      4 * n * ((ks - c0) + K), 0, None))
        C = -(-bits // 32)
        cases.append(("carry_add", f"L={K} B={B}",
                      lambda a=a, b=b: add_mask_op(a, b, bits),
                      lambda a=a, b=b: add_mask_ref(a, b, bits),
                      4 * n * (2 * C + K), 0, None))
    return cases


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
    cases += [(params.logQ, c) for c in carry_cases(torch, params, dev)]
    for level, (name, shape, kern, plain, nbytes, nmul, floor) in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        require(got.shape == want.shape and torch.equal(got, want),
                f"{name} {shape}: kernel differs from its plain version "
                f"(max abs err {err})")
        b_ms, b_by = bound_ms(nbytes, nmul)
        row = {"shape": shape, "level": level,
               "batch": int(shape.split("B=")[1]) if "B=" in shape else 1,
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
                   summed(GALOIS_LAUNCHES, GALOIS_STEP_CARRY)),
        "rotate mod2+modified": (
            E.make_he_rotate_step(st, dev, R.rotation_k(params, 1), **mod2),
            (t2, tk[1], ax, bx),
            lambda i: R.he_rotate(cts[i], 1, rks[1], params),
            {"crt_mod2": 1, "ntt_modified": 1, "intt_modified": 2,
             "icrt": 2, **GALOIS_STEP_CARRY}),
        "conjugate": (E.make_he_rotate_step(st, dev, R.conjugation_k(params),
                                            **on),
                      (t2, tk["conj"], ax, bx),
                      lambda i: R.he_conjugate(cts[i], ck, params),
                      summed(GALOIS_LAUNCHES, GALOIS_STEP_CARRY)),
        "slot_sum": (E.make_slot_sum_step(st, dev, AFFINE_SLOTS, **on),
                     (t2, tuple(tk[r] for r in ss), ax, bx),
                     lambda i: slot_sum(cts[i]),
                     scaled(summed(GALOIS_LAUNCHES, GALOIS_STEP_CARRY,
                                   {"carry_add": 2}), len(ss))),
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


def serve_stream(torch, server, reqs, circs, drain=None) -> tuple:
    """Phase 7's stream on `server` (an HEServer or an HEFrontend): the
    requests, the first circuit, one flush (the two degree-4 circuits run
    out of phase), the rest, a drain (`drain(server)`, default
    ``server.drain()``). Operands are moved to the server's device first,
    outside the timed span. Returns the results in submit order and the
    drain wall."""
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
    cids, res = [], {}
    if cins:
        cids = [server.submit_circuit(cins[0][0], {"x": cins[0][1]})]
        res = dict(server.poll(flush=True))
        cids += [server.submit_circuit(ops, {"x": x})
                 for ops, x in cins[1:]]
    res.update(drain(server) if drain else server.drain())
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
        med, ms = median_ms(torch, fn, 3)
        prof = profile(torch, fn)
        he_mul[name] = {
            "ms_median": med, "ms": ms, "device_ms": prof["device_ms"],
            "busy_share": prof["busy_share"],
            "device_events": prof["device_events"],
            "port_kernel_launches": prof["port_kernel_launches"]}
    require(he_mul["beta64_plain"]["port_kernel_launches"] == 0,
            "the β=2^64 he_mul launched a port kernel")
    print("he_mul, median of 3 (wall) and one profiled call (device): "
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
        torch, lambda: step(t1, t2, ek, *args), 3)
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
        # phase 12b's keys, ciphertexts, single ops and step
        "_keep": {"run": run, "step_args": args, "step_out": (ax3, bx3)},
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
        row["bytes_per_ms"] = nbytes / row["ms"]
        rows[name].append(row)
        print(f"kernel {name:13s} {label:32s} bitwise ok  {row['ms']:.4f} ms"
              f"  plain {row['plain_ms']:.3f} ms  bound {b_ms:.4f} ms "
              f"({b_by})  {row['bytes_per_ms'] / 1e9:.3f} TB/s", flush=True)

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
            # timed at rank 0's shard (the larger) of each split, the
            # 2-rank grid's first, and the finish on each split's sums
            r = torch.from_numpy(icrt_split_inputs(np, primes, npn, n, rng)[
                "random"].astype(np.uint32).view(np.int32)).to(dev)
            tag = f" B={B}" if B > 1 else ""
            sums = {}
            for gsz in ICRT_SPLITS:
                s = prime_rows(npn, gsz, 0)
                ns = s.stop - s.start
                ts = shard(t, s)
                timed("icrt_partial", f"np={ns} of {npn}{tag}",
                      lambda r=r[s], ts=ts: icrt_partial_op(r, ts),
                      lambda r=r[s], ts=ts: icrt_partial_ref(r, ts),
                      4 * ns * n + 16 * n * PL + 8 * n, n * ns * (PL + 3))
                parts = [icrt_partial_op(r[sk], shard(t, sk)) for sk in (
                    prime_rows(npn, gsz, k) for k in range(gsz))]
                sums[gsz] = [sum(p[i] for p in parts) for i in range(3)]
            for gsz in ICRT_SPLITS:
                which = "" if gsz == GRID_RANKS else f" split {gsz}"
                timed("icrt_finish", f"np={npn} out={out_limbs}{which}{tag}",
                      lambda a=sums[gsz], o=out_limbs: icrt_finish_op(
                          *a, t, o),
                      lambda a=sums[gsz], o=out_limbs: icrt_finish_ref(
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
            for _ in range(3):
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
                and "icrt" not in case["launches"]
                and all(case["launches"].get(k, 0) == v
                        for k, v in STEP_CARRY.items())),
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
                  f" ms (median of 3), collectives "
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
            # phase 12d's operands and the one-rank words it is held to
            "_keep": {"evk": on_host(evk), "operands": operands[params.logQ],
                      "want": refs[(params.logQ, "default")]},
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


def drain_reviving(server) -> dict:
    """Drain an HEFrontend whose only worker may die: a poll that finds no
    live worker leaves its batch queued (NoLiveWorkersError), the workers
    are revived and polling goes on. Returns {rid: result} with
    ``server.revivals`` counting the revivals."""
    from repro_torch.hserve import NoLiveWorkersError
    res: dict = {}
    server.revivals = 0
    while server.queue.depth or server._work_pending() or server._circuits:
        try:
            res.update(server.poll(flush=True))
        except NoLiveWorkersError:
            server.revive_workers()
            server.revivals += 1
    return res


def finish_grid_rank(grid, p32, evk32, operands32, want32, p64, evk64,
                     args64, want64) -> dict:
    """Phase 12b's and 12d's steps in one rank of the 2-rank grid: at
    β = 2^64 the plain step at B = BETA64_BATCH (its words against the
    one-rank step of phase 10c), and at β = 2^32 the kernel step with
    iCRT "acc3" (against phase 11b's default words); each timed once
    more. Every rank runs the same calls."""
    import torch
    from repro_torch.dist import comm
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.dist.sharding import he_expected_collectives
    from repro_torch.hserve.tables import TableCache
    from repro_torch.kernels import common

    dev = grid.device
    out = {"rank": grid.rank}
    for name, params, evk, xs, want, kw in (
            ("acc3", p32, evk32, operands32, want32,
             {"use_kernels": True, "icrt_strategy": "acc3"}),
            ("beta64", p64, evk64, args64, want64, {})):
        cache = TableCache(params, evk, device=dev, grid=grid)
        t1, t2 = cache.level_tables(params.logQ)
        st = hp.he_static(params, params.logQ)
        step = hp.make_he_mul_step(st, dev, grid=grid, **kw)
        xs = [x.to(dev) for x in xs]

        def run(step=step, t1=t1, t2=t2, xs=xs, cache=cache):
            return step(t1, t2, cache.evk(), *xs)

        sync(torch, dev)
        comm.reset(grid)
        common.reset_launches()
        got = run()
        sync(torch, dev)
        launches = {k: v for k, v in common.LAUNCHES.items() if v}
        exp = he_expected_collectives(
            "mul", grid, params, params.logQ, batch=xs[0].shape[0],
            icrt_strategy=kw.get("icrt_strategy", "matmul"),
            use_kernels=kw.get("use_kernels", False))
        case = {"bitwise": all(torch.equal(a.cpu(), b)
                               for a, b in zip(got, want)),
                "launches": launches, "schedule": comm.summary(grid, "step"),
                "expected": {"counts": exp["counts"],
                             "wire_bytes": exp["wire_bytes"]}}
        comm.reset(grid)
        sync(torch, dev)
        t0 = time.perf_counter()
        run()
        sync(torch, dev)
        ms = [(time.perf_counter() - t0) * 1e3]
        timed = comm.summary(grid, "step")
        case.update(ms=ms, ms_per_step=statistics.median(ms),
                    collective_share=timed["seconds"] * 1e3 / sum(ms))
        out[name] = case
        del cache, step, got
    return out


def drive_finish_path(torch, np, params, dev, common, evk, keys, stream,
                      serving, multihost, beta64, grid) -> dict:
    """Phase 12 (see the module docstring)."""
    import dataclasses
    from repro_torch.boot import boot_params, bootstrap_circuit
    from repro_torch.client import HESession
    from repro_torch.core import heaan as H
    from repro_torch.core.cipher import EvalKey
    from repro_torch.core.keys import keygen
    from repro_torch.core.params import paper_params
    from repro_torch.core.rns import PipelineConfig
    from repro_torch.core.rotate import conj_keygen, rot_keygen
    from repro_torch.dist import he_pipeline as hp
    from repro_torch.hserve import HEFrontend, HEServer
    from repro_torch.hserve import circuit as C
    from repro_torch.launch.mesh import spawn_grid
    from repro_torch.runtime import FailureInjector

    phase_t0 = time.perf_counter()
    plain = PipelineConfig(use_kernels=False)
    out: dict = {}

    def on_host(key):
        return EvalKey(*(getattr(key, f).cpu() for f in hp.EVK_TABLE_KEYS))

    def ended(pid) -> bool:
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except FileNotFoundError:
            return True

    def wait_ended(pids, timeout_s=30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(ended(p) for p in pids):
                return True
            time.sleep(0.2)
        return False

    # ---- 12a: the frontend's worker process on a 2-rank grid -------------
    reqs, _, outs, labels = stream
    top = f"@{params.logQ}"
    cut = [i for i, r in enumerate(reqs) if r[0].endswith(top)]
    reqs12 = [reqs[i] for i in cut]
    want12 = [outs[i] for i in cut]
    labels12 = [labels[i] for i in cut]
    rks, ck = keys
    t0 = time.perf_counter()
    fe = HEFrontend(params, evk, rks, ck, workers=1, transport="subprocess",
                    worker_device=str(dev), worker_devices=GRID_RANKS,
                    batch=SERVE_BATCH, schedule=True,
                    injector=FailureInjector(kill_worker_at={0: 2}))
    a: dict = {"start_s": time.perf_counter() - t0,
               "requests": len(reqs12), "init_bytes": fe.workers[0].init_bytes}
    try:
        first = list(fe.workers[0].followers)
        require(len(first) == GRID_RANKS - 1 and not any(map(ended, first)),
                f"12a: the worker's followers {first}")
        got, a["kill_drain_s"] = serve_stream(torch, fe, reqs12, [],
                                              drain=drain_reviving)
        for label, x, y in zip(labels12, got, want12):
            require(same_ct(x, y), f"12a: {label} through the killed and "
                    f"revived worker grid differs from phase 7's HEServer")
        fr = fe.stats()["frontend"]
        require(fe.revivals == 1 and fr["deaths"] == 1
                and fr["requeued_requests"] > 0 and fr["alive"] == 1,
                f"12a: the kill and revival did not happen as set: {fr}")
        require(wait_ended(first), f"12a: a follower {first} outlived its "
                f"killed worker")
        require(fe.workers[0].followers
                and fe.workers[0].followers != first,
                "12a: the revived worker spawned no new follower")
        a["kill"] = {k: fr[k] for k in ("deaths", "requeued_requests")}
        fe.injector = None
        # the timed pass: the group's counts set to 0 just before it and
        # read just after
        fe.reset_metrics()
        fe.worker_stats(reset_launches=True)
        got, a["drain_s"] = serve_stream(torch, fe, reqs12, [])
        snap = fe.worker_stats()[0]
        for label, x, y in zip(labels12, got, want12):
            require(same_ct(x, y), f"12a: {label} differs from phase 7's")
        a["launches"] = {k: v for k, v in snap["kernels"].items() if v}
        # (a rehearsal on the CPU launches nothing)
        require(dev.type != "cuda" or (
            a["launches"].get("icrt_partial", 0) > 0
            and a["launches"].get("icrt_finish", 0) > 0
            and "icrt" not in a["launches"]
            and all(a["launches"].get(k, 0) > 0 for k in STEP_CARRY)),
                f"12a: the split or carry kernels did not launch inside "
                f"the worker group: {a['launches']}")
        w = fe.workers[0]
        a["batches"] = len(w.frame_log)
        a["busy_s"] = w.busy_s
        a["frame_bytes"] = [f["send"]["bytes"] + f["recv"]["bytes"]
                            for f in w.frame_log]
        a["grid_step"] = snap["grid"]["step"]
        a["collective_share"] = snap["grid"]["step"]["seconds"] / w.busy_s
        a["followers"] = list(w.followers)
    finally:
        fe.close()
    require(wait_ended(first + a.get("followers", [])),
            "12a: a follower outlived the frontend")
    mh_sub = multihost.get("subprocess", {})
    print(f"12a: {len(reqs12)} of phase 7's requests (those at logq "
          f"{params.logQ}; no circuit) through 1 worker process on a "
          f"{GRID_RANKS}-rank grid of one card: killed at its 2nd batch, "
          f"{a['kill']['requeued_requests']} requests requeued, revived (a "
          f"new follower), every result == phase 7's HEServer bit for bit; "
          f"timed drain {a['drain_s'] * 1e3:.1f} ms in {a['batches']} "
          f"batches, collectives {a['collective_share']:.1%} of the "
          f"worker's busy {a['busy_s'] * 1e3:.1f} ms, frame bytes "
          f"{a['frame_bytes']}; worker group launches {a['launches']}. "
          f"Beside (whole stream of {len(reqs)} requests + 3 circuits): "
          f"phase 7 HEServer {serving['first_drain_s'] * 1e3:.1f} ms, "
          f"phase 8 worker processes "
          f"{mh_sub.get('drain_s', float('nan')) * 1e3:.1f} ms, phase 11c "
          f"HEServer(grid=) {grid['serving']['drain_s'] * 1e3:.1f} ms",
          flush=True)
    out["12a"] = a

    # ---- 12b: β = 2^64 served, uncut --------------------------------------
    keep = beta64.pop("_keep")
    run = keep["run"]
    p64 = paper_params(beta_bits=64)
    b: dict = {}
    singles = {"mul": run["mul"], "rotate": run["rot"],
               "conjugate": run["conj"]}

    def submit64(server, c1, c2):
        return {"mul": server.submit_mul(c1, c2),
                "rotate": server.submit_rotate(c1, 1),
                "conjugate": server.submit_conjugate(c1)}

    common.reset_launches()
    srv = HEServer(p64, run["evk"], {1: run["rk"]}, run["ck"], device=dev,
                   batch=BETA64_SERVE_BATCH, use_kernels=False)
    sync(torch, dev)
    t0 = time.perf_counter()
    rids = submit64(srv, run["c1"], run["c2"])
    res = srv.drain()
    sync(torch, dev)
    b["heserver_drain_s"] = time.perf_counter() - t0
    for op, rid in rids.items():
        require(same_ct(res[rid], singles[op]),
                f"12b: HEServer {op} at β=2^64 differs from the single op")
    del srv
    host = torch.device("cpu")
    t0 = time.perf_counter()
    fe = HEFrontend(p64, on_host(run["evk"]), {1: on_host(run["rk"])},
                    on_host(run["ck"]), workers=1, transport="subprocess",
                    worker_device=str(dev), batch=BETA64_SERVE_BATCH,
                    use_kernels=False)
    try:
        b["frontend_start_s"] = time.perf_counter() - t0
        b["frontend_init_bytes"] = fe.workers[0].init_bytes
        t0 = time.perf_counter()
        rids = submit64(fe, run["c1"].to(host), run["c2"].to(host))
        res = fe.drain()
        b["frontend_drain_s"] = time.perf_counter() - t0
        for op, rid in rids.items():
            x = res[rid]
            require(x.ax.dtype == torch.int64
                    and x.ax.shape == singles[op].ax.shape
                    and same_ct(x, singles[op]),
                    f"12b: HEFrontend {op} at β=2^64 differs from the "
                    f"single op")
        b["frame_bytes"] = [f["send"]["bytes"] + f["recv"]["bytes"]
                            for f in fe.workers[0].frame_log]
        b["worker_launches"] = {k: v for k, v in fe.worker_stats()[0][
            "kernels"].items() if v}
    finally:
        fe.close()
    session = HESession(p64, run["sk"], run["pk"], run["evk"],
                        rot_keys={1: run["rk"]}, conj_key=run["ck"],
                        device=dev, batch=BETA64_SERVE_BATCH,
                        use_kernels=False)
    z1 = run["z"][0]
    x = session.input(run["c1"])
    expr = ((x * x) + x).rotate(1).conj()
    cc = session.compile(expr)
    t0 = time.perf_counter()
    y = session.run([expr])[0].result()
    sync(torch, dev)
    b["session_s"] = time.perf_counter() - t0
    ref = C.execute_circuit_reference(
        cc.ops, cc.inputs, p64, evk=run["evk"], rot_keys={1: run["rk"]},
        conj_key=run["ck"], cfg=plain)
    require(same_ct(y, ref), "12b: HESession.run at β=2^64 differs from "
            "execute_circuit_reference of its compiled ops")
    b["session_err"] = float(np.abs(
        session.decrypt(y) - np.conj(np.roll(z1 * z1 + z1, -1))).max())
    require(b["session_err"] < 1e-2,
            f"12b: HESession.run decrypts {b['session_err']:.2e} off")
    require(sum(common.LAUNCHES.values()) == 0,
            f"12b: the β=2^64 path launched a kernel: {common.LAUNCHES}")
    del session
    print(f"12b: paper_params(beta_bits=64) uncut: mul, rotate, conjugate "
          f"through HEServer ({b['heserver_drain_s'] * 1e3:.1f} ms drain) "
          f"and through HEFrontend with a worker process (init frame "
          f"{b['frontend_init_bytes'] / 1e6:.1f} MB, drain "
          f"{b['frontend_drain_s'] * 1e3:.1f} ms, frames {b['frame_bytes']} "
          f"B) == the single ops word for word, int64 (N, qlimbs); "
          f"HESession.run ((x*x)+x).rotate(1).conj() == "
          f"execute_circuit_reference, error {b['session_err']:.2e}, in "
          f"{b['session_s']:.1f} s; no kernel launched", flush=True)

    # ---- 12c: one bootstrap at boot_params(logN=4, beta_bits=64) ---------
    pb = boot_params(logN=4, beta_bits=64)
    sk, pk, bevk = keygen(pb, seed=0, cfg=plain, device=dev)
    plan = bootstrap_circuit(pb, logq_in=pb.logp, device=dev)
    rot = {req[1]: rot_keygen(pb, sk, req[1], cfg=plain, device=dev)
           for req in plan.requires if req[0] == "rot"}
    conj = conj_keygen(pb, sk, cfg=plain, device=dev) \
        if ("conj",) in plan.requires else None
    server = HEServer(pb, bevk, rot, conj, device=dev, batch=BOOT_BATCH,
                      schedule=True, use_kernels=False)
    session = HESession(pb, sk, pk, bevk, server=server, device=dev)
    rng = np.random.default_rng(21)
    z = rng.uniform(-1, 1, pb.n_slots_max) + 1j * rng.uniform(
        -1, 1, pb.n_slots_max)
    z *= 2.0 ** -5 / np.max(np.abs(z))
    ct = H.he_mod_down(H.encrypt_message(z, pk, pb, seed=31, cfg=plain), pb,
                       pb.logp)
    t0 = time.perf_counter()
    refreshed = session.bootstrap(ct).result()
    sync(torch, dev)
    c = {"drain_s": time.perf_counter() - t0, "nodes": len(plan.ops)}
    want = C.execute_circuit_reference(plan.resolved_ops(), {"x": ct}, pb,
                                       evk=bevk, rot_keys=rot,
                                       conj_key=conj, cfg=plain)
    require(refreshed.ax.dtype == torch.int64 and same_ct(refreshed, want),
            "12c: the served β=2^64 bootstrap differs from the plain "
            "execute_circuit_reference")
    c["err"] = float(np.abs(session.decrypt(refreshed) - z).max())
    c["bound"] = plan.error_bound()
    require(c["err"] <= c["bound"], f"12c: bootstrap error {c['err']:.3e} "
            f"over its bound {c['bound']:.3e}")
    require(sum(common.LAUNCHES.values()) == 0,
            f"12c: the β=2^64 bootstrap launched a kernel: {common.LAUNCHES}")
    del server, session
    print(f"12c: one bootstrap at boot_params(logN=4, beta_bits=64) served "
          f"({c['nodes']} nodes, {c['drain_s']:.2f} s) == the plain path "
          f"bit for bit, error {c['err']:.3e} within {c['bound']:.3e}",
          flush=True)

    # ---- 12b's step on the grid and 12d, in one spawn ---------------------
    g = grid.pop("_keep")
    t0 = time.perf_counter()
    ranks = spawn_grid(
        finish_grid_rank, model=GRID_RANKS, device=dev.type,
        args=(params, g["evk"], g["operands"], g["want"], p64,
              on_host(run["evk"]), [x.cpu() for x in keep["step_args"]],
              [x.cpu() for x in keep["step_out"]]))
    spawn_s = time.perf_counter() - t0
    for res in ranks:
        for name in ("acc3", "beta64"):
            case = res[name]
            what = f"rank {res['rank']} {name}"
            require(case["bitwise"], f"12b/12d: the 2-rank step {what} "
                    f"differs from the one-rank words")
            sch, exp = case["schedule"], case["expected"]
            require(sch["counts"] == exp["counts"]
                    and sch["total_bytes"] == exp["wire_bytes"],
                    f"12b/12d: {what} schedule {sch['counts']} "
                    f"{sch['total_bytes']} against {exp}")
        require(dev.type != "cuda" or (
            res["acc3"]["launches"].get("icrt_partial", 0) > 0
            and "icrt" not in res["acc3"]["launches"]
            and all(res["acc3"]["launches"].get(k, 0) == v
                    for k, v in STEP_CARRY.items())),
                f"12d: rank {res['rank']} launches {res['acc3']['launches']}")
        require(not res["beta64"]["launches"],
                f"12b: the β=2^64 grid step launched "
                f"{res['beta64']['launches']}")
    r0 = ranks[0]
    for name, what in (("beta64", "12b: make_he_mul_step at β=2^64"),
                       ("acc3", "12d: iCRT \"acc3\" on the kernel path")):
        case = r0[name]
        print(f"{what}, B = {BETA64_BATCH if name == 'beta64' else BATCH} "
              f"on {GRID_RANKS} ranks of one card: == the one-rank words; "
              f"{case['ms_per_step']:.1f} ms a step (median of "
              f"{len(case['ms'])}), "
              f"collectives {case['collective_share']:.1%}; schedule "
              f"{case['schedule']['counts']} "
              f"{case['schedule']['total_bytes']:.0f} B == expected",
              flush=True)
    b["grid_step"] = {k: v for k, v in r0["beta64"].items()}
    out["12b"] = b
    out["12c"] = c
    out["12d"] = r0["acc3"]
    out["grid_spawn_and_run_s"] = spawn_s
    # rank 0's launches in 12a's timed pass (inside the worker) and 12d
    out["launches"] = summed(a["launches"], r0["acc3"]["launches"])
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase 12 took {out['phase_s']:.1f} s", flush=True)
    return out


def close_to(got, want, tol: float) -> tuple[bool, float]:
    """(every |got − want| ≤ tol + tol·|want|, the largest |got − want|):
    numpy's assert_allclose at rtol = atol = tol, on the host."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = (got - want).abs()
    return (bool((err <= tol + tol * want.abs()).all()),
            float(err.max()) if err.numel() else 0.0)


def forced_logits(model, cfg, batch: dict, toks, max_len: int,
                  grid=None) -> list:
    """The logits ``generate`` computes along its tokens `toks`: prefill's,
    then each decode step's fed toks[:, i] (the last token's step, whose
    logits choose nothing, is left out); with `grid`, one rank's."""
    from repro_torch.models import decode_step, prefill
    logits, cache = prefill(model, batch, cfg, max_len, grid=grid)
    out = [logits]
    L = batch["tokens"].shape[1]
    for i in range(toks.shape[1] - 1):
        logits, cache = decode_step(model, cache, toks[:, i: i + 1], L + i,
                                    cfg, grid=grid)
        out.append(logits)
    return out


def drive_lm_path(torch, np, dev, common, card: str) -> dict:
    """Phase 13: the LM serving path (see the module docstring)."""
    import dataclasses
    from repro_torch.configs.registry import ARCHS, get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.examples.serve_lm import decode_from_empty
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_params, prefill

    phase_t0 = time.perf_counter()
    out: dict = {"card": card}
    before = dict(common.LAUNCHES)
    cpu = torch.device("cpu")
    cfg = get_arch(LM_ARCH)
    B, L, G = LM_BATCH, LM_PROMPT, LM_GEN
    max_len = L + G + 8             # the command line's
    tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, size=(B, L)).astype(np.int32)).to(dev)

    # ---- 13a: the full config in bf16 through generate ------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        LM_SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    walls = []
    for _ in range(2):              # the first run, then a warm one
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = generate(model, cfg, tokens, G, max_len)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    require(toks.shape == (B, G) and toks.dtype == torch.int32
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"13a: generate gave {tuple(toks.shape)} {toks.dtype}")
    prefill_ms, prefill_runs = median_ms(
        torch, lambda: prefill(model, {"tokens": tokens}, cfg, max_len), 5)
    logits, cache = prefill(model, {"tokens": tokens}, cfg, max_len)
    require(bool(torch.isfinite(logits).all()), "13a: prefill logits")
    step_ms = []
    for i in range(G):              # generate's steps, each timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = decode_step(model, cache, toks[:, i: i + 1], L + i,
                                    cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    require(bool(torch.isfinite(logits).all()), "13a: decode logits")

    def decode_window():
        for i in range(LM_PROFILED_STEPS):
            decode_step(model, cache, toks[:, i: i + 1], L + i, cfg)

    trace = profile(torch, decode_window)
    decode_ms = statistics.median(step_ms)
    out["full"] = {
        "config": f"{LM_ARCH} (configs/llama3_2_1b.py) bf16, weights from "
                  f"seed {LM_SEED}",
        "batch": B, "prompt": L, "gen": G, "params": n_params,
        "param_bytes": param_bytes, "init_s": init_s,
        "generate_s": walls, "tokens_per_s": B * G / walls[1],
        "prefill_ms": prefill_ms, "prefill_ms_runs": prefill_runs,
        "decode_ms_median": decode_ms, "decode_ms": step_ms,
        "decode_tokens_per_s": B * 1e3 / decode_ms,
        # computed, not measured: the weights read once a step at the
        # memory rate
        "decode_bound_ms_computed": param_bytes / HBM_BYTES_PER_S * 1e3,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "held_before_bytes": held,
        "peak_above_held_bytes": torch.cuda.max_memory_allocated() - held,
        "decode_profile": {k: trace[k] for k in (
            "wall_ms", "device_ms", "busy_share", "device_events", "top")},
        "profiled_steps": LM_PROFILED_STEPS,
        # the decode loop is host-bound: what else this process runs
        "host_loadavg": os.getloadavg(),
        "python_threads": threading.active_count(),
        "first_tokens": toks[0, :8].tolist()}
    print(f"13a {LM_ARCH} full bf16 ({n_params / 1e9:.3f} B params, "
          f"{param_bytes / 1e9:.2f} GB) B={B} prompt={L} gen={G}: generate "
          f"{walls[0]:.2f} s first, {walls[1]:.3f} s warm "
          f"({B * G / walls[1]:.1f} tok/s); prefill {prefill_ms:.2f} ms; "
          f"decode {decode_ms:.2f} ms a step (median of {G}; the weights' "
          f"bound {param_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); device busy "
          f"{trace['busy_share']:.1%} over {LM_PROFILED_STEPS} steps "
          f"({trace['device_events']} device events); peak "
          f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.2f} GiB "
          f"above the {held / 2 ** 30:.2f} GiB earlier phases hold; {card}",
          flush=True)
    del model, cache, logits
    torch.cuda.empty_cache()

    # ---- 13b: the full width in f32, TF32 off ---------------------------
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        model = init_params(cfg32, torch.Generator(device=dev).manual_seed(
            LM_SEED), dev)
        batch = {"tokens": tokens}
        pre, _ = prefill(model, batch, cfg32, max_len)
        t0 = time.perf_counter()
        dec = decode_from_empty(model, cfg32, batch, max_len)
        torch.cuda.synchronize()
        ok, err = close_to(dec, pre, 2e-2)
        require(ok, f"13b: {L} decode steps differ from prefill by {err}")
        small = {"tokens": tokens[:1, :LM_CPU_PROMPT]}
        card_logits, _ = prefill(model, small, cfg32, LM_CPU_PROMPT)
        model = model.to(cpu)
        t1 = time.perf_counter()
        cpu_logits, _ = prefill(model, {"tokens": small["tokens"].cpu()},
                                cfg32, LM_CPU_PROMPT)
        cpu_s = time.perf_counter() - t1
        ok2, err2 = close_to(card_logits, cpu_logits, 1e-3)
        require(ok2, f"13b: the card's prefill differs from the CPU's by "
                     f"{err2}")
        out["f32"] = {"decode_vs_prefill_max_abs_err": err,
                      "decode_s": t1 - t0, "tol": 2e-2,
                      "card_vs_cpu_max_abs_err": err2, "cpu_tol": 1e-3,
                      "cpu_prefill_s": cpu_s, "cpu_batch": 1,
                      "cpu_prompt": LM_CPU_PROMPT}
        print(f"13b {LM_ARCH} full f32: {L} decode steps == prefill "
              f"(max |err| {err:.2e} ≤ 2e-2); the card's prefill at B=1 "
              f"L={LM_CPU_PROMPT} == the CPU's (max |err| {err2:.2e} ≤ 1e-3; "
              f"CPU {cpu_s:.1f} s)", flush=True)
        del model
        torch.cuda.empty_cache()

        # ---- 13c: every architecture at reduced(), card against CPU -----
        archs = {}
        for arch in ARCHS:
            rcfg = get_arch(arch).reduced()
            model = init_params(rcfg, torch.Generator(device=dev)
                                .manual_seed(LM_SEED), dev)
            twin = init_params(rcfg, torch.Generator().manual_seed(0), cpu)
            twin.load_state_dict(model.state_dict())
            data = SyntheticLM(rcfg, LM_REDUCED_BATCH, LM_REDUCED_PROMPT,
                               seed=LM_SEED, device=dev)
            batch = {k: v for k, v in data.batch_at(0).items()
                     if k != "labels"}
            host = {k: v.cpu() for k, v in batch.items()}
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            rmax = LM_REDUCED_PROMPT + LM_REDUCED_GEN + 8
            pre, cache = prefill(model, batch, rcfg, rmax)
            dec = decode_from_empty(model, rcfg, batch, rmax, cache)
            ok, err_dec = close_to(dec, pre, 2e-2)
            require(ok, f"13c {arch}: decode differs from prefill by "
                        f"{err_dec}")
            toks = generate(model, rcfg, batch["tokens"], LM_REDUCED_GEN,
                            rmax, batch_extra=extra)
            mine = forced_logits(model, rcfg, batch, toks, rmax)
            cpu_toks = generate(twin, rcfg, host["tokens"], LM_REDUCED_GEN,
                                rmax, batch_extra={k: v for k, v in
                                                   host.items()
                                                   if k != "tokens"})
            theirs = forced_logits(twin, rcfg, host, toks.cpu(), rmax)
            err_cpu, ties = 0.0, 0
            for i, (m, w) in enumerate(zip(mine, theirs)):
                ok, e = close_to(m, w, 1e-4)
                require(ok, f"13c {arch}: step {i}'s logits differ from the "
                            f"CPU's by {e}")
                err_cpu = max(err_cpu, e)
                top2 = w[:, -1].topk(2, dim=-1).values
                clear = (top2[:, 0] - top2[:, 1]) > 1e-3
                ties += int((~clear).sum())
                require(torch.equal(toks[:, i].cpu()[clear],
                                    w[:, -1].argmax(-1).to(torch.int32)
                                    [clear]),
                        f"13c {arch}: token {i} differs from the CPU's")
            archs[arch] = {"decode_vs_prefill": err_dec,
                           "card_vs_cpu": err_cpu,
                           "tokens_equal": bool(torch.equal(toks.cpu(),
                                                            cpu_toks)),
                           "near_ties": ties}
            del model, twin
        out["reduced"] = archs
        worst = {k: max(a[k] for a in archs.values())
                 for k in ("card_vs_cpu", "decode_vs_prefill")}
        same = sum(a["tokens_equal"] for a in archs.values())
        ties = sum(a["near_ties"] for a in archs.values())
        print(f"13c every arch at reduced() f32 on the card == the CPU "
              f"(max |err| {worst['card_vs_cpu']:.2e} ≤ 1e-4; tokens equal "
              f"in {same}/{len(archs)}, near ties {ties}); decode == "
              f"prefill (max |err| {worst['decode_vs_prefill']:.2e} ≤ 2e-2)",
              flush=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    launched_here = {k: v - before[k] for k, v in common.LAUNCHES.items()
                     if v - before[k]}
    # no pallas_call lies on the LM path, so no kernel of the port does
    require(not launched_here, f"13: the LM path launched {launched_here}")
    out["port_kernel_launches"] = launched_here
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase 13 took {out['phase_s']:.1f} s", flush=True)
    return out


def train_dp_rank(grid, steps: int) -> dict:
    """Phase 14d in one rank: a compress_dp Trainer of the reduced config
    on the grid; step 0's compressed gradient beside the exact mean of the
    ranks' gradients, then `steps` steps; a digest of the parameters."""
    import hashlib
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.dist import comm
    from repro_torch.launch.train import TrainConfig, Trainer, deterministic
    from repro_torch.models import loss_fn
    cfg = get_arch(LM_ARCH).reduced(**TRAIN_REDUCED)
    tr = Trainer(cfg, TrainConfig(**TRAIN_REDUCED_RUN), grid=grid,
                 compress_dp=True)
    batch = tr.data.batch_at(0)
    with deterministic():
        compressed, _ = tr._grads(batch)
        tr.params.zero_grad(set_to_none=True)
        total, _ = loss_fn(tr.params, tr.data.shard_slice(
            batch, grid.data_rank, grid.data), cfg)
        total.backward()
    errs, g_max, numel = [], [], 0
    for k, p in tr.params.named_parameters():
        g_max.append(p.grad.abs().max())
        numel += p.numel()
        exact = comm.all_reduce(grid, p.grad.clone(), axis="data") / grid.data
        errs.append((compressed[k] - exact).abs().max())
    tr.params.zero_grad(set_to_none=True)
    # the largest |g| of any shard: the reference's limit reads it
    g_top = comm.all_gather(grid, torch.stack(g_max).max()[None].cpu(),
                            axis="data", book="feed")
    err = float(torch.stack(errs).max())
    comm.reset(grid)
    t0 = time.perf_counter()
    hist = tr.run(steps)["history"]
    run_s = time.perf_counter() - t0
    log = comm.summary(grid)
    gathers = [r for r in grid.log["step"] if r["kind"] == "all-gather"]
    h = hashlib.sha1()
    for k, v in sorted(tr.params.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return {"rank": grid.rank, "digest": h.hexdigest(),
            "losses": [x["loss"] for x in hist],
            "step_s": [x["sec"] for x in hist], "run_s": run_s,
            "err": err, "g_max": float(g_top.max()), "numel": numel,
            "collectives": log["counts"],
            "all_gather_payload_bytes": sum(r["bytes"] for r in gathers),
            "all_gather_wire_bytes": sum(r["wire_bytes"] for r in gathers),
            "collective_s": log["seconds"], "backend": grid.backend}


def drive_train_path(torch, np, dev, common, card: str) -> dict:
    """Phase 14: the LM training path (see the module docstring)."""
    import dataclasses
    import tempfile
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.mesh import spawn_grid
    from repro_torch.launch.train import (
        TrainConfig, Trainer, deterministic, run_with_restarts,
    )
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw_update, warmup_cosine
    from repro_torch.runtime import FailureInjector

    phase_t0 = time.perf_counter()
    out: dict = {"card": card}
    before = dict(common.LAUNCHES)
    cfg = get_arch(LM_ARCH)

    # ---- 14a: the full config in bf16 through the Trainer ---------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    tc = TrainConfig(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
                     warmup_steps=2)
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    first = {k: p.detach().clone() for k, p in tr.params.named_parameters()}
    n_params = sum(p.numel() for p in first.values())
    t0 = time.perf_counter()
    hist = tr.run()["history"]
    run_s = time.perf_counter() - t0
    losses = [h["loss"] for h in hist]
    require(len(losses) == TRAIN_STEPS
            and all(np.isfinite(x) for x in losses),
            f"14a: losses {losses}")
    # every gradient reached its leaf; every leaf moved, but a bf16 norm
    # scale at 1.0, whose spacing (2^-8 below 1, 2^-7 above) is over ten
    # times the largest AdamW step at peak_lr (≈ lr·(1 + wd)), so each
    # step rounds back to it in bf16, as it does in the reference
    silent = [k for k, m in tr.opt.mu.items() if not bool(m.any())]
    require(not silent, f"14a: no gradient reached {silent[:4]}")
    unchanged = [k for k, p in tr.params.named_parameters()
                 if torch.equal(p.detach(), first[k])]
    odd = [k for k in unchanged if not (k.endswith("scale") and bool(
        (first[k] == 1).all()) and first[k].dtype == torch.bfloat16)]
    require(not odd, f"14a: parameters unchanged: {odd[:4]}")
    del first
    steady = [h["sec"] * 1e3 for h in hist[2:]]   # steps 3–6
    step_ms = statistics.median(steady)
    peak = torch.cuda.max_memory_allocated()
    trace = profile(torch, lambda: tr.run(tr.step + 1))
    # one more step split at the optimizer (host clock + sync each part)
    batch = tr.data.batch_at(tr.step)
    with deterministic():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _ = tr._grads(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lr = warmup_cosine(tr.opt.step, peak_lr=tc.peak_lr,
                           warmup_steps=tc.warmup_steps,
                           total_steps=tc.steps)
        _, tr.opt, _ = adamw_update(grads, tr.opt, tr.params, lr=lr)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    del grads
    param_bytes = sum(p.numel() * p.element_size()
                      for p in tr.params.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out["full"] = {
        "config": f"{LM_ARCH} (configs/llama3_2_1b.py) bf16 parameters, "
                  f"f32 moments, weights from seed {LM_SEED}; remat "
                  f"{cfg.remat_policy if cfg.remat else 'none'}",
        "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
        "losses": losses, "step_ms": [h["sec"] * 1e3 for h in hist],
        "leaves": len(tr.opt.mu), "unchanged_bf16_norm_scales": unchanged,
        "step_ms_median_3_6": step_ms, "tokens_per_s": tokens * 1e3 / step_ms,
        "run_s": run_s, "fwd_bwd_ms": (t1 - t0) * 1e3,
        "optimizer_ms": (t2 - t1) * 1e3,
        "peak_memory_bytes": peak, "held_before_bytes": held,
        "peak_above_held_bytes": peak - held,
        "step_profile": {k: trace[k] for k in (
            "wall_ms", "device_ms", "busy_share", "device_events", "top")}}
    print(f"14a {LM_ARCH} full bf16 training ({n_params / 1e9:.3f} B "
          f"params) B={TRAIN_BATCH} L={TRAIN_SEQ}: loss at each step "
          f"{', '.join(f'{x:.4f}' for x in losses)}, every leaf's "
          f"moments moved, every parameter but {len(unchanged)} bf16 norm "
          f"scales at 1.0 changed; step {step_ms:.1f} ms (median of steps "
          f"3-6; "
          f"{tokens * 1e3 / step_ms:.0f} tokens/s); one step split: "
          f"forward+backward {(t1 - t0) * 1e3:.1f} ms, AdamW "
          f"{(t2 - t1) * 1e3:.1f} ms; traced step: device "
          f"{trace['device_ms']:.1f} ms of {trace['wall_ms']:.1f} ms wall "
          f"(busy {trace['busy_share']:.1%}, {trace['device_events']} "
          f"device events); peak {(peak - held) / 2 ** 30:.2f} GiB above "
          f"the {held / 2 ** 30:.2f} GiB earlier phases hold; {card}",
          flush=True)
    del tr, batch
    torch.cuda.empty_cache()

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # ---- 14b: the full-width gradient check in f32 -------------------
        cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                    activation_dtype="float32")
        model = init_params(cfg32, torch.Generator(device=dev).manual_seed(
            LM_SEED), dev)
        batch = SyntheticLM(cfg32, GRAD_CHECK_BATCH, GRAD_CHECK_SEQ,
                            seed=LM_SEED, device=dev).batch_at(0)
        params = list(model.parameters())
        with deterministic():
            total, _ = loss_fn(model, batch, cfg32)
            total.backward()
            gnorm = float(torch.sqrt(sum(torch.sum(p.grad.double() ** 2)
                                         for p in params)))

            def loss_at(alpha: float) -> float:
                """L(θ + alpha·ĝ), θ restored afterwards."""
                with torch.no_grad():
                    for p in params:
                        p.add_(p.grad, alpha=alpha / gnorm)
                    val = float(loss_fn(model, batch, cfg32)[0].double())
                    for p in params:
                        p.sub_(p.grad, alpha=alpha / gnorm)
                return val

            checks = {}
            for delta in (1e-1, GRAD_CHECK_DELTA, 1e-3):
                eps = delta / gnorm
                fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
                checks[delta] = {"eps": eps, "central_difference": fd,
                                 "rel_err": abs(fd - gnorm) / gnorm}
        chosen = checks[GRAD_CHECK_DELTA]
        require(chosen["rel_err"] <= 1e-2,
                f"14b: the central difference {chosen['central_difference']}"
                f" against ‖∇L‖ {gnorm} (rel {chosen['rel_err']:.3e})")
        out["grad_check"] = {
            "config": f"{LM_ARCH} full width in f32, TF32 off",
            "batch": GRAD_CHECK_BATCH, "seq_len": GRAD_CHECK_SEQ,
            "loss": float(total.detach()), "grad_norm": gnorm,
            "delta": GRAD_CHECK_DELTA, "tol": 1e-2,
            "by_delta": {str(d): c for d, c in checks.items()}}
        print(f"14b {LM_ARCH} full f32 B={GRAD_CHECK_BATCH} "
              f"L={GRAD_CHECK_SEQ}: ‖∇L‖ {gnorm:.6f}; central difference "
              f"along ∇L/‖∇L‖ at ε = δ/‖∇L‖: " + ", ".join(
                  f"δ={d:g} {c['central_difference']:.6f} (rel "
                  f"{c['rel_err']:.2e})" for d, c in checks.items())
              + f"; δ={GRAD_CHECK_DELTA:g} within 1e-2", flush=True)
        del model, params, batch, total
        torch.cuda.empty_cache()

        # ---- 14c: replay bit for bit; the card against the CPU ------------
        rcfg = get_arch(LM_ARCH).reduced(**TRAIN_REDUCED)
        rtc = TrainConfig(**TRAIN_REDUCED_RUN)
        # a crashed trainer's save thread may still write as this ends
        with tempfile.TemporaryDirectory(prefix="train-",
                                         ignore_cleanup_errors=True) as tmp:
            ref = Trainer(rcfg, rtc, ckpt_dir=os.path.join(tmp, "ref"),
                          device=dev)
            init = {k: v.detach().cpu().clone()
                    for k, v in ref.params.state_dict().items()}
            t0 = time.perf_counter()
            ref_hist = ref.run()["history"]
            ref_s = time.perf_counter() - t0
            inj = FailureInjector(fail_at_steps=[3, 6])
            t0 = time.perf_counter()
            crashed, _, restarts = run_with_restarts(
                lambda: Trainer(rcfg, rtc, ckpt_dir=os.path.join(tmp, "c"),
                                injector=inj, device=dev),
                total_steps=rtc.steps)
            replay_s = time.perf_counter() - t0
        require(restarts == 2, f"14c: {restarts} restarts")
        for k, v in ref.params.state_dict().items():
            require(torch.equal(v, crashed.params.state_dict()[k]),
                    f"14c: the replayed {k} differs")
        for k in ref.opt.mu:
            require(torch.equal(ref.opt.mu[k], crashed.opt.mu[k])
                    and torch.equal(ref.opt.nu[k], crashed.opt.nu[k]),
                    f"14c: the replayed moments of {k} differ")
        cpu = Trainer(rcfg, rtc, device="cpu")
        cpu.params.load_state_dict(init)
        t0 = time.perf_counter()
        cpu_hist = cpu.run()["history"]
        cpu_s = time.perf_counter() - t0
        cpu_err = max(abs(a["loss"] - b["loss"])
                      for a, b in zip(ref_hist, cpu_hist))
        require(cpu_err <= 1e-4, f"14c: the card's losses differ from the "
                                 f"CPU's by {cpu_err}")
        out["reduced"] = {
            "config": f"{LM_ARCH}.reduced({TRAIN_REDUCED}) f32, "
                      f"{TRAIN_REDUCED_RUN}",
            "losses": [h["loss"] for h in ref_hist], "restarts": restarts,
            "replay_bitwise": True, "card_vs_cpu_max_abs_err": cpu_err,
            "tol": 1e-4, "run_s": ref_s, "replay_s": replay_s,
            "cpu_run_s": cpu_s}
        print(f"14c {LM_ARCH} reduced: {rtc.steps} steps, crash at 3 and 6 "
              f"+ {restarts} restarts == the uninterrupted run bit for bit "
              f"(parameters and moments); the card's losses == the CPU's "
              f"(max |err| {cpu_err:.2e} ≤ 1e-4); run {ref_s:.2f} s, replay "
              f"{replay_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
        del ref, crashed, cpu
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    # ---- 14d: compressed data-parallel gradients on a (2, 1) grid --------
    t0 = time.perf_counter()
    ranks = spawn_grid(train_dp_rank, model=1, data=2, device=dev.type,
                       args=(TRAIN_DP_STEPS,))
    dp_s = time.perf_counter() - t0
    r0 = ranks[0]
    require(all(r["digest"] == r0["digest"] for r in ranks)
            and all(r["losses"] == r0["losses"] for r in ranks),
            "14d: the replicas differ")
    require(all(np.isfinite(x) for x in r0["losses"])
            and len(r0["losses"]) == TRAIN_DP_STEPS, f"14d: {r0['losses']}")
    for r in ranks:
        require(r["err"] <= 3 * r["g_max"] / 127.0,
                f"14d: rank {r['rank']}'s compressed gradient is "
                f"{r['err']} from the exact mean (limit "
                f"{3 * r['g_max'] / 127.0})")
    # the f32 all-reduce the gathers replace: 2·S·(g−1)/g ring bytes of the
    # gradients, TRAIN_DP_STEPS times
    f32_wire = TRAIN_DP_STEPS * 2 * 4 * r0["numel"] * (2 - 1) / 2
    out["compressed_dp"] = {
        "note": "2 ranks share one card over gloo: not a scaling "
                "measurement",
        "grid": "2x1", "steps": TRAIN_DP_STEPS, "losses": r0["losses"],
        "replicas_bitwise": True, "spawn_s": dp_s,
        "ranks": [{k: v for k, v in r.items() if k != "losses"}
                  for r in ranks],
        "f32_all_reduce_wire_bytes_replaced": f32_wire}
    print(f"14d compress_dp on a 2x1 grid ({r0['backend']}, one card): "
          f"{TRAIN_DP_STEPS} steps, replicas bit-identical; step 0's "
          f"gradient within {max(r['err'] for r in ranks):.3e} of the "
          f"exact mean (limit {3 * r0['g_max'] / 127.0:.3e}); all-gather "
          f"{r0['all_gather_payload_bytes']} payload bytes, "
          f"{r0['all_gather_wire_bytes']:.0f} ring bytes a rank against "
          f"{f32_wire:.0f} for the f32 all-reduce "
          f"({f32_wire / r0['all_gather_wire_bytes']:.2f}x); "
          f"{r0['collectives']}, {r0['collective_s']:.2f} s in them; "
          f"spawn + run {dp_s:.1f} s", flush=True)

    launched_here = {k: v - before[k] for k, v in common.LAUNCHES.items()
                     if v - before[k]}
    # no pallas_call lies on the training path, so no kernel of the port
    require(not launched_here,
            f"14: the training path launched {launched_here}")
    out["port_kernel_launches"] = launched_here
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase 14 took {out['phase_s']:.1f} s", flush=True)
    return out


def tp_tokens(np, cfg, batch: int, prompt: int):
    """Phase 15's prompt: numpy-seeded tokens on the CPU."""
    import torch
    return torch.from_numpy(np.random.default_rng(LM_SEED).integers(
        0, cfg.vocab_size, size=(batch, prompt)).astype(np.int32))


def tp_config(case):
    from repro_torch.configs.registry import get_arch
    arch, kw = case
    if kw is None:                      # full size, in f32 or bf16
        return get_arch(arch)
    return get_arch(arch).reduced(**kw)


def tp_rank(grid, jobs) -> dict:
    """Phase 15 in one model rank: each job's model from LM_SEED, sharded
    (``shard_lm``), through ``generate(grid=)``; 15a/15b also return the
    logits along its tokens, 15c the timings and a decode step's
    collectives. (The ranks re-import this script, so they wait for the
    card only where they run on one: a CPU grid rehearses them.)"""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import shard_lm
    from repro_torch.kernels import common
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_params, prefill
    dev = grid.device
    card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed(fn):
        sync(torch, dev)
        t0 = time.perf_counter()
        res = fn()
        sync(torch, dev)
        return res, time.perf_counter() - t0

    out = {"rank": grid.rank, "backend": grid.backend, "jobs": []}
    for name, case, dtype, batch, prompt, gen in jobs:
        cfg = tp_config(case)
        if dtype:
            cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                      activation_dtype=dtype)
        model, init_s = timed(lambda: shard_lm(init_params(
            cfg, torch.Generator(device=dev).manual_seed(LM_SEED), dev),
            cfg, grid))
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        res = {"name": name, "init_shard_s": init_s,
               "held_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters())}
        tokens = tp_tokens(np, cfg, batch, prompt).to(dev)
        max_len = prompt + gen + 8
        walls = []
        for _ in range(1 if name != "15c" else 2):  # first run, warm one
            toks, wall = timed(lambda: generate(model, cfg, tokens, gen,
                                                max_len, grid=grid))
            walls.append(wall)
        res["tokens"] = toks.cpu()
        if name != "15c":
            res["logits"] = [t.cpu() for t in forced_logits(
                model, cfg, {"tokens": tokens}, toks, max_len, grid)]
            out["jobs"].append(res)
            del model
            continue
        runs = [timed(lambda: prefill(model, {"tokens": tokens}, cfg,
                                      max_len, grid=grid))[1] * 1e3
                for _ in range(6)][1:]      # after a warm-up run
        (logits, cache), _ = timed(lambda: prefill(
            model, {"tokens": tokens}, cfg, max_len, grid=grid))
        step_ms, steps, by_kind = [], [], []
        for i in range(gen):            # generate's steps, each timed
            comm.reset(grid, "decode")
            (logits, cache), wall = timed(lambda: decode_step(
                model, cache, toks[:, i: i + 1], prompt + i, cfg,
                grid=grid))
            step_ms.append(wall * 1e3)
            steps.append(comm.summary(grid, "decode"))
            kinds: dict = {}
            for rec in grid.log["decode"]:
                kinds[rec["kind"]] = kinds.get(rec["kind"], 0.0) \
                    + rec["seconds"]
            by_kind.append(kinds)
        if card:                        # one more step, traced on each rank
            i = gen - 1
            trace = profile(torch, lambda: decode_step(
                model, cache, toks[:, i: i + 1], prompt + i, cfg,
                grid=grid))
            res["decode_profile"] = {k: trace[k] for k in (
                "wall_ms", "device_ms", "busy_share", "device_events",
                "top")}
        res.update({
            "generate_s": walls, "tokens_per_s": batch * gen / walls[1],
            "prefill_ms": statistics.median(runs), "prefill_ms_runs": runs,
            "decode_ms": step_ms,
            "decode_ms_median": statistics.median(step_ms),
            # the collectives of the median step; their seconds in each
            "decode_collectives": steps[step_ms.index(
                sorted(step_ms)[len(step_ms) // 2])],
            "collective_s_per_step": [st["seconds"] for st in steps],
            "collective_s_by_kind": {k: statistics.median(
                d.get(k, 0.0) for d in by_kind) for k in by_kind[0]},
            "peak_memory_bytes": torch.cuda.max_memory_allocated()
            if card else None,
            "finite": bool(torch.isfinite(logits).all())})
        out["jobs"].append(res)
        del model, cache, logits
    out["port_kernel_launches"] = {k: v for k, v in common.LAUNCHES.items()
                                   if v}
    return out


def drive_tp_path(torch, np, dev, common, card: str,
                  full=(LM_ARCH, None)) -> dict:
    """Phase 15: the LM across model ranks (see the module docstring).
    `full` is the (arch, reduced() overrides or None for the published
    size) of 15b and 15c."""
    import dataclasses
    from repro_torch.dist.sharding import lm_param_specs
    from repro_torch.launch.mesh import GridShape
    from repro_torch.launch.mesh import spawn_grid
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params

    phase_t0 = time.perf_counter()
    out: dict = {"card": card, "ranks": TP_RANKS,
                 "note": f"{TP_RANKS} ranks share one card over gloo: not a "
                         f"scaling measurement"}
    before = dict(common.LAUNCHES)
    G = TP_DECODE_STEPS + 1         # prefill's token, then the steps
    jobs = [(f"15a {arch}", (arch, kw), None, 2, 16, G)
            for arch, kw in TP_REDUCED]
    jobs += [("15b", full, "float32", LM_BATCH, LM_PROMPT, G),
             ("15c", full, None, LM_BATCH, LM_PROMPT, LM_GEN)]

    # ---- one rank on the card: the references ---------------------------
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    refs = {}
    try:
        for name, case, dtype, batch, prompt, gen in jobs:
            cfg = tp_config(case)
            if dtype:
                cfg = dataclasses.replace(cfg, param_dtype=dtype,
                                          activation_dtype=dtype)
            torch.cuda.empty_cache()
            model = init_params(cfg, torch.Generator(device=dev)
                                .manual_seed(LM_SEED), dev)
            tokens = tp_tokens(np, cfg, batch, prompt).to(dev)
            toks = generate(model, cfg, tokens, gen, prompt + gen + 8)
            refs[name] = {
                "tokens": toks.cpu(),
                "logits": [t.cpu() for t in forced_logits(
                    model, cfg, {"tokens": tokens}, toks,
                    prompt + gen + 8)],
                "param_bytes": sum(p.numel() * p.element_size()
                                   for p in model.parameters()),
                "params": sum(p.numel() for p in model.parameters())}
            if name == "15b":
                specs = lm_param_specs(model, cfg, GridShape(model=TP_RANKS))
                refs[name]["split_bytes"] = sum(
                    p.numel() * p.element_size()
                    for n, p in model.named_parameters()
                    if "model" in specs[n])
            del model
        torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ref_s = time.perf_counter() - phase_t0

    # ---- TP_RANKS model ranks sharing the card ---------------------------
    t0 = time.perf_counter()
    ranks = spawn_grid(tp_rank, model=TP_RANKS, device=dev.type,
                       args=(jobs,))
    grid_s = time.perf_counter() - t0
    for r in ranks:
        require(not r["port_kernel_launches"],
                f"15: rank {r['rank']} launched {r['port_kernel_launches']}")
    r0 = ranks[0]
    by_name = [{j["name"]: j for j in r["jobs"]} for r in ranks]

    # ---- 15a, 15b: R ranks == one rank (f32) ----------------------------
    for name, *_ in jobs[:-1]:
        ref = refs[name]
        errs = []
        for r, mine in enumerate(by_name):
            got = mine[name]
            require(torch.equal(got["tokens"], ref["tokens"]),
                    f"{name}: rank {r}'s tokens differ from one rank's")
            for i, (a, b) in enumerate(zip(got["logits"], ref["logits"])):
                ok, e = close_to(a, b, 1e-4)
                require(ok, f"{name}: rank {r}'s step {i} logits differ "
                            f"from one rank's by {e}")
                errs.append(e)
        out[name] = {"max_abs_err": max(errs), "tol": 1e-4,
                     "steps": G, "tokens_equal": True,
                     "held_bytes": [m[name]["held_bytes"] for m in by_name],
                     "param_bytes": ref["param_bytes"],
                     "init_shard_s": [m[name]["init_shard_s"]
                                      for m in by_name]}
    b = out["15b"]
    split = refs["15b"]["split_bytes"]
    whole = refs["15b"]["param_bytes"] - split
    for r, held in enumerate(b["held_bytes"]):
        require(held == split // TP_RANKS + whole,
                f"15b: rank {r} holds {held} bytes, not its shard's "
                f"{split // TP_RANKS + whole}")
    b["held_share"] = [h / b["param_bytes"] for h in b["held_bytes"]]
    for name, *_ in jobs[:2]:
        print(f"{name} reduced() f32 on {TP_RANKS} ranks == one rank: "
              f"{G} steps, max |err| {out[name]['max_abs_err']:.2e} ≤ 1e-4, "
              f"tokens equal", flush=True)
    print(f"15b {LM_ARCH} full f32 ({refs['15b']['params'] / 1e9:.3f} B "
          f"params, {b['param_bytes'] / 1e9:.3f} GB) B={LM_BATCH} "
          f"prompt={LM_PROMPT}: {TP_RANKS} ranks == one rank over {G} steps "
          f"(max |err| {b['max_abs_err']:.2e} ≤ 1e-4, tokens equal); held "
          f"a rank {', '.join(f'{h / 1e9:.3f} GB' for h in b['held_bytes'])}"
          f" ({', '.join(f'{s:.4f}' for s in b['held_share'])} of the "
          f"model); {card}", flush=True)

    # ---- 15c: bf16 at R ranks, timed, against one rank's tokens ---------
    c = by_name[0]["15c"]
    ref = refs["15c"]
    require(c["finite"], "15c: decode logits not finite")
    for r, mine in enumerate(by_name):
        require(torch.equal(mine["15c"]["tokens"], c["tokens"]),
                f"15c: rank {r}'s tokens differ from rank 0's")
    # each row's first position where R ranks' tokens leave one rank's: a
    # flip is allowed only where one rank's top-2 gap there is at most 0.1
    firsts, gaps_there = [], []
    for row in range(LM_BATCH):
        diff = (c["tokens"][row] != ref["tokens"][row]).nonzero()
        firsts.append(int(diff[0]) if diff.numel() else None)
        if firsts[-1] is None:
            gaps_there.append(None)
            continue
        top2 = ref["logits"][firsts[-1]][row, -1].float().topk(2).values
        gaps_there.append(float(top2[0] - top2[1]))
        require(gaps_there[-1] <= 0.1,
                f"15c: row {row}'s token {firsts[-1]} differs from one "
                f"rank's, whose top-2 gap there is {gaps_there[-1]}")
    same = [f"row {r}: " + ("all equal" if f is None else
                            f"equal up to {f} (gap there {g:.3g})")
            for r, (f, g) in enumerate(zip(firsts, gaps_there))]
    coll = c["decode_collectives"]
    share = coll["seconds"] / (c["decode_ms_median"] / 1e3)
    out["15c"] = {
        "config": f"{LM_ARCH} (configs/llama3_2_1b.py) bf16, weights from "
                  f"seed {LM_SEED}",
        "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
        **{k: v for k, v in c.items() if k not in ("tokens", "name")},
        "collective_share_of_step": share,
        "first_divergence": firsts,
        "one_rank_top2_gap_there": gaps_there,
        "ranks_peak_memory_bytes": [m["15c"]["peak_memory_bytes"]
                                    for m in by_name]}
    peaks = ", ".join(f"{m['15c']['peak_memory_bytes'] / 2 ** 30:.2f}"
                      for m in by_name
                      if m["15c"]["peak_memory_bytes"] is not None)
    print(f"15c {LM_ARCH} full bf16 on {TP_RANKS} ranks ({r0['backend']}) "
          f"B={LM_BATCH} prompt={LM_PROMPT} gen={LM_GEN}: generate "
          f"{c['generate_s'][0]:.2f} s first, {c['generate_s'][1]:.3f} s "
          f"warm ({c['tokens_per_s']:.1f} tok/s); prefill "
          f"{c['prefill_ms']:.2f} ms; decode {c['decode_ms_median']:.2f} ms "
          f"a step (median of {LM_GEN}); a decode step's collectives "
          f"{coll['counts']}, {coll['total_bytes']:.0f} wire bytes, "
          f"{coll['seconds'] * 1e3:.2f} ms ({share:.1%} of the step); peak "
          f"{peaks} GiB a rank; tokens against one rank's (a flip only "
          f"where its top-2 gap ≤ 0.1): {'; '.join(same)}; {card}",
          flush=True)
    prof = c.get("decode_profile")
    if prof:
        print(f"15c a traced decode step on rank 0: {prof['device_ms']:.2f} "
              f"ms of device time in {prof['device_events']} events over "
              f"{prof['wall_ms']:.2f} ms (busy {prof['busy_share']:.1%}); "
              f"collective seconds by kind (median a step) "
              f"{ {k: round(v * 1e3, 2) for k, v in c['collective_s_by_kind'].items()} } ms",
              flush=True)
    launched_here = {k: v - before[k] for k, v in common.LAUNCHES.items()
                     if v - before[k]}
    require(not launched_here, f"15: the grid path launched {launched_here}")
    out["port_kernel_launches"] = launched_here
    out["one_rank_s"], out["grid_s"] = ref_s, grid_s
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase 15 took {out['phase_s']:.1f} s (one rank {ref_s:.1f} s, "
          f"spawn + ranks {grid_s:.1f} s)", flush=True)
    return out


def drive_recurrent_path(torch, np, dev, common, card: str,
                         archs=REC_ARCHS) -> dict:
    """Phase 16: the recurrent families at full width (see the module
    docstring). `archs` is ((arch, 16c's depth), ...)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.examples.serve_lm import decode_from_empty
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import deterministic
    from repro_torch.models import decode_step, init_params, loss_fn, prefill
    from repro_torch.models.ssm import n_chunks_of

    phase_t0 = time.perf_counter()
    out: dict = {"card": card}
    before = dict(common.LAUNCHES)
    cpu = torch.device("cpu")
    B, L, G = REC_BATCH, REC_PROMPT, REC_GEN
    max_len = L + G + 8
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)

    def weights(cfg, where=dev):
        return init_params(cfg, torch.Generator(device=where).manual_seed(
            LM_SEED), where)

    def f32(cfg, **kw):
        return dataclasses.replace(cfg, param_dtype="float32",
                                   activation_dtype="float32", **kw)

    for tag, (arch, _) in zip(("16a", "16b"), archs):
        cfg = get_arch(arch)
        tokens = torch.from_numpy(np.random.default_rng(LM_SEED).integers(
            0, cfg.vocab_size, size=(B, L)).astype(np.int32)).to(dev)
        # ---- 16a/16b: the full config in bf16 through generate ----------
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        model = weights(cfg)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        t0 = time.perf_counter()
        toks = generate(model, cfg, tokens, G, max_len)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        require(toks.shape == (B, G) and toks.dtype == torch.int32
                and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                f"{tag}: generate gave {tuple(toks.shape)} {toks.dtype}")
        prefill_runs = []
        for _ in range(REC_PREFILL_RUNS):   # generate's prefill warmed up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(model, {"tokens": tokens}, cfg, max_len)
            torch.cuda.synchronize()
            prefill_runs.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(logits).all()), f"{tag}: prefill logits")
        step_ms = []
        for i in range(G):          # generate's steps, each timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = decode_step(model, cache, toks[:, i: i + 1],
                                        L + i, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        require(bool(torch.isfinite(logits).all()), f"{tag}: decode logits")

        def decode_window():
            for i in range(REC_PROFILED_STEPS):
                decode_step(model, cache, toks[:, i: i + 1], L + i, cfg)

        trace = profile(torch, decode_window)
        peak = torch.cuda.max_memory_allocated()
        decode_ms = statistics.median(step_ms)
        prefill_ms = statistics.median(prefill_runs)
        row = {"config": f"{arch} at its published size, bf16, weights "
                         f"from seed {LM_SEED}",
               "layers": cfg.n_layers, "batch": B, "prompt": L, "gen": G,
               "params": n_params, "param_bytes": param_bytes,
               "init_s": init_s, "generate_s": gen_s,
               "tokens_per_s": B * G / gen_s, "prefill_ms": prefill_ms,
               "prefill_ms_runs": prefill_runs,
               "decode_ms_median": decode_ms, "decode_ms": step_ms,
               # computed, not measured: the weights read once a step at
               # the memory rate
               "decode_bound_ms_computed":
                   param_bytes / HBM_BYTES_PER_S * 1e3,
               "held_before_bytes": held, "peak_memory_bytes": peak,
               "peak_above_held_bytes": peak - held,
               "decode_profile": {k: trace[k] for k in (
                   "wall_ms", "device_ms", "busy_share", "device_events",
                   "top")},
               "profiled_steps": REC_PROFILED_STEPS,
               "first_tokens": toks[0, :8].tolist()}
        del model, cache, logits
        torch.cuda.empty_cache()

        # ---- the same config in f32, TF32 off: decode == prefill ---------
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            cfg32 = f32(cfg)
            model = weights(cfg32)
            one = {"tokens": tokens[:1]}
            t0 = time.perf_counter()
            pre, _ = prefill(model, one, cfg32, max_len)
            dec = decode_from_empty(model, cfg32, one, max_len)
            torch.cuda.synchronize()
            ok, err = close_to(dec, pre, 2e-2)
            require(ok, f"{tag}: {L} decode steps differ from prefill by "
                        f"{err}")
            row["f32_decode_vs_prefill_max_abs_err"] = err
            row["f32_check_s"] = time.perf_counter() - t0
            del model, pre, dec
            torch.cuda.empty_cache()
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        out[arch] = row
        print(f"{tag} {arch} full bf16 ({n_params / 1e9:.3f} B params, "
              f"{param_bytes / 1e9:.2f} GB, init {init_s:.1f} s) B={B} "
              f"prompt={L} gen={G}: generate {gen_s:.2f} s "
              f"({B * G / gen_s:.1f} tok/s); prefill {prefill_ms:.1f} ms "
              f"(median of {REC_PREFILL_RUNS}); decode {decode_ms:.2f} ms a "
              f"step (median of {G}; the weights' bound "
              f"{param_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); device busy "
              f"{trace['busy_share']:.1%} over {REC_PROFILED_STEPS} steps "
              f"({trace['device_events']} device events); peak "
              f"{(peak - held) / 2 ** 30:.2f} GiB above the "
              f"{held / 2 ** 30:.2f} GiB earlier phases hold; f32 at B=1: "
              f"{L} decode steps == prefill (max |err| {err:.2e} ≤ 2e-2); "
              f"{card}", flush=True)

    # ---- 16c: full width at cut depth, f32, the card against the CPU -----
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cut = {}
        for arch, depth in archs:
            cfg = f32(get_arch(arch), n_layers=depth)
            model = weights(cfg)
            twin = init_params(cfg, device="meta")
            twin.load_state_dict({k: v.to(cpu) for k, v in
                                  model.state_dict().items()}, assign=True)
            one = {"tokens": torch.from_numpy(np.random.default_rng(
                LM_SEED).integers(0, cfg.vocab_size, size=(1, L)).astype(
                np.int32)).to(dev)}
            mlen = L + REC_CPU_DECODE + 8
            t0 = time.perf_counter()
            toks = generate(model, cfg, one["tokens"], REC_CPU_DECODE + 1,
                            mlen)
            mine = forced_logits(model, cfg, one, toks, mlen)
            theirs = forced_logits(twin, cfg, {"tokens": one["tokens"]
                                               .cpu()}, toks.cpu(), mlen)
            worst = 0.0
            for i, (m, w) in enumerate(zip(mine, theirs)):
                ok, e = close_to(m, w, 1e-4)
                require(ok, f"16c {arch}: step {i}'s logits (0: prefill) "
                            f"differ from the CPU's by {e}")
                worst = max(worst, e)
            cut[arch] = {"layers": depth, "card_vs_cpu_max_abs_err": worst,
                         "decode_steps": len(mine) - 1, "tol": 1e-4,
                         "s": time.perf_counter() - t0}
            del model, twin, mine, theirs
            torch.cuda.empty_cache()
        out["cut_depth_f32"] = cut
        print("16c full width f32 at cut depth, the card == the CPU: "
              + "; ".join(f"{a} {c['layers']} layers: prefill and "
                          f"{c['decode_steps']} decode steps max |err| "
                          f"{c['card_vs_cpu_max_abs_err']:.2e} ≤ 1e-4"
                          for a, c in cut.items()), flush=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32

    # ---- 16d: the scan's training memory at full width -------------------
    arch, _ = archs[0]
    base = dataclasses.replace(get_arch(arch), n_layers=REC_TRAIN_LAYERS,
                               remat=True, remat_policy="full")
    model = weights(base)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        LM_SEED).integers(0, base.vocab_size, size=(1, REC_TRAIN_SEQ + 1))
        .astype(np.int32)).to(dev)}
    batch["labels"] = batch["tokens"][:, 1:].long()
    batch["tokens"] = batch["tokens"][:, :-1]
    runs = {}
    for chunk in REC_TRAIN_CHUNKS:
        cfg = dataclasses.replace(base, ssm_chunk=chunk)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with deterministic():
            loss, _ = loss_fn(model, batch, cfg)
            loss.backward()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        grads = {k: p.grad for k, p in model.named_parameters()}
        require(all(g is not None and bool(torch.isfinite(g).all())
                    for g in grads.values()), f"16d chunk {chunk}: gradients")
        runs[chunk] = {"n_chunks": n_chunks_of(REC_TRAIN_SEQ, chunk),
                       "loss": float(loss.detach()), "wall_s": wall_s,
                       "held_before_bytes": held,
                       "peak_above_held_bytes": peak - held, "grads": grads}
    a, b = (runs[c] for c in REC_TRAIN_CHUNKS)
    same = a["loss"] == b["loss"] and all(
        torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"])
    require(same, f"16d: the gradients with ssm_chunk {REC_TRAIN_CHUNKS[0]} "
                  f"differ from those with {REC_TRAIN_CHUNKS[1]}")
    require(a["peak_above_held_bytes"] < b["peak_above_held_bytes"],
            f"16d: {REC_TRAIN_CHUNKS[0]}-step chunks peaked at "
            f"{a['peak_above_held_bytes']} bytes, one chunk at "
            f"{b['peak_above_held_bytes']}")
    for r in runs.values():
        del r["grads"]
    out["train_memory"] = {
        "config": f"{arch} n_layers={REC_TRAIN_LAYERS} remat full bf16, "
                  f"B 1, L {REC_TRAIN_SEQ}", "grads_equal": same,
        "runs": {str(c): r for c, r in runs.items()},
        "saved_bytes": b["peak_above_held_bytes"]
        - a["peak_above_held_bytes"]}
    print(f"16d {arch} {REC_TRAIN_LAYERS} layers, B=1 L={REC_TRAIN_SEQ}, "
          f"remat full: loss_fn forward+backward peaks "
          + ", ".join(f"{r['peak_above_held_bytes'] / 2 ** 30:.3f} GiB "
                      f"({r['wall_s']:.2f} s) with ssm_chunk {c}"
                      for c, r in runs.items())
          + f" above the held {a['held_before_bytes'] / 2 ** 30:.2f} GiB; "
          f"gradients equal bit for bit; {card}", flush=True)
    del model, batch
    torch.cuda.empty_cache()

    launched_here = {k: v - before[k] for k, v in common.LAUNCHES.items()
                     if v - before[k]}
    # no pallas_call lies on the recurrent paths either
    require(not launched_here, f"16: the recurrent path launched "
                               f"{launched_here}")
    out["port_kernel_launches"] = launched_here
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase 16 took {out['phase_s']:.1f} s", flush=True)
    return out


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
    smoke_t0 = time.perf_counter()
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
    finish = drive_finish_path(torch, np, params, dev, common, evk,
                               circuit["keys"], stream, serving, multihost,
                               beta64, grid)
    lm = drive_lm_path(torch, np, dev, common, card)
    train = drive_train_path(torch, np, dev, common, card)
    tp = drive_tp_path(torch, np, dev, common, card)
    rec = drive_recurrent_path(torch, np, dev, common, card)
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
            # logN 4 and 10), phase 12 (12a's timed drain inside the
            # worker group, 12d on rank 0)
            "launches": path["launches"][name] + batched["launches"][name]
            + circuit["launches"][name] + circuit["steps_launches"][name]
            + serving["launches"][name]
            + multihost["launches"].get(name, 0)
            + boot["launches"].get(name, 0)
            + finish["launches"].get(name, 0),
            "main_path_launches": path["launches"][name],
            "batched_step_launches": batched["launches"][name],
            "circuit_path_launches": circuit["launches"][name],
            "per_op_steps_launches": circuit["steps_launches"][name],
            "serving_path_launches": serving["launches"][name],
            "multihost_path_launches": multihost["launches"].get(name, 0),
            "bootstrap_path_launches": boot["launches"].get(name, 0),
            # phase 11's ranks, counted in rank 0
            "grid_path_launches": grid["launches"].get(name, 0),
            # phase 12: 12a's worker group (its rank 0) and 12d's rank 0;
            # the β = 2^64 paths of 12b and 12c launch none
            "finish_path_launches": finish["launches"].get(name, 0),
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
            # served stream (11c), and phase 12's worker group (12a) and
            # acc3 step (12d), counted in rank 0
            "launches": grid["launches"].get(name, 0)
            + finish["launches"].get(name, 0),
            "grid_path_launches": grid["launches"].get(name, 0),
            "finish_path_launches": finish["launches"].get(name, 0),
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
    print(json.dumps({"finish": {
        "params": "12a/12d paper_params(); 12b paper_params(beta_bits=64); "
                  "12c boot_params(logN=4, beta_bits=64)",
        "note": f"{GRID_RANKS} ranks share one card over gloo: not a "
                f"scaling measurement", **finish, "card": card}}))
    print(json.dumps({"lm": lm}))
    print(json.dumps({"train": train}))
    print(json.dumps({"tp": tp}))
    print(json.dumps({"recurrent": rec}))
    print(f"chip_smoke took {time.perf_counter() - smoke_t0:.1f} s",
          flush=True)
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
