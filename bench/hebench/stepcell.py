"""The step cells: the batched HE Mul step, back to back.

Set-up makes a batch of ciphertext pairs and an evaluation key from the
seed, has the program derive the key's evaluation form and its tables,
and runs the step `warm_steps` times. The window then issues whole steps
without waiting for the card (the step is asynchronous) until `seconds`
have passed, and ends at the synchronised end of its last step: the rate
is the HE Muls completed over that time. With a trace, `trace_steps` more
steps run under the profiler. The check compares the last step's outputs
(a sample of its pairs drawn from the seed) with the plain reference.
"""

from __future__ import annotations

import time

import torch

import heref
from hebench import check, inputs, program, report, tracing
from hebench.cells import Measure, Run, free, sample, sync


def run(r: Run) -> Measure:
    cfg, mix, dev = r.config, r.traffic, r.device
    params = program.params_of(cfg)
    use_kernels = cfg["use_kernels"]
    program.load_kernels(use_kernels, dev)
    B, logq = mix["batch"], mix.get("logq", params.logQ)
    N, logQ, beta = params.N, params.logQ, params.beta_bits

    g = inputs.generator(r.seed, dev)
    ax1, bx1 = inputs.ciphertexts(g, B, N, logq, beta, dev)
    ax2, bx2 = inputs.ciphertexts(g, B, N, logq, beta, dev)
    key = inputs.key(g, N, logQ, beta, dev)
    evk = program.eval_key(params, *key, use_kernels, dev)
    step = program.he_mul_step(params, logq, evk, dev, use_kernels)
    if r.fault is not None:
        step = r.fault(step)
    for _ in range(mix["warm_steps"]):
        out = step(ax1, bx1, ax2, bx2)
    sync(dev)
    m = Measure(kind="step", config=cfg, traffic=mix,
                device_name=torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu", batch=B)
    m.setup_s = time.perf_counter() - r.t_start
    report.log(f"set-up {m.setup_s:.3f} s")

    t0 = time.perf_counter()
    while True:
        out = step(ax1, bx1, ax2, bx2)
        m.steps += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    sync(dev)
    m.window_s = time.perf_counter() - t0
    m.ops = m.attempted = m.steps * B
    report.log(f"window: {m.steps} steps of {B} in {m.window_s:.4f} s")
    if dev.type == "cuda":
        m.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    if r.trace:
        def body():
            nonlocal out
            for _ in range(mix["trace_steps"]):
                out = step(ax1, bx1, ax2, bx2)
            return mix["trace_steps"] * B, mix["trace_steps"]
        m.trace = tracing.traced(dev, body, program.launches)
        report.log(f"traced {m.trace.steps} steps in "
                   f"{m.trace.window_s:.4f} s, busy {m.trace.busy_s:.4f} s")

    # the reference, once the program's state is freed
    idx = sample(r.seed, B, mix["check_items"], "step")
    got = [o[idx].cpu() for o in out]
    del step, evk, out
    free(dev)
    t1 = time.perf_counter()
    ref = heref.HERef(N, logQ, beta, dev, short=r.reference_short)
    want = ref.he_mul(ax1[idx], bx1[idx], ax2[idx], bx2[idx], key, logq)
    m.mismatched_words = sum(check.mismatched(a, b.cpu())
                             for a, b in zip(got, want))
    m.compared_words = sum(a.numel() for a in got)
    m.failed = sum(int(any(not torch.equal(a[i], b[i].cpu())
                           for a, b in zip(got, want)))
                   for i in range(len(idx)))
    m.checks = check.mismatched_words(m.mismatched_words, m.compared_words)
    report.log(f"reference: {len(idx)} of {B} pairs in "
               f"{time.perf_counter() - t1:.2f} s")
    return m


def end_to_end(m: Measure) -> dict:
    """HE Muls completed over the window's whole time."""
    return {"he_ops_per_s": m.ops / m.window_s}
