"""The serving cells: an open loop of requests into the program's HEServer.

Set-up makes a pool of ciphertexts at each level of the mix, an
evaluation key and the rotation keys from the seed, builds the server on
the program's tables, and serves one request of every (op, level) bucket
the mix holds, so that each step is built and has run once. The window
then submits each request when it is due (arrivals.schedule), polls the
server, and times each request from when it was due to when poll()
returned its result: poll() has synchronised the batch's event, so the
result is complete on the card. Requests due in the window are served to
the end, flushing what remains once the last one is in. With a trace,
`trace_seconds` more of the schedule run under the profiler. The check
compares a sample of the window's answers, drawn from the seed with
every (op, level) bucket in it, with the plain reference.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from collections import defaultdict

import torch

import heref
from hebench import arrivals, check, inputs, program, report, tracing
from hebench.cells import Measure, Run, free, sample, sync

IDLE_TICK_S = 0.0005


class Loop:
    """The open loop over a slice of the schedule."""

    def __init__(self, server, cts: dict, reqs: list, keep: set):
        self.server, self.cts, self.reqs, self.keep = server, cts, reqs, keep
        self.done_s: dict = {}
        self.kept: dict = {}
        self.late_s = 0.0
        self.batches = 0
        self.pending: list = []     # (time, requests submitted, not done)

    def _submit(self, i: int):
        q = self.reqs[i]
        ops = [self.cts[q.logq][j] for j in q.operands]
        if q.op == "mul":
            return self.server.submit_mul(*ops)
        return self.server.submit_rotate(ops[0], q.r)

    def run(self, lo: int, hi: int, t0: float) -> None:
        """Serve requests lo..hi−1 (due times from t0) to the end."""
        s = self.server
        rid_of, i = {}, lo
        while i < hi or rid_of:
            now = time.perf_counter() - t0
            while i < hi and self.reqs[i].due_s <= now:
                rid_of[self._submit(i)] = i
                self.late_s = max(self.late_s, now - self.reqs[i].due_s)
                i += 1
            served = s.poll(flush=i >= hi) if s.queue.depth else []
            if served:
                self.batches += 1
                t = time.perf_counter() - t0
                self.pending.append((t, len(rid_of) - len(served)))
                for rid, ct in served:
                    k = rid_of.pop(rid)
                    self.done_s[k] = t
                    if k in self.keep:
                        self.kept[k] = (ct.ax.clone(), ct.bx.clone())
            elif i < hi:
                time.sleep(min(IDLE_TICK_S, max(
                    0.0, self.reqs[i].due_s - (time.perf_counter() - t0))))


def setup(r: Run):
    """(params, server, the pool's Ciphertexts by level, the pool's words
    by level, the evaluation key's words, the rotation keys' words)."""
    cfg, mix, dev = r.config, r.traffic, r.device
    params = program.params_of(cfg)
    use_kernels = cfg["use_kernels"]
    program.load_kernels(use_kernels, dev)
    N, logQ, beta = params.N, params.logQ, params.beta_bits
    levels = [lv for lv, _ in mix["levels"]]
    rotations = sorted({op["r"] for op in mix["ops"] if op["op"] == "rotate"})

    g = inputs.generator(r.seed, dev)
    pool = {lv: inputs.ciphertexts(g, mix["pool_per_level"], N, lv, beta, dev)
            for lv in levels}
    evk_words = inputs.key(g, N, logQ, beta, dev)
    rk_words = {rr: inputs.key(g, N, logQ, beta, dev) for rr in rotations}
    server = program.server(
        params, program.eval_key(params, *evk_words, use_kernels, dev),
        {rr: program.eval_key(params, *w, use_kernels, dev)
         for rr, w in rk_words.items()}, dev, use_kernels, mix["server"])
    if r.fault is not None:
        r.fault(server)
    cts = {lv: [program.ciphertext(params, pool[lv][0][j], pool[lv][1][j], lv)
                for j in range(mix["pool_per_level"])] for lv in levels}
    return params, server, cts, pool, evk_words, rk_words


def warm_up(server, cts, reqs: list) -> int:
    """Serve one request of every (op, level) bucket of `reqs` to the end;
    returns the buckets."""
    first = {}
    for q in reqs:
        first.setdefault((q.op, q.r, q.logq), q)
    warm = Loop(server, cts, [dataclasses.replace(q, due_s=0.0)
                              for q in first.values()], set())
    warm.run(0, len(warm.reqs), time.perf_counter())
    server.reset_metrics()
    return len(first)


def run(r: Run) -> Measure:
    cfg, mix, dev = r.config, r.traffic, r.device
    params, server, cts, pool, evk_words, rk_words = setup(r)
    N, logQ, beta = params.N, params.logQ, params.beta_bits

    horizon = r.seconds + (mix["trace_seconds"] if r.trace else 0.0)
    reqs = arrivals.schedule(mix, r.seed, horizon)
    n_win = sum(1 for q in reqs if q.due_s < r.seconds)
    buckets = defaultdict(list)
    for k in range(n_win):
        buckets[(reqs[k].op, reqs[k].r, reqs[k].logq)].append(k)
    keep = set()
    for b, ks in sorted(buckets.items()):
        keep.add(ks[sample(r.seed, len(ks), 1, f"serve{b}")[0]])
    rest = [k for k in range(n_win) if k not in keep]
    keep |= {rest[j] for j in sample(r.seed, len(rest),
                                     max(0, mix["check_requests"]
                                         - len(keep)),
                                     "serve-rest")}

    n_buckets = warm_up(server, cts, reqs)
    sync(dev)
    m = Measure(kind="serve", config=cfg, traffic=mix,
                device_name=torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu", batch=mix["server"]["batch"])
    m.setup_s = time.perf_counter() - r.t_start
    report.log(f"set-up {m.setup_s:.3f} s; {n_buckets} buckets warmed")

    loop = Loop(server, cts, reqs, keep)
    t0 = time.perf_counter()
    loop.run(0, n_win, t0)
    m.window_s = time.perf_counter() - t0
    m.attempted = n_win
    m.latencies_ms = [1e3 * (loop.done_s[k] - reqs[k].due_s)
                      for k in range(n_win) if k in loop.done_s]
    m.ops = len(m.latencies_ms)
    m.steps = loop.batches
    m.serve = server.metrics.summary()
    report.log(f"window: {n_win} requests due in {r.seconds} s, served by "
               f"{m.window_s:.4f} s in {loop.batches} batches; generator "
               f"late by {1e3 * loop.late_s:.3f} ms at most; p50 "
               f"{statistics.median(m.latencies_ms):.3f} ms; flushes "
               f"{m.serve['flushes']}")
    if dev.type == "cuda":
        m.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    if r.trace:
        traced = Loop(server, cts, reqs, set())

        def body():
            traced.run(n_win, len(reqs),
                       time.perf_counter() - reqs[n_win].due_s)
            return len(traced.done_s), traced.batches
        m.trace = tracing.traced(dev, body, program.launches)
        report.log(f"traced {m.trace.ops} requests in "
                   f"{m.trace.window_s:.4f} s, busy {m.trace.busy_s:.4f} s")

    # the reference, once the program's state is freed
    missing = [k for k in keep if k not in loop.kept]
    m.failed = (n_win - m.ops) + len(missing)
    del server, cts
    for lp in (loop, *([traced] if r.trace else [])):
        lp.server = None
    free(dev)
    t1 = time.perf_counter()
    ref = heref.HERef(N, logQ, beta, dev, short=r.reference_short)
    groups = defaultdict(list)
    for k in sorted(loop.kept):
        groups[(reqs[k].op, reqs[k].r, reqs[k].logq)].append(k)
    for (op, rr, lv), ks in sorted(groups.items()):
        ax, bx = pool[lv]
        a = [torch.stack([ax[reqs[k].operands[i]] for k in ks])
             for i in range(len(reqs[ks[0]].operands))]
        b = [torch.stack([bx[reqs[k].operands[i]] for k in ks])
             for i in range(len(reqs[ks[0]].operands))]
        if op == "mul":
            want = ref.he_mul(a[0], b[0], a[1], b[1], evk_words, lv)
        else:
            want = ref.rotate(a[0], b[0], pow(5, rr, 2 * N), rk_words[rr], lv)
        for j, k in enumerate(ks):
            bad = sum(check.mismatched(got, w[j])
                      for got, w in zip(loop.kept[k], want))
            m.mismatched_words += bad
            m.compared_words += sum(t.numel() for t in loop.kept[k])
            m.failed += int(bad > 0)
    m.checks = check.mismatched_words(m.mismatched_words, m.compared_words)
    report.log(f"reference: {len(loop.kept)} requests in "
               f"{time.perf_counter() - t1:.2f} s")
    return m


def end_to_end(m: Measure) -> dict:
    """The 95th percentile of every window request's latency."""
    return {"request_p95_ms": percentile(m.latencies_ms, 95)}


def percentile(values: list, pct: float) -> float:
    """The nearest-rank percentile of every value."""
    s = sorted(values)
    return s[max(0, -(-len(s) * pct // 100) - 1)] if s else float("nan")
