#!/usr/bin/env python3
"""Place a cell's traced stretch in the program's profiler ranges.

    python3 bench/tools/stage_split.py --workload <cell> --seed <n>
        [--steps K] [--seconds S]

Sets the cell up as the benchmark does (bench/hebench: a step cell's step,
inputs, key and warm steps; the serve cell's server, pools, keys and one
batch a bucket) and runs its traced stretch under torch.profiler: `K`
steps (the mix's `trace_steps` by default), or `S` seconds of the mix's
open loop (its `trace_seconds`), served twice in turn, without and with a
`repro_torch.obs.Tracer` on the server. hebench.ranges charges each device
event and each idle gap to the program range (``repro_torch/<cat>/<name>``)
that holds it, and one JSON line a stretch gives:

- `stage_ms`: per HE operation, each Fig. 3 stage's charge (crt, ntt,
  modmul, icrt) and `other`, the rest of the stretch; the five sum to
  window_s / ops;
- `covered_pct`: the share of the device time launched inside some range;
- `ranges`: each range's device seconds (PyTorch's own kernels and the
  rest) and idle seconds, innermost range first;
- serving with a tracer: `queue_wait_p95_ms` (the tracer's bucket_wait,
  nearest rank), `server_idle_pct` (device idle while the host is in a
  server range) and the tracer's `device_wall` per batch beside the
  device time launched inside the batch's dispatch.

Needs a CUDA card; nothing here runs in the benchmark's window.
"""

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def profiled(device, body):
    """Run body() -> ops under torch.profiler between two
    synchronisations: (host events, device events, the window on the
    profiler's clock, window_s, ops)."""
    from torch.profiler import ProfilerActivity, profile

    from hebench import cells, ranges

    cells.sync(device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        # the profiler stamps its events on the epoch clock
        t0 = time.time_ns()
        ops = body()
        cells.sync(device)
        t1 = time.time_ns()
    start = prof.profiler.kineto_results.trace_start_ns()
    host, dev = ranges.events_of(prof)
    return (host, dev, ((t0 - start) / 1e3, (t1 - start) / 1e3),
            (t1 - t0) * 1e-9, ops)


def split(host, dev, window, window_s, ops) -> tuple:
    """(what one stretch reads, see the module docstring; its
    hebench.ranges.Attribution)."""
    from hebench import ranges, tracing

    att = ranges.attribute(host, dev, window)
    torch_s = defaultdict(float)
    for d, st in zip(dev, att.stacks):
        if tracing.is_torch(d.name):
            torch_s[st[-1].name if st else None] += (d.end - d.start) * 1e-6
    names = sorted(set(att.device_s) | set(att.idle_s),
                   key=lambda k: -(att.device_s.get(k, 0.0)
                                   + att.idle_s.get(k, 0.0)))
    return {
        "window_s": window_s, "ops": ops,
        "busy_s": sum(b - a for a, b in ranges.union((d.start, d.end) for d in dev)) * 1e-6,
        "device_events": len(dev),
        "stage_ms": ranges.stage_ms(att, window_s, ops),
        "covered_pct": ranges.covered_pct(att),
        "ranges": [[k, att.device_s.get(k, 0.0), torch_s.get(k, 0.0),
                    att.idle_s.get(k, 0.0)] for k in names],
    }, att


def step_cell(r, steps: int) -> list:
    from hebench import inputs, program

    cfg, mix, dev = r.config, r.traffic, r.device
    params = program.params_of(cfg)
    use_kernels = cfg["use_kernels"]
    program.load_kernels(use_kernels, dev)
    B, logq = mix["batch"], mix.get("logq", params.logQ)
    N, logQ, beta = params.N, params.logQ, params.beta_bits
    g = inputs.generator(r.seed, dev)
    c1 = inputs.ciphertexts(g, B, N, logq, beta, dev)
    c2 = inputs.ciphertexts(g, B, N, logq, beta, dev)
    key = inputs.key(g, N, logQ, beta, dev)
    evk = program.eval_key(params, *key, use_kernels, dev)
    step = program.he_mul_step(params, logq, evk, dev, use_kernels)
    for _ in range(mix["warm_steps"]):
        step(*c1, *c2)

    def body():
        for _ in range(steps):
            step(*c1, *c2)
        return steps * B

    return [split(*profiled(dev, body))[0]]


def serve_cell(r, seconds: float) -> list:
    from repro_torch.obs import Tracer

    from hebench import arrivals, ranges, servecell

    _, server, cts, _, _, _ = servecell.setup(r)
    reqs = arrivals.schedule(r.traffic, r.seed, seconds)
    servecell.warm_up(server, cts, reqs)
    out = []
    for tracer in (None, Tracer()):
        server.tracer = tracer
        loop = servecell.Loop(server, cts, reqs, set())

        def body():
            loop.run(0, len(reqs), time.perf_counter())
            return len(loop.done_s)

        host, dev, window, window_s, ops = profiled(r.device, body)
        server.tracer = None
        line, att = split(host, dev, window, window_s, ops)
        lat = [1e3 * (t - reqs[k].due_s) for k, t in loop.done_s.items()]
        line.update(tracer=tracer is not None, batches=loop.batches,
                    request_p95_ms=ranges.nearest_rank(lat, 95))
        if tracer is not None:
            ev = tracer.events
            walls = [e["dur"] / 1e3 for e in ev if e["name"] == "device_wall"]
            dispatched = ranges.launched_in(att, dev, "lifecycle/dispatch")
            line.update(
                queue_wait_p95_ms=ranges.queue_wait_p95_ms(ev),
                server_idle_pct=ranges.server_idle_pct(host, dev, window),
                device_wall_ms_per_batch=sum(walls) / max(1, len(walls)),
                dispatched_device_ms_per_batch=1e3 * dispatched
                / max(1, len(walls)))
        out.append(line)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from hebench import cells, report, spec

    if not torch.cuda.is_available():
        print("stage_split.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    r = cells.Run(workload=args.workload, config=cell.config,
                  traffic=cell.traffic, seed=args.seed, seconds=0.0,
                  trace=True, device=dev, t_start=time.perf_counter())
    if cell.traffic["kind"] == "step":
        lines = step_cell(r, args.steps or cell.traffic["trace_steps"])
    else:
        lines = serve_cell(r, args.seconds or cell.traffic["trace_seconds"])
    for line in lines:
        print(json.dumps({"workload": args.workload, "seed": args.seed,
                          "card": report.card_line(), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
