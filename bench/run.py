#!/usr/bin/env python3
"""Run one cell of the benchmark of `repro_torch` once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`)
names a configuration (its file under bench/configs/) and a traffic mix
(bench/traffic/<mix>.json), whose `kind` names its driver,
bench/hebench/<kind>cell.py. The driver loads the program, makes its
inputs from the seed, warms up, measures for `--seconds`, checks what
the timed path produced against its plain reference, and gives the
cell's end-to-end values and its checks. With `--trace 0` the run prints
the cell's end-to-end metrics, with `--trace 1` its per-layer metrics
(each read by bench/metrics/<metric>.py), as the last line of standard
output; the numbers compared, with their limits, are the last lines of
standard error. Without a CUDA card, without the program
(src/repro_torch), with the JAX package loaded, or where the cell asks
for a driver or a value that the files do not give, it prints no result
and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "bench-cache"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"bench/run.py: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    # kernel caches at fixed paths inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(BENCH))
    import torch
    from hebench import report, spec

    if not torch.cuda.is_available():
        return fail("no CUDA card (torch.cuda.is_available() is false)")
    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload, ROOT)
    chips = cell.workload["chips"]
    if torch.cuda.device_count() < chips:
        return fail(f"{args.workload} needs {chips} cards; "
                    f"{torch.cuda.device_count()} found")
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("the program (src/repro_torch) is not in this checkout")
    sys.path.insert(0, str(ROOT / "src"))

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report.log(f"card: {report.card_line()}")
    return run_cell(cell, dev, args.seed, args.seconds, bool(args.trace))


def run_cell(cell, dev, seed: int, seconds: float, trace: bool) -> int:
    """Drive `cell` by its traffic's kind and print its result; the exit
    code."""
    from hebench import cells, report, spec

    try:
        drive = spec.driver(cell.traffic["kind"])
    except spec.SpecError as e:
        return fail(str(e))
    m = drive.run(cells.Run(
        workload=cell.name, config=cell.config, traffic=cell.traffic,
        seed=seed, seconds=seconds, trace=trace, device=dev,
        t_start=T_START))
    try:
        result = outcome(cell, drive, m, trace)
    except spec.SpecError as e:
        return fail(str(e))
    bad = report.forbidden_modules()
    if bad:
        return fail(f"the process holds {bad}: the benchmark runs without "
                    "the JAX package", 3)
    report.emit(result, m.checks)
    return 0


def outcome(cell, drive, m, trace: bool) -> dict:
    """The result line's keys but `checks`."""
    from hebench import cells, spec

    metrics = {}
    if trace:
        for entry in cell.per_layer:
            v = spec.reader(entry["name"]).read(m)
            if v is not None:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
    else:
        values = {"setup_s": m.setup_s, **drive.end_to_end(m)}
        for entry in cell.end_to_end:
            if entry["name"] not in values:
                raise spec.SpecError(
                    f"{cell.name} reports {entry['name']}, which the driver "
                    f"of kind {cell.traffic['kind']!r} does not give (it "
                    f"gives {sorted(values)})")
            metrics[entry["name"]] = {"value": values[entry["name"]],
                                      "unit": entry["unit"]}
    device = {"platform": "gpu", "kind": m.device_name,
              "count": cell.workload["chips"],
              "memory_peak_bytes": m.memory_peak_bytes}
    out = {"correct": cells.correct(m), "attempted": m.attempted, "failed": m.failed,
           "metrics": metrics, "device": device}
    if trace and m.trace is not None:
        device["busy_s"] = m.trace.busy_s
        device["window_s"] = m.trace.window_s
        out["breakdown"] = m.trace.breakdown()
    return out


if __name__ == "__main__":
    sys.exit(main())
