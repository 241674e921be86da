"""The analyzer's CLI: ``python -m repro_torch.analysis [names...]
[--json] [--bench BENCH.json]``.

Runs the static analyzer over the named example circuits (default: all
of them) and prints either pretty per-circuit reports or one JSON object
keyed by circuit name. CPU only: it analyzes plans and serves nothing.

Exit status 1 IFF any circuit has an error-severity finding (HS001):
warnings and infos report but do not fail — the performance rules are
advisory by design.

    python -m repro_torch.analysis                     # all, pretty
    python -m repro_torch.analysis degree4 --json      # one, JSON
    python -m repro_torch.analysis --bench BENCH_serve_he.json
                                                       # + calibrated costs

This is the JAX package's analyzer CLI (its ``analysis/__main__.py``);
for the same arguments its JSON is the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional

from repro_torch.analysis.analyzer import analyze_circuit
from repro_torch.analysis.cost import CostModel
from repro_torch.analysis.examples import EXAMPLES, build


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=None,
                    help=f"example circuits (default: all of "
                         f"{sorted(EXAMPLES)})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="one JSON object keyed by circuit name")
    ap.add_argument("--bench", type=Path, default=None,
                    help="BENCH_serve_he.json to calibrate the cost "
                         "model from (adds est. device-seconds; the "
                         "bench's params need not match the "
                         "circuit's)")
    args = ap.parse_args(argv)
    names = args.names or sorted(EXAMPLES)

    reports = {}
    failed = False
    for name in names:
        kwargs, note = build(name)
        cost_model: Optional[CostModel] = None
        if args.bench is not None:
            # refit per circuit: κ transfers, unit counts use the
            # CIRCUIT's params
            bench = json.loads(args.bench.read_text())
            cost_model = CostModel.from_bench(bench)
            cost_model = CostModel(cost_model.kappa,
                                   cost_model.default_kappa,
                                   kwargs["params"],
                                   calibrated_from=str(args.bench))
        report = analyze_circuit(cost_model=cost_model, **kwargs)
        failed |= not report.ok
        if args.as_json:
            d = report.to_dict()
            d["note"] = note
            reports[name] = d
        else:
            print(report.render(f"{name} ({note})"))
            print()
    if args.as_json:
        print(json.dumps(reports, indent=2))
    if failed:
        print("hslint: error-severity findings above", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
