"""CLI: `python -m repro_torch.obs report trace.json [--json]`."""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.report import analyze, format_report, load_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="serving-trace analysis (Fig. 3 attribution + "
                    "latency decomposition)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rep = sub.add_parser("report", help="summarize a trace.json written "
                                        "by serve --he --trace")
    rep.add_argument("trace", help="Chrome trace-event JSON file")
    rep.add_argument("--json", action="store_true",
                     help="emit the aggregation as JSON instead of text")
    args = ap.parse_args(argv)
    a = analyze(load_events(args.trace))
    if args.json:
        json.dump(a, sys.stdout, indent=2)
        print()
    else:
        print(format_report(a))
    return 0


if __name__ == "__main__":
    sys.exit(main())
