"""The benchmark's description, read by name: BENCHMARK.json at the root
of the checkout, a configuration's file, a traffic mix's file under
``bench/traffic/``, the driver of the mix's `kind` (``bench/hebench/<kind>cell.py``)
and a per-layer metric's reader under ``bench/metrics/``. Adding a cell,
of a kind the harness has or of a new one, adds files and entries;
nothing here names a cell or a kind."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class SpecError(Exception):
    """BENCHMARK.json asks for what the harness's files do not give."""


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    w = _named(bench["workloads"], name, "workload")
    config = json.loads(
        (root / _named(bench["configs"], w["config"], "configuration")
         ["file"]).read_text())
    traffic = json.loads(
        (root / BENCH.name / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moves = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moves)]
    return Cell(name=name, workload=w, config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)


def driver(kind: str):
    """The driver of a traffic mix of kind `kind`, the module
    ``hebench.<kind>cell``. It gives ``run(r: cells.Run) -> cells.Measure``,
    whose `checks` hold the numbers that decide `correct`, and
    ``end_to_end(m) -> {metric: value}`` for every end-to-end metric but
    `setup_s` that a cell of its kind reports."""
    name = f"hebench.{kind}cell"
    if not kind.isidentifier() or importlib.util.find_spec(name) is None:
        raise SpecError(f"a traffic mix of kind {kind!r} needs its driver, "
                        f"bench/hebench/{kind}cell.py, which is missing")
    return importlib.import_module(name)


def reader(metric: str):
    """The reader module of a per-layer metric: ``read(m)`` returns its
    value, or None where the run holds nothing to read."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
