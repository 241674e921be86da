"""A cell is driven, read and checked by its traffic's `kind` alone.

A toy kind joins a copy of the harness as new files and BENCHMARK.json
entries, and the harness's own files run it as they stand. The three
cells of the benchmark keep their result line: the same keys and the one
`mismatched_words` check."""

import ast
import dataclasses
import importlib
import json
import shutil
import sys

import pytest
import torch
from conftest import BENCH, ROOT, tiny_config, tiny_serve_mix, tiny_step_mix

import hebench
import run
from hebench import cells, spec

SEED = 2**31 + 3303

TOY_DRIVER = '''"""The toy kind: no program; its reading and its count come from its
traffic file."""

import time

from hebench.cells import Measure


def run(r):
    m = Measure(kind="toy", config=r.config, traffic=r.traffic,
                device_name="cpu", batch=1)
    m.setup_s = time.perf_counter() - r.t_start
    m.window_s = r.seconds
    m.attempted = m.ops = r.traffic["ops"]
    m.checks = {"toy_gap": {"value": r.traffic["gap"],
                            "limit": r.traffic["limit"],
                            "compared": r.traffic["compared"]}}
    return m


def end_to_end(m):
    return {"toy_per_s": m.ops / m.window_s}
'''


def harness_files(root) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A copy of the harness with the toy kind added as files and entries;
    its driver found where the harness looks for drivers."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = harness_files(root)
    assert before == harness_files(ROOT)

    (root / "bench" / "configs" / "toy.json").write_text('{"size": 1}')
    (root / "bench" / "hebench" / "toycell.py").write_text(TOY_DRIVER)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy", "source": "https://example.org/toy",
                         "file": "bench/configs/toy.json", "reduced": [],
                         "why": "a kind the harness has never seen"})
    b["workloads"].append({"name": "toy.cell", "config": "toy",
                           "traffic": "toy", "chips": 1,
                           "why": "drives the toy kind"})
    b["end_to_end"].insert(0, {"name": "toy_per_s", "unit": "ops/s",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    monkeypatch.setattr(hebench, "__path__",
                        [*hebench.__path__, str(root / "bench" / "hebench")])
    importlib.invalidate_caches()
    yield root
    sys.modules.pop("hebench.toycell", None)
    after = harness_files(root)
    assert {p: after[p] for p in before} == before
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (root / "bench" / "configs" / "toy.json",
                                      root / "bench" / "hebench" / "toycell.py",
                                      root / "bench" / "traffic" / "toy.json")}


def toy_cell(root, **traffic):
    mix = {"kind": "toy", "ops": 40, "gap": 0.5, "limit": 1.0, "compared": 3,
           **traffic}
    (root / "bench" / "traffic" / "toy.json").write_text(json.dumps(mix))
    return spec.cell(spec.load(root), "toy.cell", root)


def drive(cell, capsys, seconds=2.0):
    """run.py's dispatch, outcome and result line for `cell` on the CPU:
    (exit code, the result line or None, standard error)."""
    rc = run.run_cell(cell, torch.device("cpu"), SEED, seconds, False)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err


def test_the_toy_kind_reports_its_value_and_its_check(toy_root, capsys):
    rc, line, err = drive(toy_cell(toy_root), capsys)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 40
    assert list(line["metrics"]) == ["toy_per_s", "setup_s"]
    assert line["metrics"]["toy_per_s"] == {"value": 20.0, "unit": "ops/s"}
    assert line["checks"] == {"toy_gap": {"value": 0.5, "limit": 1.0,
                                          "compared": 3}}
    assert err.strip().splitlines()[-1] == "check toy_gap: 0.5 (limit 1.0)"


@pytest.mark.parametrize("gap, compared, ok", [
    (0.5, 3, True), (1.0, 3, True), (1.5, 3, False), (0.5, 0, False),
    (float("nan"), 3, False)])
def test_correct_follows_the_kinds_own_check(toy_root, capsys, gap,
                                             compared, ok):
    rc, line, _ = drive(toy_cell(toy_root, gap=gap, compared=compared),
                        capsys)
    assert rc == 0 and line["correct"] is ok


def test_a_value_the_driver_does_not_give_ends_the_run(toy_root, capsys):
    b = json.loads((toy_root / "BENCHMARK.json").read_text())
    for m in b["end_to_end"]:
        if m["name"] == "he_ops_per_s":
            m["workloads"].append("toy.cell")
    (toy_root / "BENCHMARK.json").write_text(json.dumps(b))
    rc, line, err = drive(toy_cell(toy_root), capsys)
    assert rc != 0 and line is None
    assert "he_ops_per_s" in err and "'toy'" in err


def test_a_kind_without_a_driver_ends_the_run(toy_root, capsys):
    rc, line, err = drive(toy_cell(toy_root, kind="toy2"), capsys)
    assert rc != 0 and line is None
    assert "bench/hebench/toy2cell.py" in err


@pytest.mark.parametrize("workload", ["paper-b32.step-b16",
                                      "paper-b32.serve-poisson",
                                      "paper-b64.step-b8"])
def test_each_cell_keeps_its_result_line(workload, capsys):
    """Each cell of BENCHMARK.json at test_params() through run.py: the
    keys of its result line and its one check are what they were."""
    cell = spec.cell(spec.load(ROOT), workload, ROOT)
    beta = cell.config["params"]["beta_bits"]
    config = tiny_config(beta)
    serve = cell.traffic["kind"] == "serve"
    mix = (tiny_serve_mix() if serve
           else tiny_step_mix(config["params"]["logQ"]))
    cell = dataclasses.replace(cell, config=config, traffic=mix)
    rc, line, _ = drive(cell, capsys, seconds=0.5 if serve else 0.3)
    assert rc == 0
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert list(line["metrics"]) == (["request_p95_ms", "setup_s"] if serve
                                     else ["he_ops_per_s", "setup_s"])
    assert list(line["device"]) == ["platform", "kind", "count",
                                    "memory_peak_bytes"]
    assert line["device"]["count"] == cell.workload["chips"] == 1
    assert line["correct"] is True
    check = line["checks"]["mismatched_words"]
    assert list(line["checks"]) == ["mismatched_words"]
    assert list(check) == ["value", "limit", "compared"]
    assert check["value"] == check["limit"] == 0
    if serve:
        assert check["compared"] > 0
    else:   # as test_a_sound_step_run_is_correct counts them
        assert check["compared"] == 4 * 2 * 32 * config["shapes"]["qlimbs"]


def test_no_file_of_the_harness_but_a_driver_names_a_kind():
    kinds = {json.loads(p.read_text())["kind"]
             for p in (BENCH / "traffic").glob("*.json")}
    assert kinds == {"step", "serve"}
    files = [BENCH / "run.py", *(p for p in (BENCH / "hebench").glob("*.py")
                                 if not p.stem.endswith("cell"))]
    for f in files:
        named = {n.value for n in ast.walk(ast.parse(f.read_text()))
                 if isinstance(n, ast.Constant) and n.value in kinds}
        assert not named, (f.name, named)


def test_the_drivers_give_the_end_to_end_values_they_gave():
    m = cells.Measure(kind="", config={}, traffic={}, device_name="cpu",
                      batch=16, ops=320, window_s=8.0,
                      latencies_ms=[float(x) for x in range(1, 201)])
    assert spec.driver("step").end_to_end(m) == {"he_ops_per_s": 40.0}
    assert spec.driver("serve").end_to_end(m) == {"request_p95_ms": 190.0}
