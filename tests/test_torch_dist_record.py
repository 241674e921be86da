"""The port's recorded collective schedule against SHARD_MANIFEST.json.

``python -m repro_torch.dist --record OUT --grid 2x4 --device cpu`` runs
once for the module (8 CPU ranks over gloo, and the 1x1 cells in its own
process, ≈ 25 s) at the manifest's params, levels and batch. Every cell's
measured counts and ``total_bytes`` equal the manifest's ``expected``
block (the reference's prediction, which its partitioner met up to the
collective-permutes it tolerates below logQ), with no collective-permute
at all, and the same replica-group axes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.analysis.manifest import diff_manifests, validate_manifest

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "SHARD_MANIFEST.json").read_text())
_RECORD: dict = {}


@pytest.fixture
def record(tmp_path_factory):
    if not _RECORD:
        out = tmp_path_factory.mktemp("record") / "rec.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        subprocess.run([sys.executable, "-m", "repro_torch.dist", "--record",
                        str(out), "--grid", "2x4", "--device", "cpu"],
                       check=True, env=env, timeout=300, cwd=ROOT,
                       capture_output=True)
        _RECORD.update(json.loads(out.read_text()))
    return _RECORD


@pytest.mark.parametrize("key", sorted(MANIFEST["cells"]))
def test_cell_equals_the_manifest_expected_block(record, key):
    want = MANIFEST["cells"][key]
    got = record["cells"][key]
    assert got["collectives"]["counts"] == want["expected"]["counts"]
    assert got["collectives"]["total_bytes"] == \
        want["expected"]["wire_bytes"]
    assert "collective-permute" not in got["collectives"]["counts"]
    assert got["group_axes"] == want["group_axes"]
    # the port's own prediction is the reference's
    assert got["expected"]["counts"] == want["expected"]["counts"]
    assert got["expected"]["wire_bytes"] == want["expected"]["wire_bytes"]


def test_record_is_a_manifest_that_differs_only_by_design(record):
    """Valid in the schema; against the committed manifest it differs only
    in the fused-kernel counts (the port counts kernel launches: none on
    the CPU) and in the cells where the reference's partitioner added
    collective-permutes (their count and their bytes), which the port
    does not issue."""
    assert validate_manifest(record) == []
    assert set(record["cells"]) == set(MANIFEST["cells"])
    permuted = {k for k, c in MANIFEST["cells"].items()
                if "collective-permute" in c["collectives"]["counts"]}
    assert permuted
    for line in diff_manifests(MANIFEST, record):
        key = line.split("[", 1)[1].split("]", 1)[0]
        assert "fused-kernel count" in line or (
            key in permuted and ("collective-permute" in line
                                 or "wire bytes" in line)), line
    assert {name: tuple(shape) for name, shape in record["meshes"].items()} \
        == {name: tuple(shape) for name, shape in MANIFEST["meshes"].items()}
    assert (record["params"], record["batch"], record["levels"]) == \
        (MANIFEST["params"], MANIFEST["batch"], MANIFEST["levels"])


def test_one_rank_records_no_collective(record):
    for key, cell in record["cells"].items():
        if key.endswith("/1x1"):
            assert cell["collectives"]["counts"] == {}
            assert cell["collectives"]["total_bytes"] == 0.0
            assert cell["memory"]["peak_bytes"] is None     # the CPU
    assert record["groups"]["2x4"]["model"] == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.mark.parametrize("form", [("acc3", 32), ("naive", 64)],
                         ids=["acc3", "naive-beta64"])
def test_record_of_a_column_form_meets_its_prediction(form, tmp_path):
    """``--icrt-strategy`` and ``--beta-bits``: on a (1,2) grid every
    cell's measured counts and wire bytes equal he_expected_collectives
    for that form (the port's own prediction: two all-reduces a
    reduction), with no collective-permute."""
    strategy, bits = form
    out = tmp_path / "rec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.dist", "--record",
                    str(out), "--grid", "1x2", "--device", "cpu",
                    "--icrt-strategy", strategy, "--beta-bits", str(bits)],
                   check=True, env=env, timeout=300, cwd=ROOT,
                   capture_output=True)
    rec = json.loads(out.read_text())
    assert rec["icrt_strategy"] == strategy
    assert rec["params"]["beta_bits"] == bits
    reduced = 0
    for key, cell in rec["cells"].items():
        got, exp = cell["collectives"], cell["expected"]
        assert got["counts"] == exp["counts"], key
        assert got["total_bytes"] == exp["wire_bytes"], key
        assert "collective-permute" not in got["counts"]
        if key.endswith("/1x2") and got["counts"]:
            reduced += 1
            assert got["counts"]["all-reduce"] % 2 == 0
    assert reduced == 15
