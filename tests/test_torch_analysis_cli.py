"""The port's analyzer CLI (``python -m repro_torch.analysis``) and its
example circuits against the JAX package's ``python -m repro.analysis``,
on the CPU.

Each of the four examples (degree4, affine_sigmoid, rotation_average,
bootstrap) is built from the port's own objects; the CLI's JSON for it —
the analyzer's whole report, noise, diagnostics and note — must equal the
reference CLI's, with and without a cost model calibrated from
``BENCH_serve_he.json``, and so must the pretty rendering of all four.
The exit status is 1 only on an error-severity (HS001) finding.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.analysis.__main__ import main as j_main

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import examples
from repro_torch.hserve.circuit import CircuitOp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "BENCH_serve_he.json")
NAMES = ["affine_sigmoid", "bootstrap", "degree4", "rotation_average"]


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_examples_are_the_references():
    from repro.analysis.examples import EXAMPLES as J_EXAMPLES
    assert sorted(examples.EXAMPLES) == sorted(J_EXAMPLES) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_json_equals_the_reference_cli(name, capsys):
    rc, out = _run(cli.main, [name, "--json"], capsys)
    jrc, jout = _run(j_main, [name, "--json"], capsys)
    assert rc == jrc == 0
    assert json.loads(out) == json.loads(jout)
    assert out == jout


@pytest.mark.parametrize("name", ["bootstrap", "degree4"])
def test_json_with_a_bench_cost_model_equals_the_reference_cli(name,
                                                               capsys):
    rc, out = _run(cli.main, [name, "--json", "--bench", BENCH], capsys)
    jrc, jout = _run(j_main, [name, "--json", "--bench", BENCH], capsys)
    assert rc == jrc == 0
    got = json.loads(out)
    assert got == json.loads(jout)
    assert got[name]["cost"]["est_device_s"] > 0


def test_pretty_reports_equal_the_reference_cli(capsys):
    rc, out = _run(cli.main, [], capsys)
    jrc, jout = _run(j_main, [], capsys)
    assert rc == jrc == 0
    assert out == jout
    assert all(f"{n} (" in out for n in NAMES)


def test_exit_status_is_one_only_on_an_error_finding(monkeypatch, capsys):
    """A circuit that exhausts its modulus is an HS001 error (with its
    HS007 hint): the CLI exits 1; the examples' warnings and infos
    alone exit 0."""
    from repro_torch.core.params import test_params

    def exhausted():
        p = test_params(logN=4, logQ=48, logp=24)
        ops = [CircuitOp("mul", ("x", "x")), CircuitOp("rescale", (0,)),
               CircuitOp("mul", (1, 1)), CircuitOp("rescale", (2,))]
        return dict(ops=ops, params=p, input_meta={"x": (48, 24)}), "bad"

    monkeypatch.setitem(examples.EXAMPLES, "exhausted", exhausted)
    rc, out = _run(cli.main, ["exhausted", "--json"], capsys)
    assert rc == 1
    diags = json.loads(out)["exhausted"]["diagnostics"]
    assert [d["rule"] for d in diags] == ["HS001", "HS007"]
    assert "run(bootstrap=\"auto\")" in diags[1]["message"]
    assert _run(cli.main, ["rotation_average"], capsys)[0] == 0


def test_module_entry_point_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "bootstrap",
         "degree4", "--json"], capture_output=True, text=True, env=env,
        timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert sorted(got) == ["bootstrap", "degree4"]
    assert got["bootstrap"]["n_ops"] == 143
