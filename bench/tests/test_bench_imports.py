"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program."""

import ast
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": f"{BENCH}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def harness_modules() -> list:
    """Every module of bench/hebench, each kind's driver (`*cell.py`) and
    its calls into the program (`program*.py`) among them, as found."""
    return sorted(p.stem for p in (BENCH / "hebench").glob("*.py")
                  if p.stem != "__init__")


def references() -> list:
    """Every plain reference, ``bench/*ref.py``."""
    return sorted(p.stem for p in BENCH.glob("*ref.py"))


def test_the_harness_and_the_program_import_no_jax():
    mods = harness_modules()
    assert {"program", "servecell", "stepcell"} <= set(mods)
    mods = top_level_after(
        f"import run, {', '.join(references())}\n"
        f"from hebench import {', '.join(mods)}\n"
        "for m in spec.load()['per_layer']: spec.reader(m['name'])\n"
        "import repro_torch.hserve.server, repro_torch.dist.he_pipeline\n"
        "import repro_torch.kernels.common")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    assert "heref" in references()
    for ref in references():
        mods = top_level_after(f"import {ref}")
        assert not mods & (FORBIDDEN | {"repro_torch", "hebench"}), ref
        tree = ast.parse((BENCH / f"{ref}.py").read_text())
        names = {a.name.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "math", "torch"}, ref


def test_the_result_guard_compares_whole_top_level_names():
    top_level_after(
        "import types, sys, repro_torch\n"
        "from hebench import report\n"
        "assert report.forbidden_modules() == []\n"
        "sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
        "assert report.forbidden_modules() == ['repro']")
