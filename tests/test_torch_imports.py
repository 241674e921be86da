"""The port's first rule: no module of repro_torch imports JAX or repro.

Every module of ``repro_torch`` is imported in a fresh interpreter, which
then must hold no ``jax*`` module and neither ``repro`` nor any
``repro.*`` module.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")
             or m.startswith("jax"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_no_module_of_the_port_imports_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # the walk reached the modules of every slice, this one's included
    for name in ("repro_torch.core.heaan", "repro_torch.core.rotate",
                 "repro_torch.analysis.dataflow", "repro_torch.hserve.circuit",
                 "repro_torch.hserve.engine", "repro_torch.dist.he_pipeline",
                 "repro_torch.kernels.ntt.variants", "repro_torch.convert",
                 "repro_torch.hserve.server", "repro_torch.hserve.tables",
                 "repro_torch.hserve.scheduler", "repro_torch.hserve.queue",
                 "repro_torch.obs.stages", "repro_torch.obs.report",
                 "repro_torch.launch.serve", "repro_torch.runtime.monitor",
                 "repro_torch.runtime.failures",
                 "repro_torch.hserve.transport", "repro_torch.hserve.worker",
                 "repro_torch.hserve.frontend", "repro_torch.client.handles",
                 "repro_torch.client.compile", "repro_torch.client.session",
                 "repro_torch.client.testing", "repro_torch.analysis.noise",
                 "repro_torch.analysis.rules", "repro_torch.analysis.cost",
                 "repro_torch.analysis.analyzer",
                 "repro_torch.analysis.examples",
                 "repro_torch.analysis.__main__", "repro_torch.boot",
                 "repro_torch.boot.modraise", "repro_torch.boot.linear",
                 "repro_torch.boot.evalmod", "repro_torch.boot.pipeline",
                 "repro_torch.launch.mesh", "repro_torch.dist.sharding",
                 "repro_torch.dist.comm", "repro_torch.dist.record",
                 "repro_torch.dist.__main__",
                 "repro_torch.analysis.manifest",
                 "repro_torch.models.model", "repro_torch.models.attention",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.models.rglru", "repro_torch.models.blocks",
                 "repro_torch.configs.registry",
                 "repro_torch.configs.llama3_2_1b",
                 "repro_torch.data.synthetic",
                 "repro_torch.optim.adamw", "repro_torch.optim.schedule",
                 "repro_torch.optim.compress", "repro_torch.ckpt.manager",
                 "repro_torch.dist.collectives", "repro_torch.launch.train",
                 "repro_torch.examples.quickstart",
                 "repro_torch.examples.he_inference",
                 "repro_torch.examples.bootstrap_demo",
                 "repro_torch.examples.serve_lm",
                 "repro_torch.examples.train_lm"):
        assert name in got["modules"]
    assert got["bad"] == []


# --------------------------------------------------------------------------
# public names: every module of the reference against its counterpart
# --------------------------------------------------------------------------

# names the port leaves out, by module, each with its reason
XLA_ONLY_NAMES = {
    # Pallas launch helpers: interpret mode and the Pallas grid's block
    "kernels/common.py": {"use_interpret", "pick_block"},
    # the TPU's 16-bit-split products: a Hopper core multiplies 32×32→64
    # natively (core/wordops.py's docstring in the port)
    "core/wordops.py": {"mulhi", "mullo", "add_wide", "barrett_modmul_ref"},
    # XLA's flags and jax Meshes; launch.mesh.HostGrid and make_host_grid
    # do make_host_mesh's job over torch.distributed
    "launch/mesh.py": {"XLA_LHS_FLAGS", "make_host_mesh",
                       "make_production_mesh"},
}
# modules with no counterpart of the same path, each with its reason
XLA_ONLY_MODULES = {
    # the Pallas bodies; their counterparts are kernels/csrc/*.cu, bound
    # in kernels/<name>/ops.py
    "kernels/crt/crt.py", "kernels/icrt/icrt.py", "kernels/modmul/modmul.py",
    "kernels/ntt/ntt.py",
    # lowering and reading XLA HLO (python -m repro_torch.dist --record
    # measures what shardlint measures)
    "analysis/xla.py", "launch/cells.py", "launch/dryrun.py",
    "launch/hlo_analysis.py",
}


def _public_names(path: str) -> set:
    """The names a module defines at its top level (functions, classes,
    assignments), less those that begin with an underscore."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out |= {n.id for t in targets for n in ast.walk(t)
                    if isinstance(n, ast.Name)}
    return {n for n in out if not n.startswith("_")}


def test_every_reference_module_has_its_public_names_in_the_port():
    ref_root = os.path.join(REPO, "src", "repro")
    port_root = os.path.join(REPO, "src", "repro_torch")
    gaps, alone, compared = {}, set(), 0
    for root, _, files in os.walk(ref_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), ref_root)
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                alone.add(rel)
                continue
            compared += 1
            missing = (_public_names(os.path.join(ref_root, rel))
                       - _public_names(port)
                       - XLA_ONLY_NAMES.get(rel, set()))
            if missing:
                gaps[rel] = sorted(missing)
    assert compared > 80
    assert not gaps, gaps
    assert alone == XLA_ONLY_MODULES
    # what the allowed gaps name is still missing (else drop it above)
    for rel, names in XLA_ONLY_NAMES.items():
        assert not names & _public_names(os.path.join(port_root, rel)), rel
    # and every example of the reference has the port's
    examples = {f for f in os.listdir(os.path.join(REPO, "examples"))
                if f.endswith(".py")}
    assert examples and examples <= set(os.listdir(
        os.path.join(port_root, "examples")))
