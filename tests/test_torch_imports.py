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
                 "repro_torch.analysis.manifest"):
        assert name in got["modules"]
    assert got["bad"] == []
