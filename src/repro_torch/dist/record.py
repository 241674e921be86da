"""Record the port's collective schedule of every served op, in the schema
of ``SHARD_MANIFEST.json``.

    PYTHONPATH=src python -m repro_torch.dist --record OUT.json \\
        [--grid 2x4] [--device cpu|cuda] [--manifest SHARD_MANIFEST.json] \\
        [--icrt-strategy matmul|acc3|naive] [--beta-bits 32|64]

(``dist/__main__.py`` calls :func:`main`; the rank function lives here,
where the spawned ranks can import it.) Spawns the grid
(``launch.mesh.spawn_grid``) and, in every rank, drives
every served op (``analysis.dataflow.OPS``) at each level of the
manifest's ``levels``, at its ``params`` and ``batch``, through the
engine's steps (``hserve.engine.OpEngine.run_step`` on a ``TableCache``
holding the rank's rows), with the op arguments the reference lowers
(``analysis/xla.py``: rotate by 1, slot_sum over all slots, rescale by
logp, mod_down to logq − logp, mod_raise to logq + logp; a level op that
has no such target is not served there). The same cells run on one rank
("1x1": no grid, no collective). Each cell holds:

  - ``collectives``: the measured counts, wire bytes by kind and
    ``total_bytes`` of the step's own log on rank 0 (every rank's must
    agree), and ``group_axes``;
  - ``expected``: ``dist.sharding.he_expected_collectives`` for the
    run's iCRT strategy and word size (the manifest's cells: "matmul" at
    the manifest's β = 2^32; the other forms' predictions are the
    port's own);
  - ``fusions``: the port's own counter in the place of XLA's fused
    kernels: the CUDA kernel launches of one step on this rank (0 on the
    CPU, where the wrappers run their plain versions);
  - ``memory``: ``peak_bytes``, the step's peak device memory above what
    was allocated before it (``torch.cuda.max_memory_allocated``), or None
    on the CPU.

No field is copied from the checked-in manifest but its run parameters
and tolerances. The operands are random ciphertext words from a seed; the
batch reaches each rank through ``he_pipeline.scatter_batch`` (the feed
log, not the step's).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis.dataflow import OPS
from repro_torch.analysis.manifest import (
    MANIFEST_NAME, SCHEMA_VERSION, cell_key,
)
from repro_torch.core import bigint
from repro_torch.core.keys import keygen
from repro_torch.core.params import HEParams, test_params
from repro_torch.core.rns import PipelineConfig
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.dist import comm
from repro_torch.dist.he_pipeline import he_static, scatter_batch
from repro_torch.dist.sharding import (
    he_expected_collectives, mesh_collective_groups,
)
from repro_torch.hserve.engine import OpEngine, slot_sum_rotations
from repro_torch.hserve.tables import TableCache
from repro_torch.kernels import common
from repro_torch.launch.mesh import HostGrid, single_grid, spawn_grid

__all__ = ["served_cells", "record_rank", "record", "main"]

DEFAULT_MANIFEST = Path(__file__).resolve().parents[3] / MANIFEST_NAME


def served_cells(params: HEParams, levels) -> list:
    """(op, logq, extra) of every served op at every level where it is
    served, with the reference's lowered op arguments."""
    logp, logQ = params.logp, params.logQ
    cells = []
    for op in sorted(OPS):
        for logq in levels:
            extra = {"rotate": 1, "slot_sum": params.n_slots_max,
                     "rescale": logp, "mod_down": logq - logp,
                     "mod_raise": logq + logp}.get(op)
            if op in ("rescale", "mod_down") and logq - logp < logp:
                continue
            if op == "mod_raise" and logq + logp > logQ:
                continue
            cells.append((op, logq, extra))
    return cells


def _operands(op: str, st, batch: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    names = (["ax1", "bx1"] + (["ax2", "bx2"] if OPS[op] == 2 else [])
             + (["pt"] if op in ("mul_plain", "add_plain") else []))
    shape = (batch, st.N, st.qlimbs)

    def draw() -> np.ndarray:
        if st.dtype == torch.int32:
            return rng.integers(0, 1 << 32, size=shape, dtype=np.uint64
                                ).astype(np.uint32).view(np.int32)
        return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64
                            ).view(np.int64)

    return {k: bigint.mask_bits(torch.from_numpy(draw()), st.logq)
            for k in names}


def _kernels(params: HEParams, dev) -> bool:
    """The kernels run on the card at β = 2^32; β = 2^64 has none."""
    return dev.type == "cuda" and params.beta_bits == 32


def record_rank(grid, params: HEParams, cells: list, batch: int,
                icrt_strategy: str = "matmul") -> dict:
    """One rank's measurement of every cell (see the module docstring)."""
    dev = grid.device
    cfg = PipelineConfig(use_kernels=_kernels(params, dev))
    sk, _, evk = keygen(params, seed=0, cfg=cfg, device=dev)
    rots = sorted({1, *slot_sum_rotations(params.n_slots_max)})
    cache = TableCache(params, evk,
                       {r: rot_keygen(params, sk, r, cfg=cfg, device=dev)
                        for r in rots},
                       conj_keygen(params, sk, cfg=cfg, device=dev),
                       device=dev, grid=grid)
    engine = OpEngine(params, dev, cache, grid=grid,
                      use_kernels=_kernels(params, dev),
                      icrt_strategy=icrt_strategy)
    out = {}
    for i, (op, logq, extra) in enumerate(cells):
        st = he_static(params, logq)
        names, full = zip(*_operands(op, st, batch, 1000 + i).items())
        arrays = dict(zip(names, scatter_batch(
            grid, *(x.to(dev) for x in full))))
        key = (op, logq, extra)
        engine.run_step(key, arrays)         # build + first run, unmetered
        comm.reset(grid, "step")
        common.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        engine.run_step(key, arrays)
        peak = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev) - base
        out[(op, logq)] = {"summary": comm.summary(grid, "step"),
                           "launches": sum(common.LAUNCHES.values()),
                           "peak_bytes": peak}
    return out


def _cell(op, logq, grid, params, batch, meas, icrt_strategy,
          use_kernels) -> dict:
    s = meas["summary"]
    exp = he_expected_collectives(op, grid, params, logq, batch=batch,
                                  n_slots=params.n_slots_max,
                                  icrt_strategy=icrt_strategy,
                                  use_kernels=use_kernels)
    return {"collectives": {"counts": s["counts"], "bytes": s["bytes"],
                            "total_bytes": s["total_bytes"]},
            "expected": {"counts": dict(exp["counts"]),
                         "wire_bytes": float(exp["wire_bytes"]),
                         "axis": exp["axis"], "allowed": exp["allowed"]},
            "group_axes": s["group_axes"],
            "fusions": int(meas["launches"]),
            "memory": {"peak_bytes": meas["peak_bytes"]}}


def record(shape=(2, 4), device="cuda", manifest=DEFAULT_MANIFEST,
           icrt_strategy: str = "matmul", beta_bits=None) -> dict:
    """The record of the 1x1 cells (in this process) and of the `shape`
    grid's (spawned), at `manifest`'s params (its β unless `beta_bits`
    says otherwise), levels and batch, with `icrt_strategy`."""
    ref = json.loads(Path(manifest).read_text())
    pp = dict(ref["params"])
    if beta_bits is not None:
        pp["beta_bits"] = int(beta_bits)
    params = test_params(logN=pp["logN"], beta_bits=pp["beta_bits"],
                         logQ=pp["logQ"], logp=pp["logp"])
    batch, levels = ref["batch"], ref["levels"]
    cells = served_cells(params, levels)
    one = single_grid(device)
    runs = {"1x1": (one, record_rank(one, params, cells, batch,
                                     icrt_strategy))}
    D, M = shape
    ranks = spawn_grid(record_rank, data=D, model=M, device=device,
                       args=(params, cells, batch, icrt_strategy))
    for r, res in enumerate(ranks[1:], 1):
        for key, meas in res.items():
            if meas["summary"]["counts"] != ranks[0][key]["summary"][
                    "counts"]:
                raise RuntimeError(f"rank {r} issued another schedule at "
                                   f"{key}")
    # rank 0's view of the grid, for the formulas (its groups are gone)
    grid = HostGrid(data=D, model=M, rank=0, device=one.device,
                    backend=None)
    runs[grid.name] = (grid, ranks[0])
    out = {"schema": SCHEMA_VERSION, "params": pp, "batch": batch,
           "icrt_strategy": icrt_strategy,
           "levels": levels,
           "meshes": {name: list(g.shape) for name, (g, _) in runs.items()},
           "tolerances": ref["tolerances"],
           "hbm_budget_bytes": ref["hbm_budget_bytes"],
           "device": str(one.device),
           "groups": {name: mesh_collective_groups(g)
                      for name, (g, _) in runs.items()},
           "cells": {}}
    for name, (g, res) in runs.items():
        for op, logq, _ in cells:
            out["cells"][cell_key(op, logq, name)] = _cell(
                op, logq, g, params, batch, res[(op, logq)], icrt_strategy,
                _kernels(params, one.device))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.dist")
    ap.add_argument("--record", required=True, metavar="OUT.json",
                    help="write the measured schedule here")
    ap.add_argument("--grid", default="2x4", metavar="DxM",
                    help="data x model ranks of the grid (beside 1x1)")
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device (cpu runs the plain versions)")
    ap.add_argument("--manifest", default=str(DEFAULT_MANIFEST),
                    help="the manifest whose params, levels and batch "
                         "to run at")
    ap.add_argument("--icrt-strategy", default="matmul",
                    choices=["matmul", "acc3", "naive"],
                    help="iCRT strategy of every step (its partial sums' "
                         "form decides the all-reduces)")
    ap.add_argument("--beta-bits", type=int, choices=[32, 64], default=None,
                    help="word size (default the manifest's)")
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.grid.split("x"))
    rec = record(shape, args.device, args.manifest, args.icrt_strategy,
                 args.beta_bits)
    Path(args.record).write_text(json.dumps(rec, indent=1, sort_keys=True))
    n = sum(1 for c in rec["cells"].values() if c["collectives"]["counts"])
    print(f"recorded {len(rec['cells'])} cells ({n} with collectives) on "
          f"{rec['device']} -> {args.record}")
