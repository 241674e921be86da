"""SHARD_MANIFEST.json schema + drift diff (stdlib only, importable
without numpy/jax).

A copy of the JAX package's ``analysis/manifest.py`` (the port imports
nothing of that package), its code verbatim: ``python -m repro_torch.dist
--record`` writes the port's collective schedule in this schema, and the
tests diff it against the checked-in ``SHARD_MANIFEST.json`` with these
functions. The text below is the reference's, but for the name of the
package whose ``__init__`` it bypasses, given as a path.

The manifest is shardlint's checked-in measurement: for every served
(op, level, mesh) cell, the collective schedule (per-kind counts and
ring-model wire bytes), the replica-group axis classification, the
fused-kernel count, and the backend memory estimate of the compiled
HLO, next to the `dist.sharding.he_expected_collectives` prediction it
was verified against. `tools/check_docs.py` diffs a freshly measured
manifest against the committed one in CI — so a PR that changes a
collective count, wire bytes, or the fusion structure of a serving
engine must regenerate the manifest (`tools/shardlint.py --write`) and
explain the diff in review.

This module must stay stdlib-only: the docs CI job runs before any
dependency install, so check_docs loads it by file path (bypassing
`src/repro/analysis/__init__.py`, which imports numpy).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import json

__all__ = ["SCHEMA_VERSION", "MANIFEST_NAME", "DEFAULT_TOLERANCES",
           "cell_key", "load_manifest", "validate_manifest",
           "diff_manifests"]

SCHEMA_VERSION = 1
MANIFEST_NAME = "SHARD_MANIFEST.json"

# bytes_rtol: committed-vs-fresh wire bytes (the ring model is exact on
#   a fixed XLA version, so drift means the partitioner changed — tight);
# expected_rtol: measured-vs-analytic all-reduce bytes (same model on
#   both sides: any drift is a real schedule change);
# fusion_rtol: fused-kernel count (fusion decisions wobble across XLA
#   minor versions — loose, and only ever a warning, HS105).
DEFAULT_TOLERANCES: Dict[str, float] = {
    "bytes_rtol": 0.01, "expected_rtol": 0.01, "fusion_rtol": 0.25,
}

_NUM = (int, float)

_TOP_SCHEMA: Dict[str, Any] = {
    "schema": int, "params": dict, "batch": int, "levels": list,
    "meshes": dict, "tolerances": dict, "hbm_budget_bytes": int,
    "cells": dict,
}
_PARAMS_KEYS = ("logN", "logQ", "logp", "beta_bits")
_CELL_SCHEMA: Dict[str, Any] = {
    "collectives": dict, "expected": dict, "group_axes": list,
    "fusions": int, "memory": dict,
}
_COLL_SCHEMA: Dict[str, Any] = {"counts": dict, "total_bytes": _NUM}
_EXPECTED_SCHEMA: Dict[str, Any] = {"counts": dict, "wire_bytes": _NUM}


def cell_key(op: str, logq: int, mesh_name: str) -> str:
    return f"{op}/{logq}/{mesh_name}"


def load_manifest(path: Union[str, Path]) -> Dict[str, Any]:
    obj = json.loads(Path(path).read_text())
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: manifest is not a JSON object")
    return obj


def _check_block(obj: Dict[str, Any], schema: Dict[str, Any],
                 where: str) -> List[str]:
    errors = []
    for key, typ in schema.items():
        if key not in obj:
            errors.append(f"{where}: missing key {key!r}")
        elif not isinstance(obj[key], typ) or (
                typ is not bool and isinstance(obj[key], bool)):
            errors.append(
                f"{where}.{key}: expected "
                f"{getattr(typ, '__name__', typ)}, got "
                f"{type(obj[key]).__name__}")
    return errors


def validate_manifest(obj: Dict[str, Any],
                      name: str = MANIFEST_NAME) -> List[str]:
    """Schema errors (empty list = valid)."""
    errors = _check_block(obj, _TOP_SCHEMA, name)
    if obj.get("schema") not in (None, SCHEMA_VERSION):
        errors.append(f"{name}: schema version {obj['schema']!r} != "
                      f"{SCHEMA_VERSION}")
    if isinstance(obj.get("params"), dict):
        for k in _PARAMS_KEYS:
            if k not in obj["params"]:
                errors.append(f"{name}.params: missing key {k!r}")
    cells = obj.get("cells")
    if isinstance(cells, dict):
        if not cells:
            errors.append(f"{name}.cells: empty — shardlint measured "
                          "nothing")
        for key, cell in sorted(cells.items()):
            if not isinstance(cell, dict):
                errors.append(f"{name}.cells[{key}]: not an object")
                continue
            where = f"{name}.cells[{key}]"
            errors += _check_block(cell, _CELL_SCHEMA, where)
            if isinstance(cell.get("collectives"), dict):
                errors += _check_block(cell["collectives"], _COLL_SCHEMA,
                                       f"{where}.collectives")
            if isinstance(cell.get("expected"), dict):
                errors += _check_block(cell["expected"], _EXPECTED_SCHEMA,
                                       f"{where}.expected")
    return errors


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(a), abs(b), 1.0)


def diff_manifests(committed: Dict[str, Any], fresh: Dict[str, Any],
                   tolerances: Optional[Dict[str, float]] = None
                   ) -> List[str]:
    """Drift between the checked-in manifest and a fresh measurement.

    Exact on cell coverage and per-kind collective counts; wire bytes
    within `bytes_rtol`; fusion counts within `fusion_rtol`. Tolerances
    come from the COMMITTED manifest (the reviewed contract), falling
    back to DEFAULT_TOLERANCES.
    """
    tol = dict(DEFAULT_TOLERANCES)
    tol.update(committed.get("tolerances") or {})
    tol.update(tolerances or {})
    errors = []
    old_cells = committed.get("cells") or {}
    new_cells = fresh.get("cells") or {}
    for key in sorted(set(old_cells) | set(new_cells)):
        if key not in new_cells:
            errors.append(f"cells[{key}]: in the committed manifest but "
                          "not measured — a served op/level/mesh "
                          "disappeared")
            continue
        if key not in old_cells:
            errors.append(f"cells[{key}]: measured but not in the "
                          "committed manifest — regenerate it "
                          "(tools/shardlint.py --write)")
            continue
        old, new = old_cells[key], new_cells[key]
        oc = (old.get("collectives") or {}).get("counts") or {}
        nc = (new.get("collectives") or {}).get("counts") or {}
        for kind in sorted(set(oc) | set(nc)):
            if oc.get(kind, 0) != nc.get(kind, 0):
                errors.append(
                    f"cells[{key}]: {kind} count {oc.get(kind, 0)} -> "
                    f"{nc.get(kind, 0)} — the collective schedule "
                    "changed")
        ob = (old.get("collectives") or {}).get("total_bytes", 0.0)
        nb = (new.get("collectives") or {}).get("total_bytes", 0.0)
        if _rel(float(ob), float(nb)) > tol["bytes_rtol"]:
            errors.append(
                f"cells[{key}]: wire bytes {ob:.0f} -> {nb:.0f} "
                f"(drift {_rel(float(ob), float(nb)):.1%} > "
                f"{tol['bytes_rtol']:.1%})")
        of, nf = old.get("fusions"), new.get("fusions")
        if isinstance(of, int) and isinstance(nf, int) \
                and _rel(of, nf) > tol["fusion_rtol"]:
            errors.append(
                f"cells[{key}]: fused-kernel count {of} -> {nf} "
                f"(drift > {tol['fusion_rtol']:.0%} — XLA broke or "
                "merged fusions)")
        if old.get("group_axes") != new.get("group_axes"):
            errors.append(
                f"cells[{key}]: replica-group axes "
                f"{old.get('group_axes')} -> {new.get('group_axes')}")
    return errors
