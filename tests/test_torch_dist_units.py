"""repro_torch.dist's rules, records and split iCRT against the JAX package.

No rank is spawned here. The reference's ``he_expected_collectives`` and
``mesh_collective_groups`` need a mesh of 8 devices, so they run once in
the 8-device subprocess harness (``run_in_8dev_subprocess``) and come back
as JSON; the port's run on shape-only grids (a HostGrid of rank 0 with no
process group: the formulas read only its shape). The split iCRT
(``icrt_partial`` over the shards of a region's primes, summed, then
``icrt_finish``) is held against the JAX ``core.crt.icrt`` at
``test_params(logN=5)``, on random and edge residues.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import manifest as ref_manifest
from repro.core import test_params as j_test_params
from repro.core.context import build_global_tables as j_global_tables
from repro.core.context import build_icrt_tables as j_icrt_tables
from repro.core.crt import icrt as j_icrt
from repro.dist import he_pipeline as jhp

from repro_torch.analysis import manifest as port_manifest
from repro_torch.core import test_params as t_test_params
from repro_torch.core.context import device_icrt_tables, device_tables
from repro_torch.core.crt import icrt_finish, icrt_partial
from repro_torch.dist import comm
from repro_torch.dist import he_pipeline as thp
from repro_torch.dist.sharding import (
    he_eval_sharding, he_expected_collectives, he_limb_sharding,
    mesh_collective_groups, prime_rows,
)
from repro_torch.kernels.icrt.ops import icrt_finish_op, icrt_partial_op
from repro_torch.kernels.icrt.ref import icrt_inputs
from repro_torch.launch.mesh import HostGrid, grid_backend, single_grid

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "SHARD_MANIFEST.json").read_text())
SHAPES = [(1, 1), (1, 2), (2, 2), (2, 4)]
OPS = sorted({key.split("/")[0] for key in MANIFEST["cells"]})


def _grid(shape, rank=0):
    return HostGrid(data=shape[0], model=shape[1], rank=rank,
                    device=torch.device("cpu"), backend=None)


def _params():
    pp = MANIFEST["params"]
    return (t_test_params(logN=pp["logN"], beta_bits=pp["beta_bits"],
                          logQ=pp["logQ"], logp=pp["logp"]),
            j_test_params(logN=pp["logN"], beta_bits=pp["beta_bits"],
                          logQ=pp["logQ"], logp=pp["logp"]))


_REFERENCE: dict = {}


@pytest.fixture
def reference(run_in_8dev_subprocess):
    """The reference's predictions and device-id groups for every mesh,
    op and level of SHARD_MANIFEST.json (one subprocess for the module:
    the harness is a function-scoped fixture, so its result is kept
    here)."""
    if not _REFERENCE:
        _REFERENCE.update(run_in_8dev_subprocess(_REFERENCE_BODY))
    return _REFERENCE


_REFERENCE_BODY = f"""
    from jax.sharding import Mesh
    from repro.core import test_params
    from repro.dist.sharding import (
        he_expected_collectives, mesh_collective_groups,
    )
    pp = {MANIFEST["params"]!r}
    params = test_params(logN=pp["logN"], beta_bits=pp["beta_bits"],
                         logQ=pp["logQ"], logp=pp["logp"])
    out = {{}}
    for shape in {SHAPES!r}:
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        name = f"{{shape[0]}}x{{shape[1]}}"
        out[name] = {{"groups": mesh_collective_groups(mesh), "cells": {{}}}}
        for op in {OPS!r}:
            for logq in {MANIFEST["levels"]!r}:
                out[name]["cells"][f"{{op}}/{{logq}}"] = \\
                    he_expected_collectives(
                        op, mesh, params, logq, batch={MANIFEST["batch"]},
                        n_slots=params.n_slots_max)
    print(json.dumps(out))
    """


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_expected_collectives_equal_the_reference(reference, shape):
    params, _ = _params()
    grid = _grid(shape)
    ref = reference[grid.name]["cells"]
    for op in OPS:
        for logq in MANIFEST["levels"]:
            got = he_expected_collectives(op, grid, params, logq,
                                          batch=MANIFEST["batch"],
                                          n_slots=params.n_slots_max)
            assert json.loads(json.dumps(got)) == ref[f"{op}/{logq}"], \
                (op, logq)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_collective_groups_equal_the_reference_device_ids(reference, shape):
    grid = _grid(shape)
    got = json.loads(json.dumps(mesh_collective_groups(grid)))
    assert got == reference[grid.name]["groups"]
    # and each rank's own groups are one of them
    for rank in range(grid.size):
        g = _grid(shape, rank)
        for axis in ("data", "model"):
            assert g.axis_ranks(axis) in got[axis]


@pytest.mark.parametrize("logq", [120, 72, 24])
def test_table_and_input_specs_equal_the_reference(logq):
    tp, jp = _params()
    tt1, tt2, tek = thp.he_table_specs(thp.he_static(tp, logq))
    jt1, jt2, jek = jhp.he_table_specs(jhp.he_static(jp, logq))
    dtypes = {np.dtype(np.uint32): torch.int32,
              np.dtype(np.float64): torch.float64}
    for port, ref in ((tt1, jt1), (tt2, jt2), (tek, jek)):
        # the port has no quot_fix, the TPU kernel's fixed-point quotient
        assert set(ref) - set(port) <= {"quot_fix"}
        for k, v in port.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(ref[k].shape), k
            assert v.dtype == dtypes[np.dtype(ref[k].dtype)], k
    for port, ref in zip(thp.he_input_specs(thp.he_static(tp, logq), 3),
                         jhp.he_input_specs(jhp.he_static(jp, logq), 3)):
        assert tuple(port.shape) == tuple(ref.shape)
        assert port.dtype == torch.int32 and ref.dtype == np.uint32


def _perturbed(kind):
    m = json.loads(json.dumps(MANIFEST))
    cells = m["cells"]
    if kind == "count":
        cells["mul/120/2x4"]["collectives"]["counts"]["all-reduce"] = 14
    elif kind == "bytes":
        cells["rotate/72/2x4"]["collectives"]["total_bytes"] *= 1.5
    elif kind == "missing":
        del cells["slot_sum/24/2x4"]
    elif kind == "extra":
        cells["mul/48/2x4"] = cells["mul/72/2x4"]
    elif kind == "axes":
        cells["mul_plain/24/2x4"]["group_axes"] = ["data"]
    elif kind == "fusions":
        cells["add/120/1x1"]["fusions"] = 60
    elif kind == "schema":
        del m["levels"]
        cells["sub/72/1x1"]["expected"]["wire_bytes"] = "many"
        m["schema"] = 2
    return m


@pytest.mark.parametrize("kind", ["same", "count", "bytes", "missing",
                                  "extra", "axes", "fusions", "schema"])
def test_manifest_module_equals_the_reference(kind, tmp_path):
    path = tmp_path / "m.json"
    path.write_text(json.dumps(_perturbed(kind)))
    shutil.copy(ROOT / "SHARD_MANIFEST.json", tmp_path / "c.json")
    fresh_p, fresh_r = (mod.load_manifest(path)
                        for mod in (port_manifest, ref_manifest))
    committed = port_manifest.load_manifest(tmp_path / "c.json")
    assert fresh_p == fresh_r
    assert port_manifest.validate_manifest(fresh_p) == \
        ref_manifest.validate_manifest(fresh_r)
    assert port_manifest.diff_manifests(committed, fresh_p) == \
        ref_manifest.diff_manifests(committed, fresh_r)
    # every perturbation is caught, by the schema or by the diff
    assert (port_manifest.diff_manifests(committed, fresh_p) == []
            and port_manifest.validate_manifest(fresh_p) == []) == \
        (kind == "same")
    assert port_manifest.cell_key("mul", 120, "2x4") == \
        ref_manifest.cell_key("mul", 120, "2x4")


def _residues(primes, npn, n, kind, seed):
    ps = np.array(primes[:npn], np.uint64)[:, None]
    if kind == "random":
        r = np.random.default_rng(seed).integers(
            0, 1 << 62, size=(npn, n), dtype=np.uint64) % ps
    elif kind == "p-1":
        r = np.tile(ps - 1, (1, n))
    else:   # X = 1, P − 1, ⌊P/2⌋ in turn: X/P within 1/P of an integer
        P = 1
        for p in primes[:npn]:
            P *= p
        cols = np.array([[x % p for x in (1, P - 1, P // 2, P // 2 + 1)]
                         for p in primes[:npn]], np.uint64)
        r = np.tile(cols, (1, n // 4))
    return np.ascontiguousarray(r.astype(np.uint32))


@pytest.mark.parametrize("kind", ["random", "p-1", "near-integer"])
@pytest.mark.parametrize("region", [1, 2])
@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_partial_sums_finish_to_the_jax_icrt(shards, region, kind):
    """The shards' icrt_partial summed (one shard empty at 4 shards of
    region 1's 9 primes), then icrt_finish, == the JAX icrt; the kernel
    wrappers (their plain versions here) give the same words."""
    tp, jp = _params()
    logq = tp.logQ
    npn = tp.np_region1(logq) if region == 1 else tp.np_region2(logq)
    out_limbs = tp.qlimbs(logq)
    jg, jt = j_global_tables(jp), j_icrt_tables(jp, npn)
    primes = [int(p) for p in jg.primes[:npn]]
    r = _residues(primes, npn, 4 * tp.N, kind, 7 * shards + region)
    want = np.asarray(j_icrt(r, jt, jg.primes[:npn], jt.inv_P,
                             jt.inv_P_shoup, jt.pdivp, jt.P_limbs,
                             jt.P_half_limbs, jg.p_inv_f64[:npn],
                             out_limbs=out_limbs))
    cpu = torch.device("cpu")
    t = icrt_inputs(device_icrt_tables(tp, npn, cpu), device_tables(tp, cpu))
    rt = torch.from_numpy(r.view(np.int32))
    sums, sums_op = None, None
    sizes = []
    for k in range(shards):
        s = prime_rows(npn, shards, k)
        sizes.append(s.stop - s.start)
        ts = {k2: (v[s] if k2 not in ("P_limbs", "P_half_limbs") else v)
              for k2, v in t.items()}
        part = icrt_partial(rt[s], ts["primes"], ts["inv_P"],
                            ts["inv_P_shoup"], ts["pdivp"], ts["p_inv_f64"])
        part_op = icrt_partial_op(rt[s], ts)
        assert all(torch.equal(a, b) for a, b in zip(part, part_op))
        assert (part[0] < 2 ** 32).all() and (part[0] >= 0).all()
        sums = part if sums is None else [a + b for a, b in zip(sums, part)]
        sums_op = part_op if sums_op is None else [
            a + b for a, b in zip(sums_op, part_op)]
    if shards == 4 and region == 1:
        assert 0 in sizes
    got = icrt_finish(*sums, t["P_limbs"], t["P_half_limbs"], out_limbs)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    got_op = icrt_finish_op(*sums_op, t, out_limbs)
    assert torch.equal(got, got_op)


def test_grid_rules():
    """The GSPMD split of primes (an empty shard past np), the batch rows
    with the replicated fallback, the backend rule, a grid of one rank."""
    assert [prime_rows(9, 4, r) for r in range(4)] == [
        slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 9)]
    assert [prime_rows(81, 2, r) for r in range(2)] == [slice(0, 41),
                                                        slice(41, 81)]
    # at a level of 5 primes: the stored split cut to [:5]
    assert [prime_rows(9, 4, r, 5) for r in range(4)] == [
        slice(0, 3), slice(3, 5), slice(5, 5), slice(5, 5)]
    assert he_eval_sharding(_grid((2, 4), 6), 12, 10) == slice(6, 9)
    assert he_limb_sharding(_grid((2, 4), 5), 2) == slice(1, 2)
    assert he_limb_sharding(_grid((2, 4), 5), 3) == slice(0, 3)
    cpu, c0, c1 = (torch.device("cpu"), torch.device("cuda", 0),
                   torch.device("cuda", 1))
    assert grid_backend([cpu, cpu]) == "gloo"
    assert grid_backend([c0, c0]) == "gloo"
    assert grid_backend([c0, c1]) == "nccl"
    one = single_grid("cpu")
    assert (one.size, one.backend, one.model_group) == (1, None, None)
    x = torch.arange(4)
    assert comm.all_reduce(one, x) is x and one.log["step"] == []


def test_across_ranks_only_matmul_at_beta32():
    """acc3/naive iCRT and β = 2^64 refuse a model grid (ROADMAP A7c) at
    build time, before any collective."""
    grid = HostGrid(data=1, model=2, rank=0, device=torch.device("cpu"),
                    backend="gloo")
    for strategy in ("acc3", "naive"):
        with pytest.raises(ValueError, match="A7c"):
            thp.make_stage_fns("cpu", grid=grid, icrt_strategy=strategy)
    st64 = thp.he_static(t_test_params(logN=4, beta_bits=64), 120)
    with pytest.raises(ValueError, match="A7c"):
        thp.make_he_mul_step(st64, "cpu", grid=grid)
    # model size 1: the one-device bundle, knobs ignored
    sf = thp.make_stage_fns("cpu", grid=single_grid("cpu"),
                            icrt_strategy="acc3", reduce_scatter_icrt=True)
    assert sf.grid is None


def test_entry_points_default_to_the_card():
    """Without a card the grid's entry points raise unless asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    from repro_torch.dist.record import record
    from repro_torch.launch.mesh import make_host_grid, spawn_grid
    from repro_torch.launch.serve import serve_he
    for call in (lambda: make_host_grid(),
                 lambda: spawn_grid(print, model=2),
                 lambda: record((1, 2)),
                 lambda: serve_he(2, model_shards=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
