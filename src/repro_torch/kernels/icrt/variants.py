"""Timed variants of the iCRT kernels, on one NVIDIA card.

    PYTHONPATH=src python -m repro_torch.kernels.icrt.variants \
        [--against OTHER/icrt.cu [--against-ops OTHER/ops.py]]

Each variant in :data:`VARIANTS` is ``csrc/icrt.cu`` with one piece of its
text replaced, built with the library's nvcc flags into a shared library of
its own under ``build/icrt_variants/`` (all built in parallel). Each entry
of :data:`OCCUPANCY` is the kernel itself launched with more dynamic shared
memory than it needs, so that fewer of its blocks fit an SM. At the four
shapes that HE Mul (B = 1) and the batched step (B = 4) give iCRT at
``paper_params()``, every variant that computes the function is held bit
for bit against ``icrt_ref``, and all are timed in turns with the kernel:
kernel, variants, variants in reverse, kernel; each turn is the median of
20 launches by CUDA events with the L2 cache flushed before each. Prints
ptxas' registers and spills of each build, the card, and one JSON line.
``--against`` adds one more exact entry, "against": another version of
the whole file (another commit's ``icrt.cu``, with the same
``icrt_launch``), built and timed in the same turns, so that two versions
of the kernel are compared on one card in one call.

Then the split kernels, ``icrt_partial_launch`` and
``icrt_finish_launch``, in the same way: the partial at rank 0's shard of
a 2- and a 4-rank split of np 81 and 122 (41, 21, 61 and 31 primes), the
finish on the shards' summed partials, B = 1 and 4, each timed in turns
with the variants of :data:`SPLIT_VARIANTS` and, with ``--against``, that
file's launches, each with its own geometry: ``--against-ops`` names the
``kernels/icrt/ops.py`` of the other commit, whose
``icrt_partial_geometry`` and ``icrt_finish_geometry`` give it (default:
this one's). Every exact entry is held bit for bit against the plain
twins before it is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import common

__all__ = ["VARIANTS", "SPLIT_VARIANTS", "OCCUPANCY", "variant_source",
           "main"]

_MAC_HEAD = "uint32_t y3) {\n"


def _chain_mac() -> str:
    """mac4 as four multiply-adds, each one mad.lo.cc / madc.hi.cc / addc
    group on the three words."""
    return "".join(
        '  asm("mad.lo.cc.u32 %0, %3, %4, %0;\\n\\t"\n'
        '      "madc.hi.cc.u32 %1, %3, %4, %1;\\n\\t"\n'
        '      "addc.u32 %2, %2, 0;"\n'
        f'      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]) : "r"(x{q}), '
        f'"r"(y{q}));\n' for q in range(4))


_NO_SWEEP = [("    if (t < kBM) {\n#pragma unroll\n",
              "    if (false) {\n#pragma unroll\n")]
_NO_PRODUCT = [("if (k0 + (t >> 5) * 8 < PL) {", "if (false) {")]
# name -> (what it changes, whether it still computes the function,
#          replacements of csrc/icrt.cu's text; None replaces mac4's body)
VARIANTS = {
    "chain": ("each multiply-add a mad.lo.cc/madc.hi.cc/addc group", True,
              [(None, _chain_mac())]),
    "no_sweep": ("the carry sweep skipped", False, _NO_SWEEP),
    "no_product": ("the column-sum product skipped", False, _NO_PRODUCT),
    "shell": ("the product and the sweep skipped: loads, staging, "
              "quotient, output", False, _NO_PRODUCT + _NO_SWEEP),
    "shell_no_staging": ("the shell without staging pdivp", False,
                         _NO_PRODUCT + _NO_SWEEP + [(
                             "for (int e = t; e < np4 * kBN; e += kThreads)",
                             "for (int e = t; e < 0; e += kThreads)")]),
    "shell_no_load": ("the shell without loading the residues", False,
                      _NO_PRODUCT + _NO_SWEEP + [(
                          "const bool ok = j < np && m < nb;",
                          "const bool ok = false;")]),
    "shell_no_output": ("the shell without storing the output", False,
                        _NO_PRODUCT + _NO_SWEEP + [(
                            "for (int row = t >> 5; row < nb;",
                            "for (int row = t >> 5; row < 0;")]),
}
# name -> dynamic shared memory per block: 1 or 2 blocks an SM
OCCUPANCY = {"1_block_per_sm": 120_000, "2_blocks_per_sm": 100_000}
# name -> (what it changes, the kernel it is timed as, replacements of
# csrc/icrt.cu's text); none computes the function
SPLIT_VARIANTS = {
    "partial_no_product": ("the partial's product skipped: loads, Shoup, "
                           "qsum, staging and stores", "icrt_partial",
                           [("    tile_product(tempd, pd, np4, W, acc);",
                             "    if (false) tile_product(tempd, pd, np4, "
                             "W, acc);")]),
    "partial_dmma_only": ("the partial's tensor-core product on constant "
                          "operands: no operand loads or conversions",
                          "icrt_partial",
                          [("        a[mt][i] = ap[(j + 4 * (i >> 1)) * "
                            "kTempPitch + 16 * mt + 8 * (i & 1)];",
                            "        a[mt][i] = 1.0;"),
                           ("          b[i] = pdivp_half(bp, (j + 4 * i) * W "
                            "+ 4 * nt, sel);", "          b[i] = 1.0;")]),
    "partial_k4": ("the partial's product in m16n8k4 steps only",
                   "icrt_partial", [("  for (; j + 16 <= np4; j += 16) {",
                                     "  for (; j + 16 <= 0; j += 16) {")]),
    "partial_no_store": ("the partial's bulk stores of lo and hi skipped",
                         "icrt_partial",
                         [("      if (bulk) {\n        bulk_store(",
                           "      if (false) {\n        bulk_store(")]),
    "finish_no_sweep": ("the finish's carry sweep skipped: the loads of lo "
                        "and hi, step 4 and the output", "icrt_finish",
                        [("    for (int k = 0; k < A; ++k) {\n      const "
                          "bool in = k < PL;", "    for (int k = 0; k < 0; "
                          "++k) {\n      const bool in = k < PL;")]),
}


def variant_source(text: str, edits: list) -> str:
    for old, new in edits:
        if old is None:
            start = text.index(_MAC_HEAD) + len(_MAC_HEAD)
            end = text.index("\n}\n", start) + 1
            text = text[:start] + new + text[end:]
            continue
        if text.count(old) != 1:
            raise ValueError(f"variant edit does not match once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_variants(against=None) -> dict:
    out_root = common.BUILD_ROOT.parent / "icrt_variants"
    text = (common.CSRC / "icrt.cu").read_text()
    sources = {name: variant_source(text, edits)
               for name, (_, _, edits) in VARIANTS.items()}
    sources.update({name: variant_source(text, edits)
                    for name, (_, _, edits) in SPLIT_VARIANTS.items()})
    if against is not None:
        sources["against"] = against.read_text()
    nvcc = common._nvcc()
    procs = {}
    for name, source in sources.items():
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "icrt.cu").write_text(source)
        procs[name] = (d, subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-I", str(common.CSRC), "-shared",
             str(d / "icrt.cu"), "-o", str(d / "libicrt.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(d / "libicrt.so"))
        for entry in ("icrt_launch", "icrt_partial_launch",
                      "icrt_finish_launch"):
            getattr(lib, entry).argtypes = common.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _turns(calls: dict, flush) -> dict:
    """name -> the medians of its two turns: every entry in order, then in
    reverse; each turn 3 launches to warm up and the median of 20, each
    timed by CUDA events after flushing the L2 cache. calls: name -> a
    function that launches once."""
    import torch
    order = list(calls)
    turns = {name: [] for name in order}
    for name in order + order[::-1]:
        for _ in range(3):
            calls[name]()
        pairs = []
        for _ in range(20):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            calls[name]()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        turns[name].append(statistics.median(
            s.elapsed_time(e) for s, e in pairs))
    return turns


def _geometry(fn, *args):
    """fn's geometry from as many of `args` as it takes: another commit's
    geometry may not take PL, the last."""
    return fn(*args[:len(inspect.signature(fn).parameters)])


def _split_entries(libs: dict, kernel: str) -> list:
    """The builds timed as `kernel` (icrt_partial or icrt_finish): this
    file, "against" and that kernel's split variants."""
    return [name for name in libs if name in ("kernel", "against")
            or name in SPLIT_VARIANTS and SPLIT_VARIANTS[name][1] == kernel]


def _shard(t: dict, s: slice) -> dict:
    """The rows `s` of a region's iCRT tables (P's limbs whole)."""
    return {k: v if k in ("P_limbs", "P_half_limbs") else v[s].contiguous()
            for k, v in t.items()}


def _ops_module(path):
    spec = importlib.util.spec_from_file_location("icrt_ops_against", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.icrt.variants")
    ap.add_argument("--against", type=Path, default=None,
                    help="another version of csrc/icrt.cu to time in turns "
                         "with this one")
    ap.add_argument("--against-ops", type=Path, default=None,
                    help="the kernels/icrt/ops.py of that version, for the "
                         "split kernels' geometry (default: this one's)")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("icrt variants: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.context import device_icrt_tables, device_tables
    from repro_torch.core.params import paper_params
    from repro_torch.kernels.icrt import ops
    from repro_torch.kernels.icrt.ref import icrt_inputs, icrt_ref

    dev = torch.device("cuda", torch.cuda.current_device())
    lib_path = common.build()
    log = (lib_path.parent / "build.log").read_text()
    for line in log[log.index("== icrt.cu"):].split("\n== ")[0].splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"ptxas kernel: {line.strip()}")
    libs = {"kernel": common.library(), **_build_variants(args.against)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)

    params = paper_params()
    g = device_tables(params, dev)
    logq, N = params.logQ, params.N
    K = params.qlimbs(logq)
    ks_limbs = params.limbs_for_bits(logq + params.logQ) + 1
    regions = ((params.np_region1(logq), K),
               (params.np_region2(logq), ks_limbs))
    primes = g.primes.cpu().numpy().view(np.uint32).astype(np.uint64)
    rng = np.random.default_rng(2025)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def residues(npn, n):
        return torch.from_numpy(
            (rng.integers(0, 1 << 62, size=(npn, n), dtype=np.uint64)
             % primes[:npn, None]).astype(np.uint32).view(np.int32)).to(dev)

    def launcher(lib, entry, a, name):
        def run():
            err = getattr(lib, entry)(*a, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return run

    def report(kind, shape, turns, exact):
        row = {"shape": shape, "ms": turns,
               "bitwise": {k: v for k, v in exact.items() if v}}
        print(f"{kind} {shape}: " + ", ".join(
            f"{k} {statistics.mean(v):.4f}" for k, v in turns.items())
            + " ms", flush=True)
        return row

    fused = [k for k in libs if k not in SPLIT_VARIANTS]
    rows = []
    for B in (1, 4):
        for npn, out_limbs in regions:
            t = icrt_inputs(device_icrt_tables(params, npn, dev), g)
            r = residues(npn, B * N)
            want = icrt_ref(r, t, out_limbs)
            out, a = ops.icrt_args(r, t, out_limbs)
            calls = {name: launcher(libs[name], "icrt_launch", a, name)
                     for name in fused}
            calls.update({name: launcher(libs["kernel"], "icrt_launch",
                                         (*a[:-1], smem), name)
                          for name, smem in OCCUPANCY.items()})
            # "against" and the occupancy entries compute the function
            exact = {name: VARIANTS[name][1] if name in VARIANTS else True
                     for name in calls}
            for name, run in calls.items():
                out.zero_()
                run()
                torch.cuda.synchronize()
                if exact[name] and not torch.equal(out, want):
                    raise RuntimeError(f"variant {name} differs from "
                                       f"icrt_ref at np {npn}, B {B}")
            rows.append(report("icrt", f"np={npn} out={out_limbs} B={B}",
                               _turns(calls, flush), exact))
    split = _time_split(libs, ops, args.against_ops, params, g, regions,
                        residues, launcher, report, flush)
    print(json.dumps({"icrt_variants": rows, "icrt_split": split,
                      "card": card,
                      "variants": {k: v[0] for k, v in VARIANTS.items()},
                      "split_variants": {k: v[0] for k, v in
                                         SPLIT_VARIANTS.items()},
                      "occupancy_smem_bytes": OCCUPANCY}))
    return 0


def _time_split(libs, ops, against_ops, params, g, regions, residues,
                launcher, report, flush) -> list:
    """The split kernels' rows (see the module docstring)."""
    import torch
    from repro_torch.core.context import device_icrt_tables
    from repro_torch.dist.sharding import prime_rows
    from repro_torch.kernels.icrt.ref import (
        icrt_finish_ref, icrt_inputs, icrt_partial_ref,
    )
    other = _ops_module(against_ops) if against_ops else ops
    geometry = {name: other if name == "against" else ops for name in libs}
    dev = g.primes.device
    rows = []
    for B in (1, 4):
        n = B * params.N
        for npn, out_limbs in regions:
            t = icrt_inputs(device_icrt_tables(params, npn, dev), g)
            PL, A = t["pdivp"].shape[1], t["P_limbs"].shape[0]
            r = residues(npn, n)
            for ranks in (2, 4):
                s = prime_rows(npn, ranks, 0)
                ns = s.stop - s.start
                ts = _shard(t, s)
                rs = r[s].contiguous()
                want = icrt_partial_ref(rs, ts)
                got = [torch.empty((n, PL), dtype=torch.int64, device=dev),
                       torch.empty((n, PL), dtype=torch.int64, device=dev),
                       torch.empty(n, dtype=torch.float64, device=dev)]
                ptrs = [x.data_ptr() for x in
                        (rs, ts["inv_P"], ts["inv_P_shoup"], ts["primes"],
                         ts["p_inv_f64"], ts["pdivp"], *got)]
                calls, exact = {}, {}
                for name in _split_entries(libs, "icrt_partial"):
                    geo = _geometry(geometry[name].icrt_partial_geometry,
                                    n, ns, PL)
                    calls[name] = launcher(libs[name], "icrt_partial_launch",
                                           (*ptrs, n, ns, PL, *geo), name)
                    exact[name] = name not in SPLIT_VARIANTS
                for name, run in calls.items():
                    for x in got:
                        x.zero_()
                    run()
                    torch.cuda.synchronize()
                    if exact[name] and not all(
                            torch.equal(x, y) for x, y in zip(got, want)):
                        raise RuntimeError(f"{name}: icrt_partial differs "
                                           f"from its twin at np {ns} of "
                                           f"{npn}, B {B}")
                rows.append(report("icrt_partial",
                                   f"np={ns} of {npn} B={B}",
                                   _turns(calls, flush), exact))
                if ranks == 2:    # the finish takes the 2-rank sums
                    parts = [icrt_partial_ref(r[sk], _shard(t, sk))
                             for sk in (s, prime_rows(npn, 2, 1))]
                    summed = [(parts[0][i] + parts[1][i]).contiguous()
                              for i in range(3)]
            fwant = icrt_finish_ref(*summed, t, out_limbs)
            out = torch.empty((n, out_limbs), dtype=torch.int32, device=dev)
            ptrs = [x.data_ptr() for x in
                    (*summed, t["P_limbs"], t["P_half_limbs"], out)]
            calls, exact = {}, {}
            for name in _split_entries(libs, "icrt_finish"):
                geo = _geometry(geometry[name].icrt_finish_geometry, n, A,
                                out_limbs, PL)
                calls[name] = launcher(libs[name], "icrt_finish_launch",
                                       (*ptrs, n, PL, A, out_limbs, *geo),
                                       name)
                exact[name] = name not in SPLIT_VARIANTS
            for name, run in calls.items():
                out.zero_()
                run()
                torch.cuda.synchronize()
                if exact[name] and not torch.equal(out, fwant):
                    raise RuntimeError(f"{name}: icrt_finish differs from "
                                       f"its twin at np {npn}, B {B}")
            rows.append(report("icrt_finish",
                               f"np={npn} out={out_limbs} B={B}",
                               _turns(calls, flush), exact))
    return rows


if __name__ == "__main__":
    sys.exit(main())
