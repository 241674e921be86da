"""Timed variants of the iCRT kernel, on one NVIDIA card.

    PYTHONPATH=src python -m repro_torch.kernels.icrt.variants \
        [--against OTHER/icrt.cu]

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
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import common

__all__ = ["VARIANTS", "OCCUPANCY", "variant_source", "main"]

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
        lib.icrt_launch.argtypes = common.SIGNATURES["icrt_launch"]
        lib.icrt_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.kernels.icrt.variants")
    ap.add_argument("--against", type=Path, default=None,
                    help="another version of csrc/icrt.cu to time in turns "
                         "with this one")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("icrt variants: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.context import device_icrt_tables, device_tables
    from repro_torch.core.params import paper_params
    from repro_torch.kernels.icrt.ops import icrt_args
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
    primes = g.primes.cpu().numpy().view(np.uint32).astype(np.uint64)
    rng = np.random.default_rng(2025)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B in (1, 4):
        for npn, out_limbs in ((params.np_region1(logq), K),
                               (params.np_region2(logq), ks_limbs)):
            t = icrt_inputs(device_icrt_tables(params, npn, dev), g)
            r = torch.from_numpy(
                (rng.integers(0, 1 << 62, size=(npn, B * N), dtype=np.uint64)
                 % primes[:npn, None]).astype(np.uint32).view(np.int32)
            ).to(dev)
            want = icrt_ref(r, t, out_limbs)
            out, args = icrt_args(r, t, out_limbs)
            calls = {name: (lib, args) for name, lib in libs.items()}
            calls.update({name: (libs["kernel"], (*args[:-1], smem))
                          for name, smem in OCCUPANCY.items()})
            # "against" and the occupancy entries compute the function
            exact = {name: VARIANTS[name][1] if name in VARIANTS else True
                     for name in calls}

            def run(name):
                lib, a = calls[name]
                err = lib.icrt_launch(*a, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            for name in calls:
                out.zero_()
                run(name)
                torch.cuda.synchronize()
                if exact[name] and not torch.equal(out, want):
                    raise RuntimeError(f"variant {name} differs from "
                                       f"icrt_ref at np {npn}, B {B}")
            order = list(calls)
            turns = {name: [] for name in order}
            for name in order + order[::-1]:
                for _ in range(3):                   # warm-up
                    run(name)
                pairs = []
                for _ in range(20):
                    flush.zero_()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run(name)
                    end.record()
                    pairs.append((start, end))
                torch.cuda.synchronize()
                turns[name].append(statistics.median(
                    s.elapsed_time(e) for s, e in pairs))
            row = {"shape": f"np={npn} out={out_limbs} B={B}",
                   "ms": turns,
                   "bitwise": {k: v for k, v in exact.items() if v}}
            rows.append(row)
            print("icrt " + row["shape"] + ": " + ", ".join(
                f"{k} {statistics.mean(v):.4f}" for k, v in turns.items())
                + " ms", flush=True)
    print(json.dumps({"icrt_variants": rows, "card": card,
                      "variants": {k: v[0] for k, v in VARIANTS.items()},
                      "occupancy_smem_bytes": OCCUPANCY}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
