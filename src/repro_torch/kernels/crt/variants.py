"""Timed variants of the CRT kernel, on one NVIDIA card.

    PYTHONPATH=src python -m repro_torch.kernels.crt.variants

Each variant in :data:`VARIANTS` is ``csrc/crt.cu`` with one piece of its
text replaced, built with the library's nvcc flags into a shared library of
its own under ``build/crt_variants/`` (all built in parallel). Some skip a
phase of the kernel, so that the difference of times says what the phase
costs; the others compute the function with other tile constants or shared
memory layout. Each entry of :data:`OCCUPANCY` is the kernel itself
launched with more dynamic shared memory than it needs, so that fewer of
its blocks fit an SM. At the four shapes that HE Mul (B = 1) and the
batched step (B = 4) give the acc3 CRT at ``paper_params()``, every variant
that computes the function is held bit for bit against ``crt_ref``, and all
are timed in turns with the kernel: kernel, variants, variants in reverse,
kernel; each turn is the median of 20 launches by CUDA events with the L2
cache flushed before each. Prints ptxas' registers and spills of each
build, the card, and one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

from repro_torch.kernels import common

__all__ = ["VARIANTS", "OCCUPANCY", "variant_source", "main"]

_NO_PRODUCT = [("for (int k = 0; k < Kp; k += 4) {",
                "for (int k = 0; k < 0; k += 4) {")]
_NO_FOLD = [("if constexpr (Every == 0) v = fold3(acc[i][c], f[c]);",
             "if constexpr (Every == 0) "
             "v = acc[i][c][0] ^ acc[i][c][1] ^ acc[i][c][2];")]


def _tiles(warps_m: int, warps_n: int) -> list:
    return [("constexpr int kWarpsM = 4;", f"constexpr int kWarpsM = "
             f"{warps_m};"),
            ("constexpr int kWarpsN = 2;", f"constexpr int kWarpsN = "
             f"{warps_n};")]


# name -> (what it changes, (coefficients, threads) of a block where they
#          differ from the kernel's, whether it still computes the function,
#          replacements of csrc/crt.cu's text)
VARIANTS = {
    "no_product": ("the product skipped", None, False, _NO_PRODUCT),
    "no_fold": ("acc3's fold skipped (the three words XORed)", None, False,
                _NO_FOLD),
    "shell": ("the product and the fold skipped: staging and store", None,
              False, _NO_PRODUCT + _NO_FOLD),
    "no_limb_staging": ("the limb tile not loaded", None, False, [(
        "cp_async4(&xs[r * pitch + k], src + e, true);", "")]),
    "no_table_staging": ("the table not loaded", None, False, [(
        "cp_async4(&ts[j * pitch + k], ok ? &tb[j * tb_cols + k] : tb, ok);",
        "")]),
    "no_store": ("the output not stored", None, False, [(
        "if (j0 + c < np && row0 + 16 * i < nb)",
        "if (v == 0xFFFFFFFFu && j0 + c < np && row0 + 16 * i < nb)")]),
    "tail2": ("acc3's last group of 4 limbs as 2 products where K is 1 or "
              "2 above a multiple of 4", None, True, [(
                  "add3(acc[i][c], dot<4>(xv[i], yv[c]));",
                  "add3(acc[i][c], k + 2 < K ? dot<4>(xv[i], yv[c])\n"
                  "                                        : dot<2>(xv[i], "
                  "yv[c]));")]),
    "pitch_kp": ("rows at a pitch of Kp words (2-way bank conflicts at "
                 "K = 38)", None, True, [("const int pitch = Kp | 4;",
                                          "const int pitch = Kp;")]),
    "bm128_bn32": ("128 coefficients, 4 warp columns, 256 threads a block",
                   (128, 256), True, _tiles(2, 4)),
    "bm128": ("128 coefficients, 2 warp columns, 128 threads a block",
              (128, 128), True, _tiles(2, 2)),
    "bm64": ("64 coefficients, 2 warp columns, 64 threads a block",
             (64, 64), True, _tiles(1, 2)),
}
# name -> dynamic shared memory per block: 1 or 2 blocks an SM
OCCUPANCY = {"1_block_per_sm": 120_000, "2_blocks_per_sm": 100_000}


def variant_source(text: str, edits: list) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant edit does not match once: {old!r}")
        text = text.replace(old, new)
    return text


def _build_variants() -> dict:
    out_root = common.BUILD_ROOT.parent / "crt_variants"
    text = (common.CSRC / "crt.cu").read_text()
    nvcc = common._nvcc()
    procs = {}
    for name, (_, _, _, edits) in VARIANTS.items():
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "crt.cu").write_text(variant_source(text, edits))
        procs[name] = (d, subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-I", str(common.CSRC), "-shared",
             str(d / "crt.cu"), "-o", str(d / "libcrt.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"ptxas {name}: {line.strip()}")
        lib = ctypes.CDLL(str(d / "libcrt.so"))
        lib.crt_launch.argtypes = common.SIGNATURES["crt_launch"]
        lib.crt_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("crt variants: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.context import device_tables
    from repro_torch.core.params import paper_params
    from repro_torch.kernels.crt.ops import crt_args, crt_geometry
    from repro_torch.kernels.crt.ref import crt_ref

    dev = torch.device("cuda", torch.cuda.current_device())
    lib_path = common.build()
    log = (lib_path.parent / "build.log").read_text()
    for line in log[log.index("== crt.cu"):].split("\n== ")[0].splitlines():
        if "registers" in line or "spill" in line.lower():
            print(f"ptxas kernel: {line.strip()}")
    libs = {"kernel": common.library(), **_build_variants()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)

    params = paper_params()
    g = device_tables(params, dev)
    logq, N = params.logQ, params.N
    K = params.qlimbs(logq)
    rng = np.random.default_rng(2026)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B in (1, 4):
        x = torch.from_numpy(rng.integers(
            0, 1 << 32, size=(B * N, K), dtype=np.uint64
        ).astype(np.uint32).view(np.int32)).to(dev)
        for npn in (params.np_region1(logq), params.np_region2(logq)):
            tabs = (x, g.crt_tb[:npn, :K].contiguous(),
                    g.crt_tb_shoup[:npn, :K].contiguous(), g.primes[:npn])
            want = crt_ref(*tabs)
            out, args = crt_args(*tabs, 0)
            calls = {}
            for name, lib in libs.items():
                tile = VARIANTS[name][1] if name in VARIANTS else None
                calls[name] = (lib, args if tile is None else (
                    *args[:-3], *crt_geometry(B * N, K, npn, *tile)))
            calls.update({name: (libs["kernel"], (*args[:-1], smem))
                          for name, smem in OCCUPANCY.items()})
            exact = {name: VARIANTS[name][2] if name in VARIANTS else True
                     for name in calls}

            def run(name):
                lib, a = calls[name]
                err = lib.crt_launch(*a, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            for name in calls:
                out.zero_()
                run(name)
                torch.cuda.synchronize()
                if exact[name] and not torch.equal(out, want):
                    raise RuntimeError(f"variant {name} differs from "
                                       f"crt_ref at np {npn}, B {B}")
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
            row = {"shape": f"K={K} np={npn} B={B}", "ms": turns,
                   "bitwise": {k: v for k, v in exact.items() if v}}
            rows.append(row)
            print("crt " + row["shape"] + ": " + ", ".join(
                f"{k} {statistics.mean(v):.4f}" for k, v in turns.items())
                + " ms", flush=True)
    print(json.dumps({"crt_variants": rows, "card": card,
                      "variants": {k: v[0] for k, v in VARIANTS.items()},
                      "occupancy_smem_bytes": OCCUPANCY}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
