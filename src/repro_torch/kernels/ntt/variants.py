"""Timed variants of the NTT/iNTT kernels, on one NVIDIA card.

    PYTHONPATH=src python -m repro_torch.kernels.ntt.variants

Each variant in :data:`VARIANTS` is ``csrc/ntt.cu`` with one piece of its
text replaced, or (``radix_tile``) the previous design kept beside this
module as ``ntt_radix_tile.cu``, built with the library's nvcc flags into
a shared library of its own under ``build/ntt_variants/`` (all built in
parallel), and launched with the geometry that ``ntt_geometry`` gives for
its constants; a variant of the geometry alone runs the kernel's own
library.
Some skip a phase of the kernel, so that the difference of times says what
the phase costs; the others compute the function another way. At the four
shapes that HE Mul (B = 1) and the batched step (B = 4) give the transforms
at ``paper_params()`` (np 81 and 122), forward and inverse, exact and
modified Shoup, every variant that computes the function is held bit for
bit against ``ntt_ref``/``intt_ref``, and all are timed in turns with the
kernel: kernel, variants, variants in reverse, kernel; each turn is the
median of 20 launches by CUDA events with the L2 cache flushed before
each. Prints ptxas' registers and spills of each build, the card, and one
JSON line.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import common
from repro_torch.kernels.ntt.ops import ntt_args

__all__ = ["VARIANTS", "variant_source", "main"]

RADIX_TILE_SOURCE = Path(__file__).resolve().parent / "ntt_radix_tile.cu"
# its entry points take no geometry
_RADIX_TILE_SIGNATURES = {
    "ntt_forward_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_void_p],
    "ntt_inverse_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    + [ctypes.c_void_p]}

# the twiddle fetch of ntt_pass (any pass) and of ntt_pass8 (8 stages)
_TWIDDLE_SMEM = ("const uint2 w = tws.smem[(set << L) + (1 << l) + "
                 "(k >> (e + 1))];")
_TWIDDLE_GLOBAL = (
    "const size_t g = tws.toff + (static_cast<size_t>(tws.top + set) << l)"
    " + (1 << l) + (k >> (e + 1));\n"
    "      const uint2 w = make_uint2(tws.g[g], tws.g_sh[g]);")
_TWIDDLE8_SMEM = "const uint2 w = tws.smem[t0 + cq];"
_TWIDDLE8_GLOBAL = (
    "const size_t g = tws.toff + (static_cast<size_t>(tws.top + set) << l)"
    " + (1 << l) + (lpk >> (e + 1)) + cq;\n"
    "      const uint2 w = make_uint2(tws.g[g], tws.g_sh[g]);")
_NO_BUTTERFLIES = [
    ("butterflies<Fwd, Col, M>(v,",
     "if (false) butterflies<Fwd, Col, M>(v,"),
    ("butterflies8<Fwd, M>(v,", "if (false) butterflies8<Fwd, M>(v,")]
# a column pass's tile staged and stored 4 bytes a thread (the staging by
# cp.async), in place of 16-byte vectors through registers
_CP_ASYNC4 = [
    ("""const int c4 = (threadIdx.x & 7) << 2;
    uint4 t[(1 << kLogS) / (kThreads / 8)];
#pragma unroll
    for (int i = 0; i < (1 << kLogS) / (kThreads / 8); ++i)
      t[i] = __ldcs(reinterpret_cast<const uint4*>(
          src + (((threadIdx.x >> 3) + i * (kThreads / 8)) << ps.lt) + c4));
#pragma unroll
    for (int i = 0; i < (1 << kLogS) / (kThreads / 8); ++i) {
      const int pr = col_pos((threadIdx.x >> 3) + i * (kThreads / 8));
      sm[pr ^ c4] = t[i].x;
      sm[pr ^ (c4 + 1)] = t[i].y;
      sm[pr ^ (c4 + 2)] = t[i].z;
      sm[pr ^ (c4 + 3)] = t[i].w;
    }""",
     """#pragma unroll 8
    for (int r = warp; r < (1 << kLogS); r += kWarps)
      cp_async4(&sm[col_pos(r) ^ lane], src + (r << ps.lt) + lane);"""),
    ("""const int c4 = (threadIdx.x & 7) << 2;
#pragma unroll 8
      for (int r = threadIdx.x >> 3; r < (1 << kLogS); r += kThreads / 8) {
        const int pr = col_pos(r);
        __stcs(reinterpret_cast<uint4*>(dst + (r << ps.lt) + c4),
               make_uint4(sm[pr ^ c4], sm[pr ^ (c4 + 1)], sm[pr ^ (c4 + 2)],
                          sm[pr ^ (c4 + 3)]));
      }""",
     """#pragma unroll 8
      for (int r = warp; r < (1 << kLogS); r += kWarps)
        __stcs(dst + (r << ps.lt) + lane, sm[col_pos(r) ^ lane]);""")]


def _bounds(blocks: int) -> tuple:
    return ("__launch_bounds__(kThreads)\n    ntt_pass8(",
            f"__launch_bounds__(kThreads, {blocks})\n    ntt_pass8(")


# name -> (what it changes, whether it still computes the function,
#          replacements of csrc/ntt.cu's text, or None for
#          ntt_radix_tile.cu, ntt_geometry's keywords)
VARIANTS = {
    "radix_tile": ("the previous design: radix-16 register passes and a "
                   "4096-word shared-memory tile pass (12 block-wide "
                   "barriers, twiddles from device memory in every "
                   "butterfly)", True, None, {}),
    "global_twiddles": ("twiddles read from device memory in every "
                        "butterfly, none staged", True,
                        [(_TWIDDLE_SMEM, _TWIDDLE_GLOBAL),
                         (_TWIDDLE8_SMEM, _TWIDDLE8_GLOBAL),
                         ("const int nsets = Col ? 1 : T >> L;",
                          "const int nsets = 0;"),
                         ("i < (kSets << kLogS); i += kThreads",
                          "i < 0; i += kThreads")], {}),
    "one_row": ("a block takes one row in every pass, the rows that "
                "share twiddles in adjacent blocks", True, [],
                {"chunk_rows": 1}),
    "row_major": ("a block takes one row, blocks in row-major order: rows "
                  "that share twiddles np·tiles blocks apart", True, [
                      ("  const int g = bid % groups, rest = bid / groups;\n"
                       "  const int ti = rest % ps.tiles, j = rest / "
                       "ps.tiles;\n",
                       "  const int ti = bid % ps.tiles, rest = bid / "
                       "ps.tiles;\n"
                       "  const int j = rest % ps.np, g = rest / ps.np;\n")],
                  {"chunk_rows": 1}),
    "no_swizzle": ("tile and exchange slices without the swizzle (a "
                   "column pass's warp then reads one bank)", True, [
                       ("return (k << 5) ^ (k & 31) ^ swizzle((k >> 5) & 7);",
                        "return k << 5;"),
                       ("return s ^ swizzle((s >> 5) & 7);", "return s;")],
                   {}),
    "w8": ("8 words a lane, 256 a warp: three layouts a pass, two "
           "exchanges, all free of bank conflicts; 2048-word chunk tiles",
           True, [("constexpr int kLogW = 4;", "constexpr int kLogW = 3;")],
           {"log_w": 3}),
    "bounds_4": ("ntt_pass8 launch-bounded to 4 blocks an SM (64 "
                 "registers)", True, [_bounds(4)], {}),
    "bounds_6": ("ntt_pass8 launch-bounded to 6 blocks an SM (40 "
                 "registers)", True, [_bounds(6)], {}),
    "rows_2": ("2 rows of a twiddle row a chunk-pass block", True, [],
               {"chunk_rows": 2}),
    "cp_async4": ("a column pass's tile staged and stored 4 bytes a "
                  "thread (cp.async), not in 16-byte vectors", True,
                  _CP_ASYNC4, {}),
    "no_butterflies": ("the butterflies skipped: staging, exchanges, "
                       "loads and stores", False, _NO_BUTTERFLIES, {}),
    "copy": ("the butterflies and the exchanges skipped: staging, loads "
             "and stores", False, _NO_BUTTERFLIES + [
                 ("if (Fwd ? lo == 0 : hi == L) break;", "break;"),
                 ("if (i > 0) {", "if (false) {")], {}),
}


def variant_source(text: str, edits: list) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant edit does not match once: {old!r}")
        text = text.replace(old, new)
    return text


def _ptxas(name: str, log: str) -> None:
    for line in log.splitlines():
        if ("registers" in line or "spill" in line.lower()
                or "entry function" in line):
            print(f"ptxas {name}: {line.strip()}")


def _build_variants() -> dict:
    out_root = common.BUILD_ROOT.parent / "ntt_variants"
    text = (common.CSRC / "ntt.cu").read_text()
    nvcc = common._nvcc()
    procs, libs = {}, {}
    for name, (_, _, edits, _) in VARIANTS.items():
        if edits == []:                  # the geometry alone
            libs[name] = common.library()
            continue
        d = out_root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ntt.cu").write_text(RADIX_TILE_SOURCE.read_text()
                                  if edits is None
                                  else variant_source(text, edits))
        procs[name] = (d, subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-I", str(common.CSRC), "-shared",
             str(d / "ntt.cu"), "-o", str(d / "libntt.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        _ptxas(name, log)
        lib = ctypes.CDLL(str(d / "libntt.so"))
        for entry in ("ntt_forward_launch", "ntt_inverse_launch"):
            fn = getattr(lib, entry)
            fn.argtypes = (_RADIX_TILE_SIGNATURES if name == "radix_tile"
                           else common.SIGNATURES)[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return {name: libs[name] for name in VARIANTS}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ntt variants: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.context import device_tables
    from repro_torch.core.params import paper_params
    from repro_torch.kernels.ntt.ref import intt_ref, ntt_ref

    dev = torch.device("cuda", torch.cuda.current_device())
    lib_path = common.build()
    log = (lib_path.parent / "build.log").read_text()
    _ptxas("kernel", log[log.index("== ntt.cu"):].split("\n== ")[0])
    libs = {"kernel": common.library(), **_build_variants()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)

    params = paper_params()
    g = device_tables(params, dev)
    N, logN = params.N, params.logN
    rng = np.random.default_rng(2026)
    primes = g.primes.cpu().numpy().view(np.uint32).astype(np.uint64)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows_out = []
    for B in (1, 4):
        for npn in (params.np_region1(params.logQ),
                    params.np_region2(params.logQ)):
            x = torch.from_numpy((rng.integers(
                0, 1 << 62, size=(B * npn, N), dtype=np.uint64)
                % np.tile(primes[:npn], B)[:, None]).astype(np.uint32)
                .view(np.int32)).to(dev)
            fwd = (g.psi_rev[:npn], g.psi_rev_shoup[:npn], g.primes[:npn])
            inv = (g.ipsi_rev[:npn], g.ipsi_rev_shoup[:npn], g.n_inv[:npn],
                   g.n_inv_shoup[:npn], g.primes[:npn])
            ev = ntt_ref(x, *fwd)
            out = torch.empty_like(x)
            geometry = {name: () if name == "radix_tile" else ntt_args(
                B * npn, logN, npn, **VARIANTS.get(name, (0, 0, 0, {}))[3])
                for name in libs}
            for direction, src, tabs, entry in (
                    ("ntt", x, fwd, "ntt_forward_launch"),
                    ("intt", ev, inv, "ntt_inverse_launch")):
                ptrs = [t.data_ptr() for t in (src, *tabs, out)]
                for mod in (False, True):
                    want = (ntt_ref(x, *fwd, modified=mod)
                            if direction == "ntt" else
                            intt_ref(ev, *inv, modified=mod))

                    def run(name, ptrs=ptrs, entry=entry, mod=mod):
                        err = getattr(libs[name], entry)(
                            *ptrs, B * npn, npn, logN, int(mod),
                            *geometry[name], stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")

                    exact = {name: VARIANTS[name][1] if name in VARIANTS
                             else True for name in libs}
                    for name in libs:
                        out.zero_()
                        run(name)
                        torch.cuda.synchronize()
                        if exact[name] and not torch.equal(out, want):
                            raise RuntimeError(
                                f"variant {name} differs from {direction}"
                                f"_ref at np {npn}, B {B}, modified {mod}")
                    order = list(libs)
                    turns = {name: [] for name in order}
                    for name in order + order[::-1]:
                        for _ in range(3):               # warm-up
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
                    row = {"shape": f"{direction}{'_modified' if mod else ''}"
                                    f" np={npn} B={B}", "ms": turns,
                           "bitwise": [k for k, v in exact.items() if v]}
                    rows_out.append(row)
                    print(row["shape"] + ": " + ", ".join(
                        f"{k} {statistics.mean(v):.4f}"
                        for k, v in turns.items()) + " ms", flush=True)
    print(json.dumps({"ntt_variants": rows_out, "card": card,
                      "variants": {k: v[0] for k, v in VARIANTS.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
