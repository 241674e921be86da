"""Build, load and launch the port's CUDA kernels.

The sources under ``csrc/`` are compiled at first use with ``nvcc`` for
``sm_90a`` — one object per source, all compiled in parallel — and linked
into one shared library with a plain C interface, loaded with ``ctypes``.
Processes that build at once (cold workers started together) serialize on
an ``flock`` of ``build.lock`` beside the objects: one compiles, the
others then load its library.
The library lands in ``build/repro_torch_kernels/<hash of the sources>/``
at the root of the checkout, beside ``build.log`` (what ``ptxas -v`` said:
registers, shared memory and spills per kernel).

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not 0
and then adds one to the kernel's count in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "SMEM_LIMIT", "reset_launches", "build", "library",
           "plain", "words32", "check", "launch", "padded"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SMEM_LIMIT = 232_448  # dynamic shared memory a Hopper block may use

# launches per kernel since the last reset_launches(); one per wrapper call.
# The variants count apart, so that a run shows which of them it launched:
# crt_mod2/crt_mod4 are crt with strategy "mod2"/"mod4", ntt_modified and
# intt_modified the transforms with modified=True.
# icrt_partial/icrt_finish are iCRT split at the cross-prime sum, for
# primes spread over ranks. carry_shift/carry_add are the BigInt carry
# chains of the β = 2^32 steps (the ÷Q shift; the combine's add and mask).
LAUNCHES = {"modmul": 0, "ntt": 0, "intt": 0, "crt": 0, "icrt": 0,
            "crt_mod2": 0, "crt_mod4": 0, "ntt_modified": 0,
            "intt_modified": 0, "icrt_partial": 0, "icrt_finish": 0,
            "carry_shift": 0, "carry_add": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_PI = ctypes.POINTER(ctypes.c_int)
SIGNATURES = {
    "modmul_launch": [_P] * 6 + [_I, _I, _P],
    "ntt_forward_launch": [_P] * 5 + [_I] * 5 + [_PI, _P],
    "ntt_inverse_launch": [_P] * 7 + [_I] * 5 + [_PI, _P],
    "crt_launch": [_P] * 5 + [_I] * 8 + [_P],
    "icrt_launch": [_P] * 9 + [_I] * 8 + [_P],
    "icrt_partial_launch": [_P] * 9 + [_I] * 6 + [_P],
    "icrt_finish_launch": [_P] * 6 + [_I] * 7 + [_P],
    "carry_shift_round_launch": [_P] * 2 + [_I] * 4 + [_P],
    "carry_add_mask_launch": [_P] * 3 + [_I] * 3 + [_P],
}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME)")


def build() -> Path:
    """Compile csrc/*.cu into one shared library, unless already built."""
    files = sorted(CSRC.glob("*.cu*"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        digest.update(f.name.encode() + f.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # processes that start cold together (a pool of workers) take turns:
    # the first builds, the others wait here and then find the library
    with open(out_dir / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(files, out_dir, lib)
    return lib


def _compile(files: list, out_dir: Path, lib: Path) -> None:
    """nvcc each .cu of `files` into out_dir in parallel, then link `lib`
    (replaced atomically); raises with the build log on failure."""
    nvcc = _nvcc()
    sources = [f for f in files if f.suffix == ".cu"]
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(out_dir / f"{src.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"tmp-{os.getpid()}.so"
    subprocess.run([nvcc, "-shared", "-o", str(tmp),
                    *[str(out_dir / f"{s.stem}.o") for s in sources]],
                   check=True, capture_output=True)
    os.replace(tmp, lib)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare argtypes/restype of every C entry point of `lib`."""
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def words32(t: torch.Tensor) -> None:
    """Refuse words other than β = 2^32 (int32 bit patterns) on any device:
    the kernels, like the reference's Pallas kernels, take 32-bit words."""
    if t.dtype != torch.int32:
        raise ValueError(
            f"the CUDA kernels take β = 2^32 words (torch.int32); got "
            f"{t.dtype}. β = 2^64 runs the plain path: "
            f"PipelineConfig(use_kernels=False)")


def plain(t: torch.Tensor) -> bool:
    """Whether a wrapper given `t` runs the plain version: only for a
    tensor on the CPU. Any other device launches the kernel or raises."""
    return t.device.type == "cpu"


def padded(n: int, block: int) -> int:
    """The width a kernel that tiles `n` coefficients by `block` runs at:
    `n` itself when it is at most one block or a multiple of one, else `n`
    rounded up to the next multiple (the wrapper pads with zeros and
    slices the result)."""
    return n if n <= block or n % block == 0 else -(-n // block) * block


def check(name: str, t: torch.Tensor, shape: tuple, device: torch.device,
          dtype: torch.dtype = torch.int32) -> int:
    """Validate a kernel operand; returns its data pointer."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")
    return t.data_ptr()


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point `entry` on the current stream and count one
    launch of `kernel`; raises when the launch reports a CUDA error."""
    err = getattr(library(), entry)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}")
    LAUNCHES[kernel] += 1
