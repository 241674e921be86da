"""Frontend <-> worker transports with pickle-free array framing.

The multi-host tier splits ``HEServer`` into a frontend that owns the
queue/scheduler and N worker engines that own a device each. Everything
that crosses the cut goes through one wire format, so the in-process and
subprocess deployments exercise the SAME serialization path:

    frame := b"HSW1" | u32 header_len | header_json | payload*

The JSON header carries the message dict plus an ``arrays`` manifest
(name/dtype/shape per array); payloads are the raw C-contiguous bytes
concatenated in manifest order. No pickle anywhere — a worker can only
ever receive ndarrays and JSON scalars.

This is the JAX package's ``hserve/transport.py``; a frame of the port and
one of the reference for the same head and arrays are equal byte for byte.
Arrays may be numpy arrays or CPU tensors: a tensor goes on the wire as a
zero-copy numpy view of its storage, its int32 words (the port's u32 bit
patterns) as ``uint32``, so a β = 2^32 ciphertext frames as it does in the
reference. An int64 tensor is not always a word array, so it frames as
``int64`` unless the caller passes it through :func:`words`, which gives
the β = 2^64 words' ``uint64`` view (the frontend's batches and keys and
the worker's results do). A tensor on another device is refused — moving
it to the host is the caller's business. Decoded arrays are numpy; :func:`read_frame`
reads each payload straight into its own writable array, and
:func:`write_frame` writes the header and then each payload to the stream
in turn, without joining them into one buffer first.

Two transports share the interface (``send`` / ``recv`` / ``kill`` /
``alive`` / ``close``):

- ``InProcTransport`` drives a ``WorkerEngine`` in this process. Every
  batch still round-trips the byte framing (encode -> decode -> handle ->
  encode -> decode), so frame bugs surface in fast unit tests, and
  ``kill()`` drops undelivered replies — the "worker died mid-batch"
  fault the requeue tests inject.
- ``SubprocessTransport`` spawns a fresh interpreter running
  ``repro_torch.hserve.worker.main`` and speaks frames over its stdin/
  stdout pipes — a real process boundary with its own CUDA context.

Each transport keeps what its last ``send`` and ``recv`` cost
(``last_send`` / ``last_recv``: bytes and seconds), which the frontend
logs per batch.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import time
from collections import deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

MAGIC = b"HSW1"
_LEN = struct.Struct("<I")

__all__ = [
    "WorkerDied",
    "words",
    "encode_frame",
    "write_frame",
    "decode_frame",
    "read_frame",
    "InProcTransport",
    "SubprocessTransport",
]


class WorkerDied(RuntimeError):
    """The worker on the other end of a transport is gone.

    Raised by ``send``/``recv`` on broken pipes, EOF mid-frame, or a
    killed in-process worker. The frontend catches this, marks the
    worker dead, and requeues its in-flight batch.
    """


def words(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor of stored words as the reference's wire array, without
    a copy: int32 (β = 2^32) as ``uint32``, int64 (β = 2^64) as
    ``uint64``."""
    if t.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"stored words are int32 or int64; got {t.dtype}")
    a = _wire_array(t)
    return a.view(np.uint32 if a.itemsize == 4 else np.uint64)


def _wire_array(a) -> np.ndarray:
    """The C-contiguous numpy array a frame carries for `a`: a CPU tensor
    as a zero-copy view (int32 words as uint32), a numpy array as is."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"frames carry host arrays; got a tensor on "
                             f"{a.device}")
        a = a.contiguous().numpy()
        if a.dtype == np.int32:
            a = a.view(np.uint32)
    return np.ascontiguousarray(a)


def _frame_parts(head: Dict[str, Any],
                 arrays: Mapping[str, Any] | None) -> List:
    """[magic + length + header, payload views...] of one frame."""
    manifest, payloads = [], []
    for name, a in (arrays or {}).items():
        a = _wire_array(a)
        manifest.append({"name": name, "dtype": str(a.dtype),
                         "shape": list(a.shape)})
        payloads.append(memoryview(a.reshape(-1).view(np.uint8)))
    header = dict(head)
    header["arrays"] = manifest
    hj = json.dumps(header, separators=(",", ":")).encode()
    return [MAGIC + _LEN.pack(len(hj)) + hj, *payloads]


def encode_frame(head: Dict[str, Any],
                 arrays: Mapping[str, Any] | None = None) -> bytes:
    """Serialize a message dict + named arrays into one frame."""
    return b"".join(_frame_parts(head, arrays))


def _write_parts(stream: Any, parts: List) -> int:
    n = 0
    for part in parts:
        stream.write(part)
        n += len(part)
    stream.flush()
    return n


def write_frame(stream: Any, head: Dict[str, Any],
                arrays: Mapping[str, Any] | None = None) -> int:
    """Write one frame to a binary stream, part by part (no joined copy);
    returns the bytes written."""
    return _write_parts(stream, _frame_parts(head, arrays))


def _manifest_arrays(head: Dict[str, Any]):
    for m in head.pop("arrays", []):
        dt = np.dtype(m["dtype"])
        count = int(np.prod(m["shape"], dtype=np.int64))
        yield m["name"], dt, count, m["shape"]


def decode_frame(buf) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Inverse of :func:`encode_frame` over a complete in-memory frame;
    the arrays are views of `buf` (writable when `buf` is)."""
    if bytes(buf[:4]) != MAGIC:
        raise WorkerDied(f"bad frame magic {bytes(buf[:4])!r}")
    (hlen,) = _LEN.unpack(bytes(buf[4:8]))
    head = json.loads(bytes(buf[8:8 + hlen]).decode())
    off = 8 + hlen
    arrays: Dict[str, np.ndarray] = {}
    for name, dt, count, shape in _manifest_arrays(head):
        if off + count * dt.itemsize > len(buf):
            raise WorkerDied("frame truncated")
        arrays[name] = np.frombuffer(buf, dtype=dt, count=count,
                                     offset=off).reshape(shape)
        off += count * dt.itemsize
    return head, arrays


def _read_into(stream: Any, view: memoryview) -> None:
    got, n = 0, len(view)
    while got < n:
        k = stream.readinto(view[got:])
        if not k:
            raise WorkerDied("worker stream closed mid-frame")
        got += k


def read_frame(stream: Any, timing: Optional[Dict[str, float]] = None
               ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Read one frame from a binary stream (worker stdout / stdin), each
    payload into its own writable array. `timing`, when given, receives
    the seconds spent waiting for the frame's first bytes ("wait_s"),
    reading the rest ("read_s") and the frame's size ("bytes")."""
    t0 = time.perf_counter()
    magic = stream.read(4)
    if not magic:
        raise WorkerDied("worker stream closed (EOF)")
    t1 = time.perf_counter()
    if magic != MAGIC:
        raise WorkerDied(f"bad frame magic {magic!r}")
    prefix = bytearray(4)
    _read_into(stream, memoryview(prefix))
    (hlen,) = _LEN.unpack(prefix)
    hj = bytearray(hlen)
    _read_into(stream, memoryview(hj))
    head = json.loads(hj.decode())
    arrays: Dict[str, np.ndarray] = {}
    nbytes = 8 + hlen
    for name, dt, count, shape in _manifest_arrays(head):
        a = np.empty(count, dtype=dt)
        _read_into(stream, memoryview(a.view(np.uint8)))
        arrays[name] = a.reshape(shape)
        nbytes += a.nbytes
    if timing is not None:
        timing.update(wait_s=t1 - t0, read_s=time.perf_counter() - t1,
                      bytes=nbytes)
    return head, arrays


class InProcTransport:
    """Drive a ``WorkerEngine`` in-process, through the byte framing.

    ``send`` is synchronous: the worker computes the reply inside the
    call and the reply frame is buffered until ``recv``. ``kill()``
    between the two models a worker that finished computing but died
    before delivering — exactly the in-flight window the frontend must
    requeue. Frames are built in writable buffers, so the arrays a
    worker decodes become tensors without a copy.
    """

    kind = "inproc"

    def __init__(self, worker: Any) -> None:
        self.worker = worker
        self._replies: deque = deque()
        self._dead = False
        self.last_send: Dict[str, float] = {}
        self.last_recv: Dict[str, float] = {}

    @property
    def alive(self) -> bool:
        return not self._dead

    def send(self, head: Dict[str, Any],
             arrays: Mapping[str, Any] | None = None) -> None:
        if self._dead:
            raise WorkerDied(f"worker {self.worker.wid} is dead")
        t0 = time.perf_counter()
        buf = bytearray().join(_frame_parts(head, arrays))
        t1 = time.perf_counter()
        h, a = decode_frame(buf)
        self.last_send = {"bytes": len(buf), "encode_s": t1 - t0,
                          "decode_s": time.perf_counter() - t1}
        reply = self.worker.handle(h, a)
        if reply is not None:
            rhead, rarrays = reply
            self._replies.append(
                bytearray().join(_frame_parts(rhead, rarrays)))

    def recv(self) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        if self._dead:
            raise WorkerDied(f"worker {self.worker.wid} is dead")
        if not self._replies:
            raise WorkerDied(
                f"worker {self.worker.wid}: no reply pending")
        buf = self._replies.popleft()
        t0 = time.perf_counter()
        out = decode_frame(buf)
        self.last_recv = {"bytes": len(buf),
                          "decode_s": time.perf_counter() - t0}
        return out

    def kill(self) -> None:
        """Simulate worker death: drop any undelivered replies."""
        self._dead = True
        self._replies.clear()

    def revive(self) -> None:
        """Bring a killed in-process worker back (test harness only)."""
        self._dead = False
        self._replies.clear()

    def close(self) -> None:
        self._dead = True
        self._replies.clear()


# The worker's command line. File descriptor 1 is reserved for frames
# before anything is imported: the frame stream is a duplicate of it, and
# fd 1 itself (and sys.stdout) then point at stderr, so no print of
# Python or C code in the worker can corrupt the stream.
_WORKER_CMD = ("import os, sys; out = os.fdopen(os.dup(1), 'wb'); "
               "os.dup2(2, 1); sys.stdout = sys.stderr; "
               "from repro_torch.hserve.worker import main; main(out)")


class SubprocessTransport:
    """Frames over the stdin/stdout pipes of a spawned worker process.

    device: the device the worker serves on (default "cuda"); it travels
    in the init frame the owner sends, and a worker that cannot open it
    answers the init with an error. The process is a fresh interpreter
    started with ``subprocess.Popen`` — never a fork of this one, which
    may hold a CUDA context.
    """

    kind = "subprocess"

    def __init__(self, *, device: str = "cuda",
                 env: Mapping[str, str] | None = None) -> None:
        # spawn args are kept so :meth:`respawn` can relaunch an
        # identical process after a crash
        self.device = str(device)
        self._env = dict(env) if env else None
        self.last_send: Dict[str, float] = {}
        self.last_recv: Dict[str, float] = {}
        self.proc = self._spawn()

    def _spawn(self) -> subprocess.Popen:
        import repro_torch
        # resolve the src dir from the package's search path (a
        # namespace package has no __file__)
        src_dir = os.path.dirname(
            os.path.abspath(list(repro_torch.__path__)[0]))
        penv = dict(os.environ)
        penv.update(self._env or {})
        pp = penv.get("PYTHONPATH", "")
        penv["PYTHONPATH"] = src_dir + (os.pathsep + pp if pp else "")
        return subprocess.Popen([sys.executable, "-c", _WORKER_CMD],
                                stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, env=penv)

    def respawn(self) -> None:
        """Relaunch the worker process with the original spawn args.

        The new process is a BLANK interpreter: it has no params, keys,
        tables, or built steps — the owner must replay the init frame
        (and await its ack) before routing work to it.
        `HEFrontend.revive_workers` does exactly that.
        """
        if self.alive:
            self.proc.kill()
        self.proc.wait(timeout=30)
        self._close_pipes()
        self.proc = self._spawn()

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def send(self, head: Dict[str, Any],
             arrays: Mapping[str, Any] | None = None) -> None:
        if not self.alive:
            raise WorkerDied("worker process exited "
                             f"(rc={self.proc.returncode})")
        t0 = time.perf_counter()
        parts = _frame_parts(head, arrays)
        t1 = time.perf_counter()
        try:
            assert self.proc.stdin is not None
            n = _write_parts(self.proc.stdin, parts)
        except (OSError, ValueError) as e:      # a closed or broken pipe
            raise WorkerDied(f"worker pipe broke: {e}") from e
        self.last_send = {"bytes": n, "encode_s": t1 - t0,
                          "write_s": time.perf_counter() - t1}

    def recv(self) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
        assert self.proc.stdout is not None
        timing: Dict[str, float] = {}
        try:
            out = read_frame(self.proc.stdout, timing)
        except (OSError, ValueError) as e:      # a closed or broken pipe
            raise WorkerDied(f"worker pipe broke: {e}") from e
        self.last_recv = timing
        return out

    def _close_pipes(self) -> None:
        for f in (self.proc.stdin, self.proc.stdout):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass

    def kill(self) -> None:
        self.proc.kill()
        self.proc.wait(timeout=30)

    def close(self) -> None:
        if self.alive:
            try:
                self.send({"type": "shutdown"})
                self.proc.wait(timeout=30)
            except (WorkerDied, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait(timeout=30)
        self._close_pipes()
