"""repro_torch's frame transport against the JAX package's, on the CPU.

The same heads and arrays — numpy arrays on the reference's side, the
port's tensors (int32 words; int64 words at β = 2^64, passed through
``transport.words``, while an int64 tensor that holds no words frames as
int64) on the port's — must frame to the same bytes, and so must the
frames of a β = 2^64 mul batch and its result that ``HEFrontend`` sends
and its worker answers;
each side must decode the other's frames; ``read_frame`` must read frames
off a stream and raise ``WorkerDied`` on EOF, a truncated frame and bad
magic; ``InProcTransport`` must drop an undelivered reply on ``kill()`` and
serve again after ``revive()``.
"""

import io

import numpy as np
import pytest
import torch

from repro.hserve import transport as jt

from repro_torch.core import heaan as H
from repro_torch.core import test_params as small_params
from repro_torch.core.keys import keygen
from repro_torch.core.rns import PipelineConfig
from repro_torch.hserve import HEFrontend
from repro_torch.hserve import frontend as tfrontend
from repro_torch.hserve import transport as tt
from repro_torch.hserve.worker import _tensor

P = small_params(logN=4, beta_bits=32)
P64 = small_params(logN=4, beta_bits=64)
PLAIN = PipelineConfig(use_kernels=False)


@pytest.fixture(scope="module")
def ct():
    _, pk, _ = keygen(P, seed=0, device="cpu")
    z = np.arange(P.n_slots_max) * (0.25 + 0.5j)
    return H.encrypt_message(z, pk, P, seed=3)


@pytest.fixture(scope="module")
def world64():
    _, pk, evk = keygen(P64, seed=0, cfg=PLAIN, device="cpu")
    z = np.arange(P64.n_slots_max) * (0.25 + 0.5j)
    return [H.encrypt_message(z, pk, P64, seed=3 + i, cfg=PLAIN)
            for i in range(2)], evk


def _cases(ct, world64):
    """(head, port arrays, reference arrays) triples."""
    words = lambda t: t.numpy().view(np.uint32)             # noqa: E731
    u64 = lambda t: t.numpy().view(np.uint64)               # noqa: E731
    (c1, c2), _ = world64
    rng = np.random.default_rng(0)
    f64 = rng.normal(size=(3, 5))
    i64 = torch.arange(-6, 6, dtype=torch.int64).reshape(3, 4)
    return {
        "head only": ({"type": "stats", "seq": 3}, None, None),
        "ciphertext": (
            {"type": "batch", "seq": 1, "key": ["mul", 120, None],
             "reqs": [{"rid": 7, "logps": [24, 24]}]},
            {"ax1": ct.ax, "bx1": ct.bx},
            {"ax1": words(ct.ax), "bx1": words(ct.bx)}),
        "stacked batch": (
            {"type": "result", "seq": 9, "wall": 0.125,
             "outs": [{"logq": 120, "logp": 48, "n_slots": 8}] * 2},
            {"ax": torch.stack([ct.ax, ct.bx])},
            {"ax": np.stack([words(ct.ax), words(ct.bx)])}),
        "mixed dtypes": (
            {"type": "init", "params": {"logN": 4}, "rot_rs": [1, 2]},
            {"f": f64, "i": i64, "u8": np.arange(7, dtype=np.uint8),
             "empty": torch.zeros((0, 3), dtype=torch.int32)},
            {"f": f64, "i": i64.numpy(), "u8": np.arange(7, dtype=np.uint8),
             "empty": np.zeros((0, 3), dtype=np.uint32)}),
        "strided view": (
            {"type": "add_key", "kind": "rot", "r": 1},
            {"ax_ev": ct.ax[:, ::2]},
            {"ax_ev": np.ascontiguousarray(words(ct.ax)[:, ::2])}),
        "beta64 mul batch": (
            {"type": "batch", "seq": 2, "key": ["mul", 120, None],
             "n_valid": 2, "reqs": [{"rid": 1, "logps": [24, 24]},
                                    {"rid": 2, "logps": [24, 24]}]},
            {k: tt.words(torch.stack([getattr(c1, f), getattr(c2, f)]))
             for k, f in (("ax1", "ax"), ("bx1", "bx"), ("ax2", "ax"),
                          ("bx2", "bx"))},
            {k: np.stack([u64(getattr(c1, f)), u64(getattr(c2, f))])
             for k, f in (("ax1", "ax"), ("bx1", "bx"), ("ax2", "ax"),
                          ("bx2", "bx"))}),
        "beta64 result": (
            {"type": "result", "seq": 2, "wall": 0.5,
             "outs": [{"logq": 120, "logp": 48, "n_slots": 8}] * 2},
            {"ax": tt.words(torch.stack([c1.ax, c2.ax])),
             "bx": tt.words(torch.stack([c1.bx, c2.bx]))},
            {"ax": np.stack([u64(c1.ax), u64(c2.ax)]),
             "bx": np.stack([u64(c1.bx), u64(c2.bx)])}),
    }


CASES = ["head only", "ciphertext", "stacked batch", "mixed dtypes",
         "strided view", "beta64 mul batch", "beta64 result"]


@pytest.mark.parametrize("case", CASES)
def test_frame_bytes_equal_the_reference(ct, world64, case):
    head, ours, theirs = _cases(ct, world64)[case]
    frame = tt.encode_frame(head, ours)
    assert frame == jt.encode_frame(head, theirs)
    buf = io.BytesIO()
    assert tt.write_frame(buf, head, ours) == len(frame)
    assert buf.getvalue() == frame


@pytest.mark.parametrize("case", CASES)
def test_decode_round_trip_both_ways(ct, world64, case):
    head, ours, theirs = _cases(ct, world64)[case]
    for decode, frame in ((tt.decode_frame, jt.encode_frame(head, theirs)),
                          (jt.decode_frame, tt.encode_frame(head, ours)),
                          (tt.decode_frame, tt.encode_frame(head, ours))):
        h, arrays = decode(frame)
        assert h == head
        assert sorted(arrays) == sorted(theirs or {})
        for k, a in (theirs or {}).items():
            assert arrays[k].dtype == a.dtype and np.array_equal(arrays[k], a)


@pytest.mark.parametrize("case", CASES)
def test_read_frame_off_a_stream(ct, world64, case):
    head, ours, theirs = _cases(ct, world64)[case]
    frame = tt.encode_frame(head, ours)
    stream = io.BytesIO(frame + frame)
    for _ in range(2):
        timing = {}
        h, arrays = tt.read_frame(stream, timing)
        assert h == head and timing["bytes"] == len(frame)
        for k, a in (theirs or {}).items():
            assert np.array_equal(arrays[k], a)
            assert arrays[k].flags.writeable
    with pytest.raises(tt.WorkerDied, match="EOF"):
        tt.read_frame(stream)


@pytest.mark.parametrize("cut", [5, 9, 30, -1])
def test_truncated_frame_raises_worker_died(ct, world64, cut):
    head, ours, _ = _cases(ct, world64)["ciphertext"]
    frame = tt.encode_frame(head, ours)
    with pytest.raises(tt.WorkerDied, match="closed mid-frame"):
        tt.read_frame(io.BytesIO(frame[:cut]))
    if cut == -1:                          # the header whole, a payload cut
        with pytest.raises(tt.WorkerDied, match="truncated"):
            tt.decode_frame(frame[:cut])


def test_bad_magic_raises_worker_died(ct):
    frame = b"XXXX" + tt.encode_frame({"type": "ok"})[4:]
    with pytest.raises(tt.WorkerDied, match="bad frame magic"):
        tt.read_frame(io.BytesIO(frame))
    with pytest.raises(tt.WorkerDied, match="bad frame magic"):
        tt.decode_frame(frame)


def test_a_tensor_off_the_host_is_refused():
    with pytest.raises(ValueError, match="host arrays"):
        tt.encode_frame({"type": "x"}, {"a": torch.empty(4, device="meta")})


class _Echo:
    """A worker stand-in: replies with the frame it was given, plus one."""

    wid = 5

    def handle(self, head, arrays):
        return ({**head, "type": "echo"},
                {k: torch.from_numpy(a.view(np.int32)) + 1
                 if a.dtype == np.uint32 else a for k, a in arrays.items()})


def test_inproc_transport_kill_and_revive(ct):
    tp = tt.InProcTransport(_Echo())
    tp.send({"type": "batch", "seq": 1}, {"ax": ct.ax})
    head, arrays = tp.recv()
    assert head == {"type": "echo", "seq": 1}
    assert np.array_equal(arrays["ax"].view(np.int32), (ct.ax + 1).numpy())
    assert tp.last_send["bytes"] == len(tt.encode_frame(
        {"type": "batch", "seq": 1}, {"ax": ct.ax}))
    tp.send({"type": "batch", "seq": 2}, {"ax": ct.ax})
    tp.kill()                              # computed, never delivered
    assert not tp.alive
    with pytest.raises(tt.WorkerDied, match="dead"):
        tp.recv()
    with pytest.raises(tt.WorkerDied, match="dead"):
        tp.send({"type": "batch", "seq": 3})
    tp.revive()
    with pytest.raises(tt.WorkerDied, match="no reply pending"):
        tp.recv()                          # the dropped reply stays gone
    tp.send({"type": "batch", "seq": 4})
    assert tp.recv()[0]["seq"] == 4


class _Recording(tt.InProcTransport):
    """An in-process transport that keeps each frame it carries, both
    ways."""

    frames: list = []

    def send(self, head, arrays=None):
        super().send(head, arrays)
        self.frames.append(("sent", head, arrays))
        if self._replies:
            self.frames.append(("reply", None, self._replies[-1]))


def test_beta64_frames_of_a_served_mul_equal_the_reference(world64,
                                                          monkeypatch):
    """The frontend's batch frame and its worker's result frame of a
    β = 2^64 mul: the reference's encoder on the same words as uint64
    gives the same bytes; the frontend rebuilds int64 (N, qlimbs)."""
    (c1, c2), evk = world64
    monkeypatch.setattr(tfrontend, "InProcTransport", _Recording)
    _Recording.frames = []
    fe = HEFrontend(P64, evk, workers=1, worker_device="cpu", batch=2,
                    use_kernels=False)
    try:
        rid = fe.submit_mul(c1, c2)
        out = fe.drain()[rid]
    finally:
        fe.close()
    sent = [f for f in _Recording.frames if f[0] == "sent"
            and f[1]["type"] == "batch"]
    assert len(sent) == 1
    _, head, arrays = sent[0]
    assert all(a.dtype == np.uint64 for a in arrays.values())
    frame = tt.encode_frame(head, arrays)
    assert frame == jt.encode_frame(head, {k: np.array(a) for k, a in
                                           arrays.items()})
    # the reply: its arrays decode as the reference's uint64 words
    reply = bytes(_Recording.frames[-1][2])
    rhead, rarrays = jt.decode_frame(reply)
    assert {a.dtype for a in rarrays.values()} == {np.dtype(np.uint64)}
    assert reply == jt.encode_frame(rhead, rarrays)
    assert out.ax.dtype == torch.int64
    assert out.ax.shape == (P64.N, P64.qlimbs(P64.logQ))
    assert np.array_equal(out.ax.numpy().view(np.uint64), rarrays["ax"][0])
    # a frame's words become the stored words, either β
    for dt, st in ((np.uint32, torch.int32), (np.uint64, torch.int64)):
        assert _tensor(np.zeros(3, dt)).dtype == st
