"""repro_torch's frame transport against the JAX package's, on the CPU.

The same heads and arrays — numpy arrays on the reference's side, the
port's tensors (int32 words) on the port's — must frame to the same bytes;
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
from repro_torch.hserve import transport as tt

P = small_params(logN=4, beta_bits=32)


@pytest.fixture(scope="module")
def ct():
    _, pk, _ = keygen(P, seed=0, device="cpu")
    z = np.arange(P.n_slots_max) * (0.25 + 0.5j)
    return H.encrypt_message(z, pk, P, seed=3)


def _cases(ct):
    """(head, port arrays, reference arrays) triples."""
    words = lambda t: t.numpy().view(np.uint32)             # noqa: E731
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
    }


CASES = ["head only", "ciphertext", "stacked batch", "mixed dtypes",
         "strided view"]


@pytest.mark.parametrize("case", CASES)
def test_frame_bytes_equal_the_reference(ct, case):
    head, ours, theirs = _cases(ct)[case]
    frame = tt.encode_frame(head, ours)
    assert frame == jt.encode_frame(head, theirs)
    buf = io.BytesIO()
    assert tt.write_frame(buf, head, ours) == len(frame)
    assert buf.getvalue() == frame


@pytest.mark.parametrize("case", CASES)
def test_decode_round_trip_both_ways(ct, case):
    head, ours, theirs = _cases(ct)[case]
    for decode, frame in ((tt.decode_frame, jt.encode_frame(head, theirs)),
                          (jt.decode_frame, tt.encode_frame(head, ours)),
                          (tt.decode_frame, tt.encode_frame(head, ours))):
        h, arrays = decode(frame)
        assert h == head
        assert sorted(arrays) == sorted(theirs or {})
        for k, a in (theirs or {}).items():
            assert arrays[k].dtype == a.dtype and np.array_equal(arrays[k], a)


@pytest.mark.parametrize("case", CASES)
def test_read_frame_off_a_stream(ct, case):
    head, ours, theirs = _cases(ct)[case]
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
def test_truncated_frame_raises_worker_died(ct, cut):
    head, ours, _ = _cases(ct)["ciphertext"]
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
