"""Request queue and batch assembler for the HE serving runtime.

The unit of work a privacy-preserving serving system schedules is a
ciphertext-op request: (op, operand ciphertexts[, op parameters]). The
engine builds ONE step per (op, level, extra), so requests must reach it
in fixed-shape batches of like kind. This module does that shaping:

  - :class:`RequestQueue` buckets incoming requests by
    ``(op, logq[, op-specific extra])`` — every member of a bucket shares
    a step — and preserves FIFO order within each bucket. It also keeps
    the age/arrival-rate bookkeeping the server's continuous-batching
    flush policy reads (``expired_key`` / ``arrival_rate``).
  - :class:`BatchAssembler` stacks a bucket's ciphertext limb tensors into
    ``(B, N, qlimbs)`` operands ON THE OPERANDS' DEVICE, zero-padding up
    to the fixed batch size (zero polynomials are valid ciphertext
    material; padded lanes are computed and discarded), and records
    ``n_valid`` so the engine can slice real results back out.

  ==========  ========  =============================================
  op          operands  extra in the bucket key
  ==========  ========  =============================================
  mul         2         — (region-1 product + region-2 key switch)
  add / sub   2         — (limb add/sub + mask; paper §III-B)
  rotate      1         r, the left-rotation amount (σ_{5^r})
  conjugate   1         — (σ₋₁, k = 2N−1; same key-switch machinery)
  slot_sum    1         n_slots (log₂ n fused rotate+add rounds)
  rescale     1         dlogp, the scale drop (÷2^dlogp; §III-A)
  mod_down    1         logq2, the target modulus
  mod_raise   1         logq2, the (wider) target modulus
  mul_plain   1         — (encoded-operand product: region 1 ONLY)
  add_plain   1         — (plaintext added to bx; no key material)
  ==========  ========  =============================================

The plaintext-operand ops carry their encoded operand (an (N, qlimbs)
int32 word tensor, ``core.heaan.encode_plain``) on the request itself;
it is stacked into the batch as the "pt" tensor — batch DATA, not step
signature, so every same-level mul_plain shares one step.

This is the JAX package's ``hserve/queue.py``. What differs: operands are
tensors; the assembler stacks them with ``torch.stack`` where they lie
(the reference stacks host numpy arrays), so a served batch never goes
through the host; the queue's defensive copy of ``pt`` is a ``.clone()``;
and a queue given a ``device`` refuses, at submit, a ciphertext or
plaintext that lies elsewhere — a request must never fail mid-drain.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.dataflow import OPS, PLAIN_OPS
from repro_torch.core.cipher import Ciphertext

__all__ = ["Request", "Batch", "RequestQueue", "BatchAssembler", "OPS",
           "PLAIN_OPS"]

BucketKey = Tuple  # (op, logq, extra): extra = r | n_slots | dlogp | logq2 | None


@dataclasses.dataclass
class Request:
    """One ciphertext-op request.

    cts: operand ciphertexts (2 for "mul"/"add"/"sub", 1 otherwise), all
    at the same modulus 2^logq. Op parameters: `r` is the left-rotation
    amount for "rotate", `dlogp` the scale drop for "rescale", `logq2`
    the target modulus for "mod_down"/"mod_raise". Plaintext-operand ops
    carry their encoded operand in `pt` ((N, qlimbs) mod-q words at the
    ciphertext's level) and its scale in `pt_logp`.
    """

    rid: int
    op: str
    cts: Tuple[Ciphertext, ...]
    r: int = 0
    dlogp: int = 0
    logq2: int = 0
    pt: Optional[torch.Tensor] = None
    pt_logp: int = 0
    t_submit: float = 0.0

    @property
    def logq(self) -> int:
        return self.cts[0].logq

    @property
    def bucket_key(self) -> BucketKey:
        if self.op == "rotate":
            return (self.op, self.logq, self.r)
        if self.op == "slot_sum":
            return (self.op, self.logq, self.cts[0].n_slots)
        if self.op == "rescale":
            return (self.op, self.logq, self.dlogp)
        if self.op in ("mod_down", "mod_raise"):
            return (self.op, self.logq, self.logq2)
        return (self.op, self.logq, None)     # mul / add / sub / conjugate


@dataclasses.dataclass
class Batch:
    """A fixed-shape, assembly-complete unit of engine work.

    arrays: stacked (B, N, qlimbs) operand tensors — "ax1"/"bx1" always,
    "ax2"/"bx2" for two-operand ops, "pt" for the plaintext ops — on the
    operands' device. Rows past n_valid are zero padding.
    """

    key: BucketKey
    requests: List[Request]
    arrays: Dict[str, torch.Tensor]
    n_valid: int

    @property
    def op(self) -> str:
        return self.key[0]

    @property
    def logq(self) -> int:
        return self.key[1]

    @property
    def size(self) -> int:
        return next(iter(self.arrays.values())).shape[0]

    @property
    def n_pad(self) -> int:
        return self.size - self.n_valid


class RequestQueue:
    """FIFO-within-bucket request queue keyed by step signature.

    Besides bucketing, the queue is the flush policy's sensor: it knows
    how long each bucket's head request has waited (`expired_key`) and
    the recent arrival rate (`arrival_rate`), which the server uses to
    size its adaptive bucket target.

    clock: the time source `submit` stamps `t_submit` with when the
    caller does not pass one. HEServer threads its own (injectable)
    clock here, so direct `queue.submit(...)` calls and server submits
    land on ONE timeline.
    device: when set, every operand (ciphertext limbs and plaintext) must
    lie on it; others are refused at submit with a ValueError.
    """

    # window of recent submit timestamps used for the arrival-rate
    # estimate; big enough to smooth bursts, small enough to track drift
    _RATE_WINDOW = 64

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 device: Optional[torch.device] = None):
        self._buckets: "OrderedDict[BucketKey, Deque[Request]]" = \
            OrderedDict()
        self._next_rid = 0
        self._submitted = 0
        self._clock = time.perf_counter if clock is None else clock
        self._arrivals: Deque[float] = deque(maxlen=self._RATE_WINDOW)
        self.device = device

    def reserve_rid(self) -> int:
        """Allocate a request id without enqueuing anything (used by
        HEServer.submit_circuit so circuit handles share the rid space
        and can never collide with per-op request ids)."""
        rid = self._next_rid
        self._next_rid += 1
        return rid

    def _check_device(self, op: str, tensors) -> None:
        for t in tensors:
            if t.device != self.device:
                raise ValueError(
                    f"{op} operand lies on {t.device}; this queue serves "
                    f"{self.device}")

    def submit(self, op: str, cts: Tuple[Ciphertext, ...], r: int = 0,
               dlogp: int = 0, logq2: int = 0,
               pt: Optional[torch.Tensor] = None, pt_logp: int = 0,
               t_submit: Optional[float] = None,
               pt_owned: bool = False) -> int:
        """Enqueue a request; returns its request id.

        t_submit defaults to THIS QUEUE'S clock, so a server built with an
        injected clock keeps every request on the injected timeline even
        when the queue is driven directly.
        """
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; serve one of {set(OPS)}")
        cts = tuple(cts) if isinstance(cts, (tuple, list)) else (cts,)
        if len(cts) != OPS[op]:
            raise ValueError(
                f"op {op!r} takes {OPS[op]} ciphertext(s), got {len(cts)}")
        if self.device is not None:
            self._check_device(op, [t for c in cts for t in (c.ax, c.bx)])
        if any(c.logq != cts[0].logq for c in cts):
            raise ValueError("operands must share a modulus (paper §III-B)")
        if op in ("add", "sub") and cts[0].logp != cts[1].logp:
            raise ValueError(
                f"{op} operands must share a scale: "
                f"logp {cts[0].logp} != {cts[1].logp} (rescale first)")
        if op == "rotate" and r <= 0:
            raise ValueError("rotate needs a positive rotation amount r")
        if op == "rescale":
            if dlogp <= 0:
                raise ValueError("rescale needs a positive dlogp")
            if cts[0].logq - dlogp <= 0:
                raise ValueError(
                    f"rescale by {dlogp} exhausts the ciphertext "
                    f"(logq {cts[0].logq}; needs bootstrapping)")
        if op == "mod_down" and not 0 < logq2 <= cts[0].logq:
            raise ValueError(
                f"mod_down target logq2={logq2} outside (0, "
                f"{cts[0].logq}]")
        if op == "mod_raise" and logq2 <= cts[0].logq:
            raise ValueError(
                f"mod_raise target logq2={logq2} must exceed the "
                f"ciphertext's logq {cts[0].logq}")
        if op in PLAIN_OPS:
            if pt is None:
                raise ValueError(f"{op} needs an encoded plaintext operand "
                                 "(core.heaan.encode_plain)")
            if not isinstance(pt, torch.Tensor):
                raise ValueError(f"{op} plaintext must be a tensor of words "
                                 f"(core.heaan.encode_plain), got "
                                 f"{type(pt).__name__}")
            if self.device is not None:
                self._check_device(op, (pt,))
            ct_shape = cts[0].ax.shape
            if pt.ndim != 2 or pt.shape[0] != ct_shape[0] \
                    or pt.shape[1] < ct_shape[-1]:
                raise ValueError(
                    f"{op} plaintext shape {tuple(pt.shape)} does not cover "
                    f"the ciphertext's {tuple(ct_shape)} limbs")
            # a copy, not a view: the queued request must not alias the
            # caller's (mutable) buffer. pt_owned marks a server-owned
            # cache resident (hash-resolved operands), which is safe to
            # alias and hot enough to matter.
            sliced = pt[:, :ct_shape[-1]]
            pt = sliced if pt_owned else sliced.clone()
            if op == "mul_plain" and pt_logp <= 0:
                raise ValueError(
                    "mul_plain needs pt_logp, the plaintext's scale "
                    "(HEServer.submit defaults it to params.log_delta)")
            if op == "add_plain":
                pt_logp = pt_logp or cts[0].logp
                if pt_logp != cts[0].logp:
                    raise ValueError(
                        f"add_plain operand scales differ: plaintext logp "
                        f"{pt_logp} != ciphertext {cts[0].logp}")
        req = Request(rid=self._next_rid, op=op, cts=cts, r=r, dlogp=dlogp,
                      logq2=logq2, pt=pt, pt_logp=pt_logp,
                      t_submit=self._clock()
                      if t_submit is None else t_submit)
        self._next_rid += 1
        self._submitted += 1
        self._arrivals.append(req.t_submit)
        self._buckets.setdefault(req.bucket_key, deque()).append(req)
        return req.rid

    @property
    def depth(self) -> int:
        return sum(len(d) for d in self._buckets.values())

    @property
    def submitted(self) -> int:
        return self._submitted

    def bucket_depths(self) -> Dict[BucketKey, int]:
        return {k: len(d) for k, d in self._buckets.items() if d}

    def ready_key(self, batch: int) -> Optional[BucketKey]:
        """Oldest bucket holding at least a full batch, else None."""
        for k, d in self._buckets.items():
            if len(d) >= batch:
                return k
        return None

    def any_key(self) -> Optional[BucketKey]:
        """Oldest non-empty bucket (for flush/drain with padding)."""
        for k, d in self._buckets.items():
            if d:
                return k
        return None

    def expired_key(self, max_age_s: float, now: float
                    ) -> Optional[BucketKey]:
        """The bucket whose HEAD request has waited longest past the age
        deadline (None when nothing has expired). The head is always the
        bucket's oldest request (FIFO), so this is exactly the per-bucket
        oldest-request deadline of the continuous-batching policy."""
        best, best_t = None, None
        for k, d in self._buckets.items():
            if d and now - d[0].t_submit >= max_age_s:
                if best_t is None or d[0].t_submit < best_t:
                    best, best_t = k, d[0].t_submit
        return best

    def arrival_rate(self, now: Optional[float] = None,
                     window_s: Optional[float] = None) -> Optional[float]:
        """Requests/second over the recent submit window.

        With `now` and `window_s`, arrivals older than ``now - window_s``
        are DECAYED OUT of the estimate (and dropped from the window):
        after an idle gap the rate reflects current traffic, not the last
        burst — otherwise the adaptive bucket target stays inflated and a
        post-idle trickle waits the full age deadline per request instead
        of flushing at the adapted target. A single in-window arrival
        reports the sparse-traffic floor ``1 / window_s`` so a lone
        post-idle request still shrinks the target. Without `now`, the
        whole-window span estimate is returned (None until two distinct
        timestamps).
        """
        if now is not None and window_s is not None and window_s > 0:
            cutoff = now - window_s
            while self._arrivals and self._arrivals[0] < cutoff:
                self._arrivals.popleft()          # stale: decay the window
            if not self._arrivals:
                return None
            span = self._arrivals[-1] - self._arrivals[0]
            if span <= 0:
                # one arrival — or several sharing a (coarse/fake) clock
                # tick: count over the window, never None, so the target
                # keeps tracking sparse post-idle traffic
                return len(self._arrivals) / window_s
            return (len(self._arrivals) - 1) / span
        if len(self._arrivals) < 2:
            return None
        span = self._arrivals[-1] - self._arrivals[0]
        if span <= 0:
            return None
        return (len(self._arrivals) - 1) / span

    def pop_bucket(self, key: BucketKey, max_n: int) -> List[Request]:
        """Dequeue up to max_n requests from one bucket, FIFO."""
        d = self._buckets.get(key)
        if not d:
            return []
        out = [d.popleft() for _ in range(min(max_n, len(d)))]
        if not d:
            del self._buckets[key]
        return out

    def requeue(self, requests: List[Request]) -> None:
        """Put already-validated requests back into their buckets (the
        frontend's worker-death path: a dead worker's in-flight batch
        returns whole). rids, t_submit, and the submitted/arrival
        bookkeeping are all preserved — the requests were already
        counted once, and circuit routing keys on the original rids.
        Requeued requests append in batch order, so a re-served batch
        pops in the order it originally flushed."""
        for r in requests:
            self._buckets.setdefault(r.bucket_key, deque()).append(r)


class BatchAssembler:
    """Stack + zero-pad a same-bucket request list to the fixed shape, on
    the operands' device."""

    def __init__(self, batch: int):
        if batch < 1:                   # not assert: gone under python -O
            raise ValueError(f"batch size must be >= 1, got {batch}")
        self.batch = batch

    def assemble(self, requests: List[Request]) -> Batch:
        if not requests:
            raise ValueError("cannot assemble an empty batch")
        if len(requests) > self.batch:
            raise ValueError(
                f"{len(requests)} requests exceed batch size {self.batch}")
        key = requests[0].bucket_key
        if any(r.bucket_key != key for r in requests):
            raise ValueError("mixed buckets in one batch: "
                             f"{ {r.bucket_key for r in requests} }")
        n_valid = len(requests)
        pad = self.batch - n_valid

        def stack(rows: List[torch.Tensor]) -> torch.Tensor:
            if pad:
                rows = rows + [torch.zeros_like(rows[0])] * pad
            return torch.stack(rows)

        arrays = {"ax1": stack([r.cts[0].ax for r in requests]),
                  "bx1": stack([r.cts[0].bx for r in requests])}
        if OPS[key[0]] == 2:
            arrays["ax2"] = stack([r.cts[1].ax for r in requests])
            arrays["bx2"] = stack([r.cts[1].bx for r in requests])
        if key[0] in PLAIN_OPS:
            arrays["pt"] = stack([r.pt for r in requests])
        return Batch(key=key, requests=list(requests), arrays=arrays,
                     n_valid=n_valid)
