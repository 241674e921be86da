"""A traced stretch of a run: torch.profiler over the device and the host,
reduced to what the per-layer metrics read.

Device time is taken from the profiler's device events (kernels, copies,
sets): the busy seconds are the union of their intervals, and each kernel
is told as PyTorch's own (its names: ``at::native``, CUB, cuBLAS and the
like, copies and sets) or not (the port's CUDA kernels and anything else
built outside PyTorch). An idle gap between two device events is charged
to what the host was doing at its middle: the innermost profiled host
event of the thread that issued the work.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import time
from collections import Counter, defaultdict

import torch

# names PyTorch's own device work goes by (its kernels, and the libraries
# it calls); anything else is a kernel built outside PyTorch
TORCH_NAME = re.compile(
    r"at::|at_cuda_detail|c10::|cub::|thrust::|cublas|cutlass|gemm|"
    r"nvjet|sm\d+_xmma|Memcpy|Memset|memcpy|memset")

# the port's kernel families that Fig. 2's plan bounds, by kernel name (a
# transform's passes are ntt_pass / ntt_pass8 <forward, column, modified>)
FAMILIES = {
    "crt": re.compile(r"\bcrt_kernel\b"),
    "icrt": re.compile(r"\bicrt_kernel\b"),
    "modmul": re.compile(r"\bmodmul_kernel\b"),
    "ntt": re.compile(r"\bntt_pass8?<true, *\w+, *false>"),
    "intt": re.compile(r"\bntt_pass8?<false, *\w+, *false>"),
}


def is_torch(name: str) -> bool:
    return bool(TORCH_NAME.search(name))


def family(name: str):
    for f, rx in FAMILIES.items():
        if rx.search(name):
            return f
    return None


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.removeprefix("void ")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


@dataclasses.dataclass
class Trace:
    """What a traced stretch saw.

    window_s: host seconds from the synchronised start to the
        synchronised end of the stretch; busy_s: union of device events;
    kernels: name -> (seconds, count) over every device event;
    ops: HE operations the stretch completed; steps: steps it ran;
    launches: the port's launch counters over the stretch;
    gaps: host label -> idle seconds, for gaps between device events."""

    window_s: float
    busy_s: float
    kernels: dict
    ops: int
    steps: int
    launches: dict
    gaps: dict

    @property
    def device_events(self) -> int:
        return sum(n for _, n in self.kernels.values())

    @property
    def device_s(self) -> float:
        return sum(s for s, _ in self.kernels.values())

    @property
    def torch_s(self) -> float:
        return sum(s for k, (s, _) in self.kernels.items() if is_torch(k))

    def breakdown(self) -> dict:
        ops = sorted(((short(k), s) for k, (s, _) in self.kernels.items()),
                     key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, s] for k, s in ops],
                "idle_gaps": [[k, s] for k, s in gaps]}


def traced(device: torch.device, body, launches) -> Trace:
    """Run body() -> (ops, steps) under the profiler, between two
    synchronisations, and reduce what it recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    before = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops, steps = body()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    after = launches()
    dev, host = [], defaultdict(list)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.start, e.time_range.end, e.name))
        elif e.device_type == DeviceType.CPU:
            host[e.thread].append((e.time_range.start, e.time_range.end,
                                   e.name))
    dev.sort()
    kernels: dict = {}
    busy, cur_s, cur_e, gaps = 0.0, None, None, []
    for s, e, name in dev:
        sec, n = kernels.get(name, (0.0, 0))
        kernels[name] = (sec + (e - s) * 1e-6, n + 1)
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    main = max(host, key=lambda t: len(host[t])) if host else None
    return Trace(window_s=window_s, busy_s=busy * 1e-6, kernels=kernels,
                 ops=ops, steps=steps,
                 launches={k: after[k] - before.get(k, 0) for k in after},
                 gaps=label_gaps(gaps, host.get(main, [])))


def label_gaps(gaps: list, host: list) -> dict:
    """Sum each idle gap (start, end) under the innermost host event that
    covers its middle ("host idle" where none does). Host events of one
    thread nest, so a stack swept in time order holds the covering ones."""
    host = sorted(host, key=lambda ev: (ev[0], -ev[1]))
    starts = [ev[0] for ev in host]
    out: Counter = Counter()
    stack: list = []
    i = 0
    for s, e in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
        mid = (s + e) / 2
        j = bisect.bisect_right(starts, mid)
        while i < j:
            ev = host[i]
            while stack and stack[-1][1] < ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        out[stack[-1][2] if stack else "host idle"] += (e - s) * 1e-6
    return dict(out)
