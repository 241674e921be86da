"""Shared set-up of the benchmark's tests: the harness and the program on
the path, tiny configurations for the CPU, and the card fixture."""

import math
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (BENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def tiny_config(beta: int, logN: int = 5) -> dict:
    """A configuration file's content for the program's test_params()."""
    from repro_torch.core.context import device_icrt_tables
    from repro_torch.core.params import test_params

    p = test_params(logN=logN, beta_bits=beta)
    L = p.logQ
    s = {"qlimbs": p.qlimbs(L), "np1": p.np_region1(L),
         "np2": p.np_region2(L)}
    for r, n in ((1, s["np1"]), (2, s["np2"])):
        t = device_icrt_tables(p, n, torch.device("cpu"))
        s[f"plimbs{r}"] = p.limbs_for_bits(
            int(sum(math.log2(q) for q in p.primes[:n])))
        s[f"pdivp_limbs{r}"] = t.plimbs
        s[f"accum_limbs{r}"] = t.accum_limbs
    return {"params": {"logN": logN, "logQ": L, "logp": p.logp,
                       "log_delta": p.log_delta, "beta_bits": beta,
                       "sigma": p.sigma, "h": p.h},
            "shapes": s, "use_kernels": beta == 32}


def tiny_serve_mix() -> dict:
    return {"kind": "serve", "rate_per_s": 200,
            "levels": [[120, 50], [96, 25], [72, 25]],
            "ops": [{"op": "mul", "weight": 75},
                    {"op": "rotate", "r": 1, "weight": 25}],
            "pool_per_level": 4,
            "server": {"batch": 4, "schedule": True, "max_age_s": 0.05},
            "trace_seconds": 1, "check_requests": 8}


def tiny_step_mix(logq: int) -> dict:
    return {"kind": "step", "batch": 4, "logq": logq, "warm_steps": 1,
            "trace_steps": 2, "check_items": 4}


def cpu_run(config, traffic, seed, seconds=0.3, fault=None, short=0):
    from hebench import cells
    return cells.Run(workload="test", config=config, traffic=traffic,
                     seed=seed, seconds=seconds, trace=False,
                     device=torch.device("cpu"), t_start=time.perf_counter(),
                     fault=fault, reference_short=short)


@pytest.fixture
def card():
    """The card, or a skip: decided here, when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
