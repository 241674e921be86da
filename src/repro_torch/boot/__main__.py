"""Measure a bootstrap's decrypted error against its stated bounds, ring by
ring: ``python -m repro_torch.boot [--logN 4 6 8 10] [--msg-bound 2^-5 ...]
[--keys 0 1] [--messages 2] [--device cuda|cpu]``.

For each ring `boot_params(logN)`, key seed and message bound it builds the
plan, mints its Galois keys, encrypts seeded messages within the bound,
walks each down to logq = logp and runs every node of the plan through
``execute_circuit_reference`` (on the card through the kernels, on the CPU
through the plain versions: the same words). One JSON line per
(ring, key seed, message bound): the largest decrypted error over the
messages beside ``BootstrapPlan.error_bound()`` and the static analyzer's
high-probability noise bound (``estimate_noise``), and the node count.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.analysis.noise import estimate_noise
from repro_torch.boot.pipeline import (DEFAULT_MSG_BOUND, boot_params,
                                       bootstrap_circuit)
from repro_torch.core import heaan as H
from repro_torch.core.context import resolve_device
from repro_torch.core.keys import keygen
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.hserve.circuit import execute_circuit_reference


def _bound(text: str) -> float:
    return 2.0 ** float(text[2:]) if text.startswith("2^") else float(text)


def measure(logN: int, key_seed: int, msg_bound: float, messages: int,
            device) -> dict:
    params = boot_params(logN=logN)
    sk, pk, evk = keygen(params, seed=key_seed, device=device)
    plan = bootstrap_circuit(params, logq_in=params.logp,
                             msg_bound=msg_bound, device=device)
    rot = {req[1]: rot_keygen(params, sk, req[1], device=device)
           for req in plan.requires if req[0] == "rot"}
    conj = conj_keygen(params, sk, device=device)
    noise = estimate_noise(
        plan.ops, {plan.in_name: (plan.logq_in, plan.logp)}, params,
        input_bounds=msg_bound, pt_bounds=plan.pt_bounds,
        input_nslots={plan.in_name: plan.n_slots}, meta=plan.meta)
    rng = np.random.default_rng(1000 * logN + key_seed)
    n = params.n_slots_max
    errs = []
    t0 = time.perf_counter()
    for i in range(messages):
        z = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        z *= msg_bound / np.max(np.abs(z))
        ct = H.he_mod_down(H.encrypt_message(z, pk, params, seed=10 + i),
                           params, params.logp)
        out = execute_circuit_reference(plan.resolved_ops(), {"x": ct},
                                        params, evk=evk, rot_keys=rot,
                                        conj_key=conj)
        errs.append(float(np.abs(H.decrypt_message(out, sk, params)
                                 - z).max()))
    return {"logN": logN, "nodes": len(plan.ops), "key_seed": key_seed,
            "msg_bound": msg_bound, "messages": messages,
            "max_abs_err": max(errs), "errors": errs,
            "error_bound": plan.error_bound(),
            "within_error_bound": max(errs) <= plan.error_bound(),
            "noise_bound": 2.0 ** noise[-1].error_bits,
            "seconds": time.perf_counter() - t0, "device": str(device)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.boot",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--logN", type=int, nargs="+", default=[4, 6, 8, 10])
    ap.add_argument("--msg-bound", type=_bound, nargs="+",
                    default=[DEFAULT_MSG_BOUND],
                    help="per-slot message bounds, e.g. 2^-5 2^-8")
    ap.add_argument("--keys", type=int, nargs="+", default=[0],
                    help="key seeds")
    ap.add_argument("--messages", type=int, default=2,
                    help="messages per (ring, key seed, message bound)")
    ap.add_argument("--device", default="cuda",
                    help="device to run on (default cuda; cpu runs the "
                         "plain torch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for logN in args.logN:
        for key_seed in args.keys:
            for mb in args.msg_bound:
                print(json.dumps(measure(logN, key_seed, mb, args.messages,
                                         dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
