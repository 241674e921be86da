"""The paper's own workload as a serving entry point: a batched HE
request stream through :class:`repro_torch.hserve.HEServer` (queue →
level-aware table cache → engine → metrics), on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve --he --batch 4 \\
        --requests 24 --levels 3 --rotations 4 --conjugations 2 \\
        [--plain-frac 0.25] [--circuit] [--schedule] [--max-age-s 0.05] \\
        [--overlap] [--no-kernels] [--trace T.json] [--profile-stages] \\
        [--metrics M.json] [--device cuda]

This is the JAX package's ``launch/serve.py`` ``serve_he``, at its SMOKE
parameters. It makes keys with the port's ``keygen``/``rot_keygen``/
``conj_keygen`` and encrypts with ``core.heaan``, calling HEServer
directly where the reference drives a client session. Not ported yet:
``--traced`` and ``--check`` (the client and the static analyzer),
``--workers`` (the multi-host tier), ``--model-shards`` (the batched step
across ranks), ``--bootstrap``, and the LM serving path.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.core import heaan as H
from repro_torch.core.context import resolve_device
from repro_torch.core.keys import keygen
from repro_torch.core.params import HEParams, test_params
from repro_torch.core.rotate import conj_keygen, rot_keygen
from repro_torch.hserve import HEServer, degree4_demo_circuit
from repro_torch.obs import Tracer

__all__ = ["SMOKE", "serve_he", "main"]

# the reference's smoke parameter set (configs/heaan_mul.py SMOKE)
SMOKE: HEParams = test_params(logN=5, beta_bits=32)


def serve_he(batch: int, requests: int = 0, levels: int = 1,
             rotations: int = 0, conjugations: int = 0,
             plain_frac: float = 0.0, use_kernels: bool = True,
             max_age_s: float | None = None, overlap: bool = False,
             circuit: bool = False, schedule: bool = False, seed: int = 0,
             trace: str | None = None, profile_stages: bool = False,
             metrics: str | None = None,
             device: str | torch.device = "cuda") -> dict:
    """Batched multi-level HE serving on `device` (default the card; raises
    without CUDA).

    Submits a mixed stream of HE-Mul / rotate / conjugate requests spread
    over `levels` moduli — `plain_frac` of the mul share served as the
    key-switch-free mul_plain/add_plain plaintext-operand ops — plus, with
    `circuit`, a whole degree-4 encrypted polynomial circuit via
    submit_circuit (TWO staggered copies under `schedule`, exercising the
    circuit-aware scheduler's cross-circuit co-batching and table
    prefetch). Drains the queue with padded batching and decrypts every
    result against numpy. Returns the server's stats plus `max_err`.

    `trace` writes a Chrome trace-event JSON of the request lifecycle and
    engine spans to that path (`python -m repro_torch.obs report PATH`);
    `profile_stages` fences each stage and adds the Fig. 3 CRT/NTT/modmul/
    iCRT split to the stats; `metrics` dumps the registry snapshot as
    JSON to that path.
    """
    dev = resolve_device(device)
    params = SMOKE
    requests = requests or 2 * batch + 1   # force >1 batch and padding
    # the lowest level logq = logp is excluded: mul results there cannot
    # rescale (ciphertext exhausted), and verification rescales every mul
    if not 1 <= levels <= params.L - 1:
        raise ValueError(f"--levels must be in [1, {params.L - 1}]")
    if not 0.0 <= plain_frac <= 1.0:
        raise ValueError("--plain-frac must be in [0, 1]")
    n_mul = requests - rotations - conjugations
    if n_mul < 0:
        raise ValueError(
            "--rotations + --conjugations cannot exceed --requests")
    tracer = Tracer() if trace else None
    sk, pk, evk = keygen(params, seed=0, device=dev)
    rot_keys = {1: rot_keygen(params, sk, 1, device=dev)} if rotations \
        else None
    conj_key = conj_keygen(params, sk, device=dev) \
        if conjugations or circuit else None
    server = HEServer(params, evk, rot_keys, conj_key, device=dev,
                      batch=batch, use_kernels=use_kernels,
                      max_age_s=max_age_s, overlap=overlap,
                      schedule=schedule, tracer=tracer,
                      profile_stages=profile_stages)

    rng = np.random.default_rng(seed)
    n = params.n_slots_max
    logqs = [params.logQ - i * params.logp for i in range(levels)]
    expect = {}   # rid -> (op, expected slots)
    n_plain = int(round(plain_frac * n_mul))

    def encrypt(z, s, logq):
        ct = H.encrypt_message(z, pk, params, seed=s)
        return H.he_mod_down(ct, params, logq) if logq < params.logQ else ct

    for i in range(requests):
        logq = logqs[i % levels]
        z = rng.normal(size=n) + 1j * rng.normal(size=n)
        ct = encrypt(z, 2 * i + 1, logq)
        if i < n_plain:
            # plaintext-operand ops: encode-only operand, region-1
            # product / bx add — no key switch, no key material
            w = rng.normal(size=n) + 1j * rng.normal(size=n)
            pt = H.encode_plain(w, params, logq, device=dev)
            if i % 2 == 0:
                expect[server.submit_mul_plain(ct, pt)] = \
                    ("mul_plain", z * w)
            else:
                expect[server.submit_add_plain(ct, pt)] = \
                    ("add_plain", z + w)
        elif i < n_mul:
            z2 = rng.normal(size=n) + 1j * rng.normal(size=n)
            expect[server.submit_mul(ct, encrypt(z2, 2 * i + 2, logq))] = \
                ("mul", z * z2)
        elif i < n_mul + rotations:
            expect[server.submit_rotate(ct, 1)] = ("rotate", np.roll(z, -1))
        else:
            expect[server.submit_conjugate(ct)] = ("conjugate", np.conj(z))

    results = {}
    if circuit:
        # a degree-4 encrypted polynomial, evaluated WHOLLY server-side:
        # conj(x⁴) + x. Under `schedule` a second, STAGGERED copy rides
        # along so the cross-circuit co-batching is exercised.
        ops, _ = degree4_demo_circuit(params)
        for j in range(2 if schedule else 1):
            zc = rng.normal(size=n) + 1j * rng.normal(size=n)
            x = H.encrypt_message(zc, pk, params, seed=7777 + j)
            cid = server.submit_circuit(ops, inputs={"x": x})
            expect[cid] = ("circuit", np.conj(zc ** 4) + zc)
            if schedule and j == 0:       # desync the two circuits
                results.update(dict(server.poll(flush=True)))

    results.update(server.drain())
    errs = []
    for rid, (op, want) in expect.items():
        out = results[rid]
        if op in ("mul", "mul_plain"):
            out = H.rescale(out, params)
        errs.append(float(np.abs(H.decrypt_message(out, sk, params)
                                 - want).max()))
    stats = server.stats()
    stats["max_err"] = max(errs)
    if trace:
        stats["trace_events"] = tracer.write(trace)
    if metrics:
        with open(metrics, "w") as f:
            json.dump(server.registry.snapshot(), f, indent=2)
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--he", action="store_true", required=True,
                    help="serve a batched multi-level HE request stream "
                         "(the only workload of the port so far)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=0,
                    help="HE requests to stream (default 2·batch+1, which "
                         "exercises multi-batch assembly and padding)")
    ap.add_argument("--levels", type=int, default=1,
                    help="number of moduli to spread HE requests over "
                         "(level i serves logq = logQ − i·logp)")
    ap.add_argument("--rotations", type=int, default=0,
                    help="how many of the HE requests are rotate(r=1)")
    ap.add_argument("--conjugations", type=int, default=0,
                    help="how many of the HE requests are conjugate")
    ap.add_argument("--plain-frac", type=float, default=0.0,
                    help="serve this fraction of the mul share as "
                         "plaintext-operand ops (mul_plain/add_plain)")
    ap.add_argument("--circuit", action="store_true",
                    help="also submit a degree-4 encrypted polynomial "
                         "circuit via submit_circuit and verify it (two "
                         "staggered copies under --schedule)")
    ap.add_argument("--schedule", action="store_true",
                    help="circuit-aware scheduling: co-batch same-"
                         "(op, level) nodes across circuits and prefetch "
                         "next-level tables behind the in-flight batch")
    ap.add_argument("--max-age-s", type=float, default=None,
                    help="continuous-batching SLO: flush a bucket once "
                         "its oldest request has waited this long")
    ap.add_argument("--overlap", action="store_true",
                    help="double-buffer batch assembly and step issue "
                         "against the in-flight step")
    ap.add_argument("--kernels", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="route the HE stages through the CUDA kernels "
                         "(default; --no-kernels runs the plain torch "
                         "versions on the device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the request "
                         "lifecycle and engine spans; open in Perfetto or "
                         "run `python -m repro_torch.obs report PATH`")
    ap.add_argument("--profile-stages", action="store_true",
                    help="attribute the ops' wall time to the paper's "
                         "Fig. 3 stages (CRT/NTT/modmul/iCRT), fencing the "
                         "card around each (same words, slower)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="dump the MetricsRegistry snapshot as JSON after "
                         "the drain")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default cuda; cpu runs the "
                         "plain torch versions)")
    args = ap.parse_args(argv)
    stats = serve_he(args.batch, requests=args.requests, levels=args.levels,
                     rotations=args.rotations,
                     conjugations=args.conjugations,
                     plain_frac=args.plain_frac, use_kernels=args.kernels,
                     max_age_s=args.max_age_s, overlap=args.overlap,
                     circuit=args.circuit, schedule=args.schedule,
                     seed=args.seed, trace=args.trace,
                     profile_stages=args.profile_stages,
                     metrics=args.metrics, device=args.device)
    ops = ", ".join(
        f"{op}: {d['requests']} reqs @ {d['ops_per_s']}/s "
        f"(p50 {d['latency_ms']['p50']}ms, "
        f"p99 {d['latency_ms']['p99']}ms, pad {d['pad_frac']})"
        for op, d in stats["per_op"].items())
    print(f"hserve batch={stats['batch']} on {stats['device']} "
          f"levels={stats['levels_served']} "
          f"steps_compiled={stats['engine']['steps_compiled']} "
          f"(first runs {stats['engine']['compile_s']}s)")
    print(f"  {ops}")
    if args.schedule:
        sch, cb = stats["scheduler"], stats["cobatch"]
        print(f"  scheduler: lookahead={sch['lookahead']} "
              f"deferrals={sch['deferrals']} "
              f"prefetched_levels={sch['prefetched_levels']} "
              f"cross_circuit_rate={cb['cross_circuit_rate']}")
    if args.profile_stages:
        for op, row in sorted(stats["stages"]["stages"].items()):
            tot = sum(row.values())
            wall = stats["per_op"].get(op, {}).get("wall_s", 0.0)
            split = " ".join(
                f"{s} {1e3 * v:.1f}ms ({v / tot:.0%})"
                for s, v in row.items()) if tot else "—"
            cov = f" coverage {tot / wall:.0%} of wall" if wall else ""
            print(f"  fig3[{op}]: {split}{cov}")
    if args.trace:
        print(f"  trace: {stats['trace_events']} events -> {args.trace}")
    if args.metrics:
        print(f"  metrics snapshot -> {args.metrics}")
    print(f"  max_err {stats['max_err']:.2e}")
    if not stats["max_err"] < 1e-2:
        raise SystemExit("HE serving pipeline diverged")


if __name__ == "__main__":
    main()
