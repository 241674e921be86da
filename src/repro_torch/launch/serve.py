"""Serving drivers: batched LM prefill + greedy decode, and the paper's
own workload — a batched HE request stream through
:class:`repro_torch.hserve.HEServer` (queue → level-aware table cache →
engine → metrics) on one device or across the model ranks of a grid, or
through the multi-host tier (:class:`repro_torch.hserve.HEFrontend` and
its workers), driven by a :class:`repro_torch.client.HESession`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --preset smoke|full --batch 4 --prompt-len 32 --gen 16 \\
        [--seed 0] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --he --batch 4 \\
        --requests 24 --levels 3 --rotations 4 --conjugations 2 \\
        [--plain-frac 0.25] [--circuit] [--schedule] [--max-age-s 0.05] \\
        [--overlap] [--no-kernels] [--trace T.json] [--profile-stages] \\
        [--metrics M.json] [--traced 2] [--check off|warn|error] \\
        [--workers 2 --transport inproc|subprocess] [--bootstrap [N]] \\
        [--model-shards R] [--device cuda]

Without ``--he`` the LM path runs, as in the JAX package's
``launch/serve.py``: the ``--arch`` model (``--preset smoke`` its
``reduced()`` config, ``full`` the published one) with weights drawn from
``--seed``, a random prompt, :func:`generate`. ``--model-shards R`` spawns
R model ranks (data size 1; ``launch.mesh.spawn_grid``), each of which
builds the model from ``--seed``, keeps its shard
(``dist.sharding.shard_lm``, tensor parallel as the reference's
``param_sharding_rules(fsdp_params=False)``) and runs
``generate(grid=)``; on one card the ranks share it (gloo).

With ``--he`` this is the JAX package's ``serve_he``, at its SMOKE
parameters (``boot_params()`` with ``--bootstrap``). ``--model-shards R``
spawns a grid of R model ranks (data size 1; ``launch.mesh.spawn_grid``)
on the card, or on the CPU with ``--device cpu``: rank 0 serves as
without it, through ``HEServer(grid=)``, and the other ranks run
``hserve.serve_follower``. With ``--workers W`` as well, rank 0 runs the
frontend, its W in-process workers spread over the grid (the
reference's ``HEFrontend(mesh=make_host_mesh(model=R))``); with
``--transport subprocess`` no grid is spawned here: each worker process
is rank 0 of its own R-rank grid (``worker_devices=R``). On one card the
ranks share it (gloo).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.boot import boot_params
from repro_torch.client import HESession
from repro_torch.configs.registry import get_arch
from repro_torch.core import heaan as H
from repro_torch.core.context import resolve_device
from repro_torch.core.keys import keygen
from repro_torch.core.params import HEParams, test_params
from repro_torch.hserve import HEFrontend, degree4_demo_circuit
from repro_torch.hserve.server import serve_follower
from repro_torch.dist import comm
from repro_torch.dist.sharding import batch_rows, shard_lm
from repro_torch.launch.mesh import spawn_grid
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Tracer

__all__ = ["SMOKE", "generate", "serve_he", "main"]

# the reference's smoke parameter set (configs/heaan_mul.py SMOKE)
SMOKE: HEParams = test_params(logN=5, beta_bits=32)


@torch.no_grad()
def generate(model, cfg: ModelConfig, tokens: torch.Tensor, gen_steps: int,
             max_len: int, batch_extra: dict | None = None, *,
             grid=None) -> torch.Tensor:
    """Greedy generation. tokens: (B, L) prompt. Returns (B, gen_steps)
    int32 tokens, on the device of `model` and `tokens`.

    With `grid` (a ``launch.mesh.HostGrid``) this is one rank's part:
    `model` is its shard (``dist.sharding.shard_lm``) and the steps run
    across the model ranks; each data rank takes its rows
    (``dist.sharding.batch_rows``: B/d of them where the data size d
    divides B) and the tokens are gathered over "data" at the end. Every
    rank returns all B rows."""
    B, L = tokens.shape
    batch = {"tokens": tokens, **(batch_extra or {})}
    rows = batch_rows(grid, B) if grid is not None else slice(0, B)
    split = rows != slice(0, B)
    if split:
        batch = {k: v[rows] for k, v in batch.items()}
    logits, cache = prefill(model, batch, cfg, max_len, grid=grid)
    out = []
    tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    for i in range(gen_steps):
        out.append(tok)
        logits, cache = decode_step(model, cache, tok, L + i, cfg, grid=grid)
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
    out = torch.cat(out, dim=1)
    if split:
        out = comm.all_gather(grid, out, axis="data", book="decode")
    return out


def serve_he(batch: int, requests: int = 0, levels: int = 1,
             rotations: int = 0, conjugations: int = 0,
             plain_frac: float = 0.0, use_kernels: bool = True,
             max_age_s: float | None = None, overlap: bool = False,
             circuit: bool = False, schedule: bool = False,
             traced: int = 0, check: str = "off", seed: int = 0,
             trace: str | None = None, profile_stages: bool = False,
             metrics: str | None = None, workers: int = 0,
             transport: str = "inproc", bootstrap: int = 0,
             model_shards: int = 1, grid=None,
             device: str | torch.device = "cuda") -> dict:
    """Batched multi-level HE serving on `device` (default the card; raises
    without CUDA), driven through an HESession (keygen, encrypt/decrypt;
    the raw per-op stream rides `session.server`).

    Submits a mixed stream of HE-Mul / rotate / conjugate requests spread
    over `levels` moduli — `plain_frac` of the mul share served as the
    key-switch-free mul_plain/add_plain plaintext-operand ops — plus, with
    `circuit`, a whole degree-4 encrypted polynomial circuit via
    submit_circuit (TWO staggered copies under `schedule`, exercising the
    circuit-aware scheduler's cross-circuit co-batching and table
    prefetch), plus, with `traced` > 0, that many TRACED client
    expressions (every handle op, no explicit level management — the
    compile pass inserts it) sharing one weight vector, so every
    expression after the first ships hash-only plaintext operands. With
    `check` ("warn" or "error") the static analyzer checks the demo
    circuit and every traced one before submission. Drains the queue with
    padded batching and decrypts every result against numpy. Returns the
    server's stats plus `max_err`.

    `workers` > 0 serves the same stream through the multi-host tier: an
    HEFrontend on the host routing batches to that many workers on
    `device`, in this process (`transport="inproc"`) or in worker
    processes ("subprocess"). Bit for bit the single-server path.

    `trace` writes a Chrome trace-event JSON of the request lifecycle and
    engine spans to that path (`python -m repro_torch.obs report PATH`);
    `profile_stages` fences each stage and adds the Fig. 3 CRT/NTT/modmul/
    iCRT split to the stats; `metrics` dumps the registry snapshot as
    JSON to that path.

    `bootstrap` > 0 additionally serves that many CONCURRENT bootstrap
    pipelines (`repro_torch.boot`) over level-exhausted ciphertexts — the
    whole run switches to the reference bootstrap params (`boot_params()`:
    logQ=336, h=2) so the pipeline fits the modulus chain. Bootstrap
    results are held to the plan's error bound (approximate, not bit for
    bit), and under `schedule` with two or more, to cross-circuit
    co-batching; the stats gain a "bootstrap" block with the measured
    error, the bound, and the cross-circuit co-batch rate.

    `model_shards` R > 1 serves the same stream across R model ranks:
    spawns the grid (its ranks on `device`) and returns rank 0's stats,
    which name the grid; rank 0 runs this function with `grid` (its
    HostGrid) and the others ``serve_follower``. With `workers`, rank 0's
    frontend spreads its in-process workers over that grid; with
    ``transport="subprocess"`` nothing is spawned here and every worker
    process runs a grid of R ranks of its own. Bit for bit the one-device
    path.
    """
    subprocess_grids = workers > 0 and transport == "subprocess"
    if model_shards > 1 and not subprocess_grids:
        kw = dict(batch=batch, requests=requests, levels=levels,
                  rotations=rotations, conjugations=conjugations,
                  plain_frac=plain_frac, use_kernels=use_kernels,
                  max_age_s=max_age_s, overlap=overlap, circuit=circuit,
                  schedule=schedule, traced=traced, check=check, seed=seed,
                  trace=trace, profile_stages=profile_stages,
                  metrics=metrics, workers=workers, transport=transport,
                  bootstrap=bootstrap)
        return spawn_grid(_serve_rank, model=model_shards, device=device,
                          args=(kw,))[0]
    dev = grid.device if grid is not None else resolve_device(device)
    params = boot_params() if bootstrap else SMOKE
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
    if workers > 0:
        if profile_stages or overlap:
            raise ValueError(
                "--profile-stages/--overlap are single-server knobs; "
                "the multi-host frontend pipelines across workers "
                "instead of double-buffering one engine")
        sk, pk, evk = keygen(params, seed=0, device=dev)
        frontend = HEFrontend(
            params, evk, batch=batch, workers=workers,
            transport=transport, worker_device=str(dev), grid=grid,
            worker_devices=model_shards if subprocess_grids else 1,
            use_kernels=use_kernels, max_age_s=max_age_s,
            schedule=schedule, tracer=tracer)
        session = HESession(params, sk, pk, evk, server=frontend,
                            device=dev)
    else:
        session = HESession(params, seed=0, device=dev, batch=batch,
                            use_kernels=use_kernels, max_age_s=max_age_s,
                            overlap=overlap, schedule=schedule,
                            tracer=tracer, profile_stages=profile_stages,
                            grid=grid)
    try:
        return _serve(session, params, requests, levels, rotations,
                      conjugations, plain_frac, circuit, schedule, traced,
                      check, seed, tracer, trace, metrics, bootstrap)
    finally:
        if workers > 0 or grid is not None:
            session.server.close()


def _serve_rank(grid, kw: dict):
    """One rank of ``serve_he(model_shards=R)``: rank 0 serves, the others
    follow."""
    if grid.model_rank == 0:
        return serve_he(grid=grid, **kw)
    return serve_follower(grid, boot_params() if kw["bootstrap"] else SMOKE)


def _serve(session, params, requests, levels, rotations, conjugations,
           plain_frac, circuit, schedule, traced, check, seed, tracer,
           trace, metrics, bootstrap) -> dict:
    server = session.server
    sdev = server.device
    if rotations:
        session.ensure_rotation_keys([1])
    if conjugations or circuit:
        session.ensure_conj_key()

    rng = np.random.default_rng(seed)
    n = params.n_slots_max
    logqs = [params.logQ - i * params.logp for i in range(levels)]
    expect = {}   # rid -> (op, expected slots)
    n_mul = requests - rotations - conjugations
    n_plain = int(round(plain_frac * n_mul))

    def encrypt(z, s, logq):
        ct = session.encrypt(z, seed=s).ciphertext
        if logq < params.logQ:
            ct = H.he_mod_down(ct, params, logq)
        return session.to_server(ct)

    for i in range(requests):
        logq = logqs[i % levels]
        z = rng.normal(size=n) + 1j * rng.normal(size=n)
        ct = encrypt(z, 2 * i + 1, logq)
        if i < n_plain:
            # plaintext-operand ops: encode-only operand, region-1
            # product / bx add — no key switch, no key material
            w = rng.normal(size=n) + 1j * rng.normal(size=n)
            pt = H.encode_plain(w, params, logq, device=sdev)
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
        if check != "off":
            # check the hand-built circuit before submitting it (the
            # traced path runs the same analyzer inside session.run)
            from repro_torch.analysis import analyze_circuit
            report = analyze_circuit(
                ops, {"x": (params.logQ, params.logp)}, params,
                input_nslots={"x": n})
            print(report.render("degree4 circuit"))
            if check == "error" and not report.ok:
                raise ValueError("static analysis rejected the demo "
                                 "circuit: " + "; ".join(
                                     d.format() for d in report.errors))
        for j in range(2 if schedule else 1):
            zc = rng.normal(size=n) + 1j * rng.normal(size=n)
            x = session.to_server(session.encrypt(zc, seed=7777 + j)
                                  .ciphertext)
            cid = server.submit_circuit(ops, inputs={"x": x})
            expect[cid] = ("circuit", np.conj(zc ** 4) + zc)
            if schedule and j == 0:       # desync the two circuits
                results.update(dict(server.poll(flush=True)))

    tfuts = []
    if traced:
        # the session API end to end: every traced op, NO explicit
        # rescale/mod_down (the compile pass inserts level management),
        # one shared weight vector — every expression after the first
        # compiles to hash-only plain operands (server-cache hits)
        wz = 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
        for j in range(traced):
            zt = 0.5 * (rng.normal(size=n) + 1j * rng.normal(size=n))
            x = session.encrypt(zt, seed=5555 + j)
            tfuts.append(
                (session.run([((x * x) * wz + x)
                              .rotate(1).conj().slot_sum()],
                             check=check)[0],
                 np.full(n, np.conj(np.roll(zt * zt * wz + zt,
                                            -1)).sum())))

    bfuts = []
    if bootstrap:
        # N concurrent bootstrap pipelines over level-exhausted inputs:
        # their aligned stage nodes co-batch ACROSS circuits (and with
        # the plain request stream) through the same queue
        for j in range(bootstrap):
            zb = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
            zb *= 2.0 ** -5 / np.max(np.abs(zb))
            ct = session.encrypt(zb, seed=8888 + j).ciphertext
            ct = H.he_mod_down(ct, params, params.logp)  # exhausted
            bfuts.append((session.bootstrap(ct), zb))

    # session.drain (not server.drain) so traced futures resolve while
    # the raw per-op/circuit results come back as {rid: ct}
    results.update(session.drain())
    errs = []
    for rid, (op, want) in expect.items():
        out = results[rid]
        if op in ("mul", "mul_plain"):
            out = H.rescale(out, params)
        errs.append(float(np.abs(session.decrypt(out) - want).max()))
    for fut, want in tfuts:
        errs.append(float(np.abs(session.decrypt(fut.result())
                                 - want).max()))
    stats = server.stats()
    stats["max_err"] = max(errs)
    if bootstrap:
        # approximate-op contract: an error-BOUND gate, not bit for bit
        plan = next(iter(session._boot_plans.values()))
        berrs = []
        for fut, want in bfuts:
            out = fut.result()
            if out.logq != plan.out_logq:
                raise AssertionError(
                    f"bootstrap result at logq {out.logq}, the plan's "
                    f"output is at {plan.out_logq}")
            berrs.append(
                float(np.abs(session.decrypt(out) - want).max()))
        bound = plan.error_bound()
        if max(berrs) > bound:
            raise AssertionError(
                f"bootstrap error {max(berrs):.3e} exceeds the "
                f"bound {bound:.3e}")
        if schedule and bootstrap >= 2 \
                and stats["cobatch"]["cross_circuit_batches"] == 0:
            raise AssertionError(
                "concurrent bootstraps never co-batched across "
                "circuits — the scheduler lost the batched-"
                "bootstrapping payoff")
        stats["bootstrap"] = {
            "n": bootstrap,
            "max_err": max(berrs),
            "error_bound": bound,
            "logq_in": plan.logq_in,
            "out_logq": plan.out_logq,
            "cross_circuit_rate":
                stats["cobatch"]["cross_circuit_rate"],
        }
    if trace:
        stats["trace_events"] = tracer.write(trace)
    if metrics:
        with open(metrics, "w") as f:
            json.dump(server.registry.snapshot(), f, indent=2)
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="the LM to serve (repro_torch.configs.ARCHS)")
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"],
                    help="smoke: the arch's reduced() config; full: its "
                         "published size")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens to generate greedily after the prompt")
    ap.add_argument("--he", action="store_true",
                    help="serve a batched multi-level HE request stream "
                         "(queue → level-aware table cache → engine) "
                         "instead of an LM")
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
    ap.add_argument("--traced", type=int, default=0,
                    help="also run this many TRACED repro_torch.client "
                         "expressions (every handle op, auto level "
                         "management) through the session; they share "
                         "one weight vector, so runs after the first hit "
                         "the server's plaintext-operand cache")
    ap.add_argument("--check", default="off",
                    choices=["off", "warn", "error"],
                    help="static-analyze circuits before submission "
                         "(repro_torch.analysis): 'warn' prints findings, "
                         "'error' refuses to submit on errors/warnings")
    ap.add_argument("--workers", type=int, default=0,
                    help="serve through the multi-host tier: an HEFrontend "
                         "routing batches by (op, level) affinity to this "
                         "many workers on --device, with heartbeat health "
                         "and worker-death requeue (0 = single HEServer)")
    ap.add_argument("--transport", default="inproc",
                    choices=["inproc", "subprocess"],
                    help="with --workers: workers in this process, or "
                         "worker processes speaking frames over pipes")
    ap.add_argument("--bootstrap", type=int, nargs="?", const=2,
                    default=0, metavar="N",
                    help="also serve N concurrent CKKS bootstrap "
                         "pipelines (repro_torch.boot) over level-exhausted "
                         "ciphertexts; bare --bootstrap means N=2 so "
                         "cross-circuit co-batching is exercised. "
                         "Switches the run to the reference bootstrap "
                         "params (logQ=336, h=2); results are held to "
                         "the plan's error bound")
    ap.add_argument("--model-shards", type=int, default=1, metavar="R",
                    help="spread the work over R model ranks (spawned "
                         "processes on --device; one card is shared by "
                         "all, over gloo): on the LM path the weights, "
                         "tensor-parallel; with --he the tables, keys and "
                         "every step's primes; with --workers, the "
                         "in-process workers share one grid, and each "
                         "worker process of --transport subprocess runs "
                         "its own; 1 = one rank")
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
    if not args.he:
        _serve_lm(args)
        return
    stats = serve_he(args.batch, requests=args.requests, levels=args.levels,
                     rotations=args.rotations,
                     conjugations=args.conjugations,
                     plain_frac=args.plain_frac, use_kernels=args.kernels,
                     max_age_s=args.max_age_s, overlap=args.overlap,
                     circuit=args.circuit, schedule=args.schedule,
                     seed=args.seed, trace=args.trace,
                     profile_stages=args.profile_stages,
                     metrics=args.metrics, traced=args.traced,
                     check=args.check, workers=args.workers,
                     transport=args.transport, bootstrap=args.bootstrap,
                     model_shards=args.model_shards, device=args.device)
    ops = ", ".join(
        f"{op}: {d['requests']} reqs @ {d['ops_per_s']}/s "
        f"(p50 {d['latency_ms']['p50']}ms, "
        f"p99 {d['latency_ms']['p99']}ms, pad {d['pad_frac']})"
        for op, d in stats["per_op"].items())
    # with workers the ops run on the workers' device; the frontend's own
    # device is only the host tier that frames them
    where = (f"{stats['frontend']['worker_device']} workers (host tier "
             f"{stats['device']})" if args.workers else stats["device"])
    if args.workers and args.model_shards > 1:
        fr = stats["frontend"]
        owner = ("one a worker process" if fr["grid"] is None
                 else "shared by the in-process workers")
        where += f" on model grids 1x{args.model_shards} ({owner})"
    if "grid" in stats:
        g = stats["grid"]
        where += (f" grid {g['data']}x{g['model']} ({g['backend']}, "
                  f"{g['step']['counts'].get('all-reduce', 0)} all-reduces "
                  f"on rank 0)")
    print(f"hserve batch={stats['batch']} on {where} "
          f"levels={stats['levels_served']} "
          f"steps_compiled={stats['engine']['steps_compiled']} "
          f"(first runs {stats['engine']['compile_s']}s)")
    print(f"  {ops}")
    if args.workers:
        fr = stats["frontend"]
        print(f"  frontend: {fr['workers']} {fr['transport']} worker(s) on "
              f"{fr['worker_device']}, {fr['alive']} alive, "
              f"{fr['deaths']} death(s), {fr['requeued_requests']} requeued")
    if args.schedule:
        sch, cb = stats["scheduler"], stats["cobatch"]
        print(f"  scheduler: lookahead={sch['lookahead']} "
              f"deferrals={sch['deferrals']} "
              f"prefetched_levels={sch['prefetched_levels']} "
              f"cross_circuit_rate={cb['cross_circuit_rate']}")
    if args.traced:
        c = stats["cache"]
        print(f"  plaintext cache: {c['plain_hits']} hits / "
              f"{c['plain_misses']} misses ({c['plain_entries']} entries)")
    if args.profile_stages:
        for op, row in sorted(stats["stages"]["stages"].items()):
            tot = sum(row.values())
            wall = stats["per_op"].get(op, {}).get("wall_s", 0.0)
            split = " ".join(
                f"{s} {1e3 * v:.1f}ms ({v / tot:.0%})"
                for s, v in row.items()) if tot else "—"
            cov = f" coverage {tot / wall:.0%} of wall" if wall else ""
            print(f"  fig3[{op}]: {split}{cov}")
    if args.bootstrap:
        bs = stats["bootstrap"]
        print(f"  bootstrap: {bs['n']} concurrent pipeline(s) "
              f"logq {bs['logq_in']} -> {bs['out_logq']}, "
              f"max_err {bs['max_err']:.2e} "
              f"(bound {bs['error_bound']:.2e}), "
              f"cross_circuit_rate {bs['cross_circuit_rate']}")
    if args.trace:
        print(f"  trace: {stats['trace_events']} events -> {args.trace}")
    if args.metrics:
        print(f"  metrics snapshot -> {args.metrics}")
    print(f"  max_err {stats['max_err']:.2e}")
    if not stats["max_err"] < 1e-2:
        raise SystemExit("HE serving pipeline diverged")


def _lm_run(args: dict, dev: torch.device, grid=None) -> dict:
    """The LM path's model, prompt and timed generate on `dev` (one rank's
    shard of them with `grid`)."""
    cfg = get_arch(args["arch"])
    if args["preset"] == "smoke":
        cfg = cfg.reduced()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args["seed"]), dev)
    if grid is not None:
        model = shard_lm(model, cfg, grid)
    B, L = args["batch"], args["prompt_len"]
    rng = np.random.default_rng(args["seed"])
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, L)).astype(np.int32)).to(dev)
    extra = {}
    if cfg.enc_dec:
        extra["frames"] = torch.from_numpy(rng.normal(
            size=(B, 2 * L, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.frontend == "vision":
        extra["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)).to(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = generate(model, cfg, tokens, args["gen"], L + args["gen"] + 8,
                   batch_extra=extra, grid=grid)
    out = out.cpu()                 # waits for the device
    dt = time.perf_counter() - t0
    run = {"tokens": out, "s": dt, "device": str(dev)}
    if grid is not None:
        run["grid"] = grid.describe()
        run["decode"] = comm.summary(grid, "decode")
        run["held_bytes"] = sum(p.numel() * p.element_size()
                                for p in model.parameters())
    return run


def _serve_lm_rank(grid, args: dict) -> dict:
    """One rank of ``--model-shards R`` on the LM path."""
    return _lm_run(args, grid.device, grid)


def _serve_lm(args) -> None:
    """The LM path of :func:`main`: the reference's, on `args.device`, on
    one device or across `args.model_shards` model ranks."""
    kw = {k: getattr(args, k) for k in ("arch", "preset", "seed", "batch",
                                        "prompt_len", "gen")}
    if args.model_shards > 1:
        run = spawn_grid(_serve_lm_rank, model=args.model_shards,
                         device=args.device, args=(kw,))[0]
    else:
        run = _lm_run(kw, resolve_device(args.device))
    out, dt = run["tokens"], run["s"]
    where = run["device"]
    if "grid" in run:
        g, d = run["grid"], run["decode"]
        where += (f" grid {g['data']}x{g['model']} ({g['backend']}, "
                  f"{sum(d['counts'].values()) // args.gen} collectives a "
                  f"decode step on rank 0)")
    print(f"arch={args.arch} preset={args.preset} generated "
          f"{tuple(out.shape)} on {where} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, first run)")
    print(f"  first tokens: {out[0, :8].tolist()}")


if __name__ == "__main__":
    main()
