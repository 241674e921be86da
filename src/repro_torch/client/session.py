"""HESession: the canonical user entry point to the serving stack.

One session owns the parameter set, the key material, and an
:class:`repro_torch.hserve.HEServer` (or wraps one you built yourself —
an ``HEServer`` or an ``HEFrontend``). The workflow is paper §I's
application shape — encrypt once, run a chained encrypted computation
server-side, decrypt once:

    session = HESession(params, seed=0, batch=8)
    x = session.encrypt(z)                       # CipherHandle (traced)
    y = ((x * x) * w + x).rotate(1).conj().slot_sum()
    prob = session.decrypt(y)                    # compile → serve → dec

``run`` submits many traced expressions WITHOUT draining between them,
so independent circuits co-batch through the circuit-aware scheduler —
the client-side mirror of the server's cross-circuit co-batching. Each
submission returns a :class:`CipherFuture`; the first ``result()`` call
drains the server and resolves every pending future at once.

Key provisioning: with the secret key in the session (the default —
``HESession(params, seed=...)`` runs keygen), rotation and conjugation
keys the trace needs are generated on demand and loaded into the
server's resident cache (``auto_keys=False`` to disable). A session can
also be built pk-only (no decrypt, no auto keys) around a shared server.

This is the JAX package's ``client/session.py``. What differs: the
session has a ``device`` (default "cuda") where its keys live and where
it encrypts and decrypts; its server may serve another device (an
``HEFrontend`` serves from the host), and the session moves a
ciphertext to the server's device explicitly when it submits one
(:meth:`to_server`) and back to its own when it decrypts. A bootstrap
plan encodes its diagonals on the server's device. The session holds one
``PipelineConfig`` (:attr:`cfg`), built from its server's ``use_kernels``,
and runs keygen, encryption, decryption and the Galois keygens through
it, where the reference's session takes its config's default (no
kernels): so a session at β = 2^64 runs with ``use_kernels=False``, and
``use_kernels=True`` there raises when the session is built.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.client.compile import CompiledCircuit, compile_handle
from repro_torch.client.handles import CipherHandle, PlainHandle
from repro_torch.core import heaan as H
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.context import resolve_device
from repro_torch.core.keys import keygen
from repro_torch.core.params import HEParams
from repro_torch.core.rns import PipelineConfig, kernels_on
from repro_torch.core.rotate import conj_keygen, rot_keygen

__all__ = ["CipherFuture", "HESession"]


class CipherFuture:
    """The pending result of one submitted traced circuit."""

    def __init__(self, session: "HESession", cid: Optional[int],
                 ct: Optional[Ciphertext] = None):
        self._session = session
        self.cid = cid
        self._ct = ct

    def done(self) -> bool:
        return self._ct is not None

    def result(self) -> Ciphertext:
        """The circuit's output ciphertext (drains the session's server
        on first call; every other pending future resolves with it).
        Raw server-submit results completed by this drain stay buffered
        for the next ``HESession.drain()`` call."""
        if self._ct is None:
            self._session._drain_server()
            if self._ct is None:
                raise RuntimeError(
                    f"circuit {self.cid} did not complete in drain()")
        return self._ct

    def decrypt(self) -> np.ndarray:
        """result() decrypted to complex slots (needs the session's sk)."""
        return self._session.decrypt(self.result())


class HESession:
    """Encrypt/decrypt boundary + traced-expression executor.

    params: the HEAAN parameter set.
    sk/pk/evk: key triple; omit ALL of them to run keygen(seed).
    rot_keys/conj_key: preloaded Galois keys for a freshly built server
        (with auto_keys and sk, traces provision their own on demand).
    seed: keygen seed when no keys are passed (default 0).
    device: where keygen runs and the session encrypts and decrypts
        (default "cuda"; raises when CUDA is absent).
    server: wrap an existing HEServer or HEFrontend instead of building
        one (batch / server knobs then live on that server).
    batch, **server_kwargs: forwarded to the built HEServer (on
        `device`; max_age_s, overlap, schedule, use_kernels, ...).
        `use_kernels` (the built server's, or the given server's) also
        sets the session's own config; at β = 2^64 it must be False.
    grid: a HostGrid whose rank 0 this is, forwarded to the built
        HEServer (`HEServer(grid=)`: tables, keys and every step spread
        over the model ranks, which run `hserve.serve_follower`); the
        session itself runs on rank 0 only.
    auto_keys: generate + load missing rotation/conjugation keys at run
        time from the session's sk (ignored without an sk).
    """

    def __init__(self, params: HEParams, sk=None, pk=None, evk=None,
                 rot_keys=None, conj_key=None, *,
                 seed: Optional[int] = None, server=None,
                 device: str | torch.device = "cuda", batch: int = 8,
                 auto_keys: bool = True, grid=None, **server_kwargs):
        self.params = params
        self.device = resolve_device(device)
        use_kernels = server_kwargs.get("use_kernels", True) \
            if server is None else getattr(server, "use_kernels", True)
        self.cfg = PipelineConfig(use_kernels=kernels_on(use_kernels,
                                                         params))
        if pk is None:
            if sk is not None or evk is not None:
                raise ValueError(
                    "pass all of (sk, pk, evk) or none of them")
            sk, pk, evk = keygen(params, seed=0 if seed is None else seed,
                                 cfg=self.cfg, device=self.device)
        self.sk, self.pk, self.evk = sk, pk, evk
        if server is None:
            from repro_torch.hserve import HEServer
            server = HEServer(params, evk, rot_keys, conj_key,
                              device=self.device, batch=batch, grid=grid,
                              **server_kwargs)
        elif server_kwargs or grid is not None:
            raise ValueError(
                "server knobs conflict with an explicit server; "
                "configure the server you pass in")
        else:
            # Galois keys passed alongside an explicit server load into
            # its resident cache (dropping them silently would strand a
            # pk-only session that cannot regenerate them)
            for r, rk in (rot_keys or {}).items():
                server.cache.add_rot_key(r, rk)
            if conj_key is not None:
                server.cache.add_conj_key(conj_key)
        self.server = server
        # client-plane telemetry rides the server's registry so one
        # snapshot (and one heartbeat) carries the whole stack
        reg = getattr(server, "registry", None)
        self._c_runs = reg.counter("client.runs") \
            if reg is not None else None
        self._c_circuits = reg.counter("client.circuits") \
            if reg is not None else None
        self._c_bootstraps = reg.counter("client.bootstraps") \
            if reg is not None else None
        self.auto_keys = auto_keys
        self._futures: Dict[int, CipherFuture] = {}
        # bootstrap plans keyed by (logq, logp, n_slots, config):
        # construction (stage lowering + DFT matrices) happens once per
        # input shape; repeats also ship their diagonals hash-only
        self._boot_plans: Dict[tuple, object] = {}
        # raw server-submit results completed by a future-triggered
        # drain, buffered until the next explicit drain() claims them
        self._raw: Dict[int, Ciphertext] = {}
        # AnalysisReports from the latest run(check=...), one per
        # handle (None for bare inputs)
        self.last_reports: list = []
        # per-session counter for default encryption seeds: every
        # default-seeded encrypt gets FRESH randomness (reusing one seed
        # across messages leaks their difference — c1.bx − c2.bx would
        # cancel the identical noise and mask)
        self._enc_seed = 1

    # ---- data boundary ---------------------------------------------------

    def encrypt(self, z, seed: Optional[int] = None) -> CipherHandle:
        """Encrypt a complex slot message into a traced input handle.

        seed: encryption randomness. Default: a fresh per-session
        counter value — never reused, so two default-seeded ciphertexts
        never share their (u, e0, e1) randomness. Pass explicit seeds
        only for reproducibility, and never the same one twice.
        """
        if seed is None:
            seed = self._enc_seed
            self._enc_seed += 1
        z = np.asarray(z, dtype=np.complex128)
        return self.input(
            H.encrypt_message(z, self.pk, self.params, seed=seed,
                              cfg=self.cfg))

    def input(self, ct: Ciphertext) -> CipherHandle:
        """Wrap an existing ciphertext as a traced input handle."""
        return CipherHandle(self, "input", ct=ct)

    def plain(self, z) -> PlainHandle:
        """Wrap a plaintext message/scalar (raw scalars and arrays in
        handle arithmetic wrap themselves; this is for explicitness)."""
        return PlainHandle(z)

    def to_server(self, ct: Ciphertext) -> Ciphertext:
        """`ct` on the server's device (a copy when it lies elsewhere) —
        for raw ``session.server.submit_*`` calls; ``run`` does this for
        its circuits' inputs."""
        return ct.to(self.server.device)

    def decrypt(self, x: Union[Ciphertext, CipherHandle, CipherFuture]
                ) -> np.ndarray:
        """Decrypt a ciphertext / future / traced handle (running the
        trace first when needed) on the session's device. Needs the
        session's secret key."""
        if isinstance(x, CipherHandle):
            x = self.run([x])[0]
        if isinstance(x, CipherFuture):
            x = x.result()
        if self.sk is None:
            raise ValueError("this session holds no secret key")
        return H.decrypt_message(x.to(self.sk.s.device), self.sk,
                                 self.params, self.cfg)

    # ---- execution -------------------------------------------------------

    def compile(self, handle: CipherHandle,
                bootstrap: Union[bool, str] = False) -> CompiledCircuit:
        """Lower one traced expression (auto level alignment, CSE,
        plaintext-cache-aware operand encoding on the server's device)
        without submitting it. bootstrap: as in :meth:`run`."""
        return compile_handle(handle, self.params,
                              plain_lookup=self.server.cache.has_plain,
                              bootstrap=bootstrap,
                              device=self.server.device)

    def bootstrap(self, x: Union[Ciphertext, CipherHandle, CipherFuture],
                  *, config=None) -> CipherFuture:
        """Refresh a level-exhausted ciphertext through the served
        `repro_torch.boot` pipeline; returns a future whose result is the
        SAME message at a higher level (within the plan's error bound —
        bootstrap is approximate, `BootstrapPlan.error_bound`).

        x: a ciphertext, input handle, traced handle (run first), or
        future (drained first). Plans are cached per input shape, so
        repeat bootstraps skip plan construction AND ship their
        CoeffToSlot/SlotToCoeff diagonals hash-only. Needed rotation /
        conjugation keys auto-provision like :meth:`run`'s.
        """
        from repro_torch.boot.pipeline import BootConfig, bootstrap_circuit
        if isinstance(x, CipherHandle):
            x = x.ct if x.op == "input" else self.run([x])[0]
        if isinstance(x, CipherFuture):
            x = x.result()
        key = (x.logq, x.logp, x.n_slots, config or BootConfig())
        plan = self._boot_plans.get(key)
        if plan is None:
            plan = bootstrap_circuit(
                self.params, logq_in=x.logq, logp=x.logp,
                n_slots=x.n_slots, config=config,
                plain_lookup=self.server.cache.has_plain,
                device=self.server.device)
            self._boot_plans[key] = plan
        if self.auto_keys and self.sk is not None:
            self.ensure_keys(plan.requires)
        cid = self.server.submit_bootstrap(self.to_server(x), plan=plan)
        fut = CipherFuture(self, cid)
        self._futures[cid] = fut
        if self._c_bootstraps is not None:
            self._c_bootstraps.inc()
        return fut

    def run(self, handles: Sequence[CipherHandle], *,
            check: str = "off",
            bootstrap: Union[bool, str] = False) -> List[CipherFuture]:
        """Compile + submit traced expressions; returns one future per
        handle. Nothing executes until a future's result() drains the
        server — so everything submitted here (and any raw server
        traffic) co-batches.

        Compilation of EVERY handle happens before anything is
        submitted: a compile error (trace too deep, bad slots) raises
        with zero circuits enqueued, never orphaning earlier handles'
        futures. Cache-aware lowering still sees siblings: operands an
        earlier handle in this call will register compile to hash-only
        nodes in later ones (they resolve at submit time, in order).
        Futures register only after EVERY submit succeeds — if a later
        submit raises (e.g. a missing Galois key on a pk-only session),
        the already-enqueued circuits' results come back as raw
        {cid: ct} entries from the next :meth:`drain` instead of
        vanishing into unreachable futures.

        check: run the static analyzer (`repro_torch.analysis`) over
        every compiled circuit BEFORE submitting anything. "error"
        raises ValueError on any error- or warning-severity finding
        (noise below the waterline, dead nodes, rotation smells); "warn"
        issues a `UserWarning` per finding instead; "off" (default)
        skips analysis entirely. The reports of the latest checked run
        are kept on ``self.last_reports`` (one per handle, None for
        bare inputs) either way.

        bootstrap: "auto" (or True) lets the compile pass splice the
        served `repro_torch.boot` pipeline in front of level-exhausted
        mul operands, so a trace deeper than the native modulus budget
        still runs (approximately, within the plan's error bound).
        Default off: such traces raise "needs bootstrapping" at compile.
        """
        if check not in ("off", "warn", "error"):
            raise ValueError(f"check must be 'off', 'warn', or "
                             f"'error', got {check!r}")
        pending: set = set()           # (hash, logq) earlier handles
                                       # in THIS call will register
        cache = self.server.cache
        dev = self.server.device
        compiled = []
        for h in handles:
            if not isinstance(h, CipherHandle):
                raise TypeError(f"run() takes CipherHandles, got "
                                f"{type(h).__name__}")
            if h.session is not self:
                raise ValueError("handle belongs to a different session")
            if h.op == "input":        # bare input: already a ciphertext
                compiled.append((h, None))
                continue
            cc = compile_handle(
                h, self.params,
                plain_lookup=lambda hs, lq: cache.has_plain(hs, lq)
                or (hs, lq) in pending,
                bootstrap=bootstrap, device=dev)
            pending |= cc.plain_registers
            compiled.append((h, cc))
        if check != "off":
            self._check_compiled(compiled, check)
        futures: List[CipherFuture] = []
        to_register: List[CipherFuture] = []
        for h, cc in compiled:
            if cc is None:
                futures.append(CipherFuture(self, None, ct=h.ct))
                continue
            if self.auto_keys and self.sk is not None:
                self.ensure_keys(cc.requires)
            try:
                cid = self._submit(cc)
            except ValueError as e:
                if "no cached plaintext" not in str(e):
                    raise
                # the compile-time has_plain answer raced LRU eviction
                # (a sibling's registration in this very call can evict
                # the entry): re-lower with every operand materialized
                cc = compile_handle(h, self.params, plain_lookup=None,
                                    bootstrap=bootstrap, device=dev)
                cid = self._submit(cc)
            to_register.append(CipherFuture(self, cid))
            futures.append(to_register[-1])
        self._futures.update((f.cid, f) for f in to_register)
        if self._c_runs is not None:
            self._c_runs.inc()
            self._c_circuits.inc(len(to_register))
        return futures

    def _submit(self, cc: CompiledCircuit) -> int:
        return self.server.submit_circuit(
            cc.ops, {k: self.to_server(ct) for k, ct in cc.inputs.items()})

    def _check_compiled(self, compiled, check: str) -> None:
        """The ``run(check=...)`` analysis pass: analyze every lowered
        circuit (bare inputs skip), escalate per policy. Rotation keys
        resident on the server count as provisioned for the HS004
        rotation rule; an auto-keys session with a secret key reports
        None (it can mint any key, so nothing is 'missing')."""
        import warnings

        from repro_torch.analysis import analyze_handle

        provisioned = None if (self.auto_keys and self.sk is not None) \
            else set(self.server.cache.rotation_amounts)
        self.last_reports = []
        findings = []
        for h, cc in compiled:
            if cc is None:
                self.last_reports.append(None)
                continue
            report = analyze_handle(h, self.params, compiled=cc,
                                    provisioned_rotations=provisioned)
            self.last_reports.append(report)
            k = len(self.last_reports) - 1
            findings += [(k, d) for d in report.diagnostics
                         if d.severity in ("error", "warning")]
        if not findings:
            return
        msgs = [f"handle {k}: {d.format()}" for k, d in findings]
        if check == "error":
            raise ValueError(
                "static analysis rejected the run (check='error'): "
                + "; ".join(msgs))
        for m in msgs:
            warnings.warn(m, stacklevel=3)

    def _drain_server(self) -> None:
        """Drain the server, routing results: future-owned cids resolve
        their futures, everything else is buffered in ``_raw`` until an
        explicit :meth:`drain` claims it (so a future-triggered drain
        never loses raw server-submit results)."""
        for rid, ct in self.server.drain().items():
            fut = self._futures.pop(rid, None)
            if fut is not None:
                fut._ct = ct
            else:
                self._raw[rid] = ct

    def drain(self) -> Dict[int, Ciphertext]:
        """Serve everything queued on the server. Resolves this
        session's pending futures; results of RAW server submits (ops
        or circuits submitted directly on ``session.server``) are
        returned as {rid: Ciphertext}, including any completed earlier
        by a future-triggered drain — use this instead of
        ``server.drain()`` when mixing the two, so futures are not
        starved of their results."""
        self._drain_server()
        out, self._raw = self._raw, {}
        return out

    # ---- key provisioning ------------------------------------------------

    def ensure_keys(self, requires) -> None:
        """Generate + load any missing Galois keys a compiled trace
        needs (("rot", r) / ("conj",) requirements). Needs the sk."""
        cache = self.server.cache
        for req in sorted(requires):
            if req[0] == "rot" and req[1] not in cache.rotation_amounts:
                cache.add_rot_key(req[1], rot_keygen(
                    self.params, self.sk, req[1], cfg=self.cfg,
                    device=self.device))
            elif req[0] == "conj" and not cache.has_conj_key:
                cache.add_conj_key(conj_keygen(
                    self.params, self.sk, cfg=self.cfg, device=self.device))

    def ensure_rotation_keys(self, rs) -> None:
        """Convenience for raw-op callers: load rotation keys for the
        given amounts."""
        self.ensure_keys({("rot", int(r)) for r in rs})

    def ensure_conj_key(self) -> None:
        self.ensure_keys({("conj",)})

    # ---- accounting ------------------------------------------------------

    def stats(self) -> dict:
        return self.server.stats()
