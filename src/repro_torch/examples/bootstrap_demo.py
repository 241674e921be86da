"""Past the native depth limit: served CKKS bootstrapping end to end.

    PYTHONPATH=src python -m repro_torch.examples.bootstrap_demo [--device cpu]

Leveled HEAAN dies of modulus exhaustion (the paper's §III-A): every
mul + rescale burns logp bits of logq, and at logq == logp no further
mul can rescale. This demo walks one traced expression PAST that
limit on the ``repro_torch.client`` session API:

  1. encrypt a full-slot message at the reference bootstrap config
     (``repro_torch.boot.boot_params()``: logN=4, logQ=336, logp=24, h=2 —
     NOT secure; a pipeline-correctness parameter set);
  2. exhaust the ciphertext down to logq = logp, so even ONE more
     mul is impossible natively — ``session.run([x * x])`` raises
     "needs bootstrapping" at compile;
  3. re-run with ``bootstrap="auto"``: the compile pass splices the
     served four-stage refresh (mod-raise → CoeffToSlot → EvalMod →
     SlotToCoeff) in front of the exhausted operand and the square
     executes at the refreshed level;
  4. explicitly refresh a second exhausted ciphertext with
     ``session.bootstrap(ct)`` — the plan is cached per input shape and
     its CoeffToSlot/SlotToCoeff diagonals now ship hash-only;
  5. decrypt and check both results against the plan's DOCUMENTED
     error bound — bootstrap is approximate by construction; the
     bound is its correctness contract.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analysis.dataflow import CircuitError
from repro_torch.boot import boot_params, bootstrap_circuit
from repro_torch.client import HESession
from repro_torch.core import heaan
from repro_torch.core.context import resolve_device
from repro_torch.examples import check


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "bootstrap_demo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    params = boot_params()
    session = HESession(params, seed=0, batch=2, schedule=True, device=dev)
    n = params.n_slots_max                   # bootstrap needs FULL slots

    rng = np.random.default_rng(7)
    msg_bound = 2.0 ** -5                    # the per-slot |z| contract
    z = (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)) * msg_bound

    # --- exhaust the modulus chain: mod-down to the last level -------------
    ct = heaan.encrypt_message(z, session.pk, params, seed=11)
    ct = heaan.he_mod_down(ct, params, params.logp)
    print(f"exhausted ciphertext: logq={ct.logq} (= logp={params.logp}; "
          f"no mul can rescale)")

    # --- natively impossible: one more mul needs a level we don't have -----
    x = session.input(ct)
    refused = None
    try:
        session.run([x * x])
    except CircuitError as e:
        refused = f"{type(e).__name__}: {e}"
        print(f"without bootstrap: {refused}")
    check(refused is not None and "needs bootstrapping" in refused,
          "an exhausted operand's mul ran without a bootstrap")

    # --- auto-insertion: the compile pass splices the served refresh -------
    cc = session.compile(x * x, bootstrap="auto")
    plan = bootstrap_circuit(params, logq_in=ct.logq,   # same shape → same
                             device=dev)                # plan
    print(f"bootstrap='auto': {len(cc.bootstraps)} pipeline spliced "
          f"({len(plan.ops)} of the circuit's {len(cc.ops)} nodes), "
          f"logq {plan.logq_in} -> {plan.out_logq} "
          f"(+{plan.levels_gained} levels)")

    fut, = session.run([x * x], bootstrap="auto")
    got = session.decrypt(fut.result())
    err = float(np.max(np.abs(got - z * z)))
    # the square doubles the refreshed operand's error, and |z| ≤ mb keeps
    # the product's own magnitude inside the contract
    budget = 4.0 * msg_bound * plan.error_bound()
    print(f"served x*x past the depth limit: |err| {err:.3e} "
          f"(budget {budget:.3e})")
    check(err <= budget, "x*x past the depth limit exceeded its budget")

    # --- explicit refresh: the cached plan ships diagonals hash-only -------
    z2 = (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)) * msg_bound
    ct2 = heaan.he_mod_down(
        heaan.encrypt_message(z2, session.pk, params, seed=12),
        params, params.logp)
    hits0 = session.server.stats()["cache"]["plain_hits"]
    refreshed = session.bootstrap(ct2).result()
    err2 = float(np.max(np.abs(session.decrypt(refreshed) - z2)))
    hits = session.server.stats()["cache"]["plain_hits"] - hits0
    print(f"explicit bootstrap: logq {ct2.logq} -> {refreshed.logq}, "
          f"|err| {err2:.3e} (bound {plan.error_bound():.3e}), "
          f"{hits} hash-only diagonal cache hits")
    check(err2 <= plan.error_bound(), "the refresh exceeded its error bound")
    check(hits > 0, "repeat bootstrap should serve diagonals from cache")
    print("ok: served past the native depth limit within the error bound")
    return {"device": str(dev), "refused": refused,
            "spliced": len(cc.bootstraps), "square_err": err,
            "square_budget": budget, "refresh_err": err2,
            "error_bound": plan.error_bound(), "diagonal_hits": hits,
            "square": got, "refreshed_logq": refreshed.logq}


if __name__ == "__main__":
    main()
