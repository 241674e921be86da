"""Quickstart: HEAAN basics through the port's public API.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Encodes two complex vectors, encrypts them, multiplies the ciphertexts
(the paper's HE Mul: CRT → NTT → pointwise → iNTT → iCRT, regions 1+2),
rescales, adds, decrypts — and checks the arithmetic came out right.
First with explicit core calls (the pipeline the port is built on, through
its CUDA kernels on the card), then the SAME computation through the
``repro_torch.client`` session API, where the compiler inserts the
rescale/mod-down bookkeeping — bitwise-identically.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.client import HESession
from repro_torch.core import heaan as H
from repro_torch.core.context import resolve_device
from repro_torch.core.keys import keygen
from repro_torch.core.params import test_params
from repro_torch.core.rns import PipelineConfig
from repro_torch.examples import check, wall


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    params = test_params(logN=8, beta_bits=32, logQ=120, logp=24)
    print(f"params: N=2^{params.logN}, logQ={params.logQ}, "
          f"logp={params.logp}, β=2^{params.beta_bits}, depth L={params.L}")
    print(f"RNS primes: region1 np={params.np_region1(params.logQ)}, "
          f"region2 np={params.np_region2(params.logQ)}")

    t0 = wall(dev)
    sk, pk, evk = keygen(params, seed=0, device=dev)
    print(f"keygen on {dev}: {wall(dev) - t0:.2f}s")

    rng = np.random.default_rng(0)
    n = 64
    z1 = rng.normal(size=n) + 1j * rng.normal(size=n)
    z2 = rng.normal(size=n) + 1j * rng.normal(size=n)

    c1 = H.encrypt_message(z1, pk, params, seed=1)
    c2 = H.encrypt_message(z2, pk, params, seed=2)
    print(f"encrypted {n} complex slots at logq={c1.logq}")

    t0 = wall(dev)
    product = H.he_mul(c1, c2, evk, params)   # the paper's Fig. 2 pipeline
    c3 = H.rescale(product, params)
    print(f"HE Mul + rescale: {wall(dev) - t0:.2f}s  (logq: "
          f"{c1.logq} -> {c3.logq})")

    c4 = H.he_add(c3, H.he_mod_down(c1, params, c3.logq))

    out = H.decrypt_message(c4, sk, params)
    expect = z1 * z2 + z1
    err = float(np.abs(out - expect).max())
    print(f"decrypt(c1*c2 + c1): max error = {err:.2e}")
    check(err < 1e-2, "HE arithmetic diverged!")

    # --- the same computation on the session API (the canonical frontend) --
    # x1 * x2 + x1 traces lazily; the compile pass inserts the rescale and
    # the mod-down level alignment written by hand above — bitwise identical
    session = HESession(params, sk=sk, pk=pk, evk=evk, batch=2, device=dev)
    x1, x2 = session.input(c1), session.input(c2)
    ct = (x1 * x2 + x1).result()         # compile → batched serve → 1 ct
    same = torch.equal(ct.ax, c4.ax) and torch.equal(ct.bx, c4.bx)
    check(same, "session API diverged from the hand-composed core pipeline")
    print("session API (repro_torch.client): x1 * x2 + x1 bitwise == "
          "hand-composed")

    # the optimization ladder (paper §V) is a config choice; its rungs are
    # the plain torch strategies (the kernels run one design whatever the
    # strategy names)
    fast = PipelineConfig(crt_strategy="matmul", icrt_strategy="matmul",
                          use_kernels=False)
    ref = PipelineConfig(crt_strategy="shoup", icrt_strategy="naive",
                         use_kernels=False)
    t0 = wall(dev)
    H.he_mul(c1, c2, evk, params, cfg=fast)
    t_fast = wall(dev) - t0
    t0 = wall(dev)
    H.he_mul(c1, c2, evk, params, cfg=ref)
    t_ref = wall(dev) - t0
    print(f"reference-structure HE Mul: {t_ref:.2f}s; "
          f"loop-reordered (paper §V-A): {t_fast:.2f}s")
    print("OK")
    return {"device": str(dev), "max_err": err, "session_bitwise": same,
            "product": product, "rescaled": c3, "result": c4,
            "t_fast_s": t_fast, "t_ref_s": t_ref}


if __name__ == "__main__":
    main()
