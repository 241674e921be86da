"""End-to-end encrypted inference (the paper's application class, §I/[39]):
logistic-regression scoring on ENCRYPTED features, batched in CKKS slots,
written on the ``repro_torch.client`` session API — the traced-handle
frontend that compiles straight to served circuits.

    PYTHONPATH=src python -m repro_torch.examples.he_inference [--device cpu]

Pipeline:
  1. train a logistic-regression probe on synthetic data (plaintext numpy);
  2. client encrypts each request batch FEATURE-MAJOR: ciphertext j holds
     feature j of every example in its slots (no rotations needed);
  3. the model is ONE traced function over handles —
         score = Σ_j w_j · ct_j + b                     (affine)
         σ(x) ≈ 0.5 + 0.197·x − 0.004·x³                (degree-3 sigmoid)
     with NO rescale/mod_down anywhere: the compile pass inserts all
     level management and hash-registers every weight, so the SECOND
     request batch ships hash-only plaintext operands and the server
     serves them from its (hash, level) cache;
  4. both requests run as futures through one drain (they co-batch
     node-for-node), then the client decrypts and we compare against
     plaintext inference.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.client import HESession
from repro_torch.core.context import resolve_device
from repro_torch.core.params import test_params
from repro_torch.examples import check, wall

N_EXAMPLES, N_FEATURES = 64, 8
# degree-3 sigmoid (Kim et al. / iDASH coefficients, valid on ~[-6, 6])
C1, C3 = 0.197, 0.004


def make_batch(seed, w_true):
    r = np.random.default_rng(seed)
    X = r.normal(size=(N_EXAMPLES, N_FEATURES))
    y = (X @ w_true + 0.3 * r.normal(size=N_EXAMPLES) > 0)
    return X, y.astype(np.float64)


def train_probe():
    """The plaintext probe: (w, b, (X, y), (X2, y2), accuracy)."""
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=N_FEATURES)
    X, y = make_batch(1, w_true)
    w = np.zeros(N_FEATURES)
    b = 0.0
    for _ in range(400):
        p = 1 / (1 + np.exp(-(X @ w + b)))
        g = X.T @ (p - y) / N_EXAMPLES + 0.08 * w   # L2 keeps scores in the
        w -= 0.5 * g                                # poly-sigmoid's range
        b -= 0.5 * float(np.mean(p - y))
    acc = float(((1 / (1 + np.exp(-(X @ w + b))) > 0.5) == y).mean())
    return w, b, (X, y), make_batch(2, w_true), acc


def traced_probs(cts, w, b):
    """The whole encrypted model as handle arithmetic. The x² and x·x²
    steps are real HE Muls — the operation this framework accelerates;
    every rescale/mod_down is the compiler's problem."""
    score = cts[0] * w[0]
    for j in range(1, N_FEATURES):
        score = score + cts[j] * w[j]
    score = score + b
    x2 = score * score                           # HE Mul #1
    x3 = x2 * score                              # HE Mul #2 (auto align)
    return score * C1 - x3 * C3 + 0.5


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "he_inference")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- plaintext training ------------------------------------------------
    w, b, (X, y), (X2, y2), acc_plain = train_probe()
    print(f"plaintext probe accuracy: {acc_plain:.3f} "
          f"(score range ±{np.abs(X @ w + b).max():.1f})")

    # --- the session: keys + server (L=6 covers the depth-4 trace) ---------
    params = test_params(logN=7, beta_bits=32, logQ=144, logp=24)
    session = HESession(params, seed=0, batch=2, device=dev)

    # --- two request batches through one traced model ----------------------
    t0 = wall(dev)
    inputs = [[session.encrypt(Xi[:, j], seed=100 * i + j)
               for j in range(N_FEATURES)] for i, Xi in enumerate((X, X2))]
    handles = [traced_probs(cts, w, b) for cts in inputs]
    print(f"encrypted 2 × {N_FEATURES} feature ciphertexts "
          f"({N_EXAMPLES} examples/slots each) on {dev}: "
          f"{wall(dev) - t0:.1f}s")

    t0 = wall(dev)
    futs = session.run(handles)          # compile + submit; NO drain yet
    probs_he = [f.decrypt().real for f in futs]   # one drain serves both
    served = [f.result() for f in futs]
    cache = session.stats()["cache"]
    print(f"served both traced circuits (2 HE Muls + affine each): "
          f"{wall(dev) - t0:.1f}s; plaintext-operand cache: "
          f"{cache['plain_hits']} hits / {cache['plain_misses']} misses "
          f"({cache['plain_entries']} entries)")

    # --- client decrypt + verify -------------------------------------------
    err, accs = 0.0, []
    for (Xi, yi), probs in zip(((X, y), (X2, y2)), probs_he):
        scores = Xi @ w + b
        probs_pt = 0.5 + C1 * scores - C3 * scores ** 3
        err = max(err, float(np.abs(probs - probs_pt).max()))
        acc_he = float(((probs > 0.5) == yi).mean())
        acc_poly = float(((probs_pt > 0.5) == yi).mean())
        accs.append((acc_he, acc_poly))
        check(acc_he == acc_poly,
              "HE must match plaintext poly-sigmoid decisions")
    print(f"max |HE - plaintext poly-sigmoid| = {err:.2e}")
    print("accuracy per batch (encrypted == plaintext poly-sigmoid): "
          + ", ".join(f"{a:.3f}" for a, _ in accs))
    check(err < 1e-2, "HE diverged from the computation it mirrors")
    check(cache["plain_hits"] >= 1,
          "second request batch never hit the plaintext-operand cache")
    check(accs[0][0] >= acc_plain - 0.1, "poly-sigmoid approximation degraded")
    print("OK")
    return {"device": str(dev), "probs": probs_he, "max_err": err,
            "accuracy": accs, "plain_accuracy": acc_plain, "cache": cache,
            "inputs": [[h.ct for h in cts] for cts in inputs],
            "served": served}


if __name__ == "__main__":
    main()
