"""The yardstick of the roofline shares: peaks, work counts and bytes.

Work is counted in 32×32-bit word products, the least any exact
implementation of a product needs: each `mul` and each `modmul` of the
paper's Table IV counts as one (a β = 2^64 product as four). The counts
are the paper's Table IV formulas (copied from the JAX package's
``benchmarks/opcount_model.py``, not imported) at the configuration's
shapes, summed over Fig. 2's plan of one HE Mul:

  region 1 (np1 primes): 4 CRT, 4 NTT, 3 iNTT, 3 iCRT
  region 2 (np2 primes): 1 CRT, 1 NTT, 2 iNTT, 2 iCRT

The product rate is the data sheet's dense INT8 tensor-core rate of one
H100 SXM (1,979 TOPS) over 16 byte products a word product; no exact
implementation forms word products faster, so no share can pass 100 %.
Bytes follow each input read once and each output written once.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "int8_ops_per_s": 1979e12},
}
BYTE_PRODUCTS_PER_WORD_PRODUCT = 16


def peak(device_name: str):
    """(bytes/s, word products/s) of a card, or None for a card that the
    table does not hold."""
    p = PEAKS.get(device_name)
    if p is None:
        return None
    return (p["hbm_bytes_per_s"],
            p["int8_ops_per_s"] / BYTE_PRODUCTS_PER_WORD_PRODUCT)


def function_op_counts(N: int, logN: int, qlimbs: int, npn: int,
                       plimbs: int) -> dict:
    """Paper Table IV: per-function counts of mul, modmul, adc, add/sub."""
    return {
        "CRT": {"mul": N * qlimbs * npn, "modmul": N * npn,
                "adc": N * qlimbs * npn, "addsub": 0},
        "NTT": {"mul": 0, "modmul": npn * (N // 2) * logN,
                "adc": 0, "addsub": npn * N * logN},
        "iNTT": {"mul": 0, "modmul": npn * ((N // 2) * logN + N),
                 "adc": 0, "addsub": npn * N * logN},
        "iCRT": {"mul": N * npn * plimbs, "modmul": 2 * N * npn,
                 "adc": N * npn * plimbs, "addsub": 0},
    }


# Fig. 2: calls of each function a HE Mul makes in each region
PLAN = {1: {"CRT": 4, "NTT": 4, "iNTT": 3, "iCRT": 3},
        2: {"CRT": 1, "NTT": 1, "iNTT": 2, "iCRT": 2}}
MODMUL_CALLS = 3          # region 1's pointwise products (d0, d1, d2)


def shapes(config: dict) -> dict:
    """The configuration's shapes at logQ: N, logN, β, K, np and PL."""
    p, s = config["params"], config["shapes"]
    return {"N": 1 << p["logN"], "logN": p["logN"], "beta": p["beta_bits"],
            "K": s["qlimbs"], "np": {1: s["np1"], 2: s["np2"]},
            "PL": {1: s["plimbs1"], 2: s["plimbs2"]}, "logQ": p["logQ"]}


def he_mul_products(config: dict) -> tuple:
    """(mul, modmul) of one HE Mul at logQ, Table IV over Fig. 2."""
    sh = shapes(config)
    mul = modmul = 0
    for region, calls in PLAN.items():
        c = function_op_counts(sh["N"], sh["logN"], sh["K"], sh["np"][region],
                               sh["PL"][region])
        for fn, n in calls.items():
            mul += n * c[fn]["mul"]
            modmul += n * c[fn]["modmul"]
    return mul, modmul


def word_products(config: dict) -> float:
    """32×32-bit word products of one HE Mul (four a β = 2^64 product)."""
    mul, modmul = he_mul_products(config)
    return (mul + modmul) * (shapes(config)["beta"] // 32) ** 2


def step_bytes(config: dict, batch: int) -> float:
    """Bytes one step must move: each pair's two input ciphertexts and its
    output once, and the evaluation key (np2 rows of each polynomial in
    the NTT domain) once a step."""
    sh = shapes(config)
    word = sh["beta"] // 8
    ct = 2 * sh["N"] * sh["K"] * word
    evk = 2 * sh["np"][2] * sh["N"] * word
    return batch * 3 * ct + evk


def step_bound_s(config: dict, batch: int, device_name: str):
    """The least time a step of `batch` HE Muls can take on the card, or
    None for a card without peaks."""
    pk = peak(device_name)
    if pk is None:
        return None
    bw, rate = pk
    return max(step_bytes(config, batch) / bw,
               batch * word_products(config) / rate)


# --------------------------------------------------------------------------
# the kernel families of the β = 2^32 path
# --------------------------------------------------------------------------

def family_calls(config: dict, batch: int) -> dict:
    """family -> [(bytes, word products)] of each call one step makes
    through the CUDA kernels: every input and table read once, every
    output written once (the byte model of the port's kernel checks); the
    products are Table IV's for CRT, NTT, iNTT and iCRT and one a word
    for the pointwise Montgomery product."""
    sh = shapes(config)
    N, logN, K = sh["N"], sh["logN"], sh["K"]
    n = batch * N
    out = {"crt": [], "ntt": [], "intt": [], "icrt": [], "modmul": []}
    for region, calls in PLAN.items():
        npn, PL = sh["np"][region], sh["PL"][region]
        rows = batch * npn
        c = function_op_counts(N, logN, K, npn, PL)

        def prod(fn):
            return batch * (c[fn]["mul"] + c[fn]["modmul"])

        # the iCRT output of region 2 is the key-switch product's width
        out_limbs = K if region == 1 else ks_limbs(config)
        accum = config["shapes"][f"accum_limbs{region}"]
        pdivp = config["shapes"][f"pdivp_limbs{region}"]
        out["crt"] += [(4 * (n * K + 2 * npn * K + npn + npn * n),
                        prod("CRT"))] * calls["CRT"]
        out["ntt"] += [(4 * (2 * rows * N + 2 * npn * N + npn),
                        prod("NTT"))] * calls["NTT"]
        out["intt"] += [(4 * (2 * rows * N + 2 * npn * N + npn) + 8 * npn,
                         prod("iNTT"))] * calls["iNTT"]
        out["icrt"] += [(4 * (npn * n + npn * (3 + pdivp) + 2 * accum
                              + n * out_limbs) + 8 * npn,
                         prod("iCRT"))] * calls["iCRT"]
        if region == 1:
            out["modmul"] += [(4 * (3 * rows * N + 3 * rows), rows * N)] \
                * MODMUL_CALLS
    return out


def ks_limbs(config: dict) -> int:
    """Limbs of the key-switch product before ÷Q: limbs(logq + logQ) + 1."""
    p = config["params"]
    return math.ceil(2 * p["logQ"] / p["beta_bits"]) + 1


def family_bounds_s(config: dict, batch: int, device_name: str):
    """family -> (calls a step, least seconds a step), or None."""
    pk = peak(device_name)
    if pk is None:
        return None
    bw, rate = pk
    return {f: (len(calls), sum(max(b / bw, w / rate) for b, w in calls))
            for f, calls in family_calls(config, batch).items()}
