"""Every call that the drivers of the HE Mul step and of serving
(``stepcell``, ``servecell``) make into the system under test, `repro_torch`.

Kept in one module so that what the benchmark takes from the program is
plain to see: its parameters, its tables, the batched HE Mul step, the
server, and its launch counters. The benchmark's inputs (ciphertext and
key words) are its own; the key's evaluation form with its Shoup
companions is derived here by the program, as a server derives it from a
key it is sent.

A driver of another kind `K` (``bench/hebench/<K>cell.py``) keeps its calls
into the program in ``bench/hebench/program_<K>.py`` (for example
``program_bootstrap.py``) and nowhere else; it may call what this module
has. Its plain reference is a file of its own, ``bench/<name>ref.py``,
which imports nothing of the program, as ``bench/heref.py``; its roofline
arithmetic is ``bench/hebench/roofline_<K>.py``. So a new kind joins as
new files.
"""

from __future__ import annotations

import math

import torch


def params_of(config: dict):
    """The program's HEParams for a configuration file, checked against
    the shapes the file states at logQ: qlimbs, np1, np2, the limbs of
    each region's prime product P (Table IV's PLimbs, by the paper's
    rule), and the widths of the program's iCRT tables (P/p and the
    accumulator), which the kernels' byte model reads."""
    from repro_torch.core.context import device_icrt_tables
    from repro_torch.core.params import HEParams

    p = HEParams(**config["params"])
    logQ = p.logQ
    np1, np2 = p.np_region1(logQ), p.np_region2(logQ)
    got = {"qlimbs": p.qlimbs(logQ), "np1": np1, "np2": np2}
    for region, npn in ((1, np1), (2, np2)):
        tabs = device_icrt_tables(p, npn, torch.device("cpu"))
        got[f"plimbs{region}"] = p.limbs_for_bits(
            int(sum(math.log2(q) for q in p.primes[:npn])))
        got[f"pdivp_limbs{region}"] = tabs.plimbs
        got[f"accum_limbs{region}"] = tabs.accum_limbs
    want = {k: config["shapes"][k] for k in got}
    if got != want:
        raise RuntimeError(f"the program's parameters give {got}; the "
                           f"configuration states {want}")
    return p


def load_kernels(use_kernels: bool, device: torch.device) -> None:
    """Build (first run in a checkout) or load the CUDA library."""
    if use_kernels and device.type == "cuda":
        from repro_torch.kernels import common
        common.library()


def eval_key(params, ax: torch.Tensor, bx: torch.Tensor, use_kernels: bool,
             device: torch.device):
    """The program's EvalKey for a key given as coefficient words mod Q²:
    both polynomials at the region-2 primes of logQ in the NTT domain,
    with their Shoup companions."""
    from repro_torch.core import rns
    from repro_torch.core.cipher import EvalKey
    from repro_torch.core.context import device_tables
    from repro_torch.core.rns import PipelineConfig
    from repro_torch.core.wordops import narrow, shoup_companion, wide

    g = device_tables(params, device)
    cfg = PipelineConfig(use_kernels=use_kernels)
    np2 = params.np_region2(params.logQ)
    primes = g.primes[:np2]
    bits = params.beta_bits
    evs = [rns.to_eval(x.to(device).contiguous(), np2, g, cfg)
           for x in (ax, bx)]
    sh = [narrow(shoup_companion(wide(e), wide(primes), bits), bits)
          for e in evs]
    return EvalKey(ax_ev=evs[0], ax_ev_shoup=sh[0], bx_ev=evs[1],
                   bx_ev_shoup=sh[1])


def he_mul_step(params, logq: int, evk, device: torch.device,
                use_kernels: bool):
    """The batched HE Mul step at `logq` (the "default" rung), closed over
    its tables: run(ax1, bx1, ax2, bx2) -> (ax3, bx3)."""
    from repro_torch.core.context import make_context
    from repro_torch.dist import he_pipeline as hp

    st = hp.he_static(params, logq)
    t1, t2, ek = hp.runtime_tables(make_context(params, logq, device), evk)
    step = hp.make_he_mul_step(st, device, use_kernels=use_kernels)

    def run(ax1, bx1, ax2, bx2):
        return step(t1, t2, ek, ax1, bx1, ax2, bx2)

    return run


def ciphertext(params, ax: torch.Tensor, bx: torch.Tensor, logq: int):
    from repro_torch.core.cipher import Ciphertext
    return Ciphertext(ax=ax, bx=bx, logq=logq, logp=params.log_delta,
                      n_slots=params.N // 2)


def server(params, evk, rot_keys: dict, device: torch.device,
           use_kernels: bool, knobs: dict):
    from repro_torch.hserve.server import HEServer
    return HEServer(params, evk, rot_keys, device=device,
                    use_kernels=use_kernels, **knobs)


def launches() -> dict:
    """The kernels' launch counters (one per wrapper call)."""
    from repro_torch.kernels import common
    return dict(common.LAUNCHES)
