"""repro_torch's static analyzer and cost model against the JAX package's,
on the CPU.

The reference's example circuits (``repro.analysis.examples``: the
degree-4 demo, the traced affine-sigmoid scoring and the rotation
average; the bootstrap example and the CLI are tests/test_torch_analysis_cli.py's)
are built again from the port's own objects and analyzed by both sides:
the noise estimates, the diagnostics, ``AnalysisReport.to_dict()`` and its
rendering, and the cost estimates of a ``CostModel`` fitted from the same
bench must be equal. So must each lint rule's findings on the reference
tests' circuits, the noise terms, the cost model's fit and estimates, and
the circuit-aware scheduler's choices with a cost model — the gate alone,
and two staggered degree-4 circuits served by the port's ``HEServer`` and
the JAX ``HEServer`` (a (1, 1) mesh with Auto axes) with the same model.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro import analysis as ja
from repro.analysis import examples as jexamples
from repro.core import test_params as j_test_params
from repro.core.cipher import Ciphertext as JCiphertext
from repro.core.cipher import EvalKey as JEvalKey
from repro.core.params import paper_params as j_paper_params
from repro.hserve import CircuitOp as JCircuitOp
from repro.hserve import HEServer as JHEServer
from repro.hserve.scheduler import CircuitScheduler as JCircuitScheduler

from repro_torch import analysis as ta
from repro_torch import convert
from repro_torch.analysis import noise as tnoise
from repro_torch.client import CipherHandle, compile_handle
from repro_torch.core import heaan as H
from repro_torch.core import test_params as t_test_params
from repro_torch.core.cipher import Ciphertext
from repro_torch.core.keys import keygen
from repro_torch.core.params import paper_params
from repro_torch.core.rotate import conj_keygen
from repro_torch.hserve import CircuitOp, HEServer, degree4_demo_circuit
from repro_torch.hserve.scheduler import CircuitScheduler

BENCH = Path(__file__).resolve().parent.parent / "BENCH_serve_he.json"


# ------------------------------------------- the examples, on the port's side

def _degree4():
    params = t_test_params()
    ops, _ = degree4_demo_circuit(params)
    return dict(ops=ops, input_meta={"x": (params.logQ, params.logp)},
                params=params, input_bounds=1.0,
                input_nslots={"x": params.n_slots_max})


def _affine_sigmoid():
    """The reference's traced logistic-regression scoring, traced over
    the port's handles (same weights, same trace)."""
    params = t_test_params(logN=7, logQ=144, logp=24)
    session = object()                 # trace-only: never submitted
    n = params.n_slots_max

    def leaf():
        z = torch.zeros((params.N, params.qlimbs(params.logQ)),
                        dtype=torch.int32)
        ct = Ciphertext(ax=z, bx=z, logq=params.logQ, logp=params.logp,
                        n_slots=n)
        return CipherHandle(session, "input", ct=ct)

    rng = np.random.default_rng(0)
    feats = [leaf() for _ in range(3)]
    weights = rng.uniform(-0.5, 0.5, size=3)
    x = feats[0] * weights[0]
    for ct, w in zip(feats[1:], weights[1:]):
        x = x + ct * w
    x = x + 0.25                       # bias
    score = x * x * x * (-0.004) + x * 0.197 + 0.5
    cc = compile_handle(score, params)
    return dict(ops=cc.ops, params=params,
                input_meta={k: (c.logq, c.logp)
                            for k, c in cc.inputs.items()},
                input_nslots={k: c.n_slots for k, c in cc.inputs.items()},
                input_bounds=1.0, pt_bounds=cc.pt_bounds)


def _rotation_average():
    params = t_test_params(logN=6, logQ=120, logp=24)
    ops = [CircuitOp("rotate", ("x",), r=1),
           CircuitOp("rotate", ("x",), r=5),
           CircuitOp("add", (0, 1)),
           CircuitOp("add", (2, "x"))]
    return dict(ops=ops, params=params,
                input_meta={"x": (params.logQ, params.logp)},
                input_nslots={"x": params.n_slots_max}, input_bounds=1.0,
                provisioned_rotations={1, 2, 4, 8, 16})


EXAMPLES = {"degree4": _degree4, "affine_sigmoid": _affine_sigmoid,
            "rotation_average": _rotation_average}


def _bench_dict(p):
    return {"params": {"logN": p.logN, "logQ": p.logQ, "logp": p.logp,
                       "beta_bits": p.beta_bits},
            "levels": [p.logQ, p.logQ - p.logp],
            "mul_per_s": 50.0, "rotate_per_s": 100.0,
            "plain": {"mul_plain_per_s": 200.0, "add_plain_per_s": 5000.0}}


def _models(cost, port_params, ref_params):
    if cost == "none":
        return None, None
    if cost == "bench":
        return ta.CostModel.from_bench(BENCH), ja.CostModel.from_bench(BENCH)
    return (ta.CostModel.from_bench(_bench_dict(port_params)),
            ja.CostModel.from_bench(_bench_dict(ref_params)))


def _same_reports(r, jr):
    assert r.to_dict() == jr.to_dict()
    assert r.render("c") == jr.render("c")
    assert [dataclasses.asdict(d) for d in r.diagnostics] == \
        [dataclasses.asdict(d) for d in jr.diagnostics]
    assert r.meta == jr.meta
    assert [dataclasses.astuple(n) for n in r.noise] == \
        [dataclasses.astuple(n) for n in jr.noise]
    assert r.cost_s == jr.cost_s and r.cost_per_node == jr.cost_per_node


@pytest.mark.parametrize("cost", ["none", "dict", "bench"])
@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_reports_equal_the_reference(name, cost):
    kw = EXAMPLES[name]()
    jkw, _ = jexamples.build(name)
    cm, jcm = _models(cost, kw["params"], jkw["params"])
    r = ta.analyze_circuit(**kw, cost_model=cm)
    _same_reports(r, ja.analyze_circuit(**jkw, cost_model=jcm))
    assert r.ok and r.noise


# ------------------------------------------------- each rule, both sides

P = t_test_params()                         # logN=5, logQ=120, logp=24
PJ = j_test_params()
TOP = (P.logQ, P.logp)


def _exhausting(C):
    ops = [C("mul", ("x", "x")), C("rescale", (0,), dlogp=P.logp)]
    for _ in range(P.L):
        ops += [C("mul", (len(ops) - 1, len(ops) - 1)),
                C("rescale", (len(ops),), dlogp=P.logp)]
    return ops


RULE_CASES = {
    "HS001/HS007 exhaustion": (_exhausting, {}),
    "HS002 waterline": (lambda C: [C("add", ("x", "x"))],
                        {"waterline_bits": 100.0}),
    "HS003 dead node": (lambda C: [C("add", ("x", "x")),
                                   C("sub", ("x", "x")),
                                   C("add", (1, "x"))], {}),
    "HS004 no-op rotate": (lambda C: [C("rotate", ("x",),
                                        r=P.n_slots_max)], {}),
    "HS004 composite, keys unknown": (
        lambda C: [C("rotate", ("x",), r=5)], {}),
    "HS004 composite, key missing": (
        lambda C: [C("rotate", ("x",), r=5)],
        {"provisioned_rotations": {1, 2, 4}}),
    "HS005 eager rescale": (lambda C: [C("mul", ("x", "x")),
                                       C("rescale", (0,), dlogp=P.logp)],
                            {}),
    "HS005 lazy": (lambda C: [C("mul", ("x", "x")),
                              C("rescale", (0,), dlogp=P.logp),
                              C("mod_down", ("x",), logq2=96),
                              C("mul", (1, 2))], {}),
    "mul_plain and add_plain": (
        lambda C: [C("mul_plain", ("x",), pt_logp=P.log_delta),
                   C("rescale", (0,), dlogp=P.logp),
                   C("add_plain", (1,), pt_logp=P.logp),
                   C("slot_sum", (2,)), C("conjugate", (3,))],
        {"pt_bounds": {0: 0.5, 2: 2.0}, "input_bounds": {"x": 0.25}}),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_findings_equal_the_reference(case):
    build, kw = RULE_CASES[case]
    r = ta.analyze_circuit(build(CircuitOp), {"x": TOP}, P, **kw)
    jr = ja.analyze_circuit(build(JCircuitOp), {"x": TOP}, PJ, **kw)
    if case.startswith("HS001"):
        # the HS007 hint names the same node in the reference's words,
        # with the port's bootstrap package in place of the reference's
        assert [d.rule for d in r.diagnostics] == ["HS001", "HS007"]
        hint = dataclasses.asdict(r.diagnostics[1])
        assert "repro_torch.boot pipeline" in hint["message"]
        hint["message"] = hint["message"].replace("repro_torch.boot",
                                                  "repro.boot")
        assert [dataclasses.asdict(r.diagnostics[0]), hint] == \
            [dataclasses.asdict(d) for d in jr.diagnostics]
        assert not r.ok
        return
    _same_reports(r, jr)


def test_rule_catalog_equals_the_reference():
    assert [(r.id, r.severity, r.title) for r in ta.RULES.values()] == \
        [(r.id, r.severity, r.title) for r in ja.RULES.values()]


@pytest.mark.parametrize("which", ["test", "paper"])
def test_noise_terms_equal_the_reference(which):
    from repro.analysis import noise as jnoise
    p, pj = ((t_test_params(), j_test_params()) if which == "test"
             else (paper_params(), j_paper_params()))
    for ns in (1, 8, p.n_slots_max):
        assert tnoise.fresh_noise(p, ns) == jnoise.fresh_noise(pj, ns)
        assert tnoise.encode_noise(ns) == jnoise.encode_noise(ns)
    assert tnoise.rescale_noise(p) == jnoise.rescale_noise(pj)
    for lq in range(p.logp, p.logQ + 1, p.logp):
        assert tnoise.keyswitch_noise(lq, p) == \
            jnoise.keyswitch_noise(lq, pj)


# ------------------------------------------------------------ cost model

OPS = ("mul", "rotate", "conjugate", "slot_sum", "mul_plain", "add",
       "add_plain", "rescale", "mod_down")


@pytest.mark.parametrize("source", ["dict", "bench"])
def test_cost_model_fit_and_estimates_equal_the_reference(source):
    if source == "bench":
        cm, jcm = ta.CostModel.from_bench(BENCH), \
            ja.CostModel.from_bench(BENCH)
    else:
        cm = ta.CostModel.from_bench(_bench_dict(P))
        jcm = ja.CostModel.from_bench(_bench_dict(PJ))
    assert cm.kappa == jcm.kappa and cm.default_kappa == jcm.default_kappa
    assert cm.calibrated_from == jcm.calibrated_from
    p = cm.params
    for op in OPS:
        for lq in range(p.logp, p.logQ + 1, p.logp):
            assert cm.op_seconds(op, lq) == jcm.op_seconds(op, lq), (op, lq)
            assert ta.op_units(op, lq, p, n_slots=4) == \
                ja.op_units(op, lq, jcm.params, n_slots=4)
    ops, _ = degree4_demo_circuit(p)
    jops = [JCircuitOp(**{f.name: getattr(o, f.name)
                          for f in dataclasses.fields(o)}) for o in ops]
    meta = {"x": (p.logQ, p.logp)}
    assert cm.estimate_circuit(ops, meta) == jcm.estimate_circuit(jops, meta)
    with pytest.raises(ValueError, match="no usable throughputs"):
        ta.CostModel.from_bench({"params": _bench_dict(P)["params"],
                                 "levels": [120]})


@pytest.mark.parametrize("kappa", [1.0, 1e-9, 1e-15])
def test_deferral_gate_equals_the_reference(kappa):
    cm, jcm = ta.CostModel({"mul": kappa}, kappa, P), \
        ja.CostModel({"mul": kappa}, kappa, PJ)
    s, js = CircuitScheduler(cost_model=cm), JCircuitScheduler(
        cost_model=jcm)
    for op in ("mul", "add", "slot_sum", "rotate"):
        for logq in (120, 96, 48):
            for depth in range(4):
                key = (op, logq, 8 if op == "slot_sum" else None)
                assert s._worth_deferring(key, depth, 4) == \
                    js._worth_deferring(key, depth, 4)
    assert s.cost_skips == js.cost_skips
    assert s.stats() == js.stats()


def test_cost_gated_scheduling_makes_the_reference_choices():
    """Two staggered degree-4 circuits, served with no cost model and
    then with one fitted at these params (where every bucket is too
    cheap to wait for): the port's HEServer and the JAX HEServer defer
    and skip alike and return the same words."""
    p, pj = t_test_params(logN=4), j_test_params(logN=4)
    sk, pk, evk = keygen(p, seed=0, device="cpu")
    ck = conj_keygen(p, sk, device="cpu")
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)

    def jkey(k):
        return JEvalKey(**{f: jnp.asarray(v)
                           for f, v in convert.to_numpy(k).items()})

    def jct(c):
        f = convert.to_numpy(c)
        return JCiphertext(ax=jnp.asarray(f["ax"]), bx=jnp.asarray(f["bx"]),
                           logq=f["logq"], logp=f["logp"],
                           n_slots=f["n_slots"])

    ours = HEServer(p, evk, {}, ck, device="cpu", batch=2, schedule=True)
    theirs = JHEServer(pj, jkey(evk), {}, jkey(ck), mesh=mesh, batch=2,
                       schedule=True)
    ops, _ = degree4_demo_circuit(p)
    rng = np.random.default_rng(3)
    cts = [H.encrypt_message(rng.normal(size=p.n_slots_max) + 0j, pk, p,
                             seed=s) for s in (1, 2)]

    def staggered(server, circ, conv):
        c1 = server.submit_circuit(circ, {"x": conv(cts[0])})
        res = dict(server.poll(flush=True))
        c2 = server.submit_circuit(circ, {"x": conv(cts[1])})
        res.update(server.drain())
        return res[c1], res[c2]

    for cm, jcm in ((None, None), (ta.CostModel.from_bench(_bench_dict(p)),
                                   ja.CostModel.from_bench(_bench_dict(pj)))):
        ours.scheduler.cost_model, theirs.scheduler.cost_model = cm, jcm
        got = staggered(ours, ops, lambda c: c)
        want = staggered(theirs, [JCircuitOp(**{
            f.name: getattr(o, f.name) for f in dataclasses.fields(o)})
            for o in ops], jct)
        for a, b in zip(got, want):
            assert np.array_equal(a.ax.numpy().view(np.uint32),
                                  np.asarray(b.ax))
            assert np.array_equal(a.bx.numpy().view(np.uint32),
                                  np.asarray(b.bx))
        assert ours.scheduler.stats() == theirs.scheduler.stats()
    assert ours.scheduler.cost_skips > 0


def test_analyze_handle_of_a_bare_input():
    z = torch.zeros((P.N, P.qlimbs(P.logQ)), dtype=torch.int32)
    x = CipherHandle(object(), "input",
                     ct=Ciphertext(ax=z, bx=z, logq=P.logQ, logp=P.logp,
                                   n_slots=4))
    r = ta.analyze_handle(x, P)
    assert r.ok and r.n_ops == 0 and r.out_precision_bits is None
