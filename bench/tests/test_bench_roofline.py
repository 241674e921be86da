"""The yardstick: Table IV's counts, the bounds, and the kernels' share."""

import json

import pytest
from conftest import BENCH

from hebench import readers, roofline, tracing
from hebench.cells import Measure

CARD = "NVIDIA H100 80GB HBM3"


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_table_iv_copy_gives_the_papers_product_counts():
    assert roofline.he_mul_products(config("heaan-paper-b32")) == (
        4143972352, 614137856)
    assert roofline.he_mul_products(config("heaan-paper-b64")) == (
        1058275328, 309329920)
    # a β = 2^64 product is four 32×32-bit word products
    assert roofline.word_products(config("heaan-paper-b64")) == 4 * (
        1058275328 + 309329920)


def test_he_mul_bound_is_products_over_the_int8_tensor_rate():
    c = config("heaan-paper-b32")
    rate = 1979e12 / 16
    assert roofline.peak(CARD) == (3.35e12, rate)
    assert roofline.step_bound_s(c, 1, CARD) == pytest.approx(
        (4143972352 + 614137856) / rate)          # ≈ 38.5 µs
    assert roofline.step_bound_s(c, 1, CARD) == pytest.approx(38.46e-6,
                                                              rel=1e-3)
    assert roofline.step_bound_s(c, 1, "another card") is None


def trace(kernels, steps=1, launches=None):
    return tracing.Trace(window_s=1.0, busy_s=0.9, kernels=kernels, ops=16,
                         steps=steps, launches=launches or {}, gaps={})


def measure(t, config_name="heaan-paper-b32"):
    return Measure(kind="step", config=config(config_name), traffic={},
                   device_name=CARD, batch=16, trace=t, steps=1,
                   window_s=1.0)


NAMES = {"crt": "(anonymous namespace)::crt_kernel<Every<1>>",
         "ntt": "(anonymous namespace)::ntt_pass8<true, true, false>",
         "intt": "(anonymous namespace)::ntt_pass<false, false, false>",
         "icrt": "(anonymous namespace)::icrt_kernel",
         "modmul": "(anonymous namespace)::modmul_kernel"}


def full_trace(scale=1.0):
    """A step whose every family takes `scale` times its bound, with the
    plan's launches (two kernels a transform call)."""
    bounds = roofline.family_bounds_s(config("heaan-paper-b32"), 16, CARD)
    per = {"ntt": 2, "intt": 2}
    kernels = {NAMES[f]: (scale * s, calls * per.get(f, 1))
               for f, (calls, s) in bounds.items()}
    kernels["void at::native::elementwise_kernel<...>"] = (0.05, 900)
    launches = {f: calls for f, (calls, _) in bounds.items()}
    return trace(kernels, launches=launches)


def test_share_is_the_bounds_over_non_torch_time_and_stays_under_100():
    assert readers.kernels_roofline_pct(measure(full_trace(1.0))) == \
        pytest.approx(100.0)
    assert readers.kernels_roofline_pct(measure(full_trace(4.0))) == \
        pytest.approx(25.0)


def test_a_family_missing_from_the_trace_drops_its_bound():
    full = full_trace(4.0)
    whole = readers.kernels_roofline_pct(measure(full))
    kernels = dict(full.kernels)
    crt_s, _ = kernels.pop(NAMES["crt"])
    # the same time under a name no family claims: counted, with no bound
    kernels["(anonymous namespace)::fused_crt_ntt"] = (crt_s, 5)
    dropped = readers.kernels_roofline_pct(
        measure(trace(kernels, launches=full.launches)))
    assert dropped < whole


def test_a_launch_count_the_counters_do_not_give_drops_the_bound():
    full = full_trace(4.0)
    launches = dict(full.launches, icrt=4)
    assert readers.kernels_roofline_pct(
        measure(trace(full.kernels, launches=launches))) < \
        readers.kernels_roofline_pct(measure(full))


def test_no_trace_or_no_peak_reads_nothing():
    assert readers.kernels_roofline_pct(measure(None)) is None
    m = measure(full_trace())
    m.device_name = "another card"
    assert readers.kernels_roofline_pct(m) is None
    assert readers.step_mfu_pct(m) is None


def test_step_mfu_is_the_step_bound_over_the_window():
    m = measure(None)
    m.steps, m.window_s = 10, 2.0
    bound = roofline.step_bound_s(m.config, 16, CARD)
    assert readers.step_mfu_pct(m) == pytest.approx(100 * 10 * bound / 2.0)
    # a window as short as the bound reads 100 %, and none can be shorter
    m.window_s = 10 * bound
    assert readers.step_mfu_pct(m) == pytest.approx(100.0)


def test_gap_labels_follow_the_innermost_host_event():
    host = [(0, 50, "outer"), (5, 15, "a"), (16, 35, "b"), (36, 38, "c")]
    got = tracing.label_gaps([(10, 20), (30, 40), (100, 120)], host)
    assert got == pytest.approx({"a": 10e-6, "b": 10e-6, "host idle": 20e-6})
