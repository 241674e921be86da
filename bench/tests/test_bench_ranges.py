"""The program's ranges in a traced stretch (hebench.ranges), on
hand-built event lists: times in µs, as `prof.events()` gives them."""

import pytest

from hebench import ranges
from hebench.ranges import Device, Host

T = 7          # the issuing thread


def rng(start, end, name, id=0, thread=T):
    return Host(thread, start, end, "repro_torch/" + name, id)


def step_trace():
    """One HE Mul step (0–100) on thread T: region 1 holds a crt and an
    ntt stage, then region-1 glue; region 2 an icrt stage; the combine
    after it. Each aten op launches one kernel (linked to the op's id);
    the crt kernel is the port's, launched by a runtime call inside the
    range with no op around it."""
    host = [
        rng(0, 100, "step/mul", 1),
        rng(2, 50, "stage/region1", 2),
        rng(4, 20, "stage/crt", 3),
        Host(T, 6, 8, "cudaLaunchKernel", 900),
        rng(22, 40, "stage/ntt", 4),
        Host(T, 24, 30, "aten::mul", 10),
        Host(T, 25, 27, "cudaLaunchKernel", 901),
        Host(T, 42, 48, "aten::add", 11),
        rng(52, 89, "stage/region2", 5),
        rng(54, 88, "stage/icrt", 6),
        Host(T, 56, 60, "aten::copy_", 12),
        Host(T, 92, 98, "aten::bitwise_and", 13),
    ]
    dev = [
        Device(10, 30, "crt_kernel", id=900),                 # runtime link
        Device(30, 45, "elementwise_kernel", id=901, linked=10),
        Device(50, 55, "add_kernel", linked=11),
        Device(60, 80, "direct_copy_kernel", linked=12),
        Device(100, 104, "bitwise_and_kernel", linked=13),
    ]
    return host, dev


def test_a_device_event_goes_to_its_innermost_range():
    host, dev = step_trace()
    att = ranges.attribute(host, dev)
    assert att.device_s == pytest.approx({
        "repro_torch/stage/crt": 20e-6,        # through its runtime call
        "repro_torch/stage/ntt": 15e-6,        # through aten::mul
        "repro_torch/stage/region1": 5e-6,     # glue outside any stage
        "repro_torch/stage/icrt": 20e-6,
        "repro_torch/step/mul": 4e-6})         # the combine
    assert [s[-1].name.rsplit("/", 1)[1] for s in att.stacks] == [
        "crt", "ntt", "region1", "icrt", "mul"]
    assert ranges.covered_pct(att) == 100.0
    assert ranges.launched_in(att, dev, "stage/region1") == pytest.approx(
        40e-6)


def test_a_launch_outside_every_range_is_unattributed():
    host = [Host(T, 0, 10, "aten::mul", 10), rng(20, 30, "step/mul", 1)]
    dev = [Device(5, 15, "k", linked=10), Device(25, 35, "k", linked=99)]
    att = ranges.attribute(host, dev)
    assert att.device_s == pytest.approx({None: 20e-6})
    assert ranges.covered_pct(att) == 0.0


def test_a_range_that_launches_owns_its_work():
    """A kernel linked to a range itself (an operator-scope range around a
    launch with no op inside) goes to that range, not a child open at
    the same instant."""
    host = [rng(0, 50, "stage/crt", 3), rng(0, 40, "stage/inner", 4)]
    att = ranges.attribute(host, [Device(1, 2, "k", linked=3)])
    assert att.device_s == pytest.approx({"repro_torch/stage/crt": 1e-6})


def test_an_idle_gap_goes_to_the_range_open_at_its_midpoint():
    host, dev = step_trace()
    # gaps between busy intervals: 45–50 (mid 47.5: region1, inside
    # aten::add, which is no range), 55–60 (57.5: icrt), 80–100 (90:
    # region2 ends at 89, so step/mul); with the window 0–110 also 0–10
    # (5: crt) and 104–110 (107: outside every range)
    att = ranges.attribute(host, dev)
    assert att.idle_s == pytest.approx({
        "repro_torch/stage/region1": 5e-6,
        "repro_torch/stage/icrt": 5e-6,
        "repro_torch/step/mul": 20e-6})
    att = ranges.attribute(host, dev, window=(0, 110))
    assert att.idle_s == pytest.approx({
        "repro_torch/stage/crt": 10e-6,
        "repro_torch/stage/region1": 5e-6,
        "repro_torch/stage/icrt": 5e-6,
        "repro_torch/step/mul": 20e-6,
        None: 6e-6})


def test_gaps_are_read_on_the_issuing_thread():
    host, dev = step_trace()
    host.append(Host(3, 0, 200, "repro_torch/server/other", 50))
    att = ranges.attribute(host, dev)
    assert "repro_torch/server/other" not in att.idle_s


def test_the_five_stage_metrics_sum_to_the_window_per_op():
    host, dev = step_trace()
    att = ranges.attribute(host, dev, window=(0, 110))
    got = ranges.stage_ms(att, window_s=110e-6, ops=2)
    assert set(got) == {"crt", "ntt", "modmul", "icrt", "other"}
    assert got["crt"] == pytest.approx(1e3 * 30e-6 / 2)
    assert got["ntt"] == pytest.approx(1e3 * 15e-6 / 2)
    assert got["modmul"] == 0.0
    assert got["icrt"] == pytest.approx(1e3 * 25e-6 / 2)
    assert sum(got.values()) == pytest.approx(1e3 * 110e-6 / 2)
    assert sum(v for k, v in got.items() if k != "other") <= 1e3 * 55e-6


def test_server_idle_is_idle_time_inside_a_server_range():
    host = [rng(0, 30, "server/poll", 1), rng(5, 25, "step/mul", 2),
            rng(40, 45, "server/submit", 3), rng(60, 90, "server/poll", 4),
            Host(T, 6, 8, "aten::mul", 10)]
    dev = [Device(10, 50, "k", linked=10), Device(70, 80, "k", linked=10)]
    # idle 0–10 (10 in poll), 50–70 (10 in the second poll), 80–100 (10)
    got = ranges.server_idle_pct(host, dev, window=(0, 100))
    assert got == pytest.approx(30.0)


@pytest.mark.parametrize("n,want", [(1, 1), (19, 19), (20, 19), (21, 20),
                                    (290, 276)])
def test_queue_wait_p95_is_nearest_rank(n, want):
    events = [{"name": "bucket_wait", "ph": "X", "dur": 1e3 * (k + 1)}
              for k in reversed(range(n))]
    events.append({"name": "complete", "ph": "X", "dur": 1e9})
    assert ranges.queue_wait_p95_ms(events) == want


def test_no_program_range_reads_none():
    host = [Host(T, 0, 10, "aten::mul", 10)]
    dev = [Device(5, 15, "k", linked=10)]
    att = ranges.attribute(host, dev, window=(0, 20))
    assert ranges.stage_ms(att, window_s=20e-6, ops=4) is None
    assert ranges.server_idle_pct(host, dev, window=(0, 20)) is None
    assert ranges.queue_wait_p95_ms([]) is None
    assert ranges.covered_pct(ranges.attribute(host, [])) is None
