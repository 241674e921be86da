"""The check that decides `correct`: sound runs pass it; the control (the
reference one prime short of the RNS bound) and each fault the cells can
have, planted under the timed path, fail it.

The CPU cases drive the harness's cells at test_params(); the card's
cases read the control at each cell's own size, on three seeds."""

import json
import time

import pytest
import torch
from conftest import ROOT, cpu_run, tiny_config, tiny_serve_mix, tiny_step_mix

from hebench import cells, servecell, spec, stepcell

SEED = 2**31 + 2024


# ---- faults planted under the timed path ----------------------------------

def step_unchanged(step):
    return lambda ax1, bx1, ax2, bx2: (ax1.clone(), bx1.clone())


def step_half_batch(step):
    def run(ax1, bx1, ax2, bx2):
        h = ax1.shape[0] // 2
        ax, bx = step(ax1[:h], bx1[:h], ax2[:h], bx2[:h])
        pad = torch.zeros_like(ax1[h:])
        return torch.cat([ax, pad]), torch.cat([bx, pad.clone()])
    return run


def step_altered(step):
    def run(*xs):
        ax, bx = step(*xs)
        ax = ax.clone()
        ax[0, 0, 0] ^= 1
        return ax, bx
    return run


def serve_fault(kind):
    def plant(server):
        real = server.engine.run_step

        def run_step(key, arrays):
            if kind == "unchanged":
                return arrays["ax1"].clone(), arrays["bx1"].clone()
            ax, bx = real(key, arrays)
            ax = ax.clone()
            if kind == "half_batch":
                ax[ax.shape[0] // 2:] = 0
            else:
                ax[0, 0, 0] ^= 1
            return ax, bx
        server.engine.run_step = run_step
    return plant


STEP_FAULTS = {"unchanged": step_unchanged, "half_batch": step_half_batch,
               "altered": step_altered}


@pytest.mark.parametrize("beta", [32, 64])
def test_a_sound_step_run_is_correct(beta):
    cfg = tiny_config(beta)
    m = stepcell.run(cpu_run(cfg, tiny_step_mix(cfg["params"]["logQ"]),
                             SEED))
    assert cells.correct(m) and m.mismatched_words == 0
    assert m.compared_words == 4 * 2 * 32 * cfg["shapes"]["qlimbs"]


@pytest.mark.parametrize("fault", sorted(STEP_FAULTS))
@pytest.mark.parametrize("beta", [32, 64])
def test_each_fault_of_the_step_fails_the_check(beta, fault):
    cfg = tiny_config(beta)
    m = stepcell.run(cpu_run(cfg, tiny_step_mix(cfg["params"]["logQ"]),
                             SEED, fault=STEP_FAULTS[fault]))
    assert not cells.correct(m) and m.mismatched_words > 0


def test_a_sound_serving_run_is_correct():
    m = servecell.run(cpu_run(tiny_config(32), tiny_serve_mix(), SEED,
                              seconds=0.5))
    assert cells.correct(m) and m.attempted == m.ops > 50
    # every (op, level) bucket of the mix is in the sample
    assert m.compared_words > 0


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_each_fault_of_serving_fails_the_check(fault):
    m = servecell.run(cpu_run(tiny_config(32), tiny_serve_mix(), SEED,
                              seconds=0.5, fault=serve_fault(fault)))
    assert not cells.correct(m) and m.mismatched_words > 0


@pytest.mark.parametrize("beta", [32, 64])
def test_the_control_fails_the_check_on_the_cpu(beta):
    cfg = tiny_config(beta)
    m = stepcell.run(cpu_run(cfg, tiny_step_mix(cfg["params"]["logQ"]),
                             SEED, short=1))
    assert not cells.correct(m)
    assert m.mismatched_words > 0.9 * m.compared_words


# ---- the control at each cell's own size, on the card ----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["paper-b32.step-b16",
                                      "paper-b32.serve-poisson",
                                      "paper-b64.step-b8"])
def test_the_control_fails_each_cell_on_the_card(card, workload):
    """The reference one prime short of the bound, in the reference's
    place against the program's answers at the cell's size and load: the
    check's number (mismatched words) over three seeds, each far above
    the limit of 0. Printed for the record."""
    cell = spec.cell(spec.load(ROOT), workload, ROOT)
    drive = spec.driver(cell.traffic["kind"])
    readings = []
    for seed in (SEED, SEED + 1, SEED + 2):
        m = drive.run(cells.Run(
            workload=workload, config=cell.config, traffic=cell.traffic,
            seed=seed, seconds=5.0, trace=False, device=card,
            t_start=time.perf_counter(), reference_short=1))
        readings.append((m.mismatched_words, m.compared_words))
        assert not cells.correct(m) and m.mismatched_words > 0
    print(json.dumps({"control": workload, "mismatched_compared":
                      readings}))
