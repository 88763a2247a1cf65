"""The check that decides ``correct`` fails what it has to fail.

Small configurations on the CPU (the port's kernels take their plain
versions there), the cells' own limits:

- a whole run (set-up, window, check) with the timed path broken
  underneath comes out not correct, once for each fault the cell can
  have: a training step that returns its state unchanged; half of the
  batch left out (a training step's mean over the other half of the
  tokens; a prefill's second half given the first half's logits); a
  prefill's answer altered where it is produced;
- the control, the reference in float8 put in the program's place, fails
  one of the cell's numbers, while the program passes them all.
"""
from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests.small import small_cell, small_model

CPU = torch.device("cpu")
SMALL = {
    "deepseek-moe-16b.train-4k": dict(seq=64),
    "minicpm3-4b.prefill-32k": dict(seq=256, check_rows=64),
    "minicpm3-4b.prefill-b16x512": dict(batch=4, seq=64, check_horizon=6,
                                        check_requests=2, check_seqs=4,
                                        check_rows=8),
}
FAULTS = [
    ("deepseek-moe-16b.train-4k", "unchanged"),
    ("deepseek-moe-16b.train-4k", "half_batch"),
    ("minicpm3-4b.prefill-32k", "altered_answer"),
    ("minicpm3-4b.prefill-b16x512", "altered_answer"),
    ("minicpm3-4b.prefill-b16x512", "half_batch"),
]


def _cell(name):
    cell = small_cell(name, **SMALL[name])
    # a CPU window of a fraction of a second holds too few requests for a
    # 90th percentile; the other metrics are the run's own
    cell["end_to_end"] = [m for m in cell["end_to_end"]
                          if m != "latency_p90_ms"]
    return cell, small_model(cell["config"])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_sound_run_is_correct(name):
    torch.manual_seed(0)
    cell, model = _cell(name)
    res = run.run_cell(name, 2 ** 40 + 3, 0.05, False, CPU, cell=cell,
                       model=model)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(cell["end_to_end"])


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(name, fault):
    torch.manual_seed(0)
    cell, model = _cell(name)
    res = run.run_cell(name, 2 ** 40 + 5, 0.05, False, CPU, fault=fault,
                       cell=cell, model=model)
    assert not res["correct"], res["checks"]


# the number that tells float8 from bf16 in each kind of cell
SEPARATES = {"lm_train": "grad_err", "lm_prefill": "logit_err"}


def _readings(cell, model, seed, device, control):
    runner = run.load_module("entries", cell["entry"]).Runner(
        cell, model, seed, device)
    runner.setup()
    for i in runner.checked:
        runner.item(i)
    runner.close_window()
    return runner.readings(control=control)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_float8_control_reads_far_above_the_program(name):
    """At a test's size (a few narrow layers) the errors stay under the
    cells' limits, which were set at the cells' own sizes on the card (the
    test below); the control still reads three times the program or
    more."""
    torch.manual_seed(0)
    cell, model = _cell(name)
    key = SEPARATES[cell["entry"]]
    program = _readings(cell, model, 2 ** 40 + 7, CPU, False)[key]
    control = _readings(cell, model, 2 ** 40 + 7, CPU, True)[key]
    assert control >= 3 * program, (program, control)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_float8_control_is_not_correct_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's "
                    "own size")
    cell = run.load_json("workloads", name)
    model = run.load_json("configs", cell["config"])["model"]
    got = _readings(cell, model, 2 ** 40 + 9, torch.device("cuda", 0), True)
    assert any(got[k] > lim for k, lim in cell["check"].items()), got
