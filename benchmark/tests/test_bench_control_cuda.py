"""On the card: the control (the reference in TF32) fails the cell's
limits and the program passes them, at the cell's widths with a smaller
corpus, pool and window than the benchmark's runs."""

import time

import pytest
import torch

from benchmark import control, harness

SMALLER = {"activitynet.eval": dict(n_videos=600, n_queries=2000),
           "tvr.train": dict(n_train_videos=384)}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def smaller_cell(name):
    c = harness.load_cell(name)
    return harness.Cell(c.name, c.chips, dict(c.config, **SMALLER[name]),
                        c.mix, c.params, c.end_to_end, c.per_layer)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SMALLER))
@pytest.mark.parametrize("seed", [31, 2**31 + 77])
def test_control_fails_and_program_passes(name, seed):
    device = card()
    cell = smaller_cell(name)
    limits = cell.params["limits"]
    low = control.CONTROLS[cell.mix["loop"]](cell, seed, device)
    assert not harness.judge(low, limits), low
    r = harness.loop(cell.mix["loop"]).run(cell, seed, 1.0, False,
                                                 device, time.perf_counter())
    assert harness.judge(r.checks, limits), r.checks
