"""A run with the timed path broken underneath comes out not correct,
once for each fault a one-card train cell can have: a step that returns
its state unchanged, half of the batch left out (the mean over the
rest).  Each drives the rest of a run, past the harness's look for a
card, at a test's size; the same run without a fault comes out
correct."""

import pytest

from conftest import tiny_run
from harness import checks, faults

TRAIN_CELLS = ["clsr-taobao.train", "sli_rec-taobao.train"]


def correct(run, fault=None):
    """The run's `correct`."""
    import run as R
    readings = R.drive(run, fault)
    return checks.passed(checks.judge(readings, run.cell.limits))


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_sound_run_is_correct(name):
    assert correct(tiny_run(name))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_train_fault_is_caught(name, fault):
    assert not correct(tiny_run(name), faults.TRAIN[fault])
