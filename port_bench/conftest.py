"""The benchmark's CPU tests: port_bench/ and the repository's root on
the path, and the cells cut to a size a test holds."""

import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.abspath(__file__))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TABLES = dict(n_users=300, n_items=2000, n_cates=30)


def tiny_cell(name):
    """A cell of the manifest at a CPU test's size: small tables, few
    rows, two steps a call."""
    from harness.common import load_cell
    cell = load_cell(name)
    cell.tables = dict(TINY_TABLES)
    cell.mix = dict(cell.mix, rows=3000, batch_size=40)
    return cell


def tiny_run(name, seed=2 ** 31 + 11, seconds=0.5, device="cpu"):
    import torch
    from harness.common import Run
    return Run(cell=tiny_cell(name), seed=seed, seconds=seconds,
               trace=False, device=torch.device(device),
               t0=time.perf_counter(), device_name=str(device),
               overrides=dict(train_steps_per_call=2))


@pytest.fixture
def card():
    """The CUDA card, or a skip: decided in the test, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
