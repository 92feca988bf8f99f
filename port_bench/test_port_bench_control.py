"""The control comes out not correct: the plain reference computed in
TF32, the nearest precision below the configurations' float32, put in
the program's place, against the plain reference in float32.  On the
card (TF32 exists only there), at the published widths and batch with
small tables, on three seeds; the check's numbers and limits are the
cells'.  The readings at each cell's own size are made by
readings.py."""

import pytest
import torch

from conftest import tiny_cell
from harness import checks, gen
from harness.train import reference_batches, reference_readings


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
@pytest.mark.parametrize("name", ["clsr-taobao.train",
                                  "sli_rec-taobao.train"])
def test_train_control_fails(card, name, seed):
    cell = tiny_cell(name)
    mix = dict(cell.mix, batch_size=400, rows=20000)
    cfg = dict(cell.cfg, batch_size=400)
    data = gen.train_rows(mix, cell.tables, 50, 86.4, seed, card)
    rows = torch.randperm(mix["rows"])[:1200].numpy()
    ref_in = dict(cfg=cfg, tables=cell.tables, seed=seed,
                  batches=reference_batches(data, rows, 400, 50, card))
    ref = reference_readings(ref_in, card)
    ctrl = reference_readings(ref_in, card, tf32=True)
    readings = checks.train_readings(dict(
        ref, losses=ctrl["ref_losses"], first=ctrl["ref_first"],
        change=ctrl["ref_change"]))
    assert not checks.passed(checks.judge(readings, cell.limits))
    same = checks.train_readings(dict(
        ref, losses=ref["ref_losses"], first=ref["ref_first"],
        change=ref["ref_change"]))
    assert checks.passed(checks.judge(same, cell.limits))
