"""The plain reference against the program's plain path (CPU, where the
program runs no kernel), at a test's size: the weights, three train
steps.  This test imports both; the reference itself
imports nothing of the program."""

import pytest
import torch

from conftest import TINY_TABLES, tiny_cell, tiny_run
from harness import checks
from harness.weights import make_weights


def _program_model(cell, weights):
    from clsr_tpu_torch.config import load_config
    from clsr_tpu_torch.models.registry import get_model_class
    cfg = load_config(cell.config_path, seed=1)
    model = get_model_class(cfg.model_type)(cfg, device="cpu",
                                            **TINY_TABLES)
    model.load_state_dict(weights)
    return model


@pytest.mark.parametrize("name", ["clsr-taobao.train",
                                  "sli_rec-taobao.train"])
def test_weights_cover_the_program_state(name):
    cell = tiny_cell(name)
    w = make_weights(cell.cfg, cell.tables, 5, "cpu")
    model = _program_model(cell, w)
    assert sorted(model.state_dict()) == sorted(w)
    for n, t in model.state_dict().items():
        assert torch.equal(t, w[n]), n


@pytest.mark.parametrize("name", ["clsr-taobao.train",
                                  "sli_rec-taobao.train"])
def test_three_train_steps_match(name):
    from harness.train import run_train
    r = run_train(tiny_run(name))
    got = checks.train_readings(r)
    assert got["loss_gap"] <= 1e-6
    assert got["grad_gap"] <= 2e-3
    assert got["change_gap_median"] <= 1e-5
