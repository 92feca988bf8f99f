"""The traffic generator: the same seed gives the same inputs, another
seed others, and every length and id lies in range."""

import numpy as np
import torch

from conftest import TINY_TABLES, tiny_cell
from harness import gen


def rows(seed):
    mix = tiny_cell("clsr-taobao.train").mix
    return gen.train_rows(mix, TINY_TABLES, 50, 86.4, seed, "cpu")


def test_train_rows_deterministic_per_seed():
    a, b, c = rows(2 ** 31 + 3), rows(2 ** 31 + 3), rows(2 ** 31 + 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["item_hist"], c["item_hist"])


def test_train_rows_in_range():
    r = rows(2 ** 33 + 1)
    n = r["users"].shape[0]
    assert n == 3000
    L = r["item_hist"].shape[1]
    lengths = r["lengths"].long()
    assert int(lengths.min()) >= 1 and int(lengths.max()) <= L
    mask = torch.arange(L)[None] < lengths[:, None]
    # real positions hold real ids, padding is zero
    assert bool((r["item_hist"][mask] >= 1).all())
    assert bool((r["item_hist"][~mask] == 0).all())
    assert bool((r["time_to_now"][~mask] == 0).all())
    assert int(r["items"].min()) >= 1
    assert int(r["items"].max()) < TINY_TABLES["n_items"]
    assert int(r["cates"].max()) < TINY_TABLES["n_cates"]
    assert int(r["users"].max()) < TINY_TABLES["n_users"]
    # features are logs of at least 0.5 of the unit
    real = r["time_to_now"][mask]
    assert float(real.min()) >= float(np.log(0.5)) - 1e-6
