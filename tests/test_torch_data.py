"""The port's config, vocab, time features and batch against clsr_tpu."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import clsr_tpu
from clsr_tpu.config import load_config as jax_load_config
from clsr_tpu.data.parser import compute_time_features as jax_time_features
from clsr_tpu.data.parser import time_range_for_unit as jax_time_range
from clsr_tpu.data.vocab import Vocab as JaxVocab
from clsr_tpu.data.vocab import load_vocab as jax_load_vocab
from clsr_tpu_torch.config import CONFIG_DIR, Config, load_config
from clsr_tpu_torch.data.batch import Batch
from clsr_tpu_torch.data.parser import (compute_time_features,
                                        time_range_for_unit)
from clsr_tpu_torch.data.vocab import Vocab, load_vocab

_VOCABS = dict(user_vocab="u", item_vocab="i", cate_vocab="c")
_JAX_YAML = os.path.join(os.path.dirname(clsr_tpu.__file__), "configs",
                         "clsr.yaml")


def test_clsr_yaml_loads_like_jax():
    port = load_config(f"{CONFIG_DIR}/clsr.yaml", **_VOCABS, seed=4)
    jax_cfg = jax_load_config(_JAX_YAML, **_VOCABS, seed=4)
    jax_fields = dataclasses.asdict(jax_cfg)
    for f in dataclasses.fields(Config):
        assert getattr(port, f.name) == jax_fields[f.name], f.name
    assert port.enable_bn and port.layer_sizes == (100, 64)
    assert port.att_fcn_layer_sizes == (80, 40)
    assert port.use_pallas_eval_attention == "auto"
    assert not port.use_pallas_scan


@pytest.mark.parametrize("bad, err", [
    (dict(user_vocab=None), ValueError),
    (dict(hidden_size=41), ValueError),
    (dict(hidden_size="40"), TypeError),
    (dict(loss="hinge"), ValueError),
    (dict(use_pallas_eval_attention="maybe"), ValueError),
    (dict(use_pallas_train_attention="maybe"), ValueError),
    (dict(contrastive_loss="hinge"), ValueError),
    (dict(learning_rate="fast"), TypeError),
    (dict(attention_block_size=64), ValueError),
])
def test_config_validation_raises(bad, err):
    kw = dict(_VOCABS, **bad)
    with pytest.raises(err):
        load_config(f"{CONFIG_DIR}/clsr.yaml", **kw)
    with pytest.raises(err):
        jax_load_config(_JAX_YAML, **kw)


def test_vocab_pickles_interoperate(tmp_path):
    counts = {"a": 3, "b": 5, "c": 3, "d": 1}
    port, jax_v = Vocab.from_counts(counts), JaxVocab.from_counts(counts)
    assert port.mapping == jax_v.mapping
    port.save(str(tmp_path / "p.pkl"))
    jax_v.save(str(tmp_path / "j.pkl"))
    assert jax_load_vocab(str(tmp_path / "p.pkl")).mapping == port.mapping
    back = load_vocab(str(tmp_path / "j.pkl"))
    assert back.lookup_many(["b", "zz", "d"]) == [1, 0, 4]
    assert len(back) == 5 and "a" in back


@pytest.mark.parametrize("unit", ["s", "ms"])
@pytest.mark.parametrize("n", [1, 2, 9])
def test_time_features_match_jax(unit, n):
    rng = np.random.RandomState(n)
    t = np.sort(1.5e9 + rng.randint(0, 10 ** 6, n)).astype(np.float64)
    cur = float(t[-1] + 3600)
    assert time_range_for_unit(unit) == jax_time_range(unit)
    for a, b in zip(compute_time_features(t, cur, time_range_for_unit(unit)),
                    jax_time_features(t, cur, jax_time_range(unit))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_batch_zeros_and_to():
    b = Batch.zeros(3, 5, 7)
    assert b.items.shape == (3, 5) and b.mask.shape == (3, 7)
    assert b.users.shape == (3,)
    assert b.items.dtype == torch.int32 and b.mask.dtype == torch.float32
    moved = b.to("cpu")
    assert all(torch.equal(getattr(moved, f.name), getattr(b, f.name))
               for f in dataclasses.fields(Batch))
